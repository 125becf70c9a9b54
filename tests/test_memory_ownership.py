"""Memory-ownership semantics of the tracker pipeline: the ownership boxes
that free full-size fields mid-pipeline, the bit-packed release of the raw
binary field, the single-use host-label stash, and input donation in detect —
the machinery that bounds device memory at production shapes."""

import numpy as np
import pandas as pd
import pytest

import marex_tpu as marEx
from marex_tpu.core.field import Field


def _blob_field(T=40, H=16, W=32):
    data = np.zeros((T, H, W), bool)
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(T):
        cx = (4 + t) % W
        dx = np.minimum(np.abs(xx - cx), W - np.abs(xx - cx))
        data[t] |= (yy - H // 2) ** 2 + dx**2 <= 9
    coords = {
        "time": pd.date_range("2021-01-01", periods=T, freq="D").to_numpy(),
        "lat": np.linspace(-40, 40, H),
        "lon": np.linspace(0, 360, W, endpoint=False),
    }
    return Field(data, ("time", "lat", "lon"), coords, name="extreme_events")


def _mask(H=16, W=32):
    return Field(
        np.ones((H, W), bool), ("lat", "lon"),
        {"lat": np.linspace(-40, 40, H), "lon": np.linspace(0, 360, W, endpoint=False)},
        name="mask",
    )


class TestDataBinRelease:
    def test_release_packs_and_payload_roundtrips(self):
        import jax.numpy as jnp

        f = _blob_field()
        dev = Field(jnp.asarray(f.values), f.dims, dict(f.coords), name=f.name)
        tr = marEx.tracker(dev, _mask(), R_fill=0, T_fill=0, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        original = np.asarray(tr.data_bin.values).copy()
        tr._release_data_bin()
        # the shell preserves dims/coords/shape but holds no real buffer
        assert tr.data_bin.shape == f.shape
        assert tr._data_bin_packed is not None
        # transparently reconstructed, bit-exactly
        recon = np.asarray(tr._data_bin_payload())
        np.testing.assert_array_equal(recon, original)

    def test_release_skips_host_inputs(self):
        f = _blob_field()
        tr = marEx.tracker(f, _mask(), R_fill=0, T_fill=0, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        tr._release_data_bin()
        assert getattr(tr, "_data_bin_packed", None) is None  # numpy payload untouched

    def test_run_twice_after_release(self):
        """A second run() on the same tracker must reconstruct the packed
        field and produce identical events."""
        import jax.numpy as jnp

        f = _blob_field()
        dev = Field(jnp.asarray(f.values), f.dims, dict(f.coords), name=f.name)
        tr = marEx.tracker(dev, _mask(), R_fill=2, T_fill=2, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        ev1 = tr.run()
        ev2 = tr.run()
        np.testing.assert_array_equal(
            np.asarray(ev1["ID_field"].values), np.asarray(ev2["ID_field"].values)
        )


class TestOwnershipBoxes:
    def test_run_tracking_accepts_array_and_box(self):
        f = _blob_field()
        tr = marEx.tracker(f, _mask(), R_fill=2, T_fill=2, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        pre, _stats = tr.run_preprocess()
        ev_a, _, n_a = tr.run_tracking(pre)
        box = [pre]
        ev_b, _, n_b = tr.run_tracking(box)
        assert n_a == n_b
        assert box == []  # ownership consumed: the filtered field was freed
        np.testing.assert_array_equal(
            np.asarray(ev_a["ID_field"].values), np.asarray(ev_b["ID_field"].values)
        )

    def test_track_objects_box_cleared(self):
        f = _blob_field()
        tr = marEx.tracker(f, _mask(), R_fill=2, T_fill=2, area_filter_quartile=0.0,
                           allow_merging=True, overlap_threshold=0.25, quiet=True)
        pre, _stats = tr.run_preprocess()
        box = [pre]
        events_ds, merges_ds, n = tr.track_objects(box)
        assert box == []
        assert n > 0

    def test_host_label_stash_single_use(self):
        f = _blob_field()
        tr = marEx.tracker(f, _mask(), R_fill=0, T_fill=0, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        sentinel = np.zeros((2, 2), np.int32)
        probe = np.zeros((4,), bool)
        import weakref

        tr._host_label_state = (weakref.ref(probe), sentinel, 7)
        assert tr._take_host_label_state(probe) == (sentinel, 7)
        # consumed: a second take returns None and the stash stays cleared
        assert tr._take_host_label_state(probe) is None
        assert tr._host_label_state is None

    def test_host_label_stash_identity_miss_clears(self):
        f = _blob_field()
        tr = marEx.tracker(f, _mask(), R_fill=0, T_fill=0, area_filter_quartile=0.0,
                           allow_merging=False, quiet=True)
        import weakref

        probe = np.zeros((4,), bool)
        other = np.zeros((4,), bool)
        tr._host_label_state = (weakref.ref(probe), np.zeros((2, 2), np.int32), 3)
        assert tr._take_host_label_state(other) is None
        assert tr._host_label_state is None  # miss must not pin the field


class TestDetectDonation:
    def test_host_input_auto_donates_and_results_match(self):
        rng = np.random.default_rng(0)
        T, H, W = 2 * 365, 8, 16
        coords = {
            "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
            "lat": np.linspace(-30, 30, H),
            "lon": np.linspace(0, 360, W, endpoint=False),
        }
        sst = (15 + rng.standard_normal((T, H, W))).astype(np.float32)
        host = Field(sst, ("time", "lat", "lon"), coords, name="sst")
        ds_host = marEx.preprocess_data(host, method_anomaly="fixed_baseline",
                                        method_extreme="global_extreme", quiet=True)
        import jax.numpy as jnp

        dev = Field(jnp.asarray(sst), ("time", "lat", "lon"), coords, name="sst")
        ds_dev = marEx.preprocess_data(dev, method_anomaly="fixed_baseline",
                                       method_extreme="global_extreme", quiet=True,
                                       donate_input=True)
        np.testing.assert_array_equal(
            np.asarray(ds_host.extreme_events.values), np.asarray(ds_dev.extreme_events.values)
        )
        np.testing.assert_array_equal(
            np.asarray(ds_host["mask"].values), np.asarray(ds_dev["mask"].values)
        )

    def test_device_input_survives_without_optin(self):
        import jax
        import jax.numpy as jnp

        rng = np.random.default_rng(1)
        T, H, W = 2 * 365, 6, 12
        coords = {
            "time": pd.date_range("2000-01-01", periods=T, freq="D").to_numpy(),
            "lat": np.linspace(-30, 30, H),
            "lon": np.linspace(0, 360, W, endpoint=False),
        }
        sst = jnp.asarray((15 + rng.standard_normal((T, H, W))).astype(np.float32))
        dev = Field(sst, ("time", "lat", "lon"), coords, name="sst")
        marEx.preprocess_data(dev, method_anomaly="detrend_harmonic",
                              method_extreme="global_extreme", quiet=True)
        jax.block_until_ready(sst)  # would raise if the buffer had been donated
        assert bool(jnp.isfinite(sst).all())
