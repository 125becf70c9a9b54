"""Infrastructure tests: exceptions, logging, dependency registry, Field
container, zarr-lite IO, helper shims.

Mirrors the reference's infra test coverage (test_exceptions.py,
test_logging_system.py) at reduced volume.
"""

import logging
import os

import numpy as np
import pandas as pd
import pytest

import marex_tpu as marEx
from marex_tpu.core.field import Coord, Field, FieldSet, broadcast, concat
from marex_tpu.io.zarr_lite import open_zarr, to_zarr


class TestExceptions:
    def test_base_error_formatting(self):
        err = marEx.MarExError(
            "something failed",
            details="the details",
            suggestions=["try this", "or that"],
            context={"param": 42},
        )
        s = str(err)
        assert "something failed" in s
        assert "the details" in s
        assert "try this" in s
        assert "param=42" in s
        assert err.error_code == "MAREX_ERROR"

    def test_subclass_error_codes(self):
        assert marEx.DataValidationError("x").error_code == "DATA_VALIDATION_ERROR"
        assert marEx.ConfigurationError("x").error_code == "CONFIGURATION_ERROR"
        assert marEx.TrackingError("x").error_code == "TRACKING_ERROR"
        assert marEx.CoordinateError("x").error_code == "COORDINATE_ERROR"
        assert marEx.VisualisationError("x").error_code == "VISUALISATION_ERROR"
        assert marEx.DependencyError("x").error_code == "DEPENDENCY_ERROR"

    def test_hierarchy(self):
        for cls in (
            marEx.DataValidationError,
            marEx.CoordinateError,
            marEx.ProcessingError,
            marEx.ConfigurationError,
            marEx.DependencyError,
            marEx.TrackingError,
            marEx.VisualisationError,
        ):
            assert issubclass(cls, marEx.MarExError)

    def test_factories(self):
        e = marEx.create_data_validation_error("bad", data_info={"shape": (3,)})
        assert isinstance(e, marEx.DataValidationError)
        assert e.context["shape"] == (3,)
        e2 = marEx.create_coordinate_error("bad coord")
        assert isinstance(e2, marEx.CoordinateError)

    def test_wrap_exception(self):
        try:
            raise ValueError("inner boom")
        except ValueError as ve:
            wrapped = marEx.wrap_exception(ve, "outer message")
        assert isinstance(wrapped, marEx.ProcessingError)
        assert isinstance(wrapped.__cause__, ValueError)
        assert "outer message" in str(wrapped)

    def test_to_dict(self):
        d = marEx.TrackingError("x", details={"a": 1}).to_dict()
        assert d["type"] == "TrackingError"
        assert d["context"]["a"] == 1


class TestLogging:
    def test_modes(self):
        marEx.set_verbose_mode()
        assert marEx.is_verbose_mode()
        assert marEx.get_verbosity_level() == "verbose"
        marEx.set_quiet_mode()
        assert marEx.is_quiet_mode()
        marEx.set_normal_logging()
        assert not marEx.is_verbose_mode() and not marEx.is_quiet_mode()

    def test_env_var_configuration(self, monkeypatch):
        monkeypatch.setenv("MAREX_VERBOSE", "1")
        marEx.configure_logging()
        assert marEx.is_verbose_mode()
        monkeypatch.delenv("MAREX_VERBOSE")
        marEx.configure_logging()

    def test_log_timing(self, caplog):
        logger = marEx.get_logger("test")
        from marex_tpu.logging_config import log_timing

        root = logging.getLogger("marex_tpu")
        old_prop = root.propagate
        root.propagate = True  # let caplog's root handler see the records
        try:
            with caplog.at_level(logging.INFO, logger="marex_tpu.test"):
                with log_timing(logger, "unit-test stage"):
                    pass
        finally:
            root.propagate = old_prop
        assert any("unit-test stage" in r.message for r in caplog.records)

    def test_log_file(self, tmp_path):
        logf = tmp_path / "marex.log"
        marEx.configure_logging(log_file=str(logf))
        marEx.get_logger("filetest").warning("to-file message")
        marEx.configure_logging()  # reset handlers
        assert logf.exists()
        assert "to-file message" in logf.read_text()


class TestDependencies:
    def test_has_dependency(self):
        assert marEx.has_dependency("scipy")
        assert not marEx.has_dependency("nonexistent_package_xyz")

    def test_status_and_profile(self):
        status = marEx.get_dependency_status()
        assert isinstance(status, dict) and "matplotlib" in status
        profile = marEx.get_installation_profile()
        assert profile in ("minimal", "performance", "io", "plotting", "full")

    def test_require_dependencies_raises(self):
        from marex_tpu._dependencies import require_dependencies

        with pytest.raises(marEx.DependencyError):
            require_dependencies(["nonexistent_package_xyz"], "testing")


class TestField:
    def _field(self):
        times = pd.date_range("2000-01-01", periods=5, freq="D").to_numpy()
        return Field(
            np.arange(5 * 3 * 4, dtype=np.float32).reshape(5, 3, 4),
            ("time", "lat", "lon"),
            coords={"time": times, "lat": [0.0, 1.0, 2.0], "lon": [10.0, 20.0, 30.0, 40.0]},
            name="v",
        )

    def test_sizes_and_isel(self):
        f = self._field()
        assert f.sizes == {"time": 5, "lat": 3, "lon": 4}
        g = f.isel(time=0)
        assert g.dims == ("lat", "lon")
        h = f.isel(time=slice(1, 3), lon=[0, 2])
        assert h.shape == (2, 3, 2)
        assert "time" in h.coords and len(h.coords["time"].values) == 2

    def test_conflicting_coord_length_raises(self):
        # A pure-broadcast construction can silently collapse an axis to 1;
        # the constructor must reject index coords that disagree with the
        # data's dimension size (xarray parity).
        from marex_tpu.exceptions import DataValidationError

        data = np.zeros((5, 3, 1), dtype=np.float32)  # lon collapsed
        with pytest.raises(DataValidationError, match="conflicting sizes"):
            Field(
                data,
                ("time", "lat", "lon"),
                coords={"lat": [0.0, 1.0, 2.0], "lon": [10.0, 20.0, 30.0, 40.0]},
            )
        # explicit Coord / tuple forms are validated too
        with pytest.raises(DataValidationError, match="conflicting sizes"):
            Field(data, ("time", "lat", "lon"), coords={"lon": (("lon",), np.arange(4.0))})
        # coords over dims the field doesn't carry stay allowed
        Field(data, ("time", "lat", "lon"), coords={"aux": (("other",), np.arange(7.0))})

    def test_sel(self):
        f = self._field()
        g = f.sel(lat=1.0)
        assert g.dims == ("time", "lon")
        h = f.sel(lon=slice(15, 35))
        assert h.sizes["lon"] == 2

    def test_arithmetic_broadcasting(self):
        f = self._field()
        m = f.isel(time=0)
        diff = f - m
        assert diff.dims == ("time", "lat", "lon")
        np.testing.assert_allclose(diff.values[0], 0)
        assert (f * 2).values[0, 0, 0] == 0

    def test_reductions(self):
        f = self._field()
        assert f.mean().values.shape == ()
        s = f.sum(dim="time")
        assert s.dims == ("lat", "lon")
        q = f.quantile(0.5, dim="time")
        assert q.dims == ("lat", "lon")

    def test_dt_accessor(self):
        f = self._field()
        tc = Field(f.coords["time"].values, ("time",))
        assert tc.dt.dayofyear.values[0] == 1
        assert tc.dt.year.values[0] == 2000

    def test_where_and_isin(self):
        f = self._field()
        w = f.where(f > 10)
        assert np.isnan(w.values[0, 0, 0])
        i = f.isin([0, 1, 2])
        assert i.values.sum() == 3

    def test_transpose_shift_pad(self):
        f = self._field()
        t = f.transpose("lon", "time", "lat")
        assert t.dims == ("lon", "time", "lat")
        sh = f.shift({"time": 1}, fill_value=-1.0)
        assert (sh.values[0] == -1).all()

    def test_concat_and_broadcast(self):
        f = self._field()
        a, b = broadcast(f.isel(time=0), f)
        assert a.dims == b.dims
        c = concat([f.isel(time=0), f.isel(time=1)], dim="time")
        assert c.sizes["time"] == 2

    def test_fieldset_access(self):
        f = self._field()
        ds = FieldSet({"v": f}, attrs={"k": 1})
        assert ds.v.dims == ("time", "lat", "lon")
        assert "v" in ds
        assert ds.attrs["k"] == 1
        sub = ds.isel(time=0)
        assert sub.v.dims == ("lat", "lon")

    def test_compat_shims(self):
        f = self._field()
        assert f.persist() is f
        assert f.chunk({"time": 2}) is f
        assert f.compute().values.shape == f.shape


class TestZarrLite:
    def test_roundtrip_fieldset(self, tmp_path):
        times = pd.date_range("2010-01-01", periods=4, freq="D").to_numpy()
        ds = FieldSet(
            {
                "temp": Field(
                    np.random.default_rng(0).random((4, 3, 5)).astype(np.float32),
                    ("time", "lat", "lon"),
                    coords={"time": times, "lat": [1.0, 2.0, 3.0], "lon": np.arange(5.0)},
                ),
                "flag": Field(np.ones((4, 3, 5), dtype=bool), ("time", "lat", "lon")),
            },
            attrs={"source": "test"},
        )
        path = str(tmp_path / "store.zarr")
        to_zarr(ds, path)
        back = open_zarr(path)
        assert back.attrs["source"] == "test"
        np.testing.assert_allclose(back["temp"].values, ds["temp"].values)
        assert back["flag"].dtype == bool
        assert list(back["temp"].dims) == ["time", "lat", "lon"]
        # datetime coordinate survives the round trip
        np.testing.assert_array_equal(
            back.coords["time"].values.astype("datetime64[ns]"), times.astype("datetime64[ns]")
        )

    def test_multi_chunk_arrays(self, tmp_path):
        # force multiple chunks by writing a large-ish first axis
        import marex_tpu.io.zarr_lite as zl

        old = zl._DEFAULT_CHUNK_BYTES
        zl._DEFAULT_CHUNK_BYTES = 1024
        try:
            arr = np.arange(300 * 7, dtype=np.float64).reshape(300, 7)
            ds = FieldSet({"x": Field(arr, ("a", "b"))})
            path = str(tmp_path / "chunked.zarr")
            to_zarr(ds, path)
            back = open_zarr(path)
            np.testing.assert_array_equal(back["x"].values, arr)
        finally:
            zl._DEFAULT_CHUNK_BYTES = old

    def test_checkpoint_helper(self, tmp_path):
        from marex_tpu.helper import checkpoint_to_zarr

        f = Field(np.arange(12.0).reshape(3, 4).astype(np.float32), ("time", "x"), name="anoms")
        back = checkpoint_to_zarr(f, name="unit", temp_dir=str(tmp_path))
        np.testing.assert_allclose(back.values, f.values)


class TestHelper:
    def test_cluster_info(self):
        info = marEx.helper.get_cluster_info()
        assert info.n_devices >= 1
        assert info.backend in ("cpu", "gpu")

    def test_start_local_cluster(self):
        info = marEx.helper.start_local_cluster()
        assert info.n_devices >= 1

    def test_configure(self):
        cfg = marEx.configure_dask()
        assert isinstance(cfg, dict)

    def test_memory_summary(self):
        ms = marEx.helper.memory_summary()
        assert "host_rss_mb" in ms


class TestMesh:
    def test_make_mesh_and_shardings(self):
        import jax

        from marex_tpu.parallel import detect_sharding, make_mesh, pad_to_multiple, track_sharding

        n = len(jax.devices())
        mesh = make_mesh()
        assert mesh.shape["time"] * mesh.shape["space"] == n
        detect_sharding(mesh)
        track_sharding(mesh)

        x = np.ones((10, 3))
        padded, orig = pad_to_multiple(x, 0, 8)
        assert padded.shape[0] % 8 == 0 and orig == 10

    def test_sharded_execution(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from marex_tpu.parallel import make_mesh

        mesh = make_mesh()
        n = mesh.shape["time"] * mesh.shape["space"]
        x = np.arange(n * 4 * 6, dtype=np.float32).reshape(n * 4, 6)
        xs = jax.device_put(x, NamedSharding(mesh, P(("time", "space"), None)))
        y = jax.jit(lambda a: (a * 2).sum())(xs)
        assert float(y) == x.sum() * 2


class TestShardedDetect:
    def test_anomaly_program_sharded_matches_unsharded(self):
        """The fused anomaly program under a space-sharded mesh produces the
        same result as single-device execution (XLA inserts no collectives
        for the space-pointwise detect stage)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from marex_tpu.core.timeaxis import decompose_time
        from marex_tpu.ops import pipeline as pipe
        from marex_tpu.parallel import make_mesh

        rng = np.random.default_rng(0)
        times = pd.date_range("2001-01-01", periods=365 * 3, freq="D").to_numpy()
        T = len(times)
        S = 64  # divisible by 8 devices
        data = rng.standard_normal((T, S)).astype(np.float32)
        tinfo = decompose_time(times)

        args = (
            jnp.asarray(tinfo.year_index),
            jnp.asarray(tinfo.dayofyear - 1),
            jnp.ones((T,), bool),
            None,
            None,
            tinfo.n_years,
            "fixed_baseline",
            0,
            0,
            False,
        )
        ref = np.asarray(pipe.anomaly_program(jnp.asarray(data), *args))

        mesh = make_mesh()
        sharded = jax.device_put(data, NamedSharding(mesh, P(None, ("time", "space"))))
        got = np.asarray(pipe.anomaly_program(sharded, *args))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, equal_nan=True)

    def test_morphology_sharded_over_time(self):
        """Morphology under time sharding matches single-device results."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from marex_tpu.ops import morphology as morph
        from marex_tpu.parallel import make_mesh

        rng = np.random.default_rng(1)
        data = rng.random((16, 12, 24)) < 0.2
        mask = np.ones((12, 24), bool)
        ref = np.asarray(morph.binary_close_open_grid(jnp.asarray(data), 2, jnp.asarray(mask)))

        mesh = make_mesh()
        sharded = jax.device_put(data, NamedSharding(mesh, P(("time", "space"), None, None)))
        got = np.asarray(morph.binary_close_open_grid(sharded, 2, jnp.asarray(mask)))
        np.testing.assert_array_equal(got, ref)

    def test_temporal_closing_sharded_halo(self):
        """Temporal closing under time sharding (halo exchange) is exact."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from marex_tpu.ops import morphology as morph
        from marex_tpu.parallel import make_mesh

        rng = np.random.default_rng(2)
        data = rng.random((32, 4, 8)) < 0.4
        ref = np.asarray(morph.binary_close_time(jnp.asarray(data), 2))

        mesh = make_mesh()
        sharded = jax.device_put(data, NamedSharding(mesh, P(("time", "space"), None, None)))
        got = np.asarray(morph.binary_close_time(sharded, 2))
        np.testing.assert_array_equal(got, ref)


class TestPackageSurface:
    def test_lazy_attributes(self):
        import marex_tpu as m

        assert m.PlotConfig().cperc == [4, 96]
        assert callable(m.tracker) and callable(m.regional_tracker)
        assert callable(m.configure_dask) and callable(m.specify_grid)
        assert hasattr(m.io, "open_zarr") and hasattr(m.parallel, "make_mesh")

    def test_all_exports_resolve(self):
        import marex_tpu as m

        for name in m.__all__:
            assert getattr(m, name) is not None, name


class TestFailureTolerance:
    """Failure detection + elastic recovery (the device runtime's answer to Dask's
    worker-failure tolerance, reference helper.py:49-66)."""

    def test_device_health_check_ok(self):
        report = marEx.helper.check_device_health()
        assert report["ok"] is True
        assert len(report["devices"]) >= 1
        assert all(e["ok"] for e in report["devices"])

    def test_run_with_retries_recovers(self):
        from marex_tpu.exceptions import DeviceError

        calls = {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] == 1:
                raise DeviceError("transient")
            return x * 2

        assert marEx.helper.run_with_retries(flaky, 21, retries=2) == 42
        assert calls["n"] == 2

    def test_run_with_retries_exhausts(self):
        from marex_tpu.exceptions import DeviceError

        def always_fails():
            raise DeviceError("permanent")

        with pytest.raises(DeviceError, match="permanent"):
            marEx.helper.run_with_retries(always_fails, retries=1, health_check=False)

    def test_run_with_retries_ignores_foreign_errors(self):
        def boom():
            raise ValueError("not a device problem")

        with pytest.raises(ValueError):
            marEx.helper.run_with_retries(boom, retries=3)

    def test_on_retry_callback_sees_failure(self):
        from marex_tpu.exceptions import DeviceError

        seen = []

        def flaky():
            if not seen:
                raise DeviceError("first")
            return "ok"

        def on_retry(attempt, exc):
            seen.append((attempt, type(exc).__name__))

        assert marEx.helper.run_with_retries(flaky, retries=1, on_retry=on_retry, health_check=False) == "ok"
        assert seen == [(0, "DeviceError")]

    def test_checkpoint_auto_resumes(self, tmp_path):
        """First run computes and saves; a second tracker with the same
        configuration resumes from the checkpoint without recomputing."""
        T, NY, NX = 6, 12, 24
        data = np.zeros((T, NY, NX), bool)
        data[:, 4:8, 6:12] = True
        coords = {
            "time": pd.date_range("2021-01-01", periods=T, freq="D").to_numpy(),
            "lat": np.linspace(-30, 30, NY),
            "lon": np.linspace(0, 360, NX, endpoint=False),
        }
        da = Field(data, ("time", "lat", "lon"), coords=coords, name="extreme_events")
        mask = Field(np.ones((NY, NX), bool), ("lat", "lon"),
                     coords={"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
        kw = dict(R_fill=1, T_fill=0, area_filter_quartile=0.0, quiet=True,
                  temp_dir=str(tmp_path), checkpoint="auto")

        tr1 = marEx.tracker(da, mask, **kw)
        data1, stats1 = tr1.run_preprocess()
        bin_path, stats_path = tr1._checkpoint_paths()
        assert os.path.exists(bin_path) and os.path.exists(stats_path)

        tr2 = marEx.tracker(da, mask, **kw)
        tr2.fill_holes = None  # would crash if the compute path ran again
        data2, stats2 = tr2.run_preprocess()
        np.testing.assert_array_equal(np.asarray(data1), np.asarray(data2))
        assert stats1 == stats2

    def test_checkpoint_auto_distinct_configs_do_not_collide(self, tmp_path):
        T, NY, NX = 5, 10, 20
        data = np.zeros((T, NY, NX), bool)
        data[:, 3:7, 5:12] = True
        coords = {
            "time": pd.date_range("2021-01-01", periods=T, freq="D").to_numpy(),
            "lat": np.linspace(-30, 30, NY),
            "lon": np.linspace(0, 360, NX, endpoint=False),
        }
        da = Field(data, ("time", "lat", "lon"), coords=coords, name="extreme_events")
        mask = Field(np.ones((NY, NX), bool), ("lat", "lon"),
                     coords={"lat": coords["lat"], "lon": coords["lon"]}, name="mask")
        base = dict(T_fill=0, area_filter_quartile=0.0, quiet=True,
                    temp_dir=str(tmp_path), checkpoint="auto")
        p1 = marEx.tracker(da, mask, R_fill=0, **base)._checkpoint_paths()
        p2 = marEx.tracker(da, mask, R_fill=2, **base)._checkpoint_paths()
        assert p1 != p2
