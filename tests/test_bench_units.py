"""Unit tests for the benchmark harness's load-bearing pieces: the on-device
data generators (structure + determinism), the stamp schedule's merge-safety
invariants, and the headline-emission preference order. The bench is the
round's performance evidence, so its building blocks get the same coverage
as product code."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, ".")  # repo root (bench.py lives beside the package)
import bench  # noqa: E402


class TestStampTable:
    def test_pair_rows_unchainable_through_closing(self):
        """Adjacent pair rows must stay separated by more than the production
        closing can bridge (2*R_fill at the resolution-scaled R_fill), or the
        pairs chain into >MAX_PARENTS merge webs (observed round 5)."""
        for ny, nx in ((720, 1440), (360, 720), (180, 360), (48, 96)):
            T = 366
            import pandas as pd

            times = pd.date_range("2000-01-01", periods=T, freq="D")
            st = bench._stamp_table(T, ny, nx, times.dayofyear.to_numpy(), times.year.to_numpy())
            kw = bench._prod_track_kwargs(ny)
            # pair stamps occupy slots 1..; find distinct row centres
            pair_rows = np.unique(st[:, 1:, 0][st[:, 1:, 3] > 0])
            if len(pair_rows) < 2:
                continue
            rp = st[:, 1:, 2][st[:, 1:, 3] > 0].max()
            gaps = np.diff(np.sort(pair_rows)) - 2 * rp
            assert (gaps > 2 * kw["R_fill"]).all(), (ny, nx, gaps.min(), kw["R_fill"])

    def test_blob_and_pair_seasons_disjoint(self):
        import pandas as pd

        T = 366
        times = pd.date_range("2000-01-01", periods=T, freq="D")
        st = bench._stamp_table(T, 720, 1440, times.dayofyear.to_numpy(), times.year.to_numpy())
        blob_days = np.nonzero(st[:, 0, 3] > 0)[0]
        pair_days = np.nonzero((st[:, 1:, 3] > 0).any(axis=1))[0]
        # a T_fill=4 temporal closing must not bridge the two populations
        assert blob_days.max() + 4 < pair_days.min()


class TestDeviceGenerators:
    def test_grid_generator_structure(self):
        da = bench.make_data_device(2, 24, 48, seed=0)
        vals = np.asarray(da.values)
        assert vals.shape == (730, 24, 48)
        assert vals.dtype == np.float32
        # land block is NaN at every timestep
        ly0, ly1, lx0, lx1 = 24 // 4, 24 // 4 + 24 // 8, 48 // 8, 48 // 4
        assert np.isnan(vals[:, ly0:ly1, lx0:lx1]).all()
        ocean = np.isfinite(vals)
        assert ocean.any()
        # seasonal+base structure: warm at the equator row band
        eq = vals[:, 12, :]
        pole = vals[:, 0, :]
        assert np.nanmean(eq) > np.nanmean(pole) + 3

    def test_grid_generator_deterministic_per_seed(self):
        a = np.asarray(bench.make_data_device(2, 16, 32, seed=5).values)
        b = np.asarray(bench.make_data_device(2, 16, 32, seed=5).values)
        c = np.asarray(bench.make_data_device(2, 16, 32, seed=6).values)
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_grid_generator_stamps_visible(self):
        """The drifting blob season (days 60-140) must lift the field by ~amp
        somewhere — detect depends on these being real events."""
        da = bench.make_data_device(2, 32, 64, seed=1)
        vals = np.asarray(da.values)
        import pandas as pd

        doy = pd.DatetimeIndex(np.asarray(da.coords["time"].values)).dayofyear.to_numpy()
        in_season = (doy >= 60) & (doy <= 140)
        off_season = (doy > 280) | (doy < 50)
        assert np.nanmax(vals[in_season]) > np.nanmax(vals[off_season]) + 2.0

    def test_unstructured_generator_structure(self):
        da, nb, areas = bench.make_unstructured_device(1, 2048, seed=1)
        C = da.sizes["ncells"]
        vals = np.asarray(da.values)
        assert vals.shape[1] == C
        nbv = np.asarray(nb.values)
        assert nbv.shape[0] == 3
        assert nbv.min() >= 1 and nbv.max() <= C  # 1-based like ICON
        assert np.asarray(areas.values).shape == (C,)
        assert np.isfinite(vals).all()

    def test_unstructured_mesh_matches_host_builder(self):
        nb_d, lat_d, lon_d = bench._tri_mesh(2048)
        da, nbf, _ = bench.make_unstructured_device(1, 2048)
        np.testing.assert_array_equal(np.asarray(nbf.values), nb_d)
        np.testing.assert_allclose(np.asarray(da.coords["lat"].values), lat_d)


class TestEmitPreference:
    def _capture(self, detail, capsys):
        bench._emit(detail)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def test_merge_production_wins_headline(self, capsys):
        detail = {
            "configs": {
                "1_fixed_global_production": {"gpd_per_s": 100.0},
                "4_merge_production": {"gpd_per_s": 50.0},
            }
        }
        out = self._capture(detail, capsys)
        assert out["value"] == 50.0
        assert "merging" in out["metric"]

    def test_fallback_to_config1(self, capsys):
        gpd = 2.0e6
        detail = {"configs": {"1_fixed_global_production": {"gpd_per_s": gpd}}}
        out = self._capture(detail, capsys)
        assert out["value"] == gpd
        assert out["vs_baseline"] == pytest.approx(gpd / bench.BASELINE_THROUGHPUT, abs=2e-3)

    def test_error_emission_when_nothing_ran(self, capsys):
        detail = {"configs": {"1_fixed_global_production": {"error": "KaboomError: x"}}}
        out = self._capture(detail, capsys)
        assert out["value"] == 0.0
        assert "Kaboom" in out["metric"]



class TestSingleProcessDriver:
    def test_refuses_cpu_unless_pinned(self, monkeypatch):
        """Without a GPU the bench fails instead of falling back to CPU;
        JAX_PLATFORMS=cpu pinned explicitly selects the small CPU run."""
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        with pytest.raises(SystemExit, match="no GPU"):
            bench._worker_context()
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        ctx = bench._worker_context()
        assert ctx["detail"]["platform"] == "cpu"
        assert ctx["detail"]["device_count"] >= 1 and ctx["detail"]["device_kind"]
        assert (ctx["ny"], ctx["nx"]) == (90, 180)

    def test_failed_config_is_recorded_and_the_next_runs(self, monkeypatch):
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        ctx = bench._worker_context()

        def boom():
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")

        ctx["try"]("a", boom)
        ctx["try"]("b", lambda: {"gpd_per_s": 1.0})
        assert ctx["detail"]["configs"]["a"]["error"].startswith("RuntimeError: RESOURCE_EXHAUSTED")
        assert ctx["detail"]["configs"]["b"] == {"gpd_per_s": 1.0}

    def test_config_order_is_the_eight_configs(self):
        assert sorted(bench._CONFIG_ORDER) == [str(i) for i in range(1, 9)]


class TestCompileCache:
    def test_env_dir_left_to_jax(self, monkeypatch, tmp_path):
        import jax

        from marex_tpu.helper import enable_compile_cache

        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
        assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "env_cache")
        assert jax.config.jax_compilation_cache_dir == before  # nothing overridden
        assert not (tmp_path / ".jax_cache").exists()

    def test_fixed_dir_in_checkout(self, monkeypatch, tmp_path):
        import jax

        from marex_tpu.helper import enable_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            path = enable_compile_cache(str(tmp_path))
            assert path == str(tmp_path / ".jax_cache")
            assert os.path.isdir(path)
            assert jax.config.jax_compilation_cache_dir == path
            assert enable_compile_cache(str(tmp_path)) == path  # same path every call
        finally:
            jax.config.update("jax_compilation_cache_dir", before)
