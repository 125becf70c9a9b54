"""``chip_smoke.py`` off the card: it refuses to run without a GPU, and each
of its phases runs and passes its oracle at a tiny shape on the CPU
backend (the same code paths the card runs at production shape, minus the
timing). The float64 oracles themselves are checked against simple cases.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from marex_tpu import _native  # noqa: E402

TINY = cs.Shape(years=3, ny=24, nx=48, n_cols=256, window_days=60, unstr_cells=6000, unstr_slices=8,
                four_years=2)


def _run_script(args, cwd, env_extra):
    env = dict(os.environ, **env_extra)
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_refuses_cpu_backend(args):
    r = _run_script(args, REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "not 'gpu'" in r.stderr
    assert '"ok": true' not in r.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _run_script([], str(tmp_path), {"JAX_PLATFORMS": "cpu", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_same_up_to_relabel():
    a = np.array([0, 1, 1, 2, 0, 3])
    assert cs.same_up_to_relabel(a, np.array([0, 7, 7, 5, 0, 9]))
    assert not cs.same_up_to_relabel(a, np.array([0, 7, 7, 7, 0, 9]))  # merged
    assert not cs.same_up_to_relabel(a, np.array([0, 7, 8, 5, 0, 9]))  # split
    assert not cs.same_up_to_relabel(a, np.array([1, 7, 7, 5, 0, 9]))  # background


def test_global_threshold_oracle_matches_kernel():
    """The float64 replay of the approximate global percentile agrees with
    the device kernel on float32 anomalies."""
    from marex_tpu.ops import quantile as Q

    rng = np.random.default_rng(3)
    anom = rng.standard_normal((730, 40)).astype(np.float32)
    anom[:, 0] = np.nan
    edges = Q.make_bin_edges(cs.PRECISION, cs.MAX_ANOMALY)
    nb = len(edges) - 1
    bins = Q.digitize_anomalies(jax.numpy.asarray(anom), cs.PRECISION, nb)
    dev = np.asarray(Q.global_thresholds_approx(bins, 0.95, nb, jax.numpy.asarray(Q.make_bin_centers(edges))))
    dev = np.where(np.isnan(anom).any(axis=0), np.nan, np.maximum(dev, edges[3]))
    ref = cs.np_global_threshold(anom.astype(np.float64), 0.95)
    assert np.array_equal(np.isnan(dev), np.isnan(ref))
    assert np.nanmax(np.abs(dev - ref)) <= cs.PRECISION


def test_detrend_oracle_recovers_a_fitted_signal():
    from marex_tpu.core.timeaxis import daily_times, decompose_time

    dy = decompose_time(daily_times("2000-01-01", 1000)).decimal_year
    noise = np.random.default_rng(0).standard_normal((1000, 3)) * 0.1
    x = 20 + 0.5 * (dy - dy.mean())[:, None] + np.sin(2 * np.pi * dy)[:, None] + noise
    np.testing.assert_allclose(cs.np_detrend_harmonic(x, dy), noise - noise.mean(axis=0), atol=0.05)


@pytest.fixture(scope="module")
def detected():
    """Phase 1 at the tiny shape: its extremes feed the tracking phases."""
    state = {}
    cs.run_phase("1", cs.phase_detect_fixed, TINY, state)
    return state


def test_phase_detect_fixed(detected):
    assert int(np.asarray(detected["extremes"].data).sum()) > 0


def test_phase_detect_hobday():
    line = cs.run_phase("2", cs.phase_detect_hobday, TINY, {})
    assert "oracle ok" in line


def _require_native():
    if not _native.has_native():
        pytest.skip("host C++ labeller unavailable (no g++)")


def test_phase_track_nomerge(detected):
    _require_native()
    assert "bit-identical" in cs.run_phase("3", cs.phase_track_nomerge, TINY, dict(detected))


def test_phase_track_merge(detected):
    assert "scan march == per-step march" in cs.run_phase("4", cs.phase_track_merge, TINY, dict(detected))


def test_phase_unstructured():
    _require_native()
    assert "up to relabelling" in cs.run_phase("5", cs.phase_unstructured, TINY, {})


def test_phase_streamed(detected):
    assert "bit-identical" in cs.run_phase("6", cs.phase_streamed, TINY, dict(detected))


def test_busiest_window():
    assert cs._busiest_window(np.array([5, 50, 52, 53, 90]), 100, 10) == 44
    assert cs._busiest_window(np.zeros(0, int), 100, 10) == 0
    assert cs._busiest_window(np.array([3]), 5, 10) == 0  # window longer than the series


def test_phase_four_on_virtual_devices():
    """The --four phase on four of the test session's virtual CPU devices."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    line = cs.run_phase("four", cs.phase_four, TINY, {}, devices=jax.devices()[:4])
    assert "bit-identical to one device" in line


def test_last_line_contract(capsys, monkeypatch):
    """main() ends with exactly the JSON device record once every phase
    passed (phases stubbed, device check faked)."""
    dev = jax.devices()[0]
    monkeypatch.setattr(cs, "device_check", lambda n: [dev])
    monkeypatch.setattr(cs, "PHASES", [("x", lambda shape, state: "stub")])
    cs.main([])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2].startswith("phase x: wall ")
    assert json.loads(out[-1]) == {
        "ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": 1}
    }
