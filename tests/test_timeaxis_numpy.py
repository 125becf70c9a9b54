"""The calendar layer runs on numpy ``datetime64`` alone: ``decompose_time``,
the ``Field.dt`` accessor and zarr-lite's CF time decoding are checked
against pandas (the oracle they replace), and the package imports and runs
the standard detect -> track drive with pandas unimportable."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest

from marex_tpu import Field
from marex_tpu.core.timeaxis import daily_times, decompose_time
from marex_tpu.io.zarr_lite import _decode_cf_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pandas_decomposition(times):
    idx = pd.DatetimeIndex(times)
    start = pd.to_datetime(idx.year.astype(str) + "-01-01")
    nxt = pd.to_datetime((idx.year + 1).astype(str) + "-01-01")
    dec = idx.year.to_numpy() + (idx - start).days.to_numpy() / (nxt - start).days.to_numpy()
    return idx.year.to_numpy(), idx.dayofyear.to_numpy(), dec


CALENDARS = {
    "leap_years": pd.date_range("2003-12-25", "2005-01-05", freq="D").to_numpy(),
    "century_1900_2000": np.concatenate(
        [pd.date_range("1900-02-25", periods=10, freq="D"), pd.date_range("2000-02-25", periods=10, freq="D")]
    ).astype("datetime64[ns]"),
    "gap_years": np.concatenate(
        [pd.date_range("1990-01-01", periods=40, freq="D"), pd.date_range("1994-12-20", periods=30, freq="D")]
    ).astype("datetime64[ns]"),
    "single_year": pd.date_range("2021-01-01", "2021-12-31", freq="D").to_numpy(),
    "sub_day_pre_1970": pd.date_range("1969-12-30 06:00", periods=12, freq="9h").to_numpy(),
}


@pytest.mark.parametrize("name", sorted(CALENDARS))
def test_decompose_time_matches_pandas(name):
    times = CALENDARS[name]
    year, doy, dec = _pandas_decomposition(times)
    ti = decompose_time(times)
    np.testing.assert_array_equal(ti.year, year)
    np.testing.assert_array_equal(ti.dayofyear, doy)
    np.testing.assert_allclose(ti.decimal_year, dec, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ti.unique_years, np.arange(year.min(), year.max() + 1))
    np.testing.assert_array_equal(ti.year_index, year - year.min())


def test_daily_times_matches_date_range():
    got = daily_times("1999-12-30", 5)
    exp = pd.date_range("1999-12-30", periods=5, freq="D").to_numpy()
    assert got.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(got, exp.astype("datetime64[ns]"))


@pytest.mark.parametrize("field", ["year", "month", "day", "dayofyear"])
def test_dt_accessor_matches_pandas(field):
    times = np.concatenate([CALENDARS["leap_years"], CALENDARS["sub_day_pre_1970"]])
    tc = Field(times, ("time",), {"time": times}, name="time")
    got = getattr(tc.dt, field).values
    np.testing.assert_array_equal(got, getattr(pd.DatetimeIndex(times), field).to_numpy())


_PD_UNITS = {
    "nanoseconds": "ns", "microseconds": "us", "milliseconds": "ms",
    "seconds": "s", "minutes": "m", "hours": "h", "days": "D",
}


@pytest.mark.parametrize("unit", sorted(_PD_UNITS))
def test_decode_cf_time_matches_pandas(unit):
    rng = np.random.default_rng(len(unit))
    vals = np.concatenate([np.arange(-3, 9, dtype=np.float64), rng.uniform(-1e4, 1e4, 200), [0.5, np.nan]])
    for epoch in ("1970-01-01", "1850-1-1", "2000-01-01 00:00:00", "1900-01-01T06:30:00"):
        got = _decode_cf_time(vals, {"units": f"{unit} since {epoch}"})
        exp = (pd.Timestamp(epoch) + pd.to_timedelta(vals, unit=_PD_UNITS[unit])).to_numpy()
        assert got.dtype == np.dtype("datetime64[ns]")
        fin = np.isfinite(vals)
        np.testing.assert_array_equal(got[fin], exp[fin])
        assert np.isnat(got[~fin]).all()


def test_decode_cf_time_leaves_unknown_units_alone():
    vals = np.arange(3.0)
    assert _decode_cf_time(vals, {"units": "fortnights since 1970-01-01"}) is vals
    assert _decode_cf_time(vals, {"units": "days since the epoch"}) is vals
    assert _decode_cf_time(vals, {"units": "kelvin"}) is vals


def test_standard_drive_without_pandas():
    """Block pandas, import the package and run the detect -> track drive
    of the verify recipe at a tiny shape."""
    script = textwrap.dedent(
        """
        import sys
        sys.modules["pandas"] = None  # any `import pandas` now raises ImportError
        import numpy as np
        import marex_tpu as marEx
        from marex_tpu import Field
        from marex_tpu.core.timeaxis import daily_times
        rng = np.random.default_rng(0)
        T, H, W = 2 * 365, 16, 32
        sst = 15 + rng.standard_normal((T, H, W)).astype(np.float32)
        for k in range(1, T):
            sst[k] = 0.7 * sst[k - 1] + 0.4 * sst[k]
        coords = {"time": daily_times("2000-01-01", T), "lat": np.linspace(-60, 60, H),
                  "lon": np.linspace(0, 360, W, endpoint=False)}
        da = Field(sst, ("time", "lat", "lon"), coords, name="sst")
        ds = marEx.preprocess_data(da, method_anomaly="fixed_baseline", method_extreme="global_extreme", quiet=True)
        tr = marEx.tracker(ds.extreme_events, ds.mask, R_fill=2, T_fill=2, area_filter_quartile=0.5,
                           allow_merging=True, overlap_threshold=0.25, quiet=True)
        events, merges = tr.run(return_merges=True)
        assert "pandas" not in sys.modules or sys.modules["pandas"] is None
        print("N_EVENTS", events.attrs["N_events_final"])
        """
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    n = int(r.stdout.split("N_EVENTS")[-1].split()[0])
    assert n > 0
