"""
Calendar utilities and the dense (year, dayofyear) device layout.

The reference expresses every climatology as a flox groupby over
``time.dt.dayofyear`` (``marEx/detect.py:1659,2365``) and the shifting
baseline as a long-form expansion + 2-key groupby (``detect.py:1622-1669``).
On an accelerator the natural formulation is a *dense scatter* of the time axis into a
``(n_years, 366, space)`` tensor: every groupby-reduce becomes a masked mean
over one axis, the rolling climatology becomes a causal windowed mean over the
year axis, and day-of-year windows become wrapped gathers — all static-shape,
XLA-fusable ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class TimeIndexInfo:
    """Host-side calendar decomposition of a time coordinate."""

    times: np.ndarray  # original datetime64 values, shape (T,)
    year: np.ndarray  # calendar year per step, int32 (T,)
    dayofyear: np.ndarray  # 1..366 per step, int32 (T,)
    year_index: np.ndarray  # 0-based index into unique_years (T,)
    unique_years: np.ndarray  # sorted unique years (Y,)
    decimal_year: np.ndarray  # fractional year per step, float64 (T,)

    @property
    def n_years(self) -> int:
        return int(len(self.unique_years))

    @property
    def n_time(self) -> int:
        return int(len(self.times))


def daily_times(start: str, n: int) -> np.ndarray:
    """``n`` consecutive days from ``start`` as ``datetime64[ns]`` (the dtype
    xarray and pandas give a daily time coordinate)."""
    return (np.datetime64(start, "D") + np.arange(n)).astype("datetime64[ns]")


def decompose_time(times: np.ndarray) -> TimeIndexInfo:
    """
    Decompose a datetime64 time coordinate into calendar components.

    ``dayofyear`` is 1..365/366, leap-aware, as ``time.dt.dayofyear`` gives
    the reference's groupby keys. Sub-day times count towards their date.
    """
    days = np.asarray(times).astype("datetime64[D]")
    year_start = days.astype("datetime64[Y]")
    year = (year_start.astype(np.int64) + 1970).astype(np.int32)
    elapsed = (days - year_start.astype("datetime64[D]")).astype(np.int64)
    doy = (elapsed + 1).astype(np.int32)
    # Dense year axis (min..max inclusive) so that year-windowed operations are
    # windows over *year values*, exactly as the reference's target-year logic
    # (detect.py:1631), even when the series has gap years.
    unique_years = np.arange(year.min(), year.max() + 1, dtype=np.int32)
    year_index = (year - year.min()).astype(np.int32)

    # decimal year: year + elapsed_days / year_length (cf. detect.py:2031-2058)
    duration = ((year_start + 1).astype("datetime64[D]") - year_start.astype("datetime64[D]")).astype(np.int64)
    decimal_year = year.astype(np.float64) + elapsed / duration

    return TimeIndexInfo(
        times=np.asarray(times),
        year=year,
        dayofyear=doy,
        year_index=year_index,
        unique_years=unique_years,
        decimal_year=decimal_year,
    )


def scatter_to_year_doy(data, tinfo: TimeIndexInfo, fill=np.nan):
    """
    Scatter a (T, *spatial) array into a dense (Y, 366, *spatial) tensor.

    Each (year, dayofyear) cell receives at most one timestep for daily data;
    missing cells (e.g. day 366 in non-leap years, or series not spanning a
    full year) are ``fill``.  Runs on device via one scatter.
    """
    import jax.numpy as jnp

    data = jnp.asarray(data)
    spatial = data.shape[1:]
    out = jnp.full((tinfo.n_years, 366) + spatial, fill, dtype=data.dtype)
    yi = jnp.asarray(tinfo.year_index)
    di = jnp.asarray(tinfo.dayofyear - 1)
    return out.at[yi, di].set(data)


def gather_from_year_doy(ymd, tinfo: TimeIndexInfo):
    """Inverse of :func:`scatter_to_year_doy`: gather back to (T, *spatial)."""
    import jax.numpy as jnp

    yi = jnp.asarray(tinfo.year_index)
    di = jnp.asarray(tinfo.dayofyear - 1)
    return ymd[yi, di]


def doy_window_indices(window_days: int) -> np.ndarray:
    """
    Wrapped day-of-year window gather table: shape (366, window_days) of
    0-based doy indices, matching the reference's modular window construction
    (``detect.py:1929-1934``).
    """
    half = window_days // 2
    base = np.arange(366)[:, None]
    offsets = np.arange(-half, half + 1)[None, :]
    return ((base + offsets) % 366).astype(np.int32)


def add_decimal_year_coord(times: np.ndarray) -> np.ndarray:
    """Standalone decimal-year computation (API parity with add_decimal_year)."""
    return decompose_time(times).decimal_year


def infer_time_resolution_days(times: np.ndarray) -> float:
    """Median spacing of the time axis in days."""
    t = np.asarray(times).astype("datetime64[s]").astype("int64")
    if len(t) < 2:
        return 1.0
    return float(np.median(np.diff(t)) / 86400.0)
