"""
Climatology kernels (device, jit-friendly).

Device re-design of the reference's flox-groupby climatology engines:

* fixed daily climatology      <- flox dayofyear nanmean  (detect.py:2365-2373)
* rolling (shifting-baseline)  <- long-form expansion + 2-key flox groupby
  climatology                     (detect.py:1511-1688)
* centered time smoothing      <- da.rolling(time=w).mean() (detect.py:1810)

All operate on the dense ``(Y, 366, S)`` year/day-of-year layout produced by
:func:`marex_tpu.core.scatter_to_year_doy`, replacing groupby-reduce shuffles
with masked means and causal prefix sums along the year axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _offset_by_mean(data: jax.Array, finite: jax.Array, axis: int):
    """``(where(finite, data - mean, 0), mean)`` with the nan-mean taken
    along ``axis``. The windowed means below difference running sums; on
    the raw field (SST ~ 30) a float32 running sum reaches ~3e4 over three
    years of days and its rounding costs ~1e-4 of absolute accuracy, while
    sums of deviations from the mean stay small enough to keep the windowed
    mean within a few 1e-7 relative of a float64 computation."""
    n = jnp.sum(finite, axis=axis, keepdims=True)
    mean = jnp.sum(jnp.where(finite, data, 0.0), axis=axis, keepdims=True) / jnp.maximum(n, 1)
    mean = jnp.where(n > 0, mean, 0.0)
    return jnp.where(finite, data - mean, 0.0), mean


def nanmean_over_years(ymd: jax.Array) -> jax.Array:
    """
    Fixed daily climatology: nanmean over the year axis.

    Parameters
    ----------
    ymd : (Y, 366, *spatial) array with NaN for missing (year, doy) cells.

    Returns
    -------
    (366, *spatial) climatology.
    """
    finite = jnp.isfinite(ymd)
    total = jnp.sum(jnp.where(finite, ymd, 0.0), axis=0)
    count = jnp.sum(finite, axis=0)
    return jnp.where(count > 0, total / count, jnp.nan)


@partial(jax.jit, static_argnames=("window_years",))
def rolling_climatology_ymd(ymd: jax.Array, window_years: int) -> jax.Array:
    """
    Shifting-baseline rolling climatology on the dense layout.

    For target year index ``y`` and day-of-year ``d``::

        clim[y, d] = nanmean(ymd[y-W : y, d])      (strictly previous W years)

    The first ``W`` year slots are NaN (insufficient history), matching the
    reference's valid-target rule (detect.py:1634).  Implemented as causal
    prefix sums over the year axis — O(Y) instead of the reference's O(Y*W)
    long-form expansion.

    Returns
    -------
    (Y, 366, *spatial) array of per-target-year climatologies.
    """
    finite = jnp.isfinite(ymd)
    vals, ref = _offset_by_mean(ymd, finite, 0)

    csum = jnp.cumsum(vals, axis=0)
    ccnt = jnp.cumsum(finite.astype(jnp.float32), axis=0)

    # windowed sums over years [y-W, y-1]:  S[y-1] - S[y-W-1]
    pad = jnp.zeros_like(csum[:1])
    csum = jnp.concatenate([pad, csum], axis=0)  # S[-1] = 0 prepended
    ccnt = jnp.concatenate([jnp.zeros_like(ccnt[:1]), ccnt], axis=0)

    Y = ymd.shape[0]
    idx_hi = jnp.arange(Y)  # exclusive upper = y  -> csum[y]
    idx_lo = jnp.maximum(idx_hi - window_years, 0)
    wsum = csum[idx_hi] - csum[idx_lo]
    wcnt = ccnt[idx_hi] - ccnt[idx_lo]

    clim = jnp.where(wcnt > 0, wsum / jnp.maximum(wcnt, 1.0) + ref, jnp.nan)
    # Targets with insufficient history (fewer than W previous years) -> NaN
    valid_target = (jnp.arange(Y) >= window_years).reshape((Y,) + (1,) * (ymd.ndim - 1))
    return jnp.where(valid_target, clim, jnp.nan)


@partial(jax.jit, static_argnames=("window", "require_full"))
def centered_rolling_mean_time(data: jax.Array, window: int, require_full: bool = True) -> jax.Array:
    """
    Centered rolling mean along axis 0 (time), NaN-strict like
    ``DataArray.rolling(time=w, center=True).mean()`` with default
    ``min_periods`` (full window required; any NaN in the window -> NaN).

    For even windows the pandas/xarray label convention is used: the window
    for output index ``i`` covers ``[i - w//2, i + (w-1)//2]``.
    """
    T = data.shape[0]
    finite = jnp.isfinite(data)
    vals, ref = _offset_by_mean(data, finite, 0)

    csum = jnp.concatenate([jnp.zeros_like(vals[:1]), jnp.cumsum(vals, axis=0)], axis=0)
    ccnt = jnp.concatenate(
        [jnp.zeros_like(vals[:1]), jnp.cumsum(finite.astype(jnp.float32), axis=0)], axis=0
    )

    left = window // 2
    right = window - left - 1  # inclusive offset to the right
    i = jnp.arange(T)
    lo = i - left  # inclusive
    hi = i + right + 1  # exclusive
    valid = (lo >= 0) & (hi <= T)
    lo = jnp.clip(lo, 0, T)
    hi = jnp.clip(hi, 0, T)

    wsum = csum[hi] - csum[lo]
    wcnt = ccnt[hi] - ccnt[lo]

    shape = (T,) + (1,) * (data.ndim - 1)
    valid = valid.reshape(shape)
    if require_full:
        ok = valid & (wcnt == window)
    else:
        ok = valid & (wcnt > 0)
    return jnp.where(ok, wsum / jnp.maximum(wcnt, 1.0) + ref, jnp.nan)


def dayofyear_std(ymd: jax.Array, ddof: int = 0) -> jax.Array:
    """
    Per-day-of-year standard deviation over years (cf. flox ``func="std"`` at
    detect.py:2260-2268).

    Returns (366, *spatial).
    """
    finite = jnp.isfinite(ymd)
    n = jnp.sum(finite, axis=0)
    mean = jnp.where(n > 0, jnp.sum(jnp.where(finite, ymd, 0.0), axis=0) / jnp.maximum(n, 1), jnp.nan)
    dev2 = jnp.where(finite, (ymd - mean[None]) ** 2, 0.0)
    denom = jnp.maximum(n - ddof, 1)
    var = jnp.sum(dev2, axis=0) / denom
    return jnp.where(n > ddof, jnp.sqrt(var), jnp.nan)


@partial(jax.jit, static_argnames=("window", "pad"))
def wrapped_rolling_rms_doy(std_doy: jax.Array, window: int = 30, pad: int = 16) -> jax.Array:
    """
    30-day rolling RMS of the day-of-year STD with annual wrap padding,
    mirroring ``sqrt((std.pad(wrap)**2).rolling(30, center=True).mean())``
    (detect.py:2271-2272).

    std_doy : (366, *spatial)
    """
    sq = std_doy**2
    padded = jnp.concatenate([sq[-pad:], sq, sq[:pad]], axis=0)
    rolled = centered_rolling_mean_time(padded, window, require_full=True)
    out = rolled[pad : pad + std_doy.shape[0]]
    return jnp.sqrt(out)
