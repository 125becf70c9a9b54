"""
Fused end-to-end detect programs.

Each public detect path (anomaly method x extreme method x percentile
method) compiles into ONE XLA program over the staged ``(T, S)`` block +
calendar index vectors: a single dispatch, full cross-stage fusion, no
intermediate host round-trips. ``detect.py`` routes through these when the
configuration is covered, falling back to the composable per-op kernels
otherwise.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import climatology as _clim
from . import detrend as _detrend
from . import quantile as _quant


# cell budget per (Y, 366, sc) chunk of the space-tiled shifting-baseline
# program (see anomaly_program); 64M cells -> ~2 GB chunk working set
_SHIFT_CHUNK_CELLS = 64 * 1024 * 1024


def _scatter_ymd(data: jax.Array, year_idx: jax.Array, doy_idx: jax.Array, n_years: int) -> jax.Array:
    # The barrier works around an XLA:CPU miscompile: when the producer of
    # ``data`` (the centered rolling mean's cumsum/slice chain) fuses into
    # this NaN-initialised scatter, the compiled program returns ALL-NaN for
    # small spatial extents (observed at S=240 with T=12yr daily; correct at
    # S=800 and in eager mode). Forcing ``data`` to materialise first costs
    # nothing — the (T, S) smoothed block exists anyway — and restores
    # correctness on every backend.
    data = jax.lax.optimization_barrier(data)
    S = data.shape[1]
    out = jnp.full((n_years, 366, S), jnp.nan, dtype=data.dtype)
    return out.at[year_idx, doy_idx].set(data)


def _doy_nanmean_direct(
    data: jax.Array, doy_idx: jax.Array, clim_time_mask: jax.Array, time_block: int = 128
) -> jax.Array:
    """
    Per-day-of-year nanmean straight from the (T, *spatial) block via
    (366, *spatial) scatter-adds of sums and counts, accumulated over TIME
    BLOCKS so the masked-value temporary is (time_block, *spatial) instead
    of a full (T, *spatial) copy. Equivalent to the dense ``(Y, 366, S)``
    scatter + ``nanmean_over_years`` (each (doy, point) accumulates its
    <= Y samples either way); the peak intermediate drops from
    (T, S)+(Y, 366, S) to 2x(366, *spatial) + one block. Rank-polymorphic
    in the trailing dims so gridded data never pays a (T, S) relayout copy.
    """
    T = data.shape[0]
    sp = data.shape[1:]
    tb = min(time_block, T)
    k = T // tb

    def _acc(carry, db, doyb, mb):
        sums, cnts = carry
        valid = jnp.logical_and(mb.reshape((-1,) + (1,) * len(sp)), jnp.isfinite(db))
        sums = sums.at[doyb].add(jnp.where(valid, db, 0.0).astype(jnp.float32))
        cnts = cnts.at[doyb].add(valid.astype(jnp.float32))
        return sums, cnts

    def body(i, carry):
        db = jax.lax.dynamic_slice(data, (i * tb,) + (0,) * len(sp), (tb,) + sp)
        doyb = jax.lax.dynamic_slice(doy_idx, (i * tb,), (tb,))
        mb = jax.lax.dynamic_slice(clim_time_mask, (i * tb,), (tb,))
        return _acc(carry, db, doyb, mb)

    init = (jnp.zeros((366,) + sp, jnp.float32), jnp.zeros((366,) + sp, jnp.float32))
    sums, cnts = jax.lax.fori_loop(0, k, body, init)
    if T - k * tb:
        sums, cnts = _acc((sums, cnts), data[k * tb :], doy_idx[k * tb :], clim_time_mask[k * tb :])
    return jnp.where(cnts > 0, sums / cnts, jnp.nan)


_ANOM_STATIC = (
    "n_years",
    "method_anomaly",
    "window_year_baseline",
    "smooth_days_baseline",
    "force_zero_mean",
)


@partial(jax.jit, static_argnames=_ANOM_STATIC)
def anomaly_program(
    data: jax.Array,
    year_idx: jax.Array,
    doy_idx: jax.Array,
    clim_time_mask: jax.Array,
    model: Optional[jax.Array],
    pmodel: Optional[jax.Array],
    n_years: int,
    method_anomaly: str,
    window_year_baseline: int,
    smooth_days_baseline: int,
    force_zero_mean: bool,
) -> jax.Array:
    """
    Fused anomaly computation for all four methods.

    data : (T, S) float32 — or (T, *spatial). The fixed_baseline and
        detrend paths are rank-polymorphic and PRESERVE the input layout,
        so no (T, S) <-> (T, H, W) relayout copy (4.5 GB at 0.25-degree
        production scale) is ever made. Only shifting_baseline flattens
        (its (Y, 366, S) rolling-window scatter requires the flat layout).
    year_idx/doy_idx : (T,) int32 (doy 0-based)
    clim_time_mask : (T,) bool — timesteps contributing to the fixed
        climatology (reference_period support; all-True otherwise)
    model/pmodel : design matrices for the detrending methods (None else)

    Returns anomalies with the same shape as ``data`` except
    shifting_baseline, which returns (T, S).
    """
    if method_anomaly == "shifting_baseline":
        data = data.reshape(data.shape[0], -1)
        T, S = data.shape

        def _chunk(d):
            smoothed = _clim.centered_rolling_mean_time(d, smooth_days_baseline)
            ymd = _scatter_ymd(smoothed, year_idx, doy_idx, n_years)
            clim_y = _clim.rolling_climatology_ymd(ymd, window_year_baseline)
            return d - clim_y[year_idx, doy_idx]

        # every step is pointwise in space, so tile over columns when the
        # dense (Y, 366, S) intermediates get large: the rolling-climatology
        # program holds ~6 of them concurrently.
        # Budget: <=64M cells per (Y, 366, sc) chunk -> chunk working set
        # ~2 GB; accumulate into a preallocated output via in-place loop
        # carry (no stacked/concat copies). The final chunk's start is
        # clamped into bounds (overlapped columns rewrite identical values).
        sc = max(1, _SHIFT_CHUNK_CELLS // (366 * max(n_years, 1)))
        sc = min(S, ((sc + 127) // 128) * 128)
        if sc >= S:
            return _chunk(data)
        n_chunks = -(-S // sc)
        starts = jnp.minimum(jnp.arange(n_chunks, dtype=jnp.int32) * sc, S - sc)

        def body(i, acc):
            s0 = starts[i]
            res = _chunk(jax.lax.dynamic_slice(data, (0, s0), (T, sc)))
            return jax.lax.dynamic_update_slice(acc, res, (0, s0))

        return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros((T, S), data.dtype))

    if method_anomaly == "fixed_baseline":
        clim = _doy_nanmean_direct(data, doy_idx, clim_time_mask)
        return (data - clim[doy_idx]).astype(jnp.float32)

    if method_anomaly in ("detrend_harmonic", "detrend_fixed_baseline"):
        anom = _detrend.detrend_subtract(data, model, pmodel)
        if force_zero_mean:
            anom = _detrend.remove_time_mean(anom)
        if method_anomaly == "detrend_fixed_baseline":
            clim = _doy_nanmean_direct(anom, doy_idx, clim_time_mask)
            anom = (anom - clim[doy_idx]).astype(jnp.float32)
        return anom

    raise ValueError(method_anomaly)


# Input-donating variant: the anomaly output aliases the input buffer, so
# the raw block and the anomalies (4.5 GB EACH at 0.25-degree production
# shape) are never concurrently live. Used whenever the staged payload is
# private (host inputs) or the caller passed donate_input=True.
anomaly_program_donated = jax.jit(
    anomaly_program.__wrapped__, static_argnames=_ANOM_STATIC, donate_argnums=(0,)
)


@partial(
    jax.jit,
    static_argnames=("nbins", "n_years", "window_days", "window_spatial", "grid_shape", "wrap_lon", "exact"),
)
def hobday_program(
    anomalies: jax.Array,
    year_idx: jax.Array,
    doy_idx: jax.Array,
    q: float,
    precision: float,
    bin_centers: jax.Array,
    lower_bound: float,
    nbins: int,
    n_years: int,
    window_days: int,
    window_spatial: Optional[int],
    grid_shape: Optional[Tuple[int, int]],
    wrap_lon: bool,
    exact: bool,
) -> Tuple[jax.Array, jax.Array]:
    """
    Fused day-of-year threshold + comparison program.

    Returns (extremes (T, S) bool, thresholds (366, S) float32).
    Approximate path applies the land NaN-out and the lower-bound clamp
    inside the program (warnings are emitted by the caller from the result).
    ``anomalies`` may arrive as (T, *spatial); it is flattened in-program
    (fused — no standalone relayout buffer).
    """
    anomalies = anomalies.reshape(anomalies.shape[0], -1)
    ymd = _scatter_ymd(anomalies, year_idx, doy_idx, n_years)
    if exact:
        thr = _quant.hobday_thresholds_exact(ymd, q, window_days)
        pre_min = jnp.nanmin(thr)
        pre_max = jnp.nanmax(thr)
    else:
        bins = _quant.digitize_anomalies(ymd, precision, nbins, compact=True)
        thr = _quant.hobday_thresholds_approx(
            bins, q, window_days, nbins, bin_centers,
            window_spatial=window_spatial, grid_shape=grid_shape, wrap_lon=wrap_lon,
        )
        land = ~jnp.isfinite(anomalies[0])
        thr = jnp.where(land[None, :], jnp.nan, thr)
        pre_min = jnp.nanmin(thr)
        pre_max = jnp.nanmax(thr)
        thr = jnp.where(thr < lower_bound, lower_bound, thr)
    extremes = anomalies >= thr[doy_idx]
    return extremes, thr, pre_min, pre_max


@partial(jax.jit, static_argnames=("nbins", "exact"))
def global_extreme_program(
    anomalies: jax.Array,
    q: float,
    precision: float,
    bin_centers: jax.Array,
    lower_bound: float,
    nbins: int,
    exact: bool,
) -> Tuple[jax.Array, jax.Array]:
    """Fused global threshold + comparison. Returns (extremes, thresholds).
    Rank-polymorphic: ``anomalies`` may be (T, S) or (T, *spatial); the
    input layout is PRESERVED (extremes shaped like the input, thresholds
    shaped like one timestep) so gridded data never pays a (T, S) relayout
    copy."""
    if exact:
        thr = _quant.exact_quantile_time(anomalies, q)
        pre_min = jnp.nanmin(thr)
        pre_max = jnp.nanmax(thr)
    else:
        bins = _quant.digitize_anomalies(anomalies, precision, nbins)
        thr = _quant.global_thresholds_approx(bins, q, nbins, bin_centers)
        nan_any = jnp.isnan(anomalies).any(axis=0)
        thr = jnp.where(nan_any, jnp.nan, thr)
        pre_min = jnp.nanmin(thr)
        pre_max = jnp.nanmax(thr)
        thr = jnp.where(thr < lower_bound, lower_bound, thr)
    extremes = anomalies >= thr[None]
    return extremes, thr, pre_min, pre_max
