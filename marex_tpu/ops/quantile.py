"""
Quantile / threshold kernels (exact and histogram-approximate).

Device re-design of the reference's percentile machinery:

* exact global threshold          <- da.quantile            (detect.py:2887-2899)
* exact hobday (day-of-year)      <- per-chunk nanpercentile (detect.py:1921-1956)
* approx 1-D histogram quantile   <- xhistogram + CDF interp (detect.py:2737-2865)
* approx 2-D histogram quantile   <- flox 2-key count histogram + count-space
  (hobday)                           interpolation            (detect.py:2465-2734)

The asymmetric binning scheme (single ``[-inf, -precision)`` bucket + uniform
``precision`` bins up to ``max_anomaly``) and the *count-space* interpolation
semantics (cumulative counts, searchsorted-right, lower-bound clamp at
``bin_edges[3]``) are preserved exactly — they are the documented numerical
contract of the approximate method.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ----------------------------------------------------------------------------
# Binning
# ----------------------------------------------------------------------------


def make_bin_edges(precision: float = 0.01, max_anomaly: float = 5.0) -> np.ndarray:
    """Asymmetric bin edges: [-inf, -precision, 0, precision, ..., max_anomaly]."""
    return np.concatenate(
        [[-np.inf], np.arange(-precision, max_anomaly + precision, precision, dtype=np.float32)]
    ).astype(np.float32)


def make_bin_centers(bin_edges: np.ndarray) -> np.ndarray:
    """Bin centres with the negative bucket centred at 0 (detect.py:2607-2608)."""
    centers = (bin_edges[1:] + bin_edges[:-1]) / 2
    centers[0] = 0.0
    return centers.astype(np.float32)


@partial(jax.jit, static_argnames=("nbins", "compact"))
def digitize_anomalies(data: jax.Array, precision: float, nbins: int, compact: bool = False) -> jax.Array:
    """
    Device equivalent of ``np.digitize(data, bin_edges) - 1`` for the
    asymmetric edges above.  NaN and out-of-range-high values map to the
    sentinel bin ``nbins`` (excluded from histograms), matching the
    flox ``expected_groups`` behaviour (detect.py:2644).

    ``compact=True`` emits int16 (when the bin count fits): worthwhile ONLY
    where the bin array is resident ACROSS programs (the hobday path holds
    a (Y, 366, S) stack through the tile loop — int16 halves it). Inside
    one fused program the convert is a pure loss: XLA keeps the int32
    floor result AND its int16 copy live (+2.4 GB measured at production
    shape), so the in-program global path keeps int32.
    """
    k = jnp.floor((data + precision) / precision).astype(jnp.int32) + 1
    k = jnp.where(data < -precision, 0, k)
    k = jnp.where(jnp.isnan(data), nbins, k)
    k = jnp.clip(k, 0, nbins)
    if compact and nbins + 1 <= np.iinfo(np.int16).max:
        k = k.astype(jnp.int16)
    return k


# ----------------------------------------------------------------------------
# Histogram accumulation
# ----------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nbins",))
def histogram_doy_bins(bins_ymd: jax.Array, nbins: int) -> jax.Array:
    """
    2-key (day-of-year x bin) count histogram per spatial point.

    Parameters
    ----------
    bins_ymd : (Y, 366, S) int32 bin indices (sentinel ``nbins`` for invalid)

    Returns
    -------
    hist : (366, S, nbins) int32 counts

    One fused scatter-add replaces the reference's flox shuffle-reduce.
    """
    Y, D, S = bins_ymd.shape
    hist = jnp.zeros((D, S, nbins + 1), dtype=jnp.int32)
    doy_idx = jax.lax.broadcasted_iota(jnp.int32, (Y, D, S), 1)
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (Y, D, S), 2)
    hist = hist.at[doy_idx, s_idx, bins_ymd].add(1)
    return hist[..., :nbins]


@partial(jax.jit, static_argnames=("nbins",))
def histogram_bins_1d(bins_ts: jax.Array, nbins: int) -> jax.Array:
    """
    Per-point histogram over all time.

    bins_ts : (T, S) int32 bin indices (sentinel ``nbins`` excluded)
    returns : (S, nbins) int32
    """
    T, S = bins_ts.shape
    hist = jnp.zeros((S, nbins + 1), dtype=jnp.int32)
    s_idx = jax.lax.broadcasted_iota(jnp.int32, (T, S), 1)
    hist = hist.at[s_idx, bins_ts].add(1)
    return hist[..., :nbins]


@partial(jax.jit, static_argnames=("window",))
def rolling_doy_window_sum(hist: jax.Array, window: int) -> jax.Array:
    """
    Wrapped rolling sum over the day-of-year axis (axis 0), window centred —
    the windowed histogram of detect.py:2494-2500.
    """
    # NOTE: a shifted-add formulation (sum of jnp.roll terms) was measured
    # WORSE here: XLA materialises every rolled slice simultaneously
    # (window-many full-size buffers, 25 GB at production tiles) where the
    # cumsum chain holds only padded + csum + out. Keep the cumsum.
    pad = window // 2
    padded = jnp.concatenate([hist[-pad:], hist, hist[:pad]], axis=0)
    csum = jnp.cumsum(padded, axis=0)
    csum = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)
    D = hist.shape[0]
    i = jnp.arange(D)
    return csum[i + window] - csum[i]


@partial(jax.jit, static_argnames=("window", "axis", "wrap"))
def rolling_axis_sum(hist: jax.Array, window: int, axis: int, wrap: bool) -> jax.Array:
    """
    Centred rolling sum along ``axis``; circular when ``wrap`` else truncated
    windows at the edges (``min_periods=1`` semantics, detect.py:2659-2666).
    """
    hist = jnp.moveaxis(hist, axis, 0)
    n = hist.shape[0]
    half = window // 2
    # (shifted-add variant rejected — see rolling_doy_window_sum)
    if wrap:
        padded = jnp.concatenate([hist[-half:], hist, hist[:half]], axis=0)
        csum = jnp.concatenate([jnp.zeros_like(padded[:1]), jnp.cumsum(padded, axis=0)], axis=0)
        i = jnp.arange(n)
        out = csum[i + window] - csum[i]
    else:
        csum = jnp.concatenate([jnp.zeros_like(hist[:1]), jnp.cumsum(hist, axis=0)], axis=0)
        i = jnp.arange(n)
        lo = jnp.clip(i - half, 0, n)
        hi = jnp.clip(i + half + 1, 0, n)
        out = csum[hi] - csum[lo]
    return jnp.moveaxis(out, 0, axis)


# ----------------------------------------------------------------------------
# Count-space quantile interpolation (2-D hobday path)
# ----------------------------------------------------------------------------


@jax.jit
def histogram_quantile_counts(hist_windowed: jax.Array, q: float, bin_centers: jax.Array) -> jax.Array:
    """
    Count-space quantile from windowed histograms, vectorised over all
    leading axes.  Mirrors ``_rolling_histogram_quantile`` (detect.py:2508-2558):
    cumulative counts, position ``q * total``, searchsorted-right upper bin,
    linear interpolation between bin centres in count space.

    hist_windowed : (..., nbins) int32
    returns       : (...) float32 thresholds (NaN where total count is 0)
    """
    nbins = hist_windowed.shape[-1]
    cumsum = jnp.cumsum(hist_windowed.astype(jnp.int32), axis=-1)
    total = cumsum[..., -1]
    pos = q * total.astype(jnp.float32)

    # searchsorted(cumsum, pos, side="right") == count of entries <= pos
    idx_upper = jnp.sum((cumsum.astype(jnp.float32) <= pos[..., None]).astype(jnp.int32), axis=-1)
    idx_upper = jnp.clip(idx_upper, 0, nbins - 1)
    idx_lower = jnp.maximum(idx_upper - 1, 0)

    count_lower = jnp.take_along_axis(cumsum, idx_lower[..., None], axis=-1)[..., 0].astype(jnp.float32)
    count_upper = jnp.take_along_axis(cumsum, idx_upper[..., None], axis=-1)[..., 0].astype(jnp.float32)

    bin_lower = bin_centers[idx_lower]
    bin_upper = bin_centers[idx_upper]

    eps = 1e-10
    diff = count_upper - count_lower
    frac = jnp.where(diff > eps, (pos - count_lower) / jnp.where(diff > eps, diff, 1.0), 0.5)
    thr = bin_lower + frac * (bin_upper - bin_lower)

    thr = jnp.where(total > 0, thr, jnp.nan)
    thr = jnp.where((idx_upper == 0) & (total > 0), bin_centers[0], thr)
    return thr.astype(jnp.float32)


# ----------------------------------------------------------------------------
# CDF-space quantile interpolation (1-D global path)
# ----------------------------------------------------------------------------


@jax.jit
def histogram_quantile_cdf(hist: jax.Array, q: float, bin_centers: jax.Array) -> jax.Array:
    """
    CDF-space quantile with robust tail handling, vectorised — mirrors
    ``_compute_histogram_quantile_1d`` interpolation (detect.py:2777-2832).

    hist : (..., nbins) counts
    """
    nbins = hist.shape[-1]
    eps = 1e-10
    total = jnp.sum(hist, axis=-1, keepdims=True).astype(jnp.float32) + eps
    cdf = jnp.cumsum(hist, axis=-1).astype(jnp.float32) / total

    idx_upper = jnp.argmax(cdf >= (q - eps), axis=-1).astype(jnp.int32)
    idx_before = jnp.where(idx_upper - 1 > 0, idx_upper - 1, 0)
    cdf_target = jnp.take_along_axis(cdf, idx_before[..., None], axis=-1)[..., 0]
    idx_lower = jnp.argmax(cdf > cdf_target[..., None], axis=-1).astype(jnp.int32)

    idx_lower = jnp.clip(idx_lower, 0, nbins - 2)
    idx_upper = jnp.clip(idx_upper, 1, nbins - 1)

    cdf_lower = jnp.take_along_axis(cdf, idx_lower[..., None], axis=-1)[..., 0]
    cdf_upper = jnp.take_along_axis(cdf, idx_upper[..., None], axis=-1)[..., 0]
    bin_lower = bin_centers[idx_lower]
    bin_upper = bin_centers[idx_upper]

    denom = cdf_upper - cdf_lower
    exact_match = jnp.abs(cdf_lower - q) < eps
    zero_denom = jnp.abs(denom) <= eps

    frac = (q - cdf_lower) / jnp.where(jnp.abs(denom) > eps, denom, 1.0)
    thr = bin_lower + frac * (bin_upper - bin_lower)
    thr = jnp.where(exact_match, bin_lower, thr)
    thr = jnp.where(zero_denom & ~exact_match, (bin_lower + bin_upper) / 2, thr)
    return thr.astype(jnp.float32)


# ----------------------------------------------------------------------------
# Exact quantiles
# ----------------------------------------------------------------------------


@jax.jit
def exact_quantile_time(data: jax.Array, q: float) -> jax.Array:
    """Exact (linear-interpolated) nan-quantile along axis 0 (time)."""
    return jnp.nanquantile(data, q, axis=0).astype(jnp.float32)


@partial(jax.jit, static_argnames=("window_days", "doy_chunk"))
def hobday_thresholds_exact(data_ymd: jax.Array, q: float, window_days: int, doy_chunk: int = 6) -> jax.Array:
    """
    Exact day-of-year thresholds: for each doy, the nan-quantile over all
    samples whose day-of-year falls in the wrapped window (detect.py:1921-1956).

    data_ymd : (Y, 366, S)
    returns  : (366, S)

    Memory: the (Y, doy_chunk, W, S_tile) window gather is the peak
    intermediate; the space axis tiles under an outer lax.map when the full
    gather would exceed ~1 GB.
    """
    Y, D, S = data_ymd.shape
    half = window_days // 2
    W = 2 * half + 1
    offsets = jnp.arange(-half, half + 1)

    def block_for(data_tile, s_tile):
        def per_doy_block(d0: jax.Array) -> jax.Array:
            doys = (d0[:, None] + offsets[None, :]) % D  # (chunk, W)
            win = data_tile[:, doys, :]  # (Y, chunk, W, s_tile)
            win = jnp.moveaxis(win, 1, 0).reshape(doy_chunk, Y * W, s_tile)
            return jnp.nanquantile(win, q, axis=1).astype(jnp.float32)

        starts = jnp.arange(0, D, doy_chunk)
        blocks = jax.lax.map(lambda s: per_doy_block(s + jnp.arange(doy_chunk)), starts)
        return blocks.reshape(-1, s_tile)[:D]

    full_bytes = Y * doy_chunk * W * S * 4
    if full_bytes <= _HIST_TILE_BYTES:
        return block_for(data_ymd, S)

    tile_s = max(1, _HIST_TILE_BYTES // (Y * doy_chunk * W * 4))
    n_tiles = -(-S // tile_s)
    s_pad = n_tiles * tile_s
    padded = jnp.pad(data_ymd, ((0, 0), (0, 0), (0, s_pad - S)), constant_values=jnp.nan)
    starts = jnp.arange(n_tiles) * tile_s

    def per_tile(start):
        tile = jax.lax.dynamic_slice_in_dim(padded, start, tile_s, axis=2)
        return block_for(tile, tile_s)

    tiles = jax.lax.map(per_tile, starts)  # (n_tiles, D, tile_s)
    return jnp.moveaxis(tiles, 0, 1).reshape(D, s_pad)[:, :S]


# ----------------------------------------------------------------------------
# Orchestrators
# ----------------------------------------------------------------------------


# Device-memory budget for the (366, S_tile, nbins) histogram intermediate;
# above this the space axis is processed in spatial tiles under lax.map.
# ~2-3 copies of one tile are live inside the rolling-sum chain.
_HIST_TILE_BYTES = 1 << 29


def _hobday_tile(bins_tile: jax.Array, q, window_days, nbins, bin_centers, window_spatial, tile_grid, wrap_lon):
    """Thresholds for one spatial tile: histogram -> spatial pool -> doy
    window -> count-space quantile."""
    hist = histogram_doy_bins(bins_tile, nbins)  # (366, S_tile, nbins)
    if window_spatial is not None and window_spatial > 1:
        ty, nx = tile_grid
        hist = hist.reshape(366, ty, nx, nbins)
        hist = rolling_axis_sum(hist, window_spatial, axis=2, wrap=wrap_lon)
        hist = rolling_axis_sum(hist, window_spatial, axis=1, wrap=False)
        hist = hist.reshape(366, ty * nx, nbins)
    hist_w = rolling_doy_window_sum(hist, window_days)
    return histogram_quantile_counts(hist_w, q, bin_centers)


def hobday_thresholds_approx(
    bins_ymd: jax.Array,
    q: float,
    window_days: int,
    nbins: int,
    bin_centers: jax.Array,
    window_spatial: Optional[int] = None,
    grid_shape: Optional[Tuple[int, int]] = None,
    wrap_lon: bool = True,
) -> jax.Array:
    """
    Approximate hobday thresholds from pre-binned data.

    bins_ymd : (Y, 366, S) int32 bin indices (sentinel ``nbins`` = no sample)
    grid_shape : (ny, nx) when the flattened space axis is a regular grid and
        ``window_spatial`` smoothing is requested.

    Returns (366, S) float32 thresholds (land handling is done by the caller).

    Memory: the (366, S, nbins) histogram is the peak intermediate (the
    reference streams 16x16 Dask chunks for the same reason,
    detect.py:2617-2631); when it exceeds ~1 GB the computation tiles over
    latitude rows (or flat spans) under ``lax.map``, with halo rows carrying
    the spatial window across tile boundaries (sentinel-padded rows at the
    global edges reproduce the truncated-window edge semantics).
    """
    Y, D, S = bins_ymd.shape
    full_bytes = D * S * nbins * 4
    if full_bytes <= _HIST_TILE_BYTES:
        return _hobday_tile(bins_ymd, q, window_days, nbins, bin_centers, window_spatial, grid_shape, wrap_lon)

    if grid_shape is not None:
        ny, nx = grid_shape
        halo = (window_spatial // 2) if (window_spatial is not None and window_spatial > 1) else 0
        cell_bytes = D * nbins * 4
        # the ACTUAL tile buffer includes the halo band — budgeting only the
        # core rows under-counts 3x at production widths
        budget_cells = max(1, _HIST_TILE_BYTES // cell_bytes)
        tile_rows = budget_cells // nx - 2 * halo

        if tile_rows >= 1:
            # full-width row bands: in-tile lon rolling keeps native wrap
            # semantics, no lon halo duplication
            n_tiles = -(-ny // tile_rows)
            ny_pad = n_tiles * tile_rows

            b = bins_ymd.reshape(Y, D, ny, nx)
            # sentinel-pad: halo rows beyond the globe + rows up to the tile multiple
            b = jnp.pad(b, ((0, 0), (0, 0), (halo, halo + (ny_pad - ny)), (0, 0)), constant_values=nbins)

            starts = jnp.arange(n_tiles) * tile_rows

            def per_tile(start):
                tile = jax.lax.dynamic_slice_in_dim(b, start, tile_rows + 2 * halo, axis=2)
                tile = tile.reshape(Y, D, (tile_rows + 2 * halo) * nx)
                thr = _hobday_tile(
                    tile, q, window_days, nbins, bin_centers, window_spatial, (tile_rows + 2 * halo, nx), wrap_lon
                )
                thr = thr.reshape(D, tile_rows + 2 * halo, nx)
                return jax.lax.dynamic_slice_in_dim(thr, halo, tile_rows, axis=1)

            tiles = jax.lax.map(per_tile, starts)  # (n_tiles, D, tile_rows, nx)
            out = jnp.moveaxis(tiles, 0, 1).reshape(D, ny_pad, nx)[:, :ny]
            return out.reshape(D, ny * nx)

        # 2-D tiles: at production widths one full-width halo'd row band
        # already exceeds the budget (nx=1440: 5 rows = 5.3 GB), so tile
        # both axes. Halos are baked into a padded copy — wrapped columns
        # when the grid is periodic, sentinel otherwise — and the in-tile
        # rolling runs wrap=False on both axes (core cells always see their
        # full window via the halo; sentinel halo = zero counts = the
        # truncated-window edge semantics).
        side = max(1, int(budget_cells**0.5))
        tr = min(ny, max(1, side - 2 * halo))
        tc = min(nx, max(1, side - 2 * halo))
        nty = -(-ny // tr)
        ntx = -(-nx // tc)

        b = bins_ymd.reshape(Y, D, ny, nx)
        if wrap_lon and halo > 0:
            lon_l, lon_r = b[..., nx - halo:], b[..., :halo]
        else:
            lon_l = jnp.full(b.shape[:3] + (halo,), nbins, b.dtype)
            lon_r = lon_l
        lon_fill = jnp.full(b.shape[:3] + (ntx * tc - nx,), nbins, b.dtype)
        b = jnp.concatenate([lon_l, b, lon_r, lon_fill], axis=3)
        b = jnp.pad(b, ((0, 0), (0, 0), (halo, halo + (nty * tr - ny)), (0, 0)), constant_values=nbins)

        th, tw = tr + 2 * halo, tc + 2 * halo

        def per_tile2d(i):
            y0 = (i // ntx) * tr
            x0 = (i % ntx) * tc
            tile = jax.lax.dynamic_slice(b, (0, 0, y0, x0), (Y, D, th, tw))
            thr = _hobday_tile(
                tile.reshape(Y, D, th * tw), q, window_days, nbins, bin_centers,
                window_spatial, (th, tw), False,
            )
            return jax.lax.dynamic_slice(thr.reshape(D, th, tw), (0, halo, halo), (D, tr, tc))

        tiles = jax.lax.map(per_tile2d, jnp.arange(nty * ntx, dtype=jnp.int32))
        out = tiles.reshape(nty, ntx, D, tr, tc)
        out = jnp.transpose(out, (2, 0, 3, 1, 4)).reshape(D, nty * tr, ntx * tc)
        return out[:, :ny, :nx].reshape(D, ny * nx)

    # unstructured: flat tiles (no spatial window by construction)
    tile_s = max(1, _HIST_TILE_BYTES // (D * nbins * 4))
    n_tiles = -(-S // tile_s)
    s_pad = n_tiles * tile_s
    b = jnp.pad(bins_ymd, ((0, 0), (0, 0), (0, s_pad - S)), constant_values=nbins)
    starts = jnp.arange(n_tiles) * tile_s

    def per_flat_tile(start):
        tile = jax.lax.dynamic_slice_in_dim(b, start, tile_s, axis=2)
        return _hobday_tile(tile, q, window_days, nbins, bin_centers, None, None, wrap_lon)

    tiles = jax.lax.map(per_flat_tile, starts)  # (n_tiles, D, tile_s)
    return jnp.moveaxis(tiles, 0, 1).reshape(D, s_pad)[:, :S]


def global_thresholds_approx(
    bins_ts: jax.Array,
    q: float,
    nbins: int,
    bin_centers: jax.Array,
) -> jax.Array:
    """
    Approximate global-in-time thresholds: (T, *spatial) bins ->
    (*spatial,) thresholds (rank-polymorphic in the trailing dims, so
    gridded callers keep their natural layout).

    Numerically identical to
    ``histogram_quantile_cdf(histogram_bins_1d(bins), q, centers)`` but
    computed WITHOUT materialising the (S, nbins) histogram: the CDF is only
    ever needed at a handful of bin indices, so each lookup is one fused
    compare+reduce pass over (T, S) and the argmax searches become binary
    searches (2*ceil(log2 nbins) passes): ~22 bandwidth-bound passes in
    place of a full-field scatter-add.
    """
    eps = 1e-10
    valid = bins_ts < nbins  # sentinel = NaN / overflow, excluded from counts
    total = jnp.sum(valid, axis=0).astype(jnp.float32) + eps  # (S,)

    def cdf_at(k: jax.Array) -> jax.Array:
        """cdf[k] per cell — f32(count of bins <= k) / f32(total + eps).

        The probe is cast to the bins' OWN dtype: comparing int16 bins
        against an int32 probe promotes the whole (T, S) array, and XLA
        hoists that convert out of the binary-search loop — a materialised
        full-size int32 copy (4.5 GB at production shape, an observed OOM)."""
        c = jnp.sum(jnp.logical_and(valid, bins_ts <= k.astype(bins_ts.dtype)[None]), axis=0)
        return c.astype(jnp.float32) / total

    n_steps = max(1, int(np.ceil(np.log2(nbins))))

    def search_first(target: jax.Array, strict: bool) -> jax.Array:
        """Smallest k in [0, nbins-1] with cdf(k) > target (strict) or
        >= target; 0 when no k satisfies (argmax-over-all-False parity)."""
        lo = jnp.zeros_like(target, jnp.int32)
        hi = jnp.full_like(lo, nbins - 1)

        def body(_, state):
            lo, hi = state
            mid = (lo + hi) // 2
            c = cdf_at(mid)
            ok = (c > target) if strict else (c >= target)
            return jnp.where(ok, lo, mid + 1), jnp.where(ok, mid, hi)

        lo, hi = jax.lax.fori_loop(0, n_steps, body, (lo, hi))
        c_final = cdf_at(lo)
        found = (c_final > target) if strict else (c_final >= target)
        return jnp.where(found, lo, 0)

    q_target = jnp.broadcast_to(jnp.asarray(q, jnp.float32) - jnp.float32(eps), total.shape)
    idx_upper = search_first(q_target, strict=False)
    idx_before = jnp.where(idx_upper - 1 > 0, idx_upper - 1, 0)
    cdf_target = cdf_at(idx_before)
    idx_lower = search_first(cdf_target, strict=True)

    idx_lower = jnp.clip(idx_lower, 0, nbins - 2)
    idx_upper = jnp.clip(idx_upper, 1, nbins - 1)

    cdf_lower = cdf_at(idx_lower)
    cdf_upper = cdf_at(idx_upper)
    bin_lower = bin_centers[idx_lower]
    bin_upper = bin_centers[idx_upper]

    denom = cdf_upper - cdf_lower
    exact_match = jnp.abs(cdf_lower - q) < eps
    zero_denom = jnp.abs(denom) <= eps
    frac = (q - cdf_lower) / jnp.where(jnp.abs(denom) > eps, denom, 1.0)
    thr = bin_lower + frac * (bin_upper - bin_lower)
    thr = jnp.where(exact_match, bin_lower, thr)
    thr = jnp.where(zero_denom & ~exact_match, (bin_lower + bin_upper) / 2, thr)
    return thr.astype(jnp.float32)
