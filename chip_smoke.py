#!/usr/bin/env python3
"""
Smoke run of the marex_tpu detect -> track pipeline on one NVIDIA GPU, at
the reference's production shape: 0.25 deg global daily SST, 3 years x 720 x
1440 (1095 x 720 x 1440 ~ 1.14 G gridpoint-days, 4.5 GB of float32), with
the production tracking parameters (R_fill=12, T_fill=4, area >= 600 cells,
overlap 0.25; reference examples/batch_jobs/submit_track.sh:20-28).

    python chip_smoke.py           # phases 0-6 on one GPU
    python chip_smoke.py --four    # only the sharded phase, on four GPUs

Every phase goes through the public entry points (``preprocess_data`` ->
``tracker(...).run()`` / ``run_streamed``) on seeded synthetic data made on
the device (``bench.make_data_device`` / ``make_unstructured_device``), and
checks its result against an independent oracle:

  0  device: JAX backend must be "gpu"; card name and power limit
  1  detect fixed_baseline + global_extreme (approximate), full shape, vs a
     numpy float64 computation on sampled grid columns
  2  detect shifting_baseline + hobday_extreme (approximate, window 2 years
     as bench config 2 uses for 3 years, 5 x 5 spatial pooling), full
     width, same oracle on 8 x 8 patches; then detrend_harmonic on phase
     1's input vs a float64 lstsq fit
  3  no-merge tracking of phase 1's extremes on the device fixpoint and on
     the host C++ labeller: ID_field and N_* attrs bit-identical; one
     masked 3x3 min-pool iteration timed against its bytes
  4  merge tracking, full shape: merges happen; on the 140-day window with
     the most merges the scan march equals the per-step march
  5  unstructured merge tracking on the bench's 1,048,576-cell triangle
     mesh, 2 years: on the filtered field the tracker labels, device
     per-slice labels equal the host labeller's up to relabelling; both
     labellers timed on the whole field
  6  streamed merge tracking of 1 year x 720 x 1440 extremes (the year of
     phase 4 with the most merges) from a zarr-lite store: ID_field equals
     the in-memory run bit for bit

Tolerances (float32 device results against float64 numpy):
  * anomalies 1e-5 absolute: SST ~ 30 has a float32 spacing of 1.9e-6, and
    each anomaly is a handful of roundings of such values;
  * thresholds one histogram bin (precision 0.01): the oracle replays the
    approximate method's histogram quantile in float64 on the device's
    anomalies (checked above), so the only difference is a value within a
    float32 rounding of a bin edge landing in the neighbouring bin;
  * detrend_harmonic 1e-4 absolute: the float32 least-squares fit sums
    1095 products of values ~ 30; TF32 products (10-bit mantissa) would
    miss by ~1e-3.

Each phase prints one line before the result: its wall (cold, compile
included), the process's ``peak_bytes_in_use`` so far, and the oracle that
passed. A failed phase raises and the script exits non-zero. The last line
is the JSON device record. Cuts from the production job: 3 of its ~40 years
(phases 1-4), 1 year for the streamed phase, 2 years for the unstructured
phase. Widths are never cut.
The compile cache is ``JAX_COMPILATION_CACHE_DIR`` when set, else
``.jax_cache/`` in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

PRECISION = 0.01  # histogram bin width of the approximate percentile
MAX_ANOMALY = 5.0
ANOM_TOL = 1e-5
DETREND_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


class OracleMismatch(AssertionError):
    """A phase's result disagrees with its oracle."""


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise OracleMismatch(msg)


@dataclass(frozen=True)
class Shape:
    years: int = 3
    ny: int = 720
    nx: int = 1440
    n_cols: int = 4096  # sampled grid columns for the float64 oracles
    window_days: int = 140  # march oracle window, placed where merges are densest
    unstr_years: int = 2
    unstr_cells: int = 1_048_576
    unstr_slices: int = 16
    stream_years: int = 1
    four_years: int = 2


# ---------------------------------------------------------------------------
# float64 numpy oracles
# ---------------------------------------------------------------------------


def _np_bin_centers():
    edges = np.concatenate([[-np.inf], np.arange(-PRECISION, MAX_ANOMALY + PRECISION, PRECISION, dtype=np.float32)])
    edges = edges.astype(np.float32).astype(np.float64)
    centers = (edges[1:] + edges[:-1]) / 2
    centers[0] = 0.0
    return edges, np.float32(centers).astype(np.float64)


def _np_digitize(x: np.ndarray, nbins: int) -> np.ndarray:
    k = np.floor((x + PRECISION) / PRECISION).astype(np.int64) + 1
    k = np.where(x < -PRECISION, 0, k)
    k = np.where(np.isnan(x), nbins, k)
    return np.clip(k, 0, nbins)


def np_fixed_baseline(x: np.ndarray, doy: np.ndarray) -> np.ndarray:
    """(T, n) anomalies: x minus its day-of-year nan-mean."""
    out = np.empty_like(x)
    for d in np.unique(doy):
        sel = doy == d
        with np.errstate(invalid="ignore"):
            out[sel] = x[sel] - np.nanmean(x[sel], axis=0)
    return out


def np_shifting_baseline(x, year, doy, window_years: int, smooth_days: int):
    """(T', n) anomalies of the shifting baseline, trimmed to the years that
    have ``window_years`` years of history (reference detect.py:1511-1850)."""
    T = x.shape[0]
    left, right = smooth_days // 2, smooth_days - smooth_days // 2 - 1
    sm = np.full_like(x, np.nan)
    for i in range(left, T - right):
        sm[i] = x[i - left : i + right + 1].mean(axis=0)  # NaN-strict full window
    y0 = year.min()
    Y = int(year.max() - y0 + 1)
    ymd = np.full((Y, 366, x.shape[1]), np.nan)
    ymd[year - y0, doy - 1] = sm
    clim = np.full_like(ymd, np.nan)
    for y in range(window_years, Y):
        win = ymd[y - window_years : y]
        n = np.isfinite(win).sum(axis=0)
        s = np.where(np.isfinite(win), win, 0.0).sum(axis=0)
        clim[y] = np.where(n > 0, s / np.maximum(n, 1), np.nan)
    anom = x - clim[year - y0, doy - 1]
    return anom[year >= y0 + window_years]


def np_global_threshold(anom: np.ndarray, q: float) -> np.ndarray:
    """Per-column threshold of the approximate global method: histogram,
    CDF-space interpolation between bin centres (reference
    detect.py:2777-2832), land NaN, lower-bound clamp."""
    edges, centers = _np_bin_centers()
    nbins = len(edges) - 1
    eps = 1e-10
    out = np.empty(anom.shape[1])
    for j in range(anom.shape[1]):
        hist = np.bincount(_np_digitize(anom[:, j], nbins), minlength=nbins + 1)[:nbins]
        cdf = np.cumsum(hist) / (hist.sum() + eps)
        up = int(np.argmax(cdf >= q - eps))
        before = max(up - 1, 0)
        lo = int(np.argmax(cdf > cdf[before]))
        lo, up = min(max(lo, 0), nbins - 2), min(max(up, 1), nbins - 1)
        denom = cdf[up] - cdf[lo]
        if abs(cdf[lo] - q) < eps:
            thr = centers[lo]
        elif abs(denom) <= eps:
            thr = (centers[lo] + centers[up]) / 2
        else:
            thr = centers[lo] + (q - cdf[lo]) / denom * (centers[up] - centers[lo])
        out[j] = np.nan if np.isnan(anom[:, j]).any() else max(thr, edges[3])
    return out


def np_hobday_threshold(anom, year, doy, q: float, window_days: int, halo: int) -> np.ndarray:
    """(366, P, h, w) thresholds of the approximate hobday method at the
    core cells of P patches ``anom`` (T, P, h + 2 halo, w + 2 halo): per
    (doy, cell) histograms pooled over the wrapped day window of all years
    and the (2 halo + 1)^2 spatial window, count-space interpolation between
    bin centres (reference detect.py:2465-2734). Cells outside the grid are
    NaN in ``anom`` and count nothing."""
    edges, centers = _np_bin_centers()
    nbins = len(edges) - 1
    y0 = year.min()
    Y = int(year.max() - y0 + 1)
    T, P, hh, ww = anom.shape
    h, w = hh - 2 * halo, ww - 2 * halo
    half = window_days // 2
    out = np.empty((366, P, h, w))
    for p in range(P):
        bins = np.full((Y, 366, hh, ww), nbins, np.int64)
        bins[year - y0, doy - 1] = _np_digitize(anom[:, p], nbins)
        hist = np.zeros((366, h, w, nbins + 1), np.int64)
        d_idx = np.broadcast_to(np.arange(366)[None, :, None, None], (Y, 366, h, w))
        y_idx = np.broadcast_to(np.arange(h)[None, None, :, None], (Y, 366, h, w))
        x_idx = np.broadcast_to(np.arange(w)[None, None, None, :], (Y, 366, h, w))
        for dy in range(2 * halo + 1):
            for dx in range(2 * halo + 1):
                np.add.at(hist, (d_idx, y_idx, x_idx, bins[:, :, dy : dy + h, dx : dx + w]), 1)
        hist = hist[..., :nbins]
        padded = np.concatenate([hist[-half:], hist, hist[:half]])
        cs = np.concatenate([np.zeros_like(padded[:1]), np.cumsum(padded, axis=0)])
        cum = np.cumsum(cs[window_days:] - cs[:-window_days], axis=-1)  # (366, h, w, nbins)
        total = cum[..., -1]
        pos = q * total
        up = np.clip((cum <= pos[..., None]).sum(axis=-1), 0, nbins - 1)
        lo = np.maximum(up - 1, 0)
        c_lo = np.take_along_axis(cum, lo[..., None], axis=-1)[..., 0].astype(np.float64)
        c_up = np.take_along_axis(cum, up[..., None], axis=-1)[..., 0].astype(np.float64)
        diff = c_up - c_lo
        frac = np.where(diff > 1e-10, (pos - c_lo) / np.where(diff > 1e-10, diff, 1.0), 0.5)
        thr = centers[lo] + frac * (centers[up] - centers[lo])
        thr = np.where(total > 0, thr, np.nan)
        thr = np.where((up == 0) & (total > 0), centers[0], thr)
        thr = np.where(np.isnan(anom[0, p, halo : halo + h, halo : halo + w])[None], np.nan, thr)
        out[:, p] = np.where(thr < edges[3], edges[3], thr)
    return out


def np_detrend_harmonic(x: np.ndarray, decimal_year: np.ndarray) -> np.ndarray:
    """Linear trend + annual/semi-annual harmonics removed by a float64
    least-squares fit per column, then the time mean (reference
    detect.py:2143-2224)."""
    dy = decimal_year
    A = np.stack(
        [
            np.ones_like(dy),
            dy - dy.mean(),
            np.sin(2 * np.pi * dy),
            np.cos(2 * np.pi * dy),
            np.sin(4 * np.pi * dy),
            np.cos(4 * np.pi * dy),
        ],
        axis=1,
    )
    ok = np.isfinite(x).all(axis=0)
    out = np.full_like(x, np.nan)
    coef, *_ = np.linalg.lstsq(A, x[:, ok], rcond=None)
    res = x[:, ok] - A @ coef
    out[:, ok] = res - res.mean(axis=0)
    return out


def _max_abs_diff(a: np.ndarray, b: np.ndarray, what: str) -> float:
    check(np.array_equal(np.isnan(a), np.isnan(b)), f"{what}: NaN pattern differs from the oracle")
    d = np.abs(np.where(np.isnan(a), 0.0, a - np.where(np.isnan(b), 0.0, b)))
    return float(d.max()) if d.size else 0.0


def same_up_to_relabel(a: np.ndarray, b: np.ndarray) -> bool:
    """True when the integer label maps ``a`` and ``b`` (0 = background)
    partition the same cells into the same components."""
    if not np.array_equal(a > 0, b > 0):
        return False
    pa, pb = a[a > 0].astype(np.int64), b[b > 0].astype(np.int64)
    pairs = np.unique(np.stack([pa, pb]), axis=1)
    return len(np.unique(pairs[0])) == pairs.shape[1] == len(np.unique(pairs[1]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _sample_columns(ny: int, nx: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    flat = rng.choice(ny * nx, size=min(n, ny * nx), replace=False)
    return flat // nx, flat % nx


def _sample_patches(ny: int, nx: int, n_cols: int, size: int, halo: int, seed: int):
    """Row/column index grids of ``n_cols / size^2`` random size x size
    patches with a ``halo`` ring: rows (P, size + 2 halo) clipped into the
    grid plus their validity, columns wrapped in longitude."""
    rng = np.random.default_rng(seed)
    P = max(1, n_cols // (size * size))
    r0 = rng.integers(0, ny - size + 1, P)
    c0 = rng.integers(0, nx, P)
    off = np.arange(-halo, size + halo)
    rows = r0[:, None] + off[None, :]
    cols = (c0[:, None] + off[None, :]) % nx
    return np.clip(rows, 0, ny - 1), (rows >= 0) & (rows < ny), cols


def _columns(field, iy, ix) -> np.ndarray:
    """(T, n) float64 host copy of the sampled columns of a (T, H, W) field."""
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(field.data)[:, iy, ix], dtype=np.float64)


def _track_kwargs(ny: int, merging: bool) -> dict:
    import bench

    kw = dict(allow_merging=merging, **bench._prod_track_kwargs(ny))
    if merging:
        kw.update(nn_partitioning=True, overlap_threshold=0.25)
    return kw


def phase_detect_fixed(shape: Shape, state: dict) -> str:
    import bench
    import marex_tpu as marEx
    from marex_tpu.core.timeaxis import decompose_time

    sst = bench.make_data_device(shape.years, shape.ny, shape.nx, seed=0)
    iy, ix = _sample_columns(shape.ny, shape.nx, shape.n_cols, seed=11)
    x = _columns(sst, iy, ix)
    ds = marEx.preprocess_data(
        sst, method_anomaly="fixed_baseline", method_extreme="global_extreme",
        method_percentile="approximate", threshold_percentile=95, quiet=True, donate_input=True,
    )
    del sst
    tinfo = decompose_time(ds.coords["time"].values)
    dev_anom = _columns(ds["dat_anomaly"], iy, ix)
    d_anom = _max_abs_diff(dev_anom, np_fixed_baseline(x, tinfo.dayofyear), "anomaly")
    check(d_anom <= ANOM_TOL, f"fixed_baseline anomaly off by {d_anom:.3g} > {ANOM_TOL}")
    thr = np.asarray(ds["thresholds"].data)[iy, ix].astype(np.float64)
    d_thr = _max_abs_diff(thr, np_global_threshold(dev_anom, 0.95), "threshold")
    check(d_thr <= PRECISION + 1e-6, f"global threshold off by {d_thr:.3g} > one bin")
    n_ext = int(np.asarray(ds["extreme_events"].data.sum()))
    check(n_ext > 0, "no extremes detected")
    state["extremes"], state["mask"] = ds["extreme_events"], ds["mask"]
    return (
        f"{len(iy)} columns x {x.shape[0]} days: anomaly max |diff| {d_anom:.3g} <= {ANOM_TOL}, "
        f"threshold max |diff| {d_thr:.3g} <= {PRECISION}; {n_ext} extreme cells"
    )


def phase_detect_hobday(shape: Shape, state: dict) -> str:
    import bench
    import marex_tpu as marEx
    from marex_tpu.core.timeaxis import decompose_time

    wyb = min(5, max(shape.years - 1, 1))
    size, halo = 8, 2  # hobday pools a 5 x 5 spatial window on grids by default
    sst = bench.make_data_device(shape.years, shape.ny, shape.nx, seed=2)
    rows, row_ok, cols = _sample_patches(shape.ny, shape.nx, shape.n_cols, size, halo, seed=12)
    P, n = rows.shape
    iy, ix = np.broadcast_to(rows[:, :, None], (P, n, n)), np.broadcast_to(cols[:, None, :], (P, n, n))
    x = _columns(sst, iy, ix)  # (T, P, n, n)
    tin = decompose_time(sst.coords["time"].values)
    ds = marEx.preprocess_data(
        sst, method_anomaly="shifting_baseline", method_extreme="hobday_extreme",
        method_percentile="approximate", threshold_percentile=95, window_year_baseline=wyb,
        smooth_days_baseline=21, window_days_hobday=11, quiet=True, donate_input=True,
    )
    del sst
    ref = np_shifting_baseline(x.reshape(x.shape[0], -1), tin.year, tin.dayofyear, wyb, 21)
    ref = ref.reshape((-1,) + x.shape[1:])
    ref = np.where(np.broadcast_to(row_ok[None, :, :, None], ref.shape), ref, np.nan)
    core = (slice(None), slice(None), slice(halo, halo + size), slice(halo, halo + size))
    d_anom = _max_abs_diff(_columns(ds["dat_anomaly"], iy, ix)[core], ref[core], "anomaly")
    check(d_anom <= ANOM_TOL, f"shifting_baseline anomaly off by {d_anom:.3g} > {ANOM_TOL}")
    del ref
    tout = decompose_time(ds.coords["time"].values)
    dev_anom = _columns(ds["dat_anomaly"], iy, ix)
    dev_anom = np.where(np.broadcast_to(row_ok[None, :, :, None], dev_anom.shape), dev_anom, np.nan)
    thr = _columns(ds["thresholds"], iy, ix)[core]
    d_thr = _max_abs_diff(thr, np_hobday_threshold(dev_anom, tout.year, tout.dayofyear, 0.95, 11, halo), "threshold")
    check(d_thr <= PRECISION + 1e-6, f"hobday threshold off by {d_thr:.3g} > one bin")
    del ds

    # float32 products in the detrend fit (TF32 would miss by ~1e-3)
    iy, ix = _sample_columns(shape.ny, shape.nx, shape.n_cols, seed=13)
    sst = bench.make_data_device(shape.years, shape.ny, shape.nx, seed=0)
    x0 = _columns(sst, iy, ix)
    det = marEx.compute_normalised_anomaly(sst, method_anomaly="detrend_harmonic")
    t0 = decompose_time(det.coords["time"].values)
    d_det = _max_abs_diff(_columns(det["dat_anomaly"], iy, ix), np_detrend_harmonic(x0, t0.decimal_year), "detrend")
    check(d_det <= DETREND_TOL, f"detrend_harmonic off by {d_det:.3g} > {DETREND_TOL}")
    return (
        f"{P} patches of {size}x{size} = {P * size * size} columns: shifting anomaly max |diff| {d_anom:.3g} <= "
        f"{ANOM_TOL}, hobday threshold (5x5 pooled) max |diff| {d_thr:.3g} <= {PRECISION}; {len(iy)} columns: "
        f"detrend_harmonic max |diff| {d_det:.3g} <= {DETREND_TOL}"
    )


def _time_min_pool(extremes) -> str:
    """One masked 3x3 min-pool iteration of the CCL fixpoint on the largest
    block the fixpoint uses, against its bytes (int32 read, bool read,
    int32 write) at the card's HBM rate."""
    import jax
    import jax.numpy as jnp

    from marex_tpu.ops import label as _label

    _, H, W = extremes.shape
    tb = max(1, min(extremes.shape[0], _label._BLOCK_CELL_BUDGET // (H * W)))
    data = jnp.asarray(extremes[:tb])
    lab = jnp.where(data, jnp.arange(tb * H * W, dtype=jnp.int32).reshape(tb, H, W) % (H * W), _label._BIG)
    step = jax.jit(lambda lab, d: jnp.where(d, _label._min_pool_3x3(lab, True), _label._BIG))
    jax.block_until_ready(step(lab, data))
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        out = step(lab, data)
    jax.block_until_ready(out)
    t = (time.perf_counter() - t0) / n
    nbytes = tb * H * W * 9
    return (
        f"min-pool iteration on ({tb}, {H}, {W}) = {tb * H * W} cells: {t * 1e6:.1f} us, "
        f"{nbytes / t / 1e9:.1f} GB/s = {nbytes / t / HBM_BYTES_PER_S:.1%} of {HBM_BYTES_PER_S / 1e12} TB/s"
    )


def _run_tracker(ev, mask, kw, env: dict):
    import marex_tpu as marEx

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        tr = marEx.tracker(ev, mask, quiet=True, **kw)
        events = tr.run()
        ids = np.asarray(events["ID_field"].data)
        return ids, dict(events.attrs), time.perf_counter() - t0, dict(getattr(tr, "stage_walls", {}))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_track_nomerge(shape: Shape, state: dict) -> str:
    from marex_tpu import _native

    check(_native.has_native(), "the host C++ labeller did not build")
    ev, mask = state["extremes"], state["mask"]
    kw = _track_kwargs(shape.ny, merging=False)
    id_dev, at_dev, wall_dev_cold, _ = _run_tracker(ev, mask, kw, {"MAREX_HOST_CCL": "0", "MAREX_STAGE_TIMING": "1"})
    id_host, at_host, wall_host, st_host = _run_tracker(ev, mask, kw, {"MAREX_HOST_CCL": "1", "MAREX_STAGE_TIMING": "1"})
    check(np.array_equal(id_dev, id_host), "ID_field differs between the device fixpoint and the host labeller")
    del id_host
    keys = sorted(k for k in at_dev if k.startswith("N_") or k.startswith("area_threshold"))
    for k in keys:
        check(at_dev[k] == at_host[k], f"attr {k}: device {at_dev[k]} != host {at_host[k]}")
    check(at_dev["N_events_final"] > 0, "no events tracked")
    _, _, wall_dev, st_dev = _run_tracker(ev, mask, kw, {"MAREX_HOST_CCL": "0", "MAREX_STAGE_TIMING": "1"})
    cells = int(np.prod(ev.shape))
    fix = st_dev.get("filter/ccl_fixpoint", float("nan"))
    host = st_host.get("filter/host_ccl", float("nan"))
    down = st_host.get("filter/host_download", float("nan"))
    return (
        f"ID_field and {len(keys)} N_*/threshold attrs bit-identical, {at_dev['N_events_final']} events; "
        f"walls device {wall_dev_cold:.2f} s cold / {wall_dev:.2f} s warm, host {wall_host:.2f} s; "
        f"filter/ccl_fixpoint {fix:.3f} s = {fix / cells:.3g} s/cell, filter/host_ccl {host:.3f} s = "
        f"{host / cells:.3g} s/cell, filter/host_download {down:.3f} s; " + _time_min_pool(ev.data)
    )


def _busiest_window(merge_days: np.ndarray, T: int, n: int) -> int:
    """Start of the ``n``-day window of ``[0, T)`` holding the most merges."""
    starts = np.arange(max(T - n, 0) + 1)
    d = np.sort(merge_days)
    counts = np.searchsorted(d, starts + n) - np.searchsorted(d, starts)
    return int(starts[np.argmax(counts)])


def _merge_run(ev, mask, kw, scan: bool):
    import marex_tpu as marEx

    tr = marEx.tracker(ev, mask, quiet=True, **kw)
    tr.use_scan_march = scan
    events, merges = tr.run(return_merges=True)
    return events, merges, tr


def phase_track_merge(shape: Shape, state: dict) -> str:
    ev, mask = state["extremes"], state["mask"]
    kw = _track_kwargs(shape.ny, merging=True)
    t0 = time.perf_counter()
    events, merges, tr = _merge_run(ev, mask, kw, scan=True)
    wall = time.perf_counter() - t0
    n_ev, n_mg = int(events.attrs["N_events_final"]), int(events.attrs["total_merges"])
    check(n_ev > 0 and n_mg > 0, f"merge tracking found {n_ev} events and {n_mg} merges")
    times = np.asarray(ev.coords["time"].values)
    state["merge_days"] = np.searchsorted(times, np.asarray(merges["merge_time"].values))
    del events, merges

    a = _busiest_window(state["merge_days"], len(times), shape.window_days)
    win = ev.isel(time=slice(a, a + shape.window_days))
    e_scan, m_scan, _ = _merge_run(win, mask, kw, scan=True)
    e_step, m_step, _ = _merge_run(win, mask, kw, scan=False)
    check(
        np.array_equal(np.asarray(e_scan["ID_field"].data), np.asarray(e_step["ID_field"].data)),
        "scan march ID_field differs from the per-step march",
    )
    for k in ("N_events_final", "total_merges"):
        check(e_scan.attrs[k] == e_step.attrs[k], f"{k}: scan {e_scan.attrs[k]} != per-step {e_step.attrs[k]}")
    check(e_scan.attrs["total_merges"] > 0, f"the march oracle window (days {a}-{a + shape.window_days}) has no merges")
    for name in ("parent_IDs", "child_IDs", "merge_time", "n_parents"):
        if name in m_scan.data_vars:
            check(
                np.array_equal(np.asarray(m_scan[name].values), np.asarray(m_step[name].values)),
                f"merge ledger {name} differs",
            )
    walls = {k: round(v, 3) for k, v in getattr(tr, "stage_walls", {}).items()}
    return (
        f"{n_ev} events, {n_mg} merges in {wall:.2f} s (stage walls {walls}); days {a}-{a + shape.window_days}: "
        f"scan march == per-step march ({e_scan.attrs['N_events_final']} events, "
        f"{e_scan.attrs['total_merges']} merges)"
    )


def phase_unstructured(shape: Shape, state: dict) -> str:
    import jax
    import jax.numpy as jnp

    import bench
    import marex_tpu as marEx
    from marex_tpu import _native
    from marex_tpu.ops import label as _label

    check(_native.has_native(), "the host C++ labeller did not build")
    da, nb, areas = bench.make_unstructured_device(shape.unstr_years, shape.unstr_cells)
    ds = marEx.preprocess_data(
        da, dimensions={"time": "time", "x": "ncells"}, coordinates={"time": "time", "x": "lon", "y": "lat"},
        neighbours=nb, cell_areas=areas, method_anomaly="fixed_baseline", method_extreme="global_extreme",
        method_percentile="approximate", threshold_percentile=95, quiet=True, donate_input=True,
    )
    del da
    tmp = tempfile.mkdtemp(prefix="marex_smoke_")
    try:
        tr = marEx.tracker(
            ds["extreme_events"], ds["mask"], R_fill=2, T_fill=2, area_filter_quartile=0.5,
            allow_merging=True, nn_partitioning=True, overlap_threshold=0.25, unstructured_grid=True,
            dimensions={"x": "ncells"}, coordinates={"x": "lon", "y": "lat"}, coordinate_units="degrees",
            temp_dir=tmp, neighbours=ds["neighbours"], cell_areas=ds["cell_areas"], quiet=True,
        )
        events = tr.run()
        # the field the tracker labels: extremes after closing/opening and
        # the area filter (the raw extremes hold more objects per slice
        # than the host labeller's int16 ids can number at 1M cells)
        filtered, _ = tr.run_preprocess()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_ev, n_mg = int(events.attrs["N_events_final"]), int(events.attrs["total_merges"])
    check(n_ev > 0, "no unstructured events tracked")

    # per-slice CCL over the whole field: device fixpoint vs the host
    # union-find (cold call, then timed warm calls of each)
    T, C = (int(n) for n in ds["extreme_events"].shape)
    masked = jnp.logical_and(jnp.asarray(filtered), jnp.asarray(np.asarray(ds["mask"].values, bool))[None])
    del filtered
    nbs = jnp.asarray(tr.neighbours_sym)
    jax.block_until_ready(_label.label_slices_unstructured(masked, nbs))
    t0 = time.perf_counter()
    dev, _ = jax.block_until_ready(_label.label_slices_unstructured(masked, nbs))
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    bits = np.asarray(jnp.packbits(masked, axis=-1, bitorder="little"))
    t_down = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = _native.unstr_slice_ccl(bits, T, C, tr.neighbours_sym)
    t_host = time.perf_counter() - t0
    check(res is not None, "host labeller refused the field")
    busiest = np.sort(np.argsort(np.asarray(masked.sum(axis=1)))[-shape.unstr_slices :])
    dev, host = np.asarray(dev)[busiest], np.array(res[0][busiest], copy=True)
    n_obj = 0
    for t in range(dev.shape[0]):
        check(same_up_to_relabel(dev[t], host[t]), f"slice {busiest[t]}: device labels differ from the host labeller")
        n_obj += int(dev[t].max())
    check(n_obj > 0, "the compared slices hold no objects")
    cells = T * C
    return (
        f"{C} cells x {T} days: {n_ev} events, {n_mg} merges; {dev.shape[0]} slices ({n_obj} objects) equal the "
        f"host labeller up to relabelling; whole-field labelling device {t_dev:.3f} s = {t_dev / cells:.3g} s/cell, "
        f"host {t_host:.3f} s = {t_host / cells:.3g} s/cell (+ {t_down:.3f} s bit-packed download)"
    )


def phase_streamed(shape: Shape, state: dict) -> str:
    import jax.numpy as jnp

    import marex_tpu as marEx
    from marex_tpu.io import zarr_lite

    ev, mask = state["extremes"], state["mask"]
    n_days = int(shape.stream_years * 365)
    a = _busiest_window(state.get("merge_days", np.zeros(0, int)), ev.shape[0], n_days)
    sub = ev.isel(time=slice(a, a + n_days))
    T, H, W = sub.shape
    bits = np.asarray(jnp.packbits(jnp.asarray(sub.data).reshape(T, H * W), axis=-1, bitorder="little"))
    host = np.unpackbits(bits, axis=-1, count=H * W, bitorder="little").astype(bool).reshape(T, H, W)
    del bits
    ev_host = marEx.Field(host, sub.dims, dict(sub.coords), name="extreme_events")
    kw = _track_kwargs(shape.ny, merging=True)
    tmp = tempfile.mkdtemp(prefix="marex_smoke_")
    try:
        src, out = os.path.join(tmp, "src.zarr"), os.path.join(tmp, "out.zarr")
        zarr_lite.to_zarr(ev_host, src, chunks={"time": 64})
        lazy = zarr_lite.open_zarr(src, lazy=True)
        tr_s = marEx.tracker(lazy["extreme_events"], mask, quiet=True, **kw)
        ev_s = tr_s.run_streamed(out, memory_budget_mb=2048)
        ids_s = np.asarray(ev_s["ID_field"].values)
        n_blocks = int(tr_s.dispatch_counts.get("march_scan", 0))
        ev_m = marEx.tracker(ev_host, mask, quiet=True, **kw).run()
        ids_m = np.asarray(ev_m["ID_field"].data)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(np.array_equal(ids_s, ids_m), "streamed ID_field differs from the in-memory run")
    for k in ("N_events_final", "total_merges"):
        check(ev_s.attrs[k] == ev_m.attrs[k], f"{k}: streamed {ev_s.attrs[k]} != in-memory {ev_m.attrs[k]}")
    check(ev_m.attrs["total_merges"] > 0, "the streamed window has no merges")
    return (
        f"days {a}-{a + T}, {T} x {H} x {W} from zarr-lite ({n_blocks} march blocks): ID_field bit-identical to the in-memory "
        f"run, {ev_m.attrs['N_events_final']} events, {ev_m.attrs['total_merges']} merges"
    )


def phase_four(shape: Shape, state: dict, devices=None) -> str:
    """Detect + merge tracking over a ("time", "space") mesh of four devices
    against the same run on one device: identical ID_field, every device
    holding shards."""
    import jax
    import jax.numpy as jnp

    import bench
    import marex_tpu as marEx
    from marex_tpu.parallel import detect_sharding, make_mesh, shard_if_divisible, track_sharding

    devices = list(devices if devices is not None else jax.devices())
    check(len(devices) >= 4, f"--four needs 4 devices, JAX sees {len(devices)}")
    mesh = make_mesh(4, 1, devices=devices[:4])
    detect_kw = dict(
        method_anomaly="fixed_baseline", method_extreme="global_extreme",
        method_percentile="approximate", threshold_percentile=95, quiet=True,
    )
    kw = _track_kwargs(shape.ny, merging=True)
    n_days = (int(shape.four_years * 365.25) // 4) * 4  # time shards evenly over 4
    S = shape.ny * shape.nx
    check(S % 4 == 0, f"{S} grid cells do not shard over 4 devices")

    def detect_track(on_mesh: bool):
        sst = bench.make_data_device(shape.four_years, shape.ny, shape.nx, seed=0)
        if on_mesh:
            staged = shard_if_divisible(jnp.asarray(sst.data).reshape(sst.shape[0], S), detect_sharding(mesh))
            check(len(staged.sharding.device_set) == 4, "detect input not sharded over 4 devices")
            del staged
        ds = marEx.preprocess_data(sst, mesh=mesh if on_mesh else None, **detect_kw)
        del sst
        ev = ds["extreme_events"].isel(time=slice(0, n_days))
        mask = ds["mask"]
        del ds
        if on_mesh:
            placed = shard_if_divisible(jnp.asarray(ev.data), track_sharding(mesh))
            check(len(placed.sharding.device_set) == 4, "tracking input not sharded over 4 devices")
            del placed
        tr = marEx.tracker(ev, mask, quiet=True, mesh=mesh if on_mesh else None, **kw)
        events = tr.run()
        in_use = [(d.memory_stats() or {}).get("bytes_in_use") for d in devices[:4]]
        return np.asarray(events["ID_field"].data), dict(events.attrs), in_use

    t0 = time.perf_counter()
    ids4, at4, in_use = detect_track(True)
    w4 = time.perf_counter() - t0
    if all(b is not None for b in in_use):
        check(all(b > 0 for b in in_use), f"a device holds no bytes: {in_use}")
    t0 = time.perf_counter()
    ids1, at1, _ = detect_track(False)
    w1 = time.perf_counter() - t0
    check(np.array_equal(ids4, ids1), "sharded ID_field differs from the one-device run")
    check(at4["N_events_final"] == at1["N_events_final"], "event counts differ")
    check(at4["total_merges"] == at1["total_merges"], "merge counts differ")
    gib = ", ".join("n/a" if b is None else f"{b / 2**30:.2f} GiB" for b in in_use)
    return (
        f"{n_days} x {shape.ny} x {shape.nx} on a (4, 1) mesh: ID_field bit-identical to one device, "
        f"{at4['N_events_final']} events, {at4['total_merges']} merges; walls 4 devices {w4:.2f} s, "
        f"1 device {w1:.2f} s; bytes_in_use per device after tracking: {gib}"
    )


PHASES = [
    ("1 detect fixed+global", phase_detect_fixed),
    ("2 detect shifting+hobday", phase_detect_hobday),
    ("3 track no-merge", phase_track_nomerge),
    ("4 track merge", phase_track_merge),
    ("5 track unstructured", phase_unstructured),
    ("6 track streamed", phase_streamed),
]


def run_phase(name: str, fn, shape: Shape, state: dict, **kw) -> str:
    """Run one phase and print its line: cold wall, running device peak
    memory, oracle. Exceptions propagate (the script then exits non-zero)."""
    import jax

    t0 = time.perf_counter()
    oracle = fn(shape, state, **kw)
    wall = time.perf_counter() - t0
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in jax.local_devices()]
    peak = "n/a" if None in peaks else f"{max(peaks)} B ({max(peaks) / 2**30:.2f} GiB)"
    line = f"phase {name}: wall {wall:.2f} s, peak_bytes_in_use {peak}, oracle ok: {oracle}"
    print(line, flush=True)
    return line


def device_check(n_devices: int):
    """Phase 0: refuse anything but a GPU backend; print the card."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: JAX backend is {backend!r}, not 'gpu' (no usable NVIDIA GPU); nothing was run")
    devices = jax.devices()
    if len(devices) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    from marex_tpu import _native
    from marex_tpu.helper import enable_compile_cache

    cache = enable_compile_cache(REPO)
    print(f"phase 0 device: {devices[0].device_kind} x {len(devices)} ({backend})", flush=True)
    for line in smi.splitlines():
        print(line.strip(), flush=True)
    print(f"phase 0 host labeller loaded: {_native.get_lib() is not None}; compile cache: {cache}", flush=True)
    return devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true", help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import jax  # noqa: F401

        import bench  # noqa: F401
        import marex_tpu  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: cannot import JAX and the marex_tpu checkout beside this script ({e})")

    devices = device_check(4 if args.four else 1)
    shape = Shape()
    state: dict = {}
    if args.four:
        run_phase("4-GPU detect+track", phase_four, shape, state, devices=devices[:4])
    else:
        for name, fn in PHASES:
            run_phase(name, fn, shape, state)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}}))


if __name__ == "__main__":
    main()
