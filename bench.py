"""
Benchmark harness for marex_tpu — the BASELINE.json configs at production
scale, run in order in ONE process on one GPU.

Headline metric: end-to-end detect+track wall-clock at the reference's
PRODUCTION resolution and tracking parameters (0.25 deg global: 720x1440,
R_fill=12, T_fill=4, area_filter_absolute=600 cells, overlap=0.25,
nn_partitioning — examples/batch jobs/submit_track.sh:20-28), reported as
gridpoint-days/sec/chip. The detail block carries per-config breakdowns
including per-stage (detect/track) walls, cold-start walls, merge counts,
march dispatch counts, and a modeled HBM-traffic rate:

  1. fixed_baseline + global_extreme, tracker(allow_merging=False),
     production morphology/filter params [headline when 4 is absent]
  2. shifting_baseline + hobday_extreme (production detect methods) at
     full bench resolution
  3. regional grid (open boundaries, area_filter_absolute)
  4. allow_merging=True split/merge with REAL merges (converging blob
     pairs) at production params [headline when it completes]
  5. unstructured mesh at ICON-like cell count (default 1M cells) with
     merging patches
  6. merge-dense stress: overhead factor + dispatch accounting
  7. streamed larger-than-memory detect (lat-tile streaming -> zarr)
  8. streamed larger-than-memory tracking (lazy zarr -> blockwise scan
     march -> region-written ID_field, bounded memory budget)

Prints ONE JSON line after every config (the last line is the result):
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

``detail`` names the device the run used (platform, device_kind, count).
Without a GPU the run fails, unless ``JAX_PLATFORMS=cpu`` is set explicitly
(the small CPU run of ``run_ci_tests.sh``, whose numbers are CPU numbers).
A config that fails is recorded with its error; no second process is
started. The compile cache is ``JAX_COMPILATION_CACHE_DIR`` when set, else
``.jax_cache/`` in the checkout.

``vs_baseline`` compares against the reference's implied production
throughput: the marEx batch jobs process ~0.25 deg global daily data with 128
Dask workers in 39 min (detect, examples/batch jobs/run_detect.py:29-33) plus
179 min (track, submit_track.sh:2-9) per ~40-year dataset ->
~40*365*1036800 / 13080 s ~= 1.16e6 gridpoint-days/s on 128 cores.

Size knobs:
  MAREX_BENCH_YEARS (3), MAREX_BENCH_NY (720), MAREX_BENCH_NX (1440),
  MAREX_BENCH_CELLS (1048576), MAREX_BENCH_CONFIGS (comma list, default all),
  MAREX_BENCH_WARM (1; 0 = one cold-inclusive timed run per config).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np

from marex_tpu.core.timeaxis import daily_times, decompose_time

# Implied reference throughput (gridpoint-days per second, 128-core Dask)
BASELINE_THROUGHPUT = 40 * 365 * 720 * 1440 / (39 * 60 + 179 * 60)

_silence = contextlib.redirect_stdout(io.StringIO())


def _calendar(n_years: int):
    """(times, dayofyear, year) of the bench's daily axis from 2000-01-01."""
    times = daily_times("2000-01-01", int(n_years * 365.25))
    ti = decompose_time(times)
    return times, ti.dayofyear, ti.year


def make_data(n_years: int, ny: int, nx: int, seed: int = 0, lat_range=(-89.5, 89.5), lon_range=(0.0, 360.0)):
    """Host synthetic SST with drifting warm blobs AND oscillating converging
    blob pairs (the pairs join and separate twice per season, so merge-mode
    tracking performs real split/merge work)."""
    from marex_tpu.core.field import Field

    rng = np.random.default_rng(seed)
    times, doy, years = _calendar(n_years)
    T = len(times)
    lat = np.linspace(lat_range[0], lat_range[1], ny)
    global_lon = lon_range == (0.0, 360.0)
    lon = np.linspace(lon_range[0], lon_range[1], nx, endpoint=not global_lon)

    # float32 end-to-end with in-place accumulation: the f64 broadcast
    # temporaries of the naive `base + seasonal + noise` are 9 GB EACH at
    # production shape
    seasonal = (
        3.0 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25) * np.cos(np.deg2rad(lat))[None, :, None]
    ).astype(np.float32)
    base = (15.0 + 10.0 * np.cos(np.deg2rad(lat))[None, :, None]).astype(np.float32)
    sst = rng.standard_normal((T, ny, nx)).astype(np.float32)  # becomes the output buffer
    for k in range(1, T):
        np.multiply(sst[k], 0.6, out=sst[k])
        sst[k] += 0.8 * sst[k - 1]
    sst += base
    sst += seasonal

    y0 = years.min()
    yrow = np.arange(ny)
    xcol = np.arange(nx)

    def _stamp(t: int, cy: int, cx: int, rad: int, amp: float) -> None:
        """Add a disk bump touching only the affected latitude band."""
        r0, r1 = max(cy - rad, 0), min(cy + rad + 1, ny)
        if r0 >= r1:
            return
        dxc = np.minimum(np.abs(xcol - cx), nx - np.abs(xcol - cx))
        blob = (yrow[r0:r1, None] - cy) ** 2 + dxc[None, :] ** 2 <= rad * rad
        sst[t, r0:r1][blob] += amp

    # (a) coherent drifting warm blobs (days 60-140): spatially coherent
    # events that survive the R_fill opening at any bench scale
    r = max(min(ny, nx) // 8, 12)
    for t in range(T):
        d = int(doy[t])
        if 60 <= d <= 140:
            yr = int(years[t] - y0)
            cy = ny // 2 + ((yr % 3) - 1) * (ny // 6)
            cx = (nx // 4 + yr * (nx // 5) + (d - 60)) % nx
            _stamp(t, cy, cx, r, 4.0)

    # (b) converging/separating blob pairs: n_pairs pairs oscillate with a
    # 40-day period (approach, join, separate), giving O(n_pairs) merge
    # events per cycle in merge-mode tracking. Blob radius sized to survive
    # the production R_fill=12 opening and the 600-cell area filter.
    rp = max(16, min(ny, nx) // 45)
    n_pairs = max(6, ny // 36)
    pair_centers = [
        (int(ny * (0.25 + 0.5 * i / max(n_pairs - 1, 1))), int((i * 997) % nx))
        for i in range(n_pairs)
    ]
    for t in range(T):
        d = int(doy[t])
        if 150 <= d <= 270:
            yr = int(years[t] - y0)
            phase = ((d - 150) % 40) / 40.0
            sep = int((1.0 - min(phase * 2, 1.0)) * 3 * rp) + rp
            for cy, cx0 in pair_centers:
                # per-year longitude offset: a fixed-center bump recurring at
                # the same (dayofyear, cell) EVERY year is absorbed exactly by
                # the fixed-baseline climatology (anomaly ~ noise, never
                # detected); shifting by year makes each cell's bump a 1-of-N
                # year event -> anomaly ~ +5*(N-1)/N >> the 95th percentile
                cx0y = (cx0 + yr * (nx // 3 + 7)) % nx
                for s in (-sep, sep):
                    _stamp(t, cy, (cx0y + s) % nx, rp, 5.0)

    # land block
    sst[:, ny // 4 : ny // 4 + ny // 8, nx // 8 : nx // 4] = np.nan
    return Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")


# ---------------------------------------------------------------------------
# On-device data generation.
#
# Configs 1-5 synthesize their input on the device (same recipe as
# make_data: AR(1) noise, seasonal cycle, drifting warm blobs,
# converging/separating pair stamps, land block), so building the 4.5 GB
# production block costs one compile and a pass over device memory instead
# of minutes of single-core host time plus the upload. Only the streaming
# configs (7/8), whose purpose is host<->device IO, move real bytes.
# ---------------------------------------------------------------------------

_GEN_FNS: dict = {}


def _stamp_table(T, ny, nx, doy, years) -> np.ndarray:
    """(T, S, 4) per-day disk-stamp parameters (cy, cx, radius, amplitude):
    slot 0 the drifting warm blob, slots 1.. the converging pair stamps —
    the schedule make_data paints on the host."""
    y0 = years.min()
    r = max(min(ny, nx) // 8, 12)
    rp = max(6, min(ny, nx) // 45)
    # vertical spacing: adjacent pair rows must stay unconnectable through
    # the production closing (gap > 2*R_fill + margin), or the pairs chain
    # into one giant component whose merges exceed the reference's
    # MAX_PARENTS=10 cap (observed: 11-parent TrackingError at smoke shapes)
    n_pairs = max(2, min(ny // 90, 12))
    pair_centers = [
        (int(ny * (0.15 + 0.7 * i / max(n_pairs - 1, 1))), int((i * 997) % nx))
        for i in range(n_pairs)
    ]
    S = 1 + 2 * n_pairs
    st = np.zeros((T, S, 4), np.float32)
    for t in range(T):
        d = int(doy[t])
        yr = int(years[t] - y0)
        if 60 <= d <= 140:
            cy = ny // 2 + ((yr % 3) - 1) * (ny // 6)
            cx = (nx // 4 + yr * (nx // 5) + (d - 60)) % nx
            st[t, 0] = (cy, cx, r, 4.0)
        if 150 <= d <= 270:
            phase = ((d - 150) % 40) / 40.0
            sep = int((1.0 - min(phase * 2, 1.0)) * 3 * rp) + rp
            for i, (cy, cx0) in enumerate(pair_centers):
                cx0y = (cx0 + yr * (nx // 3 + 7)) % nx
                st[t, 1 + 2 * i] = (cy, (cx0y - sep) % nx, rp, 5.0)
                st[t, 2 + 2 * i] = (cy, (cx0y + sep) % nx, rp, 5.0)
    return st


def _gen_grid_fn():
    """Jitted on-device grid SST generator (cached: configs sharing a shape
    share one compile)."""
    if "grid" in _GEN_FNS:
        return _GEN_FNS["grid"]
    from functools import partial

    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("ny", "nx", "wrap", "land"))
    def gen(key, st, seas_t, lat, ny, nx, wrap, land):
        coslat = jnp.cos(jnp.deg2rad(lat))  # (ny,)
        base = 15.0 + 10.0 * coslat
        yy = jnp.arange(ny, dtype=jnp.float32)
        xx = jnp.arange(nx, dtype=jnp.float32)
        k0, k1 = jax.random.split(key)
        prev0 = jax.random.normal(k0, (ny, nx), jnp.float32)  # stationary std ~ 1
        keys = jax.random.split(k1, st.shape[0])

        def step(prev, xs):
            kt, stt, seas = xs
            noise = jax.random.normal(kt, (ny, nx), jnp.float32)
            cur = 0.8 * prev + 0.6 * noise
            cy, cx, rr, amp = stt[:, 0], stt[:, 1], stt[:, 2], stt[:, 3]
            dy2 = (yy[None, :] - cy[:, None]) ** 2  # (S, ny)
            dxa = jnp.abs(xx[None, :] - cx[:, None])  # (S, nx)
            dx = jnp.minimum(dxa, nx - dxa) if wrap else dxa
            inside = dy2[:, :, None] + (dx**2)[:, None, :] <= (rr**2)[:, None, None]
            bump = jnp.sum(jnp.where(inside, amp[:, None, None], 0.0), axis=0)
            out = cur + base[:, None] + seas * coslat[:, None] + bump
            return cur, out

        _, sst = jax.lax.scan(step, prev0, (keys, st, seas_t))
        ly0, ly1, lx0, lx1 = land
        sst = sst.at[:, ly0:ly1, lx0:lx1].set(jnp.nan)
        return sst

    _GEN_FNS["grid"] = gen
    return gen


def make_data_device(n_years: int, ny: int, nx: int, seed: int = 0, lat_range=(-89.5, 89.5), lon_range=(0.0, 360.0)):
    """Device-resident synthetic SST block with make_data's structure (see
    the section comment above for why generation happens on the device)."""
    import jax
    import jax.numpy as jnp

    from marex_tpu.core.field import Field

    times, doy, years = _calendar(n_years)
    T = len(times)
    lat = np.linspace(lat_range[0], lat_range[1], ny)
    global_lon = lon_range == (0.0, 360.0)
    lon = np.linspace(lon_range[0], lon_range[1], nx, endpoint=not global_lon)
    st = _stamp_table(T, ny, nx, doy, years)
    seas_t = (3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25)).astype(np.float32)
    land = (ny // 4, ny // 4 + ny // 8, nx // 8, nx // 4)
    sst = _gen_grid_fn()(
        jax.random.PRNGKey(seed),
        jnp.asarray(st),
        jnp.asarray(seas_t),
        jnp.asarray(lat.astype(np.float32)),
        ny, nx, bool(global_lon), land,
    )
    sst.block_until_ready()
    return Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")


def _tri_mesh(n_cells: int):
    """Vectorised triangle-pair mesh at ICON-like cell counts: returns
    (nb (3, C) 1-based int32, lat_c (C,), lon_c (C,))."""
    gx = int(np.sqrt(n_cells / 2))
    gy = max(n_cells // (2 * gx), 2)
    C = 2 * gy * gx

    jj, ii = np.mgrid[0:gy, 0:gx]
    lo = 2 * (jj * gx + ii)
    up = lo + 1

    def tid(j, i, upper):
        return (2 * ((j % gy) * gx + (i % gx)) + upper).astype(np.int32)

    nb = np.empty((3, C), dtype=np.int32)
    nb[0].reshape(gy, 2 * gx)[:, 0::2] = up
    nb[1].reshape(-1)[lo.ravel()] = tid(jj, ii - 1, 1).ravel()
    nb[2].reshape(-1)[lo.ravel()] = tid(jj - 1, ii, 1).ravel()
    nb[0].reshape(-1)[up.ravel()] = lo.ravel()
    nb[1].reshape(-1)[up.ravel()] = tid(jj, ii + 1, 0).ravel()
    nb[2].reshape(-1)[up.ravel()] = tid(jj + 1, ii, 0).ravel()

    lat_g = np.linspace(-60, 60, gy)
    lon_g = np.linspace(0, 360, gx, endpoint=False)
    lat_c = np.empty(C, np.float64)
    lon_c = np.empty(C, np.float64)
    lat_c[lo.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() - 0.2
    lat_c[up.ravel()] = np.broadcast_to(lat_g[:, None], (gy, gx)).ravel() + 0.2
    lon_c[lo.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel()
    lon_c[up.ravel()] = np.broadcast_to(lon_g[None, :], (gy, gx)).ravel() + 0.2
    return nb + 1, lat_c, lon_c  # 1-based like ICON output


def _gen_unstr_fn():
    """Jitted on-device unstructured SST on a triangle mesh: AR(1) noise, a
    seasonal cycle, TWO warm patches per latitude band that converge and
    merge each season, and blinking distractor blobs with a log-spaced size
    spectrum (without one the quartile-0.5 area filter, strict ``>`` on
    unstructured grids as in reference marEx/track.py:1839,1848, would sit
    between half-patch and joined size and drop every pre-merge parent)."""
    if "unstr" in _GEN_FNS:
        return _GEN_FNS["unstr"]
    from functools import partial

    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("C",))
    def gen(key, patch_t, damp_t, lat_c, lon_c, d_lat, d_lon, d_rad, seas_t, C):
        coslat = jnp.cos(jnp.deg2rad(lat_c))
        # distractor cell masks are time-invariant: build once, then apply
        # each day's on/off amplitudes as a (40,) x (40, C) matvec
        dd = jnp.abs(lon_c[None, :] - d_lon[:, None])
        dd = jnp.minimum(dd, 360.0 - dd)
        dmask = (
            (jnp.abs(lat_c[None, :] - d_lat[:, None]) < d_rad[:, None]) & (dd < d_rad[:, None])
        ).astype(jnp.float32)
        k0, k1 = jax.random.split(key)
        prev0 = jax.random.normal(k0, (C,), jnp.float32)
        keys = jax.random.split(k1, patch_t.shape[0])

        def step(prev, xs):
            kt, pt, da_, seas = xs
            noise = jax.random.normal(kt, (C,), jnp.float32)
            cur = 0.8 * prev + 0.6 * noise
            dlon = jnp.abs(lon_c[None, :] - pt[:, 1:2])
            dlon = jnp.minimum(dlon, 360.0 - dlon)
            pmask = (jnp.abs(lat_c[None, :] - pt[:, 0:1]) < 12.0) & (dlon < 18.0)
            bump = jnp.sum(jnp.where(pmask, pt[:, 2:3], 0.0), axis=0)
            bump = bump + da_ @ dmask
            return cur, cur + 15.0 + seas * coslat + bump

        _, sst = jax.lax.scan(step, prev0, (keys, patch_t, damp_t, seas_t))
        return sst

    _GEN_FNS["unstr"] = gen
    return gen


def make_unstructured_device(n_years: int, n_cells: int, seed: int = 1):
    """Device-resident unstructured SST (see :func:`_gen_unstr_fn`); only
    the mesh table and cell coordinates move to the device (~12 MB at 1M
    cells vs the 2.9 GB SST block)."""
    import jax
    import jax.numpy as jnp

    from marex_tpu.core.field import Field

    nb, lat_c, lon_c = _tri_mesh(n_cells)
    C = nb.shape[1]
    times, doy, yrs = _calendar(n_years)
    T = len(times)
    yr0 = yrs.min()
    seas_t = (3.0 * np.cos(2 * np.pi * (doy - 30) / 365.25)).astype(np.float32)

    # (T, 4, 3) per-day patch params (lat0, clon, amp): two bands x two signs
    patch_t = np.zeros((T, 4, 3), np.float32)
    for t in range(T):
        d = int(doy[t])
        if 60 <= d <= 140:
            k = d - 60
            yr = int(yrs[t] - yr0)
            for band, (lat0, lon0) in enumerate([(15.0, 40.0), (-15.0, 200.0)]):
                lon0y = (lon0 + yr * 137.0) % 360.0
                for si, sgn in enumerate((-1, +1)):
                    clon = (lon0y + sgn * max(60 - k * 1.6, 8.0)) % 360.0
                    patch_t[t, 2 * band + si] = (lat0, clon, 5.0)

    rng_d = np.random.default_rng(seed + 1000)
    n_distr = 40
    d_lat = rng_d.uniform(-55, 55, n_distr).astype(np.float32)
    d_lon = rng_d.uniform(0, 360, n_distr).astype(np.float32)
    d_rad = np.geomspace(1.5, 10.0, n_distr).astype(np.float32)
    damp_t = (rng_d.random((T, n_distr)) < 0.25).astype(np.float32) * 5.0

    lat32 = jnp.asarray(lat_c.astype(np.float32))
    lon32 = jnp.asarray(lon_c.astype(np.float32))
    sst = _gen_unstr_fn()(
        jax.random.PRNGKey(seed), jnp.asarray(patch_t), jnp.asarray(damp_t),
        lat32, lon32, jnp.asarray(d_lat), jnp.asarray(d_lon), jnp.asarray(d_rad),
        jnp.asarray(seas_t), C,
    )
    sst.block_until_ready()
    coords = {"time": times, "lat": ("ncells", lat_c), "lon": ("ncells", lon_c)}
    da = Field(sst, ("time", "ncells"), coords=coords, name="sst")
    nbf = Field(nb, ("nv", "ncells"), coords={"lat": ("ncells", lat_c), "lon": ("ncells", lon_c)}, name="neighbours")
    areas = Field(np.full(C, 1.0e7, np.float32), ("ncells",), name="cell_areas")
    return da, nbf, areas


def _stage(da):
    import jax.numpy as jnp

    from marex_tpu import Field

    dev = jnp.asarray(np.asarray(da.values, dtype=np.float32))
    dev.block_until_ready()
    return Field(dev, da.dims, da.coords, da.name, da.attrs)


def _block(x):
    import jax

    jax.block_until_ready(x)


def measure_roundtrip_ms() -> float:
    """Median host<->device dispatch roundtrip for a tiny program — makes
    the march's dispatch-count x latency cost model auditable."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda a: a + 1)
    x = jnp.zeros((8,), jnp.float32)
    f(x).block_until_ready()
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        f(x).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


# Production tracking parameters (examples/batch jobs/submit_track.sh:20-28).
# Exact at the production resolution (ny>=720, i.e. 0.25 deg); at smoke sizes
# R_fill and the area floor scale with resolution so the opening does not
# annihilate every synthetic blob.
def _prod_track_kwargs(ny: int):
    s = min(ny / 720.0, 1.0)
    return dict(
        R_fill=max(int(round(12 * s)), 2),
        T_fill=4,
        area_filter_absolute=max(int(round(600 * s * s)), 8),
        grid_resolution=round(180.0 / ny, 4),
    )


def _warm() -> bool:
    """False when MAREX_BENCH_WARM=0 asks for a single cold-inclusive timed
    run per config."""
    return os.environ.get("MAREX_BENCH_WARM", "1") != "0"


def _cold_then_warm(run):
    """Timed cold run, then (unless MAREX_BENCH_WARM=0) a warm run whose
    result is returned. The cold result is NOT bound across the warm run:
    holding it would keep the cold run's full-size device outputs (the
    4.5 GB ID_field at production shape) alive through the warm run's peak.
    Returns (result, cold_wall_s)."""
    t0 = time.perf_counter()
    if _warm():
        run()  # result dropped immediately -> device buffers freed
        cold = time.perf_counter() - t0
        return run(), cold
    res = run()
    return res, time.perf_counter() - t0


def _detect_track(da, detect_kwargs, track_kwargs):
    """Run detect then track with per-stage walls; returns
    (events, tracker, t_detect, t_track).

    ``da`` is either a Field (host blocks are staged HERE, upload untimed,
    like _stage) or a zero-arg callable returning a device-resident Field
    (the on-device generators — regenerated per run so neither the cold nor
    the warm run pins the 4.8 GB block across tracking). Input + anomalies
    are RELEASED before tracking starts: production runs detect and track as
    separate jobs (submit_track.sh), so holding the raw SST block across
    tracking would be a bench artifact that inflates the tracking peak."""
    import gc

    import marex_tpu as marEx

    gc.collect()  # free the previous run's device buffers before the peak
    if callable(da):
        da_dev = da()
    else:
        da_dev = da if type(da.data).__module__.startswith("jax") else _stage(da)
    t0 = time.perf_counter()
    # the generated/staged block is the bench's private buffer: donate it into
    # the anomaly program (halves the detect peak at production shape)
    ds = marEx.preprocess_data(da_dev, quiet=True, donate_input=True, **detect_kwargs)
    _block(ds.extreme_events.data)
    t_detect = time.perf_counter() - t0

    ev, mask = ds.extreme_events, ds.mask
    extra = {}
    if "neighbours" in ds.data_vars:
        extra["neighbours"] = ds.neighbours
        extra["cell_areas"] = ds.cell_areas
    del ds, da_dev  # separate-jobs semantics: only extremes+mask survive
    gc.collect()

    t0 = time.perf_counter()
    tr = marEx.tracker(ev, mask, quiet=True, **extra, **track_kwargs)
    events = tr.run()
    _block(events["ID_field"].data)
    t_track = time.perf_counter() - t0
    return events, tr, t_detect, t_track


DETECT_FIXED = dict(
    method_anomaly="fixed_baseline",
    method_extreme="global_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
)


def _bw_model_gb(T: int, S: int, track: bool) -> float:
    """Lower-bound unique-buffer HBM traffic model (GB): detect reads the
    f32 block ~4x (climatology scatter, anomaly, digitize, compare) and
    writes ~2x; tracking touches the bool/int32 fields ~10x (morphology
    iterations, CCL sweeps, props). Used to turn walls into an achieved-
    bandwidth floor — NOT a precise measurement."""
    detect_bytes = 6 * T * S * 4
    track_bytes = 10 * T * S * 4 if track else 0
    return (detect_bytes + track_bytes) / 1e9


def config1_production_nomerge(make, T, ny, nx):
    kw = dict(allow_merging=False, **_prod_track_kwargs(ny))

    def run():
        return _detect_track(make, DETECT_FIXED, kw)

    with _silence:
        res, cold = _cold_then_warm(run)
        events, tr, t_det, t_trk = res
    wall = t_det + t_trk
    two_level = T * ny * nx > 200_000_000
    return {
        "wall_s": round(wall, 2),
        "cold_wall_s": round(cold, 2),
        "detect_wall_s": round(t_det, 2),
        "track_wall_s": round(t_trk, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "n_events": int(events.attrs["N_events_final"]),
        "two_level_ccl": bool(two_level),
        "stage_walls": dict(getattr(tr, "stage_walls", {})),
        "est_hbm_gb_per_s": round(_bw_model_gb(T, ny * nx, True) / wall, 3),
    }


def config2_hobday_shifting(n_years, ny, nx):
    """The reference's DEFAULT production path (shifting_baseline +
    hobday_extreme, detect.py:287) at FULL bench resolution: the rolling
    climatology's dense (years, 366, space) intermediate is space-chunked
    (ops/pipeline anomaly_program), so 0.25-degree in-memory detect+track
    runs at the default 3-year block (century-scale runs use config 7's
    streaming)."""
    def make():
        return make_data_device(n_years, ny, nx, seed=2)

    kw_detect = dict(
        method_anomaly="shifting_baseline",
        method_extreme="hobday_extreme",
        method_percentile="approximate",
        threshold_percentile=95,
        window_year_baseline=min(5, max(n_years - 1, 1)),
        smooth_days_baseline=21,
        window_days_hobday=11,
    )
    kw_track = dict(allow_merging=False, **_prod_track_kwargs(ny))

    def run():
        return _detect_track(make, kw_detect, kw_track)

    with _silence:
        res, _ = _cold_then_warm(run)
        events, tr, t_det, t_trk = res
    T = int(n_years * 365.25)
    wall = t_det + t_trk
    return {
        "wall_s": round(wall, 2),
        "detect_wall_s": round(t_det, 2),
        "track_wall_s": round(t_trk, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "n_events": int(events.attrs["N_events_final"]),
        "stage_walls": dict(getattr(tr, "stage_walls", {})),
    }


def config3_regional(n_years, ny, nx):
    def run():
        import marex_tpu as marEx

        da = make_data_device(n_years, ny, nx, seed=3, lat_range=(30.0, 70.0), lon_range=(-30.0, 40.0))
        t0 = time.perf_counter()
        ds = marEx.preprocess_data(da, quiet=True, donate_input=True, **DETECT_FIXED)
        _block(ds.extreme_events.data)
        t_det = time.perf_counter() - t0
        ev, mask = ds.extreme_events, ds.mask
        del ds, da
        t0 = time.perf_counter()
        tr = marEx.regional_tracker(
            ev, mask, R_fill=8, T_fill=2,
            area_filter_absolute=50, allow_merging=False,
            coordinate_units="degrees", quiet=True,
        )
        events = tr.run()
        _block(events["ID_field"].data)
        return events, t_det, time.perf_counter() - t0

    with _silence:
        res, _ = _cold_then_warm(run)
        events, t_det, t_trk = res
    T = int(n_years * 365.25)
    wall = t_det + t_trk
    return {
        "wall_s": round(wall, 2),
        "detect_wall_s": round(t_det, 2),
        "track_wall_s": round(t_trk, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "n_events": int(events.attrs["N_events_final"]),
    }


def config4_merge_production(make, T, ny, nx):
    kw = dict(
        allow_merging=True,
        nn_partitioning=True,
        overlap_threshold=0.25,
        **_prod_track_kwargs(ny),
    )

    def run():
        return _detect_track(make, DETECT_FIXED, kw)

    with _silence:
        res, cold = _cold_then_warm(run)
        events, tr, t_det, t_trk = res
    wall = t_det + t_trk
    return {
        "wall_s": round(wall, 2),
        "cold_wall_s": round(cold, 2),
        "detect_wall_s": round(t_det, 2),
        "track_wall_s": round(t_trk, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "n_events": int(events.attrs["N_events_final"]),
        "total_merges": int(events.attrs["total_merges"]),
        "march_dispatches": dict(getattr(tr, "dispatch_counts", {})),
        "stage_walls": dict(getattr(tr, "stage_walls", {})),
        "est_hbm_gb_per_s": round(_bw_model_gb(T, ny * nx, True) / wall, 3),
    }


def config5_unstructured(n_years, n_cells):
    import marex_tpu as marEx

    dims = {"time": "time", "x": "ncells"}
    coords = {"time": "time", "x": "lon", "y": "lat"}

    def run():
        da, nb, areas = make_unstructured_device(n_years, n_cells)
        t0 = time.perf_counter()
        ds = marEx.preprocess_data(
            da, dimensions=dims, coordinates=coords, donate_input=True,
            neighbours=nb, cell_areas=areas, quiet=True, **DETECT_FIXED,
        )
        _block(ds.extreme_events.data)
        t_det = time.perf_counter() - t0
        ev, mask = ds.extreme_events, ds.mask
        nbv, cav = ds.neighbours, ds.cell_areas
        del ds, da
        t0 = time.perf_counter()
        tr = marEx.tracker(
            ev, mask, R_fill=2, T_fill=2,
            area_filter_quartile=0.5, allow_merging=True,
            nn_partitioning=True, overlap_threshold=0.25,
            unstructured_grid=True, dimensions={"x": "ncells"},
            coordinates={"x": "lon", "y": "lat"},
            coordinate_units="degrees", temp_dir=tempfile.gettempdir(),
            neighbours=nbv, cell_areas=cav, quiet=True,
        )
        events = tr.run()
        _block(events["ID_field"].data)
        return (events, tr), t_det, time.perf_counter() - t0

    with _silence:
        res, _ = _cold_then_warm(run)
        (events, tr), t_det, t_trk = res
    T, C = (int(s) for s in events["ID_field"].data.shape)
    wall = t_det + t_trk
    return {
        "wall_s": round(wall, 2),
        "detect_wall_s": round(t_det, 2),
        "track_wall_s": round(t_trk, 2),
        "gpd_per_s": round(T * C / wall, 1),
        "n_cells": int(C),
        "n_events": int(events.attrs["N_events_final"]),
        "total_merges": int(events.attrs["total_merges"]),
        "stage_walls": dict(getattr(tr, "stage_walls", {})),
        "march_dispatches": dict(getattr(tr, "dispatch_counts", {})),
    }


def config6_merge_dense(ny: int, nx: int, T: int = 200, n_pairs: int = 24):
    """Merge-dense stress: n_pairs blob pairs converge/merge/separate every
    50 steps. Reports the merge-mode overhead factor plus the march's
    dispatch counts and the measured dispatch roundtrip so latency x count
    is auditable."""
    import jax.numpy as jnp

    import marex_tpu as marEx
    from marex_tpu.core.field import Field

    data = np.zeros((T, ny, nx), bool)
    yy, xx = np.mgrid[0:ny, 0:nx]
    rng = np.random.default_rng(9)
    centers = [(rng.integers(ny // 6, 5 * ny // 6), rng.integers(0, nx)) for _ in range(n_pairs)]
    r = max(min(ny, nx) // 30, 5)
    for t in range(T):
        phase = (t % 50) / 50.0
        sep = int((1.0 - min(phase * 2, 1.0)) * 3 * r) + r
        for cy, cx0 in centers:
            for s in (-sep, sep):
                cx = (cx0 + s) % nx
                dx = np.minimum(np.abs(xx - cx), nx - np.abs(xx - cx))
                data[t] |= (yy - cy) ** 2 + dx**2 <= r * r
    coords = {
        "time": daily_times("2015-01-01", T),
        "lat": np.linspace(-60, 60, ny),
        "lon": np.linspace(0, 360, nx, endpoint=False),
    }
    daf = Field(jnp.asarray(data), ("time", "lat", "lon"), coords=coords, name="extreme_events")
    mask = Field(np.ones((ny, nx), bool), ("lat", "lon"),
                 coords={"lat": coords["lat"], "lon": coords["lon"]}, name="mask")

    def run(merging):
        tr = marEx.tracker(
            daf, mask, R_fill=2, T_fill=0, area_filter_quartile=0.0,
            allow_merging=merging, nn_partitioning=True, overlap_threshold=0.3,
            quiet=True,
        )
        return tr.run(), tr

    with _silence:
        if _warm():
            run(False)
        t0 = time.perf_counter()
        _, tr_plain = run(False)
        w_plain = time.perf_counter() - t0
        if _warm():
            run(True)
        t0 = time.perf_counter()
        ev, tr = run(True)
        w_merge = time.perf_counter() - t0
    disp = dict(getattr(tr, "dispatch_counts", {}))
    rt_ms = measure_roundtrip_ms()
    return {
        "no_merge_wall_s": round(w_plain, 2),
        "merge_wall_s": round(w_merge, 2),
        "merge_overhead_x": round(w_merge / max(w_plain, 1e-9), 2),
        "total_merges": int(ev.attrs["total_merges"]),
        "march_dispatches": disp,
        "dispatch_roundtrip_ms": round(rt_ms, 3),
        "dispatch_latency_total_s": round(sum(disp.values()) * rt_ms / 1e3, 2),
        "stage_walls_no_merge": dict(getattr(tr_plain, "stage_walls", {})),
        "stage_walls_merge": dict(getattr(tr, "stage_walls", {})),
    }


def config7_streamed(n_years, ny, nx):
    """Streamed larger-than-memory detect: lat-row tiles from host RAM
    through the fused detect programs into a raw zarr store (the
    century-scale ingest path; README.md:161 analogue). The whole f32 block
    crosses the host->device link once — that IS the workload — so the
    spatial shape adapts to the MEASURED link rate (~90 s of link budget):
    full production shape on a PCIe-attached host, scaled down over a slow
    link, with the link rate recorded alongside the result."""
    import shutil

    import marex_tpu as marEx
    from marex_tpu.helper import measured_link_bandwidth

    up, _ = measured_link_bandwidth()
    T_est = int(n_years * 365.25)
    s = min(1.0, (90.0 * up * 1e6 / (T_est * ny * nx * 4.0)) ** 0.5)
    ny = max(int(ny * s) // 8 * 8, 24)
    nx = max(int(nx * s) // 8 * 8, 48)
    da_host = make_data(n_years, ny, nx)

    out = os.path.join(tempfile.gettempdir(), "marex_bench_streamed.zarr")
    T = da_host.sizes["time"]
    # shifting_baseline drops the first `window` years; at small CI shapes
    # (2 years) a fixed window=2 would trim the dataset to nothing
    years = decompose_time(da_host.coords["time"].values).year
    wyb = max(1, min(2, int(years.max() - years.min())))

    def run():
        return marEx.preprocess_data_streamed(
            da_host, out,
            method_anomaly="shifting_baseline",
            method_extreme="hobday_extreme",
            threshold_percentile=95,
            window_year_baseline=wyb,
            smooth_days_baseline=21,
            window_days_hobday=11,
            memory_budget_mb=2048,
            compressor=None,
        )

    with _silence:
        t0 = time.perf_counter()
        ds = run()
        wall = time.perf_counter() - t0
    n_tiles = int(ds.attrs["stream_n_tiles"])
    row_block = int(ds.attrs["stream_row_block"])
    out_bytes = sum(
        os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(out) for f in fs
    )
    n_ex = int(np.asarray(ds.data_vars["extreme_events"].data[: min(T, 64)]).sum())
    shutil.rmtree(out, ignore_errors=True)
    return {
        "wall_s": round(wall, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "row_block": row_block,
        "n_tiles": n_tiles,
        "out_gb": round(out_bytes / 1e9, 2),
        "extremes_probe": n_ex,
        "shape": [int(T), int(ny), int(nx)],
        "link_up_mbps": round(up, 2),
    }


def config8_streamed_track(n_years, ny, nx):
    """Streamed larger-than-memory TRACKING: detect once (on device-generated
    data), write the binary extremes to a chunked zarr store, then stream the
    whole tracking pipeline (lazy reads, blockwise scan march, region-written
    ID_field) under a bounded memory budget. The out-of-core counterpart of
    config 4's track stage (reference analogue: zarr-region batched
    split/merge, track.py:3804-4814). Every cell crosses the link ~5x (bool
    extremes up from zarr, int32 IDs down to zarr), so like config 7 the
    spatial shape adapts to the MEASURED link rate (~150 s budget per run)."""
    import shutil

    import jax.numpy as jnp

    import marex_tpu as marEx
    from marex_tpu.helper import measured_link_bandwidth
    from marex_tpu.io import zarr_lite

    up, down = measured_link_bandwidth()
    T_est = int(n_years * 365.25)
    per_cell_s = 1.0 / (up * 1e6) + 4.125 / (down * 1e6)
    s = min(1.0, (150.0 / (T_est * ny * nx * per_cell_s)) ** 0.5)
    ny = max(int(ny * s) // 8 * 8, 24)
    nx = max(int(nx * s) // 8 * 8, 48)

    src = os.path.join(tempfile.gettempdir(), "marex_bench_trkstream_src.zarr")
    outp = os.path.join(tempfile.gettempdir(), "marex_bench_trkstream_out.zarr")
    with _silence:
        da_dev = make_data_device(n_years, ny, nx)
        T = da_dev.sizes["time"]
        ds = marEx.preprocess_data(da_dev, quiet=True, donate_input=True, **DETECT_FIXED)
        ev, mask = ds.extreme_events, ds.mask
        # extremes leave the device bit-packed (1/8th the link bytes)
        S = ny * nx
        bits = np.asarray(jnp.packbits(ev.data.reshape(T, S), axis=-1, bitorder="little"))
        ev_np = np.unpackbits(bits, axis=-1, count=S, bitorder="little").astype(bool).reshape(T, ny, nx)
        ev_host = marEx.Field(ev_np, ev.dims, dict(ev.coords), name="extreme_events")
        del ds, ev, da_dev, bits
        zarr_lite.to_zarr(ev_host, src, chunks={"time": 64})
        del ev_host
        lazy = zarr_lite.open_zarr(src, lazy=True)
        kw = dict(allow_merging=True, nn_partitioning=True, overlap_threshold=0.25, **_prod_track_kwargs(ny))

        def run():
            shutil.rmtree(outp, ignore_errors=True)
            tr = marEx.tracker(lazy["extreme_events"], mask, quiet=True, **kw)
            t0 = time.perf_counter()
            events = tr.run_streamed(outp, memory_budget_mb=2048)
            return events, tr, time.perf_counter() - t0

        res, _ = _cold_then_warm(run)
        events, tr, wall = res
    out = {
        "track_wall_s": round(wall, 2),
        "gpd_per_s": round(T * ny * nx / wall, 1),
        "n_events": int(events.attrs["N_events_final"]),
        "total_merges": int(events.attrs["total_merges"]),
        "march_blocks": int(tr.dispatch_counts.get("march_scan", 0)),
        "memory_budget_mb": 2048,
        "shape": [int(T), int(ny), int(nx)],
        "link_mbps": [round(up, 2), round(down, 2)],
    }
    shutil.rmtree(src, ignore_errors=True)
    shutil.rmtree(outp, ignore_errors=True)
    return out


# Order: headline configs first so a timeout at ANY point still leaves the
# best-so-far JSON line on stdout; the link-bound streaming configs (7/8) go
# last.
_CONFIG_ORDER = ["1", "4", "2", "5", "6", "3", "7", "8"]


def _requested_configs():
    req = set(os.environ.get("MAREX_BENCH_CONFIGS", "1,2,3,4,5,6,7,8").split(","))
    ids = [c for c in _CONFIG_ORDER if c in req]
    if "merge_dense" in req and "6" not in ids:
        ids.append("6")
    return ids


def _emit(detail) -> None:
    """Print the headline JSON line (stdout, flushed). Called after EVERY
    config completes — the last line wins, so a driver timeout mid-benchmark
    still captures everything finished so far."""
    configs = detail.get("configs", {})
    headline = None
    for name, metric in (
        ("4_merge_production",
         "detect+track throughput (fixed_baseline+global_extreme, production params: "
         "R_fill=12 T_fill=4 area>=600 overlap=0.25 merging+nn, 0.25deg)"),
        ("1_fixed_global_production",
         "detect+track throughput (fixed_baseline+global_extreme, production params, no-merge)"),
    ):
        c = configs.get(name, {})
        if "gpd_per_s" in c:
            headline = (metric, c["gpd_per_s"])
            break
    if headline is None:
        with_tp = [(n, c) for n, c in configs.items() if "gpd_per_s" in c]
        if with_tp:
            headline = (f"detect+track throughput (config {with_tp[0][0]})", with_tp[0][1]["gpd_per_s"])
    if headline is None:
        errs = "; ".join(f"{n}: {c['error'][:120]}" for n, c in configs.items() if "error" in c)
        out = {
            "metric": f"error: no benchmark config completed ({errs or 'none ran'})",
            "value": 0.0,
            "unit": "gridpoint-days/sec/chip",
            "vs_baseline": 0.0,
            "detail": detail,
        }
    else:
        metric, throughput = headline
        out = {
            "metric": metric,
            "value": round(throughput, 1),
            "unit": "gridpoint-days/sec/chip",
            "vs_baseline": round(throughput / BASELINE_THROUGHPUT, 3),
            "detail": detail,
        }
    print(json.dumps(out), flush=True)


def _run_config(cid: str, ctx: dict) -> None:
    """Dispatch one config id into ctx["detail"]["configs"] via ctx["try"]."""
    n_years, ny, nx, n_cells = ctx["n_years"], ctx["ny"], ctx["nx"], ctx["n_cells"]
    _try = ctx["try"]
    T = int(n_years * 365.25)

    def make(seed=0):
        return make_data_device(n_years, ny, nx, seed=seed)

    if cid == "1":
        _try("1_fixed_global_production", config1_production_nomerge, make, T, ny, nx)
    elif cid == "2":
        _try("2_shifting_hobday", config2_hobday_shifting, n_years, ny, nx)
    elif cid == "3":
        _try("3_regional", config3_regional, n_years, max(ny // 2, 32), max(nx // 2, 64))
    elif cid == "4":
        _try("4_merge_production", config4_merge_production, make, T, ny, nx)
    elif cid == "5":
        _try("5_unstructured", config5_unstructured, max(n_years // 2, 2), n_cells)
    elif cid == "6":
        _try("6_merge_dense", config6_merge_dense, max(ny // 4, 60), max(nx // 4, 120))
    elif cid == "7":
        _try("7_streamed", config7_streamed, n_years, ny, nx)
    elif cid == "8":
        _try("8_streamed_track", config8_streamed_track, n_years, ny, nx)


def _worker_context() -> dict:
    """Shapes, the device record and the per-config fault isolation for the
    run. Fails unless JAX found a GPU or the user pinned JAX_PLATFORMS=cpu."""
    import jax

    small = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    devices = jax.devices()
    if devices[0].platform != "gpu" and not small:
        raise SystemExit(
            f"bench.py: JAX found no GPU (backend {devices[0].platform!r}); "
            "set JAX_PLATFORMS=cpu explicitly for the small CPU run"
        )
    # < 2 years is scientifically degenerate for the baseline climatologies
    # (1 year of daily data IS its own day-of-year mean, so anomalies ~ 0 and
    # the 95th-percentile threshold collapses to the histogram floor -> zero
    # extremes). Clamp and record rather than emit garbage.
    n_years_req = int(os.environ.get("MAREX_BENCH_YEARS", "3"))
    n_years = max(n_years_req, 2)
    ny = int(os.environ.get("MAREX_BENCH_NY", "90" if small else "720"))
    nx = int(os.environ.get("MAREX_BENCH_NX", "180" if small else "1440"))
    n_cells = int(os.environ.get("MAREX_BENCH_CELLS", "20000" if small else "1048576"))

    T = int(n_years * 365.25)
    detail = {
        "shape": [T, ny, nx],
        "configs": {},
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }
    if n_years != n_years_req:
        detail["years_clamped"] = {"requested": n_years_req, "used": n_years}

    def _try(name, fn, *args, **kw):
        """Per-config fault isolation: a failure in one config records an
        error entry instead of zeroing the whole benchmark."""
        import gc
        import traceback

        try:
            detail["configs"][name] = fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - recorded, the next config runs
            traceback.print_exc()
            detail["configs"][name] = {"error": f"{type(e).__name__}: {e}"}
        gc.collect()
        return detail["configs"][name]

    return {
        "detail": detail, "try": _try,
        "n_years": n_years, "ny": ny, "nx": nx, "n_cells": n_cells,
    }


def _drive() -> None:
    """Run the requested configs in order in THIS process, re-emitting the
    merged headline JSON line after each config (last line wins).
    SIGTERM / SIGINT emits the best-so-far line before exiting."""
    import signal

    t0 = time.monotonic()
    ctx = _worker_context()
    detail = ctx["detail"]

    def _die(signum, frame):  # noqa: ARG001
        detail.setdefault("note", f"interrupted by signal {signum} after {time.monotonic() - t0:.0f}s")
        _emit(detail)
        os._exit(0)

    signal.signal(signal.SIGTERM, _die)
    signal.signal(signal.SIGINT, _die)

    for cid in _requested_configs():
        _run_config(cid, ctx)
        detail["elapsed_s"] = round(time.monotonic() - t0, 1)
        _emit(detail)
    if "elapsed_s" not in detail:  # nothing requested: still print one line
        _emit(detail)


def main() -> None:
    from marex_tpu.helper import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    _drive()


if __name__ == "__main__":
    main()
