"""Test configuration for marex_tpu.

Multi-device analogue of the reference's LocalCluster-based testing
(``tests/conftest.py:72-146``): tests run on the CPU backend with 8 virtual
XLA devices (``--xla_force_host_platform_device_count=8``) so that sharded
code paths execute real collectives without accelerator hardware.
"""

import os
import tempfile

# The scan-march capacity cache persists to disk (track._scan_cache_path) so
# production runs skip the retry ladder; tests must NOT share that file —
# the forced-overflow ladder tests would poison it (and a poisoned file
# pre-grows capacities, breaking the ladder tests themselves next session).
os.environ.setdefault(
    "MAREX_SCAN_CACHE", os.path.join(tempfile.mkdtemp(prefix="marex_test_scancache_"), "scan_sizes.json")
)

# Must be configured before the jax backend is initialised anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # pragma: no cover - older jax without this flag
    pass

# Persistent compilation cache: kernel compiles dominate test wall-time on
# the CPU backend; cache them across test sessions.
# Namespace the cache by host fingerprint: XLA:CPU AOT executables compiled
# on a machine with different vector extensions SIGILL/segfault when replayed
# (observed: avx512 cache entries crashing a narrower host mid-suite).
import hashlib
import platform

def _host_tag() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            flags = [ln for ln in fh if ln.startswith("flags")][0]
    except Exception:
        flags = platform.processor()
    return hashlib.sha1(f"{platform.machine()}:{flags}".encode()).hexdigest()[:12]

# The persistent compilation cache is OPT-IN for tests (MAREX_TEST_CACHE=1):
# XLA:CPU executable (de)serialization is not reliable across process
# configurations even on ONE host — cache READS segfault inside
# compilation_cache.get_executable_and_time with target-feature mismatches
# (+prefer-no-scatter/-gather pseudo-flags) that the host fingerprint below
# cannot capture, and WRITES have crashed at high RSS. Correctness of
# `pytest tests/` beats compile-time savings.
if os.environ.get("MAREX_TEST_CACHE", "") == "1":
    _cache_dir = os.path.join(os.path.dirname(__file__), "..", f".pytest_jax_cache_{_host_tag()}")
    os.makedirs(_cache_dir, exist_ok=True)
    try:
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_enable_xla_caches", "none")
    except Exception:  # pragma: no cover
        pass

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from marex_tpu.core.field import Coord, Field  # noqa: E402


# ----------------------------------------------------------------------------
# Statistical assertion helpers (numerical contract, cf. tests/conftest.py:168-346)
# ----------------------------------------------------------------------------


def assert_percentile_frequency(frequency, expected_percentile, tolerance_std=2.0, sample_size=None, description=None):
    """Observed extreme frequency must match (100-p)/100 within binomial CI."""
    expected = (100 - expected_percentile) / 100.0
    desc = f" ({description})" if description else ""
    if sample_size is not None:
        std_error = np.sqrt(expected * (1 - expected) / sample_size)
        lo, hi = expected - tolerance_std * std_error, expected + tolerance_std * std_error
    else:
        tol = max(0.005, expected * 0.20)
        lo, hi = expected - tol, expected + tol
    assert lo <= frequency <= hi, (
        f"Extreme frequency {frequency:.4f} outside expected range [{lo:.4f}, {hi:.4f}] "
        f"for {expected_percentile}th percentile{desc}"
    )


def assert_reasonable_bounds(value, expected_value, tolerance_relative=0.1, tolerance_absolute=None, description="value"):
    if tolerance_absolute is not None:
        lo, hi = expected_value - tolerance_absolute, expected_value + tolerance_absolute
    else:
        tol = abs(expected_value * tolerance_relative)
        lo, hi = expected_value - tol, expected_value + tol
    assert lo <= value <= hi, f"{description} {value} outside [{lo:.4f}, {hi:.4f}] (expected {expected_value})"


def assert_count_in_reasonable_range(count, expected_count, tolerance=2):
    assert expected_count - tolerance <= count <= expected_count + tolerance, (
        f"Count {count} outside [{expected_count - tolerance}, {expected_count + tolerance}]"
    )


# ----------------------------------------------------------------------------
# Synthetic fixtures (deterministic; same scale as the reference's test zarrs)
# ----------------------------------------------------------------------------


def make_gridded_sst(n_years=12, ny=20, nx=40, seed=42, with_land=True, start="2000-01-01"):
    """
    Daily synthetic SST on a regular grid: seasonal cycle + warming trend +
    AR(1)-ish noise + a land block, mirroring the statistical structure of the
    reference fixture ``tests/data/sst_gridded.zarr``.
    """
    rng = np.random.default_rng(seed)
    times = pd.date_range(start, periods=int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    lat = np.linspace(-60, 60, ny).astype(np.float64)
    lon = np.linspace(0, 360, nx, endpoint=False).astype(np.float64)

    doy = pd.DatetimeIndex(times).dayofyear.to_numpy()
    t_years = np.arange(T) / 365.25

    seasonal = 3.0 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25) * np.cos(np.deg2rad(lat))[None, :, None]
    trend = 0.02 * t_years[:, None, None]
    base = 15.0 + 10.0 * np.cos(np.deg2rad(lat))[None, :, None]

    noise = rng.standard_normal((T, ny, nx)).astype(np.float32)
    # cheap temporal correlation
    for k in range(1, T):
        noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]

    sst = (base + seasonal + trend + noise).astype(np.float32)
    sst = sst + 0 * lon[None, None, :]

    if with_land:
        sst[:, 2:6, 5:12] = np.nan  # land block

    return Field(
        sst,
        ("time", "lat", "lon"),
        coords={"time": times, "lat": lat, "lon": lon},
        name="sst",
    )


def make_unstructured_mesh(n_side=16, seed=7):
    """
    Small triangular mesh via Delaunay triangulation of a jittered grid.
    Returns (lat_cells, lon_cells, neighbours(3, ncells) 1-based, cell_areas).
    Cells are triangles; neighbours = adjacent triangles (0 = no neighbour),
    matching the ICON-style (nv=3, ncells) table the reference expects
    (track.py:1060-1089).
    """
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, 355, n_side), np.linspace(-55, 55, n_side))
    pts = np.column_stack([gx.ravel(), gy.ravel()]).astype(np.float64)
    pts[:, 0] += rng.uniform(-2, 2, len(pts))
    pts[:, 1] += rng.uniform(-2, 2, len(pts))
    tri = Delaunay(pts)

    centroids = pts[tri.simplices].mean(axis=1)
    lon_c = centroids[:, 0].astype(np.float32)
    lat_c = centroids[:, 1].astype(np.float32)
    neighbours = (tri.neighbors.T + 1).astype(np.int32)  # 1-based, 0 = invalid

    # triangle areas (planar, arbitrary units)
    p = pts[tri.simplices]
    areas = 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    ).astype(np.float32)
    return lat_c, lon_c, neighbours, areas


def make_unstructured_sst(n_years=10, n_side=16, seed=3, start="2005-01-01"):
    """Daily synthetic SST on the triangular mesh, plus grid metadata Fields."""
    rng = np.random.default_rng(seed)
    lat_c, lon_c, neighbours, areas = make_unstructured_mesh(n_side=n_side)
    ncells = len(lat_c)
    times = pd.date_range(start, periods=int(n_years * 365.25), freq="D").to_numpy()
    T = len(times)
    doy = pd.DatetimeIndex(times).dayofyear.to_numpy()

    seasonal = 3.0 * np.cos(2 * np.pi * (doy[:, None] - 30) / 365.25) * np.cos(np.deg2rad(lat_c))[None, :]
    noise = rng.standard_normal((T, ncells)).astype(np.float32)
    for k in range(1, T):
        noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
    sst = (15.0 + seasonal + 0.01 * np.arange(T)[:, None] / 365.25 + noise).astype(np.float32)

    da = Field(
        sst,
        ("time", "ncells"),
        coords={
            "time": times,
            "lat": Coord("ncells", lat_c),
            "lon": Coord("ncells", lon_c),
        },
        name="sst",
    )
    nb = Field(neighbours, ("nv", "ncells"), name="neighbours")
    ca = Field(
        areas,
        ("ncells",),
        coords={"lat": Coord("ncells", lat_c), "lon": Coord("ncells", lon_c)},
        name="cell_areas",
    )
    return da, nb, ca


@pytest.fixture(scope="session")
def gridded_sst():
    return make_gridded_sst()

@pytest.fixture(scope="session")
def gridded_sst_long():
    return make_gridded_sst(n_years=20, ny=16, nx=32, seed=11)


@pytest.fixture(scope="session")
def unstructured_sst():
    return make_unstructured_sst()


@pytest.fixture(autouse=True, scope="module")
def _free_compiled_programs():
    """Drop compiled-executable references after each test module: a full
    one-process suite accumulates hundreds of XLA:CPU executables, and the
    compiler has been observed to segfault (backend_compile_and_load) late
    in such runs. Per-module clearing bounds resident compiled state; each
    module mostly compiles distinct shapes anyway."""
    yield
    try:
        jax.clear_caches()
    except Exception:  # pragma: no cover
        pass
