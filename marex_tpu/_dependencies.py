"""
Optional-dependency registry for marex_tpu.

Equivalent role to the reference's ``marEx/_dependencies.py:15-179``: a single
place that records which optional packages are importable, raises helpful
errors when a feature needs one, and reports installation profiles.

The core stack (jax/jaxlib/numpy) is required; xarray/zarr/dask are *optional interop* layers (the
framework has its own Field container and zarr-lite IO); matplotlib/cartopy/
pillow gate the plotX subsystem.
"""

from __future__ import annotations

import importlib
import importlib.util
from typing import Dict, List, Optional

from .exceptions import DependencyError

# name -> (pip package, why it is needed)
OPTIONAL_DEPENDENCIES: Dict[str, tuple] = {
    "xarray": ("xarray", "xarray interop (accepting/returning xarray objects)"),
    "dask": ("dask[distributed]", "ingesting dask-backed arrays"),
    "zarr": ("zarr", "reading compressed external zarr stores (zarr-lite covers zlib/raw)"),
    "matplotlib": ("matplotlib", "plotX visualisation"),
    "cartopy": ("cartopy", "map projections in plotX"),
    "cmocean": ("cmocean", "oceanographic colormaps"),
    "seaborn": ("seaborn", "statistical plot styling"),
    "pillow": ("Pillow", "animation frame encoding"),
    "psutil": ("psutil", "memory telemetry in logs"),
    "h5py": ("h5py", "HDF5/NetCDF4 ingest"),
    "scipy": ("scipy", "reference kernels for testing & host-side graph ops"),
    "netCDF4": ("netCDF4", "NetCDF ingest"),
}

REQUIRED_DEPENDENCIES: Dict[str, str] = {
    "jax": "jax",
    "numpy": "numpy",
}

INSTALLATION_PROFILES: Dict[str, List[str]] = {
    "minimal": [],
    "performance": ["psutil"],
    "io": ["zarr", "xarray", "h5py", "netCDF4"],
    "plotting": ["matplotlib", "cartopy", "cmocean", "seaborn", "pillow"],
    "full": sorted(OPTIONAL_DEPENDENCIES.keys()),
}

_availability_cache: Dict[str, bool] = {}

_IMPORT_NAMES = {"pillow": "PIL"}


def has_dependency(name: str) -> bool:
    """Return True when the optional dependency ``name`` is importable."""
    if name in _availability_cache:
        return _availability_cache[name]
    import_name = _IMPORT_NAMES.get(name, name)
    ok = importlib.util.find_spec(import_name) is not None
    _availability_cache[name] = ok
    return ok


def require_dependencies(names: List[str], feature: str = "this feature") -> None:
    """
    Raise :class:`DependencyError` (an ImportError-flavoured MarExError) when
    any of ``names`` is missing, with an install hint.
    """
    missing = [n for n in names if not has_dependency(n)]
    if missing:
        pips = [OPTIONAL_DEPENDENCIES.get(n, (n, ""))[0] for n in missing]
        raise DependencyError(
            f"Missing dependencies for {feature}: {', '.join(missing)}",
            details=f"{feature} requires additional packages that are not installed",
            suggestions=[f"Install with: pip install {' '.join(pips)}"],
            context={"missing": missing, "feature": feature},
        )


_warned: set = set()


def warn_missing_dependency(name: str, feature: str = "Some functionality") -> None:
    """Log (once per dependency) that a feature is degraded."""
    if name in _warned:
        return
    _warned.add(name)
    from .logging_config import get_logger

    pip_name = OPTIONAL_DEPENDENCIES.get(name, (name, ""))[0]
    get_logger(__name__).warning(
        f"{feature} requires '{name}' which is not installed. Install with: pip install {pip_name}"
    )


def get_dependency_status() -> Dict[str, bool]:
    """Availability map for every known optional dependency."""
    return {name: has_dependency(name) for name in sorted(OPTIONAL_DEPENDENCIES)}


def get_installation_profile() -> str:
    """
    Classify the current environment against the installation profiles,
    returning the richest fully-satisfied profile name.
    """
    status = get_dependency_status()
    best = "minimal"
    for profile in ("performance", "io", "plotting", "full"):
        needs = INSTALLATION_PROFILES[profile]
        if all(status.get(n, False) for n in needs):
            best = profile
    return best


def print_dependency_status() -> None:
    """Human-readable dump of dependency availability."""
    status = get_dependency_status()
    print("marex_tpu optional dependencies:")
    for name, ok in status.items():
        pip_name, why = OPTIONAL_DEPENDENCIES[name]
        mark = "+" if ok else "-"
        print(f"  [{mark}] {name:<12} {why}")
    print(f"Installation profile: {get_installation_profile()}")


def jax_backend_info() -> Dict[str, object]:
    """Report the active JAX backend and device inventory."""
    import jax

    devices = jax.devices()
    return {
        "backend": jax.default_backend(),
        "n_devices": len(devices),
        "device_kinds": sorted({d.device_kind for d in devices}),
    }
