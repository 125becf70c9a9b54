"""
MarEx-TPU: Marine Extremes Detection and Tracking on accelerators
================================================================

A JAX/XLA-native framework for identifying and tracking marine extremes
(e.g. Marine Heatwaves) in decadal-to-century daily climate data, on regular
lat/lon grids and unstructured triangular ocean-model meshes.

Same capability surface as the reference marEx package (detect -> track ->
visualise), re-designed for accelerators: dense device-resident tensors
instead of Dask task graphs, jitted XLA kernels instead of Numba, SPMD
sharding over a device mesh instead of a distributed scheduler.

Example
-------
>>> import marex_tpu as marEx
>>> extremes_ds = marEx.preprocess_data(sst, threshold_percentile=95)
>>> events_ds = marEx.tracker(extremes_ds.extreme_events, extremes_ds.mask,
...                           R_fill=8, area_filter_quartile=0.5).run()
"""

try:  # coverage bootstrap for subprocess measurement (must import first)
    from . import _coverage_init  # noqa: F401
except ImportError:  # pragma: no cover
    pass

from ._dependencies import (
    get_dependency_status,
    get_installation_profile,
    has_dependency,
    print_dependency_status,
)
from .core.field import Coord, Field, FieldSet, as_field, concat, from_xarray
from .detect import (
    add_decimal_year,
    compute_normalised_anomaly,
    identify_extremes,
    preprocess_data,
    rolling_climatology,
    smoothed_rolling_climatology,
)
from .exceptions import (
    ConfigurationError,
    CoordinateError,
    DataValidationError,
    DependencyError,
    DeviceError,
    MarExError,
    ProcessingError,
    TrackingError,
    VisualisationError,
    create_coordinate_error,
    create_data_validation_error,
    create_processing_error,
    create_tracking_error,
    wrap_exception,
)
from .logging_config import (
    configure_logging,
    get_logger,
    get_verbosity_level,
    is_quiet_mode,
    is_verbose_mode,
    set_normal_logging,
    set_quiet_mode,
    set_verbose_mode,
)

__all__ = [
    # Core containers
    "Field",
    "FieldSet",
    "Coord",
    "as_field",
    "from_xarray",
    "concat",
    # Core data preprocessing
    "preprocess_data",
    "preprocess_data_streamed",
    "compute_normalised_anomaly",
    "smoothed_rolling_climatology",
    "rolling_climatology",
    "identify_extremes",
    "add_decimal_year",
    # Tracking
    "tracker",
    "regional_tracker",
    # Visualisation
    "specify_grid",
    "PlotConfig",
    # Exceptions
    "MarExError",
    "DataValidationError",
    "CoordinateError",
    "ProcessingError",
    "ConfigurationError",
    "DependencyError",
    "TrackingError",
    "VisualisationError",
    "DeviceError",
    "create_data_validation_error",
    "create_coordinate_error",
    "create_processing_error",
    "create_tracking_error",
    "wrap_exception",
    # Dependency management
    "has_dependency",
    "print_dependency_status",
    "get_dependency_status",
    "get_installation_profile",
    # Logging configuration
    "configure_logging",
    "set_verbose_mode",
    "set_quiet_mode",
    "set_normal_logging",
    "get_verbosity_level",
    "is_verbose_mode",
    "is_quiet_mode",
    "get_logger",
    # HPC helper utilities
    "configure_dask",
    "configure_devices",
]

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import marex_tpu` light and avoid hard failures when
    # optional plotting dependencies are absent.  NB: must use
    # importlib.import_module — a `from . import x` here re-enters this
    # __getattr__ during the submodule import and recurses.
    import importlib

    if name in ("tracker", "regional_tracker"):
        return getattr(importlib.import_module(".track", __name__), name)
    if name == "preprocess_data_streamed":
        return getattr(importlib.import_module(".detect_stream", __name__), name)
    if name in ("specify_grid", "PlotConfig", "plotX"):
        mod = importlib.import_module(".plotX", __name__)
        return mod if name == "plotX" else getattr(mod, name)
    if name in (
        "configure_dask",
        "configure_devices",
        "start_local_cluster",
        "start_distributed_cluster",
        "helper",
        "check_device_health",
        "run_with_retries",
    ):
        mod = importlib.import_module(".helper", __name__)
        return mod if name == "helper" else getattr(mod, name)
    if name == "io":
        return importlib.import_module(".io", __name__)
    if name == "parallel":
        return importlib.import_module(".parallel", __name__)
    raise AttributeError(f"module 'marex_tpu' has no attribute {name!r}")
