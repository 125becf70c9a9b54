"""
MarEx-TPU Detect: anomalies & extreme-event identification.

Accelerator-native rebuild of the reference detect engine (``marEx/detect.py``):
the same four anomaly methods (``detrend_harmonic``, ``shifting_baseline``,
``fixed_baseline``, ``detrend_fixed_baseline``), the same two extreme methods
(``global_extreme``, ``hobday_extreme``) with exact and histogram-approximate
percentile paths, and the same validation/output contract
(``dat_anomaly``/``mask``/``extreme_events``/``thresholds`` + attrs,
cf. detect.py:414-421,678-783).

Execution model: instead of lazy Dask graphs, inputs are staged to device
once, the time axis is scattered into a dense ``(year, dayofyear, space)``
tensor, and all reductions run as jitted XLA programs
(:mod:`marex_tpu.ops.climatology`, :mod:`marex_tpu.ops.detrend`,
:mod:`marex_tpu.ops.quantile`).
"""

from __future__ import annotations

import logging
import warnings
from typing import Any, Dict, List, Literal, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .core.field import Coord, Field, FieldSet, as_field
from .core.timeaxis import TimeIndexInfo, decompose_time, gather_from_year_doy, scatter_to_year_doy
from .exceptions import ConfigurationError, create_data_validation_error
from .logging_config import configure_logging, get_logger, log_array_info, log_memory_usage, log_timing
from .ops import climatology as _clim
from .ops import detrend as _detrend
from .ops import pipeline as _pipe
from .ops import quantile as _quant

logger = get_logger(__name__)


# ============================
# Validation Functions
# ============================


def _validate_dimensions_exist(da: Field, dimensions: Dict[str, str]) -> None:
    """Ensure every mapped dimension name exists on the Field (cf. detect.py:53-89)."""
    missing = [f"'{actual}' (for {concept})" for concept, actual in dimensions.items() if actual not in da.dims]
    if missing:
        available = list(da.dims)
        raise create_data_validation_error(
            f"Missing required dimensions: {', '.join(missing)}",
            details=f"Dataset has dimensions: {available}",
            suggestions=[
                "Check dimension names in your data",
                "Update the 'dimensions' parameter to match your data structure",
                f"Available dimensions: {available}",
            ],
            data_info={
                "missing_dimensions": missing,
                "available_dimensions": available,
                "provided_dimensions": dimensions,
            },
        )


def _validate_coordinates_exist(da: Field, coordinates: Dict[str, str]) -> None:
    """Ensure every mapped coordinate name exists (cf. detect.py:92-128)."""
    missing = [f"'{actual}' (for {concept})" for concept, actual in coordinates.items() if actual not in da.coords]
    if missing:
        available = list(da.coords.keys())
        raise create_data_validation_error(
            f"Missing required coordinates: {', '.join(missing)}",
            details=f"Dataset has coordinates: {available}",
            suggestions=[
                "Check coordinate names in your data",
                "Update the 'coordinates' parameter to match your data structure",
                f"Available coordinates: {available}",
            ],
            data_info={
                "missing_coordinates": missing,
                "available_coordinates": available,
                "provided_coordinates": coordinates,
            },
        )


def _infer_dims_coords(
    da: Field, dimensions: Optional[Dict[str, str]], coordinates: Optional[Dict[str, str]]
) -> Tuple[Dict[str, str], Dict[str, str]]:
    """
    Apply default dim/coord names and validate (cf. detect.py:131-202).
    Gridded default: {time: time, x: lon, y: lat}. Unstructured (no 'y')
    requires explicit coordinates.
    """
    if dimensions is None:
        dimensions = {"time": "time", "x": "lon", "y": "lat"}
    if "time" not in dimensions:
        dimensions = {"time": "time", **dimensions}

    if coordinates is None:
        if "y" not in dimensions:
            logger.error("Coordinates parameter required for unstructured data")
            raise create_data_validation_error(
                "Coordinates parameter must be explicitly specified for unstructured data",
                details="Unstructured data requires coordinate names for x and y spatial coordinates",
                suggestions=[
                    "Specify coordinates parameter with spatial coordinate names",
                    "Example: coordinates={'time': 'time', 'x': 'lon', 'y': 'lat'}",
                    f"Your x dimension '{dimensions['x']}' needs associated coordinate names",
                    "If data is gridded, ensure 'y' dimension is also specified",
                ],
                data_info={
                    "data_structure": "unstructured (2D)",
                    "dimensions": dimensions,
                    "missing_coordinates": "x and y spatial coordinates",
                },
            )
        coordinates = dimensions.copy()
    else:
        if "time" not in coordinates:
            coordinates = {"time": dimensions.get("time", "time"), **coordinates}

    _validate_dimensions_exist(da, dimensions)
    _validate_coordinates_exist(da, coordinates)
    return dimensions, coordinates


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("tax",))
def _validation_stats_program(v: jnp.ndarray, tax: int):
    """One fused program computing all NaN-policy statistics (5 scalars)."""
    v = jnp.moveaxis(v, tax, 0)
    finite = jnp.isfinite(v)
    spatial_mask = finite[0]
    invalid_per_location = jnp.sum(~finite, axis=0)
    invalid_in_valid = jnp.where(spatial_mask, invalid_per_location, 0)
    return (
        jnp.any(spatial_mask).astype(jnp.int32),
        jnp.max(invalid_in_valid).astype(jnp.int32),
        jnp.sum(invalid_in_valid).astype(jnp.int32),
        jnp.sum(invalid_in_valid > 0).astype(jnp.int32),
        jnp.sum(spatial_mask).astype(jnp.int32),
    )


def _validate_data_values(da: Field, dimensions: Dict[str, str]) -> None:
    """
    NaN/inf policy identical to the reference (detect.py:205-279): the spatial
    mask comes from time step 0; any non-finite value at a valid location at
    any other time is an error.  The scan runs on device (one fused reduction)
    when the payload is device-resident or large.
    """
    tax = da.dims.index(dimensions["time"])
    payload = da.data

    if type(payload).__module__.startswith("jax") or getattr(payload, "size", 0) > 10_000_000:
        stats = jax.device_get(_validation_stats_program(jnp.asarray(payload), tax))
        any_valid, max_invalid, total_invalid, locations_affected, total_ocean = map(int, stats)
        if not any_valid:
            raise create_data_validation_error(
                "Dataset contains no valid (finite) data",
                details="All values in the first time step are NaN or infinite",
                suggestions=[
                    "Check your input data for data quality issues",
                    "Verify the data was loaded correctly",
                ],
                data_info={"total_values": int(payload.size)},
            )
        if max_invalid > 0:
            raise create_data_validation_error(
                f"Dataset contains {total_invalid} invalid values in {locations_affected} ocean locations",
                details=(
                    f"Found invalid data across time series. Worst location has {max_invalid} "
                    f"invalid time steps out of {payload.shape[tax]}."
                ),
                suggestions=[
                    "Remove or interpolate NaN/infinite values before preprocessing",
                    "Check data quality and loading procedures",
                    "For ocean data, ensure land mask is properly applied before preprocessing",
                ],
                data_info={
                    "total_invalid_values_in_ocean": total_invalid,
                    "locations_affected": locations_affected,
                    "total_ocean_locations": total_ocean,
                    "max_invalid_at_one_location": max_invalid,
                    "total_time_steps": int(payload.shape[tax]),
                },
            )
        return

    vals = da.values
    vals = np.moveaxis(vals, tax, 0)
    spatial_mask = np.isfinite(vals[0])

    if not spatial_mask.any():
        raise create_data_validation_error(
            "Dataset contains no valid (finite) data",
            details="All values in the first time step are NaN or infinite",
            suggestions=[
                "Check your input data for data quality issues",
                "Verify the data was loaded correctly",
                "Check for issues in data preprocessing steps",
            ],
            data_info={"total_values": int(vals.size)},
        )

    invalid_per_location = (~np.isfinite(vals)).sum(axis=0)
    invalid_in_valid = np.where(spatial_mask, invalid_per_location, 0)
    max_invalid = invalid_in_valid.max()
    if max_invalid > 0:
        total_invalid = int(invalid_in_valid.sum())
        locations_affected = int((invalid_in_valid > 0).sum())
        total_ocean = int(spatial_mask.sum())
        raise create_data_validation_error(
            f"Dataset contains {total_invalid} invalid values in {locations_affected} ocean locations",
            details=(
                f"Found invalid data across time series. Worst location has {int(max_invalid)} "
                f"invalid time steps out of {vals.shape[0]}."
            ),
            suggestions=[
                "Remove or interpolate NaN/infinite values before preprocessing",
                "Check data quality and loading procedures",
                "For ocean data, ensure land mask is properly applied before preprocessing",
            ],
            data_info={
                "total_invalid_values_in_ocean": total_invalid,
                "locations_affected": locations_affected,
                "total_ocean_locations": total_ocean,
                "max_invalid_at_one_location": int(max_invalid),
                "total_time_steps": int(vals.shape[0]),
            },
        )


# ============================
# Internal staging
# ============================


class _Staged:
    """Device-staged view of the input with calendar decomposition.

    ``prefer_flat`` picks the upload layout for HOST payloads (a numpy
    reshape is free; on-device (T, S) <-> (T, H, W) reshapes can be real
    relayout copies — 4.5 GB at 0.25-degree production scale): True for paths that need the flat layout (the
    (Y, 366, S) calendar scatters of shifting_baseline / hobday), False
    for the rank-polymorphic fixed/detrend/global programs which then run
    with ZERO relayouts end-to-end. Device-resident payloads always keep
    their original shape; an active mesh always forces flat (space
    sharding is defined over the flattened axis).
    """

    def __init__(
        self,
        da: Field,
        dimensions: Dict[str, str],
        coordinates: Dict[str, str],
        prefer_flat: bool = True,
    ):
        self.dimensions = dimensions
        self.coordinates = coordinates
        self.timedim = dimensions["time"]
        self.xdim = dimensions["x"]
        self.ydim = dimensions.get("y")
        self.is_gridded = self.ydim is not None and self.ydim in da.dims

        order = (self.timedim, self.ydim, self.xdim) if self.is_gridded else (self.timedim, self.xdim)
        da = da.transpose(*order)
        self.field = da
        self.spatial_dims = order[1:]
        self.spatial_shape = tuple(da.sizes[d] for d in self.spatial_dims)
        self.n_space = int(np.prod(self.spatial_shape))

        # multi-device: place the payload space-sharded on the active mesh
        # (the detect stage is pointwise over space — no collectives; mirrors
        # the reference's spatial-chunk data parallelism, detect.py:1944-1953)
        from .parallel import detect_sharding, get_default_mesh, shard_if_divisible

        mesh = get_default_mesh()
        payload = da.data
        # host payloads are staged into a PRIVATE device copy — programs may
        # donate (destroy) it freely; device-resident payloads belong to the
        # caller and may only be donated on explicit opt-in (donate_input)
        self.owns_data = not type(payload).__module__.startswith("jax")
        self._mask_np: Optional[np.ndarray] = None
        if type(payload).__module__.startswith("jax"):
            # Already device-resident (e.g. chained from another detect
            # stage): keep the ORIGINAL (T, *spatial) shape. A standalone
            # (T, S) relayout would allocate a full extra copy (4.5 GB at
            # 0.25 deg production scale); the fused detect programs flatten
            # in-program instead. The mesh
            # path still needs the flat layout for space sharding.
            self.data = payload.astype(jnp.float32)
            if mesh is not None:
                self.data = shard_if_divisible(
                    self.data.reshape(payload.shape[0], self.n_space), detect_sharding(mesh)
                )
        else:
            vals = np.asarray(payload, dtype=np.float32)
            if prefer_flat or mesh is not None:
                vals = vals.reshape(vals.shape[0], self.n_space)
            self.data = jnp.asarray(vals)
            if mesh is not None:
                self.data = shard_if_divisible(self.data, detect_sharding(mesh))
        self.tinfo: TimeIndexInfo = decompose_time(da.coords[coordinates["time"]].values)
        self._ymd_cache: Dict[str, Any] = {}

    def flat2d(self) -> jnp.ndarray:
        """The payload as (T, S) — a view reshape for host-staged data, a
        relayout for device-resident gridded data (only the rare standalone
        helpers pay it; the fused programs flatten in-program instead)."""
        return self.data.reshape(self.data.shape[0], self.n_space)

    def ymd(self, data: Optional[jnp.ndarray] = None, key: str = "raw") -> jnp.ndarray:
        if data is None:
            data = self.flat2d()
        if key not in self._ymd_cache:
            self._ymd_cache[key] = scatter_to_year_doy(data, self.tinfo)
        return self._ymd_cache[key]

    def unflatten(self, arr: np.ndarray, leading_dims: Tuple[str, ...]) -> np.ndarray:
        lead_shape = arr.shape[: len(leading_dims)]
        return np.asarray(arr).reshape(lead_shape + self.spatial_shape)

    def spatial_coords(self) -> Dict[str, Coord]:
        out = {}
        for name, c in self.field.coords.items():
            if set(c.dims) <= set(self.spatial_dims):
                out[name] = c
        return out

    def mask_values(self) -> np.ndarray:
        # cached: paths that DONATE the payload into the anomaly program must
        # capture the mask first (the buffer is invalid afterwards)
        if self._mask_np is None:
            self._mask_np = np.isfinite(np.asarray(self.data[0])).reshape(self.spatial_shape)
        return self._mask_np


# ============================
# Public API
# ============================


def preprocess_data(
    da: Any,
    method_anomaly: Literal[
        "detrend_harmonic", "shifting_baseline", "fixed_baseline", "detrend_fixed_baseline"
    ] = "shifting_baseline",
    method_extreme: Literal["global_extreme", "hobday_extreme"] = "hobday_extreme",
    threshold_percentile: float = 95,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    window_days_hobday: int = 11,
    window_spatial_hobday: Optional[int] = None,
    std_normalise: bool = False,
    detrend_orders: Optional[List[int]] = None,
    force_zero_mean: bool = True,
    reference_period: Optional[Tuple[int, int]] = None,
    method_percentile: Literal["exact", "approximate"] = "approximate",
    precision: float = 0.01,
    max_anomaly: float = 5.0,
    dask_chunks: Optional[Dict[str, int]] = None,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    neighbours: Optional[Any] = None,
    cell_areas: Optional[Any] = None,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    mesh: Optional[Any] = None,
    donate_input: bool = False,
) -> FieldSet:
    """
    Complete preprocessing pipeline: anomalies + extreme identification.

    API-compatible with the reference ``marEx.preprocess_data``
    (detect.py:287-841); accepts marex_tpu Fields, xarray DataArrays, or
    anything duck-typed like one. ``dask_chunks`` / ``use_temp_checkpoints``
    are accepted for compatibility (no task graph exists to checkpoint).

    ``mesh`` (a ``jax.sharding.Mesh``, or True for an auto mesh over all
    devices) runs the whole stage multi-device: payloads are placed
    space-sharded (``parallel.detect_sharding``) and every kernel executes
    SPMD — the device equivalent of the reference's Dask cluster scale-out
    (helper.py:414-639). Equivalent to wrapping the call in
    ``parallel.use_mesh(mesh)``.

    Returns
    -------
    FieldSet with ``dat_anomaly``, ``mask``, ``extreme_events``,
    ``thresholds`` (+ ``dat_stn``/``STD``/``extreme_events_stn``/
    ``thresholds_stn`` when ``std_normalise`` and ``neighbours``/
    ``cell_areas`` passthrough), and provenance attrs.
    """
    if mesh is not None:
        from .parallel import make_mesh, use_mesh

        with use_mesh(make_mesh() if mesh is True else mesh):
            return preprocess_data(
                da,
                method_anomaly=method_anomaly,
                method_extreme=method_extreme,
                threshold_percentile=threshold_percentile,
                window_year_baseline=window_year_baseline,
                smooth_days_baseline=smooth_days_baseline,
                window_days_hobday=window_days_hobday,
                window_spatial_hobday=window_spatial_hobday,
                std_normalise=std_normalise,
                detrend_orders=detrend_orders,
                force_zero_mean=force_zero_mean,
                reference_period=reference_period,
                method_percentile=method_percentile,
                precision=precision,
                max_anomaly=max_anomaly,
                dask_chunks=dask_chunks,
                dimensions=dimensions,
                coordinates=coordinates,
                neighbours=neighbours,
                cell_areas=cell_areas,
                use_temp_checkpoints=use_temp_checkpoints,
                verbose=verbose,
                quiet=quiet,
                mesh=None,
            )

    if detrend_orders is None:
        detrend_orders = [1]
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)

    logger.info(f"Starting data preprocessing - Method: {method_anomaly} -> {method_extreme}")
    logger.info(f"Parameters: percentile={threshold_percentile}%, method_percentile={method_percentile}")

    da = as_field(da)
    log_array_info(logger, da, "Input data")
    log_memory_usage(logger, "Initial memory state", logging.DEBUG)

    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    # Stage the payload to device ONCE up front (float32): validation and all
    # subsequent compute reuse the same device buffer — host<->device traffic
    # is the dominant cost at production sizes.
    if not type(da.data).__module__.startswith("jax"):
        da = Field(
            jnp.asarray(np.asarray(da.data, dtype=np.float32)), da.dims, da.coords, da.name, da.attrs
        )

    if reference_period is not None and method_anomaly not in ("fixed_baseline", "detrend_fixed_baseline"):
        raise ConfigurationError(
            f"reference_period is not supported for method_anomaly='{method_anomaly}'",
            details="reference_period is only applicable to 'fixed_baseline' and 'detrend_fixed_baseline' methods",
            suggestions=[
                "Remove the reference_period parameter, or",
                "Use method_anomaly='fixed_baseline' or 'detrend_fixed_baseline'",
            ],
        )

    _validate_data_values(da, dimensions)

    with log_timing(logger, f"Anomaly computation using {method_anomaly} method", log_memory=True):
        ds = compute_normalised_anomaly(
            da if da.dtype == np.float32 else da.astype(np.float32),
            method_anomaly,
            dimensions,
            coordinates,
            window_year_baseline,
            smooth_days_baseline,
            std_normalise,
            detrend_orders,
            force_zero_mean,
            reference_period,
            donate_input=donate_input,
        )

    # Shifting baseline: drop the first `window_year_baseline` years
    if method_anomaly == "shifting_baseline":
        tvals = ds.coords[coordinates["time"]].values
        tinfo = decompose_time(tvals)
        total_years = int(tinfo.year.max() - tinfo.year.min() + 1)
        if total_years < window_year_baseline:
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=f"Dataset spans {total_years} years but requires at least {window_year_baseline} years",
                suggestions=[
                    "Use more years of data to meet minimum requirement",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                    "Consider using detrend_fixed_baseline or detrend_harmonic method instead",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline)},
            )
        start_year = int(tinfo.year.min() + window_year_baseline)
        keep = np.nonzero(tinfo.year >= start_year)[0]
        if keep.size == 0:
            # the reference's `total_years < window` guard (detect.py:622)
            # lets the equality case through and silently empties the
            # dataset; fail loudly instead
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=(
                    f"Removing the first {window_year_baseline} baseline years "
                    f"leaves no timesteps (dataset spans {total_years} years)"
                ),
                suggestions=[
                    "Use more years of data (at least window_year_baseline + 1)",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                    "Consider using detrend_fixed_baseline or detrend_harmonic method instead",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline) + 1},
            )
        logger.info(f"Trimming data to start from {start_year} (removing first {window_year_baseline} years)")
        ds = ds.isel({dimensions["time"]: keep})

    anomalies = ds["dat_anomaly"]

    with log_timing(logger, f"Extreme event identification using {method_extreme} method", log_memory=True):
        extremes, thresholds = identify_extremes(
            anomalies,
            method_extreme,
            threshold_percentile,
            dimensions,
            coordinates,
            window_days_hobday,
            window_spatial_hobday,
            method_percentile,
            precision,
            max_anomaly,
        )

    ds["extreme_events"] = extremes
    ds["thresholds"] = thresholds

    if std_normalise and method_anomaly == "detrend_harmonic":
        logger.info("Processing standardised anomalies for extreme identification")
        extremes_stn, thresholds_stn = identify_extremes(
            ds["dat_stn"],
            method_extreme,
            threshold_percentile,
            dimensions,
            coordinates,
            window_days_hobday,
            window_spatial_hobday,
            method_percentile,
            precision,
            max_anomaly,
        )
        ds["extreme_events_stn"] = extremes_stn
        ds["thresholds_stn"] = thresholds_stn

    if neighbours is not None:
        nb = as_field(neighbours)
        ds["neighbours"] = nb.astype(np.int32)
        if "nv" in nb.dims:
            ds.coords.setdefault("nv", Coord("nv", np.arange(nb.sizes["nv"])))
    if cell_areas is not None:
        ds["cell_areas"] = as_field(cell_areas).astype(np.float32)

    ds.attrs.update(
        {
            "method_anomaly": method_anomaly,
            "method_extreme": method_extreme,
            "threshold_percentile": threshold_percentile,
            "preprocessing_steps": _get_preprocessing_steps(
                method_anomaly,
                method_extreme,
                std_normalise,
                detrend_orders,
                window_year_baseline,
                smooth_days_baseline,
                window_days_hobday,
                window_spatial_hobday,
                reference_period,
            ),
        }
    )
    if method_anomaly == "detrend_harmonic":
        ds.attrs.update(
            {"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean, "std_normalise": std_normalise}
        )
    elif method_anomaly == "shifting_baseline":
        ds.attrs.update(
            {"window_year_baseline": window_year_baseline, "smooth_days_baseline": smooth_days_baseline}
        )
    elif method_anomaly in ("fixed_baseline", "detrend_fixed_baseline"):
        if method_anomaly == "detrend_fixed_baseline":
            ds.attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean})
        if reference_period is not None:
            ds.attrs["reference_period"] = list(reference_period)
    if method_extreme == "hobday_extreme":
        ds.attrs["window_days_hobday"] = window_days_hobday
    ds.attrs.update({"method_percentile": method_percentile, "precision": precision, "max_anomaly": max_anomaly})

    ev = ds["extreme_events"].data
    n_extremes = int(jnp.sum(ev)) if type(ev).__module__.startswith("jax") else int(np.sum(ev))
    logger.info(f"Preprocessing completed successfully - {n_extremes} extreme events identified")
    return ds


def _get_preprocessing_steps(
    method_anomaly: str,
    method_extreme: str,
    std_normalise: bool,
    detrend_orders: List[int],
    window_year_baseline: int,
    smooth_days_baseline: int,
    window_days_hobday: int,
    window_spatial_hobday: Optional[int],
    reference_period: Optional[Tuple[int, int]] = None,
) -> List[str]:
    """Provenance description of the processing chain (cf. detect.py:844-888)."""
    steps = []
    if method_anomaly == "detrend_harmonic":
        steps.append(f"Removed polynomial trend orders={detrend_orders} & seasonal cycle")
        if std_normalise:
            steps.append("Normalised by 30-day rolling STD")
    elif method_anomaly == "shifting_baseline":
        steps.append(f"Rolling climatology using {window_year_baseline} years")
        steps.append(f"Smoothed with {smooth_days_baseline}-day window")
    elif method_anomaly == "fixed_baseline":
        if reference_period is not None:
            steps.append(f"Daily climatology computed from {reference_period[0]}-{reference_period[1]}")
        else:
            steps.append("Daily climatology computed from full time series")
    elif method_anomaly == "detrend_fixed_baseline":
        steps.append(f"Removed polynomial trend orders={detrend_orders}")
        if reference_period is not None:
            steps.append(f"Daily climatology computed from detrended data ({reference_period[0]}-{reference_period[1]})")
        else:
            steps.append("Daily climatology computed from detrended data")

    if method_extreme == "global_extreme":
        steps.append("Global percentile threshold applied to all days")
    elif method_extreme == "hobday_extreme":
        if window_spatial_hobday is not None:
            steps.append(
                f"Day-of-year thresholds with {window_days_hobday} day window & {window_spatial_hobday} spatial neighbours"
            )
        else:
            steps.append(f"Day-of-year thresholds with {window_days_hobday} day window")
    return steps


def compute_normalised_anomaly(
    da: Any,
    method_anomaly: Literal[
        "detrend_harmonic", "shifting_baseline", "fixed_baseline", "detrend_fixed_baseline"
    ] = "shifting_baseline",
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    std_normalise: bool = False,
    detrend_orders: Optional[List[int]] = None,
    force_zero_mean: bool = True,
    reference_period: Optional[Tuple[int, int]] = None,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
    donate_input: bool = False,
) -> FieldSet:
    """
    Generate anomalies using the selected methodology
    (cf. detect.py:891-1116). Returns a FieldSet with ``dat_anomaly`` and
    ``mask`` (+ ``dat_stn``/``STD`` for std-normalised detrending).
    """
    if detrend_orders is None:
        detrend_orders = [1]
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)

    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    if reference_period is not None and method_anomaly not in ("fixed_baseline", "detrend_fixed_baseline"):
        raise ConfigurationError(
            f"reference_period is not supported for method_anomaly='{method_anomaly}'",
            details="reference_period is only applicable to 'fixed_baseline' and 'detrend_fixed_baseline' methods",
            suggestions=[
                "Remove the reference_period parameter, or",
                "Use method_anomaly='fixed_baseline' or 'detrend_fixed_baseline'",
            ],
        )

    if method_anomaly == "detrend_harmonic":
        return _anomaly_detrended(
            da, dimensions, coordinates, std_normalise, detrend_orders, force_zero_mean,
            remove_harmonics=True, donate=donate_input,
        )
    elif method_anomaly == "shifting_baseline":
        return _anomaly_shifting_baseline(da, dimensions, coordinates, window_year_baseline, smooth_days_baseline)
    elif method_anomaly == "fixed_baseline":
        return _anomaly_fixed_baseline(da, dimensions, coordinates, reference_period, donate=donate_input)
    elif method_anomaly == "detrend_fixed_baseline":
        detrended = _anomaly_detrended(
            da, dimensions, coordinates, False, detrend_orders, force_zero_mean,
            remove_harmonics=False, donate=donate_input,
        )
        # the intermediate detrended field is OURS: always donate it onward
        return _anomaly_fixed_baseline(detrended["dat_anomaly"], dimensions, coordinates, reference_period, donate=True)
    else:
        raise ConfigurationError(
            f"Unknown anomaly method '{method_anomaly}'",
            details="Invalid method_anomaly parameter",
            suggestions=[
                "Use 'detrend_harmonic' for efficient processing with trend and harmonic removal",
                "Use 'shifting_baseline' for accurate climatology (requires more data)",
                "Use 'fixed_baseline' to remove a single daily climatology across all years",
                "Use 'detrend_fixed_baseline' for trend removal followed by fixed climatology",
            ],
            context={
                "provided_method": method_anomaly,
                "valid_methods": ["detrend_harmonic", "shifting_baseline", "fixed_baseline", "detrend_fixed_baseline"],
            },
        )


def _device_reshape(x: jnp.ndarray, shape: Tuple[int, ...]) -> jnp.ndarray:
    """Zero-copy device reshape: a bare ``x.reshape`` dispatches a program
    that ALLOCATES a new buffer (3.8 GB extra for a century of 0.25 deg
    anomalies); donating the operand lets XLA
    alias input and output where layouts agree. A no-op when the shape
    already matches (the rank-polymorphic detect programs preserve the
    gridded layout end-to-end, so this is the common case)."""
    if tuple(x.shape) == tuple(shape):
        return x
    if type(x).__module__.startswith("jax"):
        return jax.jit(lambda a: a.reshape(shape), donate_argnums=0)(x)
    return np.asarray(x).reshape(shape)


def _assemble_anomaly_ds(
    staged: _Staged,
    anomalies_ts: jnp.ndarray,
    extra_vars: Optional[Dict[str, Field]] = None,
) -> FieldSet:
    """Wrap (T,S) anomalies + mask back into labeled Fields."""
    dims = (staged.timedim,) + staged.spatial_dims
    coords: Dict[str, Any] = dict(staged.field.coords)
    # keep the payload device-resident; downloads happen only when a caller
    # actually asks for .values
    anom = Field(
        _device_reshape(anomalies_ts, (anomalies_ts.shape[0],) + staged.spatial_shape),
        dims,
        coords,
        name="dat_anomaly",
    )
    mask = Field(staged.mask_values(), staged.spatial_dims, staged.spatial_coords(), name="mask")
    data_vars = {"dat_anomaly": anom, "mask": mask}
    if extra_vars:
        data_vars.update(extra_vars)
    return FieldSet(data_vars, coords)


def _anomaly_shifting_baseline(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    window_year_baseline: int,
    smooth_days_baseline: int,
) -> FieldSet:
    """Smoothed rolling climatology anomaly (cf. detect.py:1819-1850) —
    one fused XLA program (smooth -> scatter -> prefix sums -> gather)."""
    staged = _Staged(da, dimensions, coordinates)
    anomalies = _pipe.anomaly_program(
        staged.data,
        jnp.asarray(staged.tinfo.year_index),
        jnp.asarray(staged.tinfo.dayofyear - 1),
        jnp.ones((staged.data.shape[0],), bool),
        None,
        None,
        staged.tinfo.n_years,
        "shifting_baseline",
        window_year_baseline,
        smooth_days_baseline,
        False,
    )
    return _assemble_anomaly_ds(staged, anomalies)


def _anomaly_fixed_baseline(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    reference_period: Optional[Tuple[int, int]],
    donate: bool = False,
) -> FieldSet:
    """Fixed daily climatology anomaly (cf. detect.py:2299-2397)."""
    staged = _Staged(da, dimensions, coordinates, prefer_flat=False)

    if reference_period is not None:
        start_year, end_year = reference_period
        if start_year > end_year:
            raise ConfigurationError(
                f"Invalid reference_period: start year ({start_year}) must be <= end year ({end_year})",
                details="The reference_period tuple must be (start_year, end_year) with start_year <= end_year",
                suggestions=[f"Swap the order: use reference_period=({end_year}, {start_year})"],
            )
        in_period = (staged.tinfo.year >= start_year) & (staged.tinfo.year <= end_year)
        if not in_period.any():
            y0, y1 = int(staged.tinfo.year.min()), int(staged.tinfo.year.max())
            raise ConfigurationError(
                f"No data found in reference_period ({start_year}, {end_year})",
                details=f"Dataset spans {y0}-{y1} but no timesteps fall within the specified period",
                suggestions=[
                    f"Adjust reference_period to overlap with data range ({y0}-{y1})",
                    "Set reference_period=None to use the full time series",
                ],
            )
        clim_mask = jnp.asarray(in_period)
    else:
        clim_mask = jnp.ones((staged.data.shape[0],), bool)

    # donate the payload into the program when it is OURS (host-staged) or
    # the caller opted in: the input and anomaly buffers (4.5 GB each at
    # production shape) are otherwise concurrently live, and the detect peak
    # decides whether the pipeline fits the chip's share of a busy pool
    prog = _pipe.anomaly_program_donated if (donate or staged.owns_data) else _pipe.anomaly_program
    staged.mask_values()  # capture the land mask BEFORE the buffer dies
    anomalies = prog(
        staged.data,
        jnp.asarray(staged.tinfo.year_index),
        jnp.asarray(staged.tinfo.dayofyear - 1),
        clim_mask,
        None,
        None,
        staged.tinfo.n_years,
        "fixed_baseline",
        0,
        0,
        False,
    )
    return _assemble_anomaly_ds(staged, anomalies)


def _anomaly_detrended(
    da: Field,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    std_normalise: bool,
    detrend_orders: List[int],
    force_zero_mean: bool,
    remove_harmonics: bool,
    donate: bool = False,
) -> FieldSet:
    """Polynomial + harmonic detrending anomaly (cf. detect.py:2061-2296)."""
    if not detrend_orders:
        raise ConfigurationError(
            "detrend_orders cannot be empty",
            details="At least one polynomial order must be specified for detrending",
            suggestions=[
                "Use detrend_orders=[1] for linear detrending",
                "Use detrend_orders=[1, 2] for linear + quadratic detrending",
                "Remove detrend_orders optional parameter to use default [1]",
            ],
        )
    if any(order < 1 for order in detrend_orders):
        invalid = [o for o in detrend_orders if o < 1]
        raise ConfigurationError(
            f"Invalid polynomial orders: {invalid}",
            details="Polynomial orders must be positive integers (>= 1)",
            suggestions=[
                "Use only positive integers for polynomial orders",
                "Common values: [1] for linear, [1,2] for linear+quadratic",
                f"Remove invalid orders: {invalid}",
            ],
        )
    if 1 not in detrend_orders and len(detrend_orders) > 1:
        warnings.warn("Higher-order detrending without linear term may be unstable", UserWarning, stacklevel=2)

    staged = _Staged(da, dimensions, coordinates, prefer_flat=False)
    model, pmodel = _detrend.build_design_matrix(staged.tinfo, detrend_orders, remove_harmonics)
    prog = _pipe.anomaly_program_donated if (donate or staged.owns_data) else _pipe.anomaly_program
    staged.mask_values()  # capture the land mask BEFORE the buffer dies
    anomalies = prog(
        staged.data,
        jnp.asarray(staged.tinfo.year_index),
        jnp.asarray(staged.tinfo.dayofyear - 1),
        jnp.ones((staged.data.shape[0],), bool),
        jnp.asarray(model, dtype=jnp.float32),
        jnp.asarray(pmodel, dtype=jnp.float32),
        staged.tinfo.n_years,
        "detrend_harmonic",
        0,
        0,
        force_zero_mean,
    )

    extra: Dict[str, Field] = {}
    if std_normalise:
        # the (Y, 366, S) scatter needs the flat layout; anomalies may be
        # (T, *spatial) when the input was device-resident gridded data
        anom_flat = anomalies.reshape(anomalies.shape[0], -1)
        ymd = scatter_to_year_doy(anom_flat, staged.tinfo)
        std_doy = _clim.dayofyear_std(ymd)  # (366, S)
        std_rolling = _clim.wrapped_rolling_rms_doy(std_doy, window=30, pad=16)
        std_safe = jnp.where(std_rolling > 1e-10, std_rolling, jnp.nan)
        doy_idx = jnp.asarray(staged.tinfo.dayofyear - 1)
        dat_stn = anom_flat / std_safe[doy_idx]

        dims = (staged.timedim,) + staged.spatial_dims
        extra["dat_stn"] = Field(
            staged.unflatten(np.asarray(dat_stn), (staged.timedim,)), dims, staged.field.coords, name="dat_stn"
        )
        std_field = Field(
            staged.unflatten(np.asarray(std_rolling), ("dayofyear",)),
            ("dayofyear",) + staged.spatial_dims,
            {**staged.spatial_coords(), "dayofyear": Coord("dayofyear", np.arange(1, 367))},
            name="STD",
        )
        extra["STD"] = std_field

    return _assemble_anomaly_ds(staged, anomalies, extra)


# ===============================================
# Shifting Baseline public helpers
# ===============================================


def rolling_climatology(
    da: Any,
    window_year_baseline: int = 15,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    use_temp_checkpoints: bool = False,
) -> Field:
    """
    Rolling climatology: for each timestep, the mean over the same day-of-year
    in the previous ``window_year_baseline`` years (cf. detect.py:1511-1688).
    Years without sufficient history are NaN.
    """
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    staged = _Staged(da, dimensions, coordinates)
    ymd = staged.ymd()
    clim_y = _clim.rolling_climatology_ymd(ymd, window_year_baseline)
    clim_ts = gather_from_year_doy(clim_y, staged.tinfo)
    dims = (staged.timedim,) + staged.spatial_dims
    return Field(staged.unflatten(np.asarray(clim_ts), (staged.timedim,)), dims, staged.field.coords, name=da.name)


def smoothed_rolling_climatology(
    da: Any,
    window_year_baseline: int = 15,
    smooth_days_baseline: int = 21,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    use_temp_checkpoints: bool = False,
) -> Field:
    """
    Rolling climatology of the time-smoothed data — smoothing the raw series
    first is cheaper than smoothing the climatology (cf. detect.py:1691-1816).
    """
    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    staged = _Staged(da, dimensions, coordinates)
    smoothed = _clim.centered_rolling_mean_time(staged.flat2d(), smooth_days_baseline)
    ymd = scatter_to_year_doy(smoothed, staged.tinfo)
    clim_y = _clim.rolling_climatology_ymd(ymd, window_year_baseline)
    clim_ts = gather_from_year_doy(clim_y, staged.tinfo)
    dims = (staged.timedim,) + staged.spatial_dims
    return Field(staged.unflatten(np.asarray(clim_ts), (staged.timedim,)), dims, staged.field.coords, name=da.name)


def add_decimal_year(da: Any, dim: str = "time", coord: Optional[str] = None) -> Field:
    """Attach a ``decimal_year`` coordinate (cf. detect.py:2031-2058)."""
    da = as_field(da)
    coord_name = coord if coord is not None else dim
    dy = decompose_time(da.coords[coord_name].values).decimal_year
    return da.assign_coords(decimal_year=(dim, dy))


# ==========================
# Extreme identification
# ==========================


def identify_extremes(
    da: Any,
    method_extreme: Literal["global_extreme", "hobday_extreme"] = "hobday_extreme",
    threshold_percentile: float = 95,
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    window_days_hobday: int = 11,
    window_spatial_hobday: Optional[int] = None,
    method_percentile: Literal["exact", "approximate"] = "approximate",
    precision: float = 0.01,
    max_anomaly: float = 5.0,
    use_temp_checkpoints: bool = False,
    verbose: Optional[bool] = None,
    quiet: Optional[bool] = None,
) -> Tuple[Field, Field]:
    """
    Identify extreme events exceeding a percentile threshold
    (cf. detect.py:1119-1503). Returns ``(extremes, thresholds)``.
    """
    if verbose is not None or quiet is not None:
        configure_logging(verbose=verbose, quiet=quiet)

    da = as_field(da)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)

    valid_methods = ["exact", "approximate"]
    if method_percentile not in valid_methods:
        raise ConfigurationError(
            f"Unknown method_percentile '{method_percentile}'",
            details="Invalid method_percentile parameter",
            suggestions=[
                "Use 'exact' for precise percentile computation (memory intensive)",
                "Use 'approximate' for efficient histogram-based computation (default)",
            ],
            context={"provided_method": method_percentile, "valid_methods": valid_methods},
        )

    if method_percentile == "exact":
        if precision != 0.01:
            raise ConfigurationError(
                "Parameter 'precision' cannot be used with method_percentile='exact'",
                details="The precision parameter is only used by the approximate histogram method",
                suggestions=[
                    "Remove the 'precision' parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if you want to control histogram precision",
                ],
                context={"method_percentile": method_percentile, "provided_precision": precision},
            )
        if max_anomaly != 5.0:
            raise ConfigurationError(
                "Parameter 'max_anomaly' cannot be used with method_percentile='exact'",
                details="The max_anomaly parameter is only used by the approximate histogram method",
                suggestions=[
                    "Remove the 'max_anomaly' parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if you want to control histogram binning range",
                ],
                context={"method_percentile": method_percentile, "provided_max_anomaly": max_anomaly},
            )

    if not 0 < threshold_percentile <= 100:
        # the reference leaves out-of-range percentiles to fail deep inside
        # numpy's quantile (exact) or silently misbehave (approximate
        # histogram interpolation); reject them up front instead
        raise ConfigurationError(
            f"threshold_percentile must be in (0, 100], got {threshold_percentile}",
            suggestions=["Use a percentile like 90, 95, or 99 for extreme event detection"],
            context={"threshold_percentile": threshold_percentile},
        )

    if threshold_percentile < 60 and method_percentile == "approximate":
        raise ConfigurationError(
            f"Percentile threshold {threshold_percentile}% is not supported with method_percentile='approximate'",
            details="Low percentile thresholds (<60%) produce undefined behaviour with approximate histograms",
            suggestions=[
                "Use method_percentile='exact' for percentiles below 60%",
                "Use a higher percentile threshold (>=60%) with method_percentile='approximate'",
            ],
            context={
                "threshold_percentile": threshold_percentile,
                "method_percentile": method_percentile,
                "min_supported_percentile": 60,
            },
        )

    has_y_dim = "y" in dimensions and dimensions["y"] in da.dims
    if window_spatial_hobday is not None:
        if not has_y_dim:
            raise ConfigurationError(
                "window_spatial_hobday is not supported for unstructured grids",
                details="Spatial smoothing requires structured grids with both x and y dimensions",
                suggestions=[
                    "Remove the window_spatial_hobday parameter for unstructured grids",
                    "Use structured grid data if spatial smoothing is required",
                    "Set window_spatial_hobday=None to use default behavior",
                ],
                context={"grid_type": "unstructured", "window_spatial_hobday": window_spatial_hobday},
            )
        if method_extreme != "hobday_extreme":
            raise ConfigurationError(
                "window_spatial_hobday can only be used with method_extreme='hobday_extreme'",
                details="The window_spatial_hobday parameter is only implemented for the Hobday extreme method",
                suggestions=[
                    "Remove the window_spatial_hobday parameter when using method_extreme='global_extreme'",
                    "Use method_extreme='hobday_extreme' if spatial smoothing is required",
                ],
                context={"method_extreme": method_extreme, "window_spatial_hobday": window_spatial_hobday},
            )
        if method_percentile == "exact":
            raise ConfigurationError(
                "window_spatial_hobday is not supported with method_percentile='exact'",
                details="The window_spatial_hobday parameter is only implemented for the approximate percentile method",
                suggestions=[
                    "Remove the window_spatial_hobday parameter when using method_percentile='exact'",
                    "Use method_percentile='approximate' if spatial smoothing is required",
                ],
                context={"method_percentile": method_percentile, "window_spatial_hobday": window_spatial_hobday},
            )

    if method_extreme == "hobday_extreme" and window_days_hobday is not None and window_days_hobday % 2 == 0:
        raise ConfigurationError(
            "window_days_hobday must be an odd number",
            details=f"window_days_hobday={window_days_hobday} is even, which would create asymmetric temporal windows.",
            suggestions=[f"Use window_days_hobday={window_days_hobday + 1} or {window_days_hobday - 1}", "Choose an odd number"],
            context={"window_days_hobday": window_days_hobday, "is_odd": False},
        )

    if method_extreme == "hobday_extreme" and window_spatial_hobday is None and has_y_dim:
        window_spatial_hobday = 5

    if method_extreme == "hobday_extreme" and window_spatial_hobday is not None and window_spatial_hobday % 2 == 0:
        raise ConfigurationError(
            "window_spatial_hobday must be an odd number",
            details=f"window_spatial_hobday={window_spatial_hobday} is even, which would create asymmetric spatial windows.",
            suggestions=["Choose an odd number."],
            context={"window_spatial_hobday": window_spatial_hobday, "is_odd": False},
        )

    if method_extreme == "global_extreme":
        return _identify_extremes_constant(da, threshold_percentile, method_percentile, dimensions, coordinates, precision, max_anomaly)
    elif method_extreme == "hobday_extreme":
        return _identify_extremes_hobday(
            da,
            threshold_percentile,
            window_days_hobday,
            window_spatial_hobday,
            method_percentile,
            dimensions,
            coordinates,
            precision,
            max_anomaly,
        )
    else:
        raise ConfigurationError(
            f"Unknown extreme method '{method_extreme}'",
            details="Invalid method_extreme parameter",
            suggestions=[
                "Use 'global_extreme' for efficient constant percentile threshold",
                "Use 'hobday_extreme' for day-of-year specific thresholds",
            ],
            context={"provided_method": method_extreme, "valid_methods": ["global_extreme", "hobday_extreme"]},
        )


def _warn_threshold_bounds(pre_min: float, pre_max: float, bin_edges: np.ndarray, max_anomaly: float) -> None:
    """Warn on out-of-range thresholds (the clamp itself happens on device,
    detect.py:2707-2732)."""
    upper_bound = float(bin_edges[-2])
    lower_bound = float(bin_edges[3])
    if np.isfinite(pre_max) and pre_max > upper_bound:
        warnings.warn(
            f"Quantile values exceed expected range: max={pre_max:.4f} > {upper_bound:.4f}. "
            f"Consider increasing max_anomaly parameter (currently {max_anomaly:.2f}) or using a lower percentile threshold.",
            UserWarning,
            stacklevel=2,
        )
    if np.isfinite(pre_min) and pre_min < lower_bound:
        warnings.warn(
            f"Quantile values below expected range in some locations: min={pre_min:.4f} < {lower_bound:.4f}. "
            "This is likely due to a constant anomaly in certain regions (e.g. due to sea ice). "
            "Double check the computed threshold values are correct.",
            UserWarning,
            stacklevel=2,
        )


def _identify_extremes_hobday(
    da: Field,
    threshold_percentile: float,
    window_days_hobday: int,
    window_spatial_hobday: Optional[int],
    method_percentile: str,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    precision: float,
    max_anomaly: float,
) -> Tuple[Field, Field]:
    """Day-of-year thresholds + comparison (cf. detect.py:1858-2023)."""
    staged = _Staged(da, dimensions, coordinates)
    q = threshold_percentile / 100.0

    n_years = len(np.unique(staged.tinfo.year))
    n_samples = n_years * window_days_hobday * (window_spatial_hobday if window_spatial_hobday is not None else 1) ** 2
    n_above = n_samples * (1.0 - q)
    if n_above < 50:
        logger.warning(
            f"Not enough samples for accurate extreme detection: {n_above} < 50. "
            "Consider using a lower threshold_percentile, increasing your time-series size, "
            "increasing the window_days_hobday, or using a larger window_spatial_hobday."
        )

    bin_edges = _quant.make_bin_edges(precision, max_anomaly)
    nbins = len(bin_edges) - 1
    centers = jnp.asarray(_quant.make_bin_centers(bin_edges))
    grid_shape = staged.spatial_shape if staged.is_gridded else None
    exact = method_percentile == "exact"

    extremes_ts, thr, pre_min, pre_max = _pipe.hobday_program(
        staged.data,
        jnp.asarray(staged.tinfo.year_index),
        jnp.asarray(staged.tinfo.dayofyear - 1),
        q,
        precision,
        centers,
        float(bin_edges[3]),
        nbins,
        staged.tinfo.n_years,
        window_days_hobday,
        window_spatial_hobday,
        grid_shape,
        True,
        exact,
    )
    if not exact:
        _warn_threshold_bounds(float(pre_min), float(pre_max), bin_edges, max_anomaly)

    dims = (staged.timedim,) + staged.spatial_dims
    extremes = Field(
        _device_reshape(extremes_ts, (extremes_ts.shape[0],) + staged.spatial_shape),
        dims,
        staged.field.coords,
        name="extreme_events",
    )
    thr_field = Field(
        _device_reshape(thr, (366,) + staged.spatial_shape),
        ("dayofyear",) + staged.spatial_dims,
        {**staged.spatial_coords(), "dayofyear": Coord("dayofyear", np.arange(1, 367))},
        name="thresholds",
    )
    return extremes, thr_field


def _identify_extremes_constant(
    da: Field,
    threshold_percentile: float,
    method_percentile: str,
    dimensions: Dict[str, str],
    coordinates: Dict[str, str],
    precision: float,
    max_anomaly: float,
) -> Tuple[Field, Field]:
    """Global-in-time threshold per spatial point (cf. detect.py:2737-2923)."""
    staged = _Staged(da, dimensions, coordinates, prefer_flat=False)
    q = threshold_percentile / 100.0

    bin_edges = _quant.make_bin_edges(precision, max_anomaly)
    nbins = len(bin_edges) - 1
    centers = jnp.asarray(_quant.make_bin_centers(bin_edges))
    exact = method_percentile == "exact"

    extremes_ts, thr, pre_min, pre_max = _pipe.global_extreme_program(
        staged.data, q, precision, centers, float(bin_edges[3]), nbins, exact
    )
    if not exact:
        _warn_threshold_bounds(float(pre_min), float(pre_max), bin_edges, max_anomaly)

    dims = (staged.timedim,) + staged.spatial_dims
    extremes = Field(
        _device_reshape(extremes_ts, (extremes_ts.shape[0],) + staged.spatial_shape),
        dims,
        staged.field.coords,
        name="extreme_events",
    )
    thr_field = Field(
        _device_reshape(thr, staged.spatial_shape),
        staged.spatial_dims,
        staged.spatial_coords(),
        name="thresholds",
    )
    return extremes, thr_field
