"""
MarEx-TPU streamed detect: larger-than-memory preprocessing.

The reference's headline scalability claim is lazy, chunked execution over
datasets "100-1000x larger than available RAM" (``/root/reference/README.md:161``,
``docs/why_marex.rst:153``): every op runs over Dask chunks
(``detect.py:1944-1953``) and the histogram path re-chunks to small spatial
tiles with the full time axis (``detect.py:2617-2631``).

This module is the device counterpart: the input zarr store is opened
LAZILY (:class:`~marex_tpu.io.zarr_lite.LazyZarrArray`), latitude-row tiles
(with hobday spatial-window halos) stream through the exact same fused XLA
detect programs used by :func:`marex_tpu.detect.preprocess_data`, and each
tile's outputs are region-written straight into a chunked output zarr store.
Host RSS and HBM stay bounded by the tile working set — dataset size only
affects wall time.

Numerically the streamed path is BIT-EXACT with the monolithic path for the
climatology anomaly methods (``fixed_baseline``, ``shifting_baseline``) and
both percentile paths: all reductions are pointwise over space, and the
hobday spatial window is carried across tile seams by real halo rows
(NaN-padded beyond the physical domain, which digitizes to the sentinel bin
— precisely the padding ``ops.quantile.hobday_thresholds_approx`` uses for
its own internal tiles). The ``detrend_*`` methods match to float32
round-off (~1e-7 relative): their lstsq/pinv matmuls tile differently at
tile width than at full width, so XLA's reduction order differs.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np

from .core.field import Coord, Field, FieldSet
from .detect import (
    _get_preprocessing_steps,
    _infer_dims_coords,
    _validate_data_values,
    compute_normalised_anomaly,
    identify_extremes,
)
from .core.timeaxis import decompose_time
from .exceptions import ConfigurationError, create_data_validation_error
from .io import zarr_lite
from .logging_config import get_logger, log_timing

logger = get_logger(__name__)


def _resolve_input(data: Any, var: Optional[str]) -> Field:
    """Accept a zarr path (opened lazily), FieldSet, or Field."""
    if isinstance(data, str):
        if not os.path.isdir(data):
            raise create_data_validation_error(
                f"Not a zarr store: {data}",
                suggestions=["Pass a path to a directory-style zarr v2 store, a Field, or a FieldSet"],
            )
        data = zarr_lite.open_zarr(data, lazy=True)
    if isinstance(data, FieldSet):
        if var is None:
            big = [n for n, f in data.data_vars.items() if f.ndim >= 2]
            if len(big) != 1:
                raise ConfigurationError(
                    "Cannot infer the data variable for streamed preprocessing",
                    details=f"Store has {len(big)} multi-dimensional variables: {big}",
                    suggestions=["Pass var='<name>' to select the variable to process"],
                )
            var = big[0]
        return data.data_vars[var]
    if isinstance(data, Field):
        return data
    raise create_data_validation_error(
        f"Unsupported input type for streamed preprocessing: {type(data)!r}",
        suggestions=["Pass a zarr store path, a marex_tpu FieldSet, or a Field"],
    )


def _auto_row_block(T: int, ny: int, nx: int, memory_budget_mb: int) -> int:
    """Tile height from the working-set budget: the device pipeline holds
    roughly 6 copies of the (T, rows, nx) f32 tile (payload, (Y,366,S)
    scatter, anomalies, bins, extremes+thresholds, slack)."""
    budget = memory_budget_mb * 2**20
    row_bytes = T * nx * 4
    rows = max(1, budget // (row_bytes * 6))
    return int(min(rows, ny))


def preprocess_data_streamed(
    data: Any,
    out_path: str,
    var: Optional[str] = None,
    row_block: Optional[int] = None,
    memory_budget_mb: int = 1024,
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
    dimensions: Optional[Dict[str, str]] = None,
    coordinates: Optional[Dict[str, str]] = None,
    neighbours: Optional[Any] = None,
    cell_areas: Optional[Any] = None,
    compressor: Optional[str] = "zlib",
) -> FieldSet:
    """
    Streamed :func:`~marex_tpu.detect.preprocess_data`: identical parameters
    and numerics, but the input is read in latitude-row tiles (cell-range
    tiles for unstructured data) and the outputs are region-written to
    ``out_path`` as they are produced, so datasets far larger than host RAM
    or HBM process in bounded memory (the reference's larger-than-memory
    capability, README.md:161 / detect.py:794-830).

    Parameters beyond :func:`preprocess_data`:

    data : zarr store path (opened lazily), FieldSet, or Field
    out_path : output zarr store (created/overwritten)
    var : data variable name when ``data`` is a store with several
    row_block : tile height in grid rows (cells when unstructured); default
        sized so the tile working set fits ``memory_budget_mb``
    compressor : 'zlib' (default) or None (raw chunks, fastest)

    Returns the output store opened lazily (``FieldSet`` of
    ``LazyZarrArray``-backed fields).
    """
    if detrend_orders is None:
        detrend_orders = [1]

    da = _resolve_input(data, var)
    dimensions, coordinates = _infer_dims_coords(da, dimensions, coordinates)
    timedim = dimensions["time"]
    xdim = dimensions["x"]
    ydim = dimensions.get("y")
    is_gridded = ydim is not None and ydim in da.dims

    order = (timedim, ydim, xdim) if is_gridded else (timedim, xdim)
    if tuple(da.dims) != order:
        raise create_data_validation_error(
            "Streamed preprocessing requires time-major input layout",
            details=f"Expected dimension order {order}, found {tuple(da.dims)}",
            suggestions=[
                "Store the input with dimensions ordered (time, y, x) / (time, cell)",
                "Use marEx.preprocess_data for in-memory data in any order",
            ],
        )

    payload = da.data
    T = int(payload.shape[0])
    if is_gridded:
        ny, nx = int(payload.shape[1]), int(payload.shape[2])
    else:
        ny, nx = int(payload.shape[1]), 1  # cells tile like rows with nx=1

    # ---- resolve the effective hobday spatial window & halo ----------------
    eff_spatial = window_spatial_hobday
    if method_extreme == "hobday_extreme" and eff_spatial is None and is_gridded and method_percentile != "exact":
        eff_spatial = 5  # identify_extremes' default (detect.py:1450-1452)
    halo = (eff_spatial // 2) if (is_gridded and eff_spatial is not None and eff_spatial > 1) else 0

    if row_block is None:
        row_block = _auto_row_block(T, ny, nx, memory_budget_mb)
    row_block = int(max(1, min(row_block, ny)))
    n_tiles = -(-ny // row_block)

    logger.info(
        f"Streamed preprocessing: {n_tiles} tiles of {row_block} rows (+{halo} halo) over "
        f"({T}, {ny}{', ' + str(nx) if is_gridded else ''}) - {method_anomaly} -> {method_extreme}"
    )

    # ---- time handling (trim for shifting_baseline) ------------------------
    time_vals = np.asarray(da.coords[coordinates["time"]].values)
    tinfo = decompose_time(time_vals)
    if method_anomaly == "shifting_baseline":
        total_years = int(tinfo.year.max() - tinfo.year.min() + 1)
        if total_years < window_year_baseline:
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=f"Dataset spans {total_years} years but requires at least {window_year_baseline} years",
                suggestions=[
                    "Use more years of data to meet minimum requirement",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline)},
            )
        start_year = int(tinfo.year.min() + window_year_baseline)
        keep_t = np.nonzero(tinfo.year >= start_year)[0]
        if keep_t.size == 0:
            # equality case (total_years == window): trimming would leave an
            # empty output store — fail loudly, mirroring detect.py
            raise create_data_validation_error(
                "Insufficient data for shifting_baseline method",
                details=(
                    f"Removing the first {window_year_baseline} baseline years "
                    f"leaves no timesteps (dataset spans {total_years} years)"
                ),
                suggestions=[
                    "Use more years of data (at least window_year_baseline + 1)",
                    f"Reduce window_year_baseline parameter (currently {window_year_baseline})",
                ],
                data_info={"available_years": total_years, "required_years": int(window_year_baseline) + 1},
            )
    else:
        keep_t = np.arange(T)
    T_out = int(len(keep_t))
    time_out = time_vals[keep_t]

    if reference_period is not None and method_anomaly not in ("fixed_baseline", "detrend_fixed_baseline"):
        raise ConfigurationError(
            f"reference_period is not supported for method_anomaly='{method_anomaly}'",
            details="reference_period is only applicable to 'fixed_baseline' and 'detrend_fixed_baseline' methods",
            suggestions=[
                "Remove the reference_period parameter, or",
                "Use method_anomaly='fixed_baseline' or 'detrend_fixed_baseline'",
            ],
        )

    # ---- create the output store layout ------------------------------------
    sdims = (ydim, xdim) if is_gridded else (xdim,)
    sshape = (ny, nx) if is_gridded else (ny,)
    t_chunk = int(min(T_out, 366))
    row_chunk = row_block

    def _schunks(lead: Tuple[int, ...]) -> Tuple[int, ...]:
        return lead + ((row_chunk, nx) if is_gridded else (row_chunk,))

    zarr_lite.create_group(out_path, mode="w")
    zarr_lite.create_array(out_path, "dat_anomaly", (T_out,) + sshape, np.float32, (timedim,) + sdims, _schunks((t_chunk,)), compressor=compressor)
    zarr_lite.create_array(out_path, "extreme_events", (T_out,) + sshape, bool, (timedim,) + sdims, _schunks((t_chunk,)), compressor=compressor)
    zarr_lite.create_array(out_path, "mask", sshape, bool, sdims, _schunks(()), compressor=compressor)
    thr_has_doy = method_extreme == "hobday_extreme"
    thr_dims = (("dayofyear",) + sdims) if thr_has_doy else sdims
    thr_shape = ((366,) + sshape) if thr_has_doy else sshape
    zarr_lite.create_array(out_path, "thresholds", thr_shape, np.float32, thr_dims, _schunks((366,)) if thr_has_doy else _schunks(()), compressor=compressor)
    want_stn = std_normalise and method_anomaly == "detrend_harmonic"
    if want_stn:
        zarr_lite.create_array(out_path, "dat_stn", (T_out,) + sshape, np.float32, (timedim,) + sdims, _schunks((t_chunk,)), compressor=compressor)
        zarr_lite.create_array(out_path, "STD", (366,) + sshape, np.float32, ("dayofyear",) + sdims, _schunks((366,)), compressor=compressor)
        zarr_lite.create_array(out_path, "extreme_events_stn", (T_out,) + sshape, bool, (timedim,) + sdims, _schunks((t_chunk,)), compressor=compressor)
        zarr_lite.create_array(out_path, "thresholds_stn", thr_shape, np.float32, thr_dims, _schunks((366,)) if thr_has_doy else _schunks(()), compressor=compressor)

    # coords (eager, small)
    zarr_lite._write_array(out_path, coordinates["time"], time_out, (timedim,), {})
    for cname, coord in da.coords.items():
        if cname == coordinates["time"]:
            continue
        if set(coord.dims) <= set(sdims):
            zarr_lite._write_array(out_path, cname, np.asarray(coord.values), tuple(coord.dims), {})
    if thr_has_doy:
        zarr_lite._write_array(out_path, "dayofyear", np.arange(1, 367), ("dayofyear",), {})
    if neighbours is not None:
        nb = neighbours if isinstance(neighbours, Field) else Field(np.asarray(neighbours), ("nv", xdim))
        zarr_lite._write_array(out_path, "neighbours", np.asarray(nb.values, np.int32), tuple(nb.dims), {})
    if cell_areas is not None:
        ca = cell_areas if isinstance(cell_areas, Field) else Field(np.asarray(cell_areas), sdims)
        zarr_lite._write_array(out_path, "cell_areas", np.asarray(ca.values, np.float32), tuple(ca.dims), {})

    # lat coords for a padded tile (values are irrelevant to the numerics;
    # only the time coord feeds the programs)
    lat_vals = (
        np.asarray(da.coords[coordinates["y"]].values, np.float64)
        if is_gridded and coordinates.get("y") in da.coords and da.coords[coordinates["y"]].dims == (ydim,)
        else np.arange(ny, dtype=np.float64)
    )

    rows_tile = row_block + 2 * halo
    seen_warnings: set = set()
    detect_logger = logging.getLogger("marex_tpu.detect")

    # ---- tile loop ---------------------------------------------------------
    for ti in range(n_tiles):
        r0 = ti * row_block
        r1 = min(r0 + row_block, ny)
        c0 = max(0, r0 - halo)
        c1 = min(ny, r1 + halo)

        with log_timing(logger, f"Streamed tile {ti + 1}/{n_tiles} rows [{r0}:{r1})"):
            if is_gridded:
                tile = np.full((T, rows_tile, nx), np.nan, np.float32)
                off = c0 - (r0 - halo)
                tile[:, off : off + (c1 - c0), :] = np.asarray(payload[:, c0:c1, :], dtype=np.float32)
                tile_lat = np.arange(r0 - halo, r0 - halo + rows_tile, dtype=np.float64)
                inb = (tile_lat >= 0) & (tile_lat < ny)
                lat_pad = np.interp(tile_lat, np.arange(ny), lat_vals)  # clamped extrapolation is fine
                lat_pad[inb] = lat_vals[tile_lat[inb].astype(int)]
                tile_coords: Dict[str, Any] = {
                    coordinates["time"]: Coord(timedim, time_vals),
                    coordinates.get("y", "lat"): Coord(ydim, lat_pad),
                }
                if coordinates.get("x") in da.coords:
                    xc = da.coords[coordinates["x"]]
                    if xc.dims == (xdim,):
                        tile_coords[coordinates["x"]] = Coord(xdim, np.asarray(xc.values))
                tile_field = Field(tile, (timedim, ydim, xdim), tile_coords, name=da.name)
            else:
                tile = np.full((T, rows_tile), np.nan, np.float32)
                tile[:, : (c1 - c0)] = np.asarray(payload[:, c0:c1], dtype=np.float32)
                tile_coords = {coordinates["time"]: Coord(timedim, time_vals)}
                for ck in ("x", "y"):
                    cname = coordinates.get(ck)
                    if cname and cname in da.coords and da.coords[cname].dims == (xdim,):
                        cv = np.zeros(rows_tile, np.float32)
                        cv[: (c1 - c0)] = np.asarray(da.coords[cname].values)[c0:c1]
                        tile_coords[cname] = Coord(xdim, cv)
                tile_field = Field(tile, (timedim, xdim), tile_coords, name=da.name)

            if not np.isfinite(tile[0]).any():
                # all-land tile (or pure padding): the monolithic path yields
                # NaN anomalies/thresholds and False extremes here
                sh_t = (T_out, r1 - r0, nx) if is_gridded else (T_out, r1 - r0)
                sh_s = (r1 - r0, nx) if is_gridded else (r1 - r0,)
                starts_t = (0, r0, 0) if is_gridded else (0, r0)
                starts_s = (r0, 0) if is_gridded else (r0,)
                zarr_lite.write_region(out_path, "dat_anomaly", starts_t, np.full(sh_t, np.nan, np.float32))
                zarr_lite.write_region(out_path, "extreme_events", starts_t, np.zeros(sh_t, bool))
                zarr_lite.write_region(out_path, "mask", starts_s, np.zeros(sh_s, bool))
                thr_block = np.full(((366,) + sh_s) if thr_has_doy else sh_s, np.nan, np.float32)
                zarr_lite.write_region(out_path, "thresholds", ((0,) + starts_s) if thr_has_doy else starts_s, thr_block)
                if want_stn:
                    zarr_lite.write_region(out_path, "dat_stn", starts_t, np.full(sh_t, np.nan, np.float32))
                    zarr_lite.write_region(out_path, "STD", (0,) + starts_s, np.full((366,) + sh_s, np.nan, np.float32))
                    zarr_lite.write_region(out_path, "extreme_events_stn", starts_t, np.zeros(sh_t, bool))
                    zarr_lite.write_region(out_path, "thresholds_stn", ((0,) + starts_s) if thr_has_doy else starts_s, thr_block)
                continue

            _validate_data_values(tile_field, dimensions)

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if ti > 0:
                    prev_level = detect_logger.level
                    detect_logger.setLevel(logging.ERROR)  # param warnings repeat identically per tile
                try:
                    ds_tile = compute_normalised_anomaly(
                        tile_field,
                        method_anomaly,
                        dimensions,
                        coordinates,
                        window_year_baseline,
                        smooth_days_baseline,
                        std_normalise,
                        detrend_orders,
                        force_zero_mean,
                        reference_period,
                    )
                    anom = ds_tile["dat_anomaly"]
                    if T_out != T:
                        anom = anom.isel({timedim: keep_t})
                    extremes, thresholds = identify_extremes(
                        anom,
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
                    if want_stn:
                        stn = ds_tile["dat_stn"]
                        if T_out != T:
                            stn = stn.isel({timedim: keep_t})
                        extremes_stn, thresholds_stn = identify_extremes(
                            stn,
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
                finally:
                    if ti > 0:
                        detect_logger.setLevel(prev_level)
            for w in caught:
                key = (w.category, str(w.message))
                if key not in seen_warnings:
                    seen_warnings.add(key)
                    warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)

            # ---- region-write the interior rows -------------------------
            int_lo, n_rows = halo, r1 - r0

            def _interior(arr: Any, lead_time: bool) -> np.ndarray:
                a = np.asarray(arr)
                if is_gridded:
                    return a[:, int_lo : int_lo + n_rows, :] if lead_time or a.ndim == 3 else a[int_lo : int_lo + n_rows, :]
                return a[:, int_lo - halo : int_lo - halo + n_rows] if lead_time or a.ndim == 2 else a[: n_rows]

            def _wr(name: str, arr: Any, lead: Tuple[int, ...]) -> None:
                block = _interior(arr, lead_time=bool(lead))
                starts = lead + ((r0, 0) if is_gridded else (r0,))
                zarr_lite.write_region(out_path, name, starts, block)

            _wr("dat_anomaly", anom.data, (0,))
            _wr("extreme_events", extremes.data, (0,))
            _wr("mask", ds_tile["mask"].values, ())
            _wr("thresholds", thresholds.data, (0,) if thr_has_doy else ())
            if want_stn:
                _wr("dat_stn", ds_tile["dat_stn"].data, (0,))
                _wr("STD", ds_tile["STD"].data, (0,))
                _wr("extreme_events_stn", extremes_stn.data, (0,))
                _wr("thresholds_stn", thresholds_stn.data, (0,) if thr_has_doy else ())
            del ds_tile, anom, extremes, thresholds, tile_field, tile

    # ---- group attrs (provenance parity with preprocess_data) --------------
    attrs: Dict[str, Any] = {
        "method_anomaly": method_anomaly,
        "method_extreme": method_extreme,
        "threshold_percentile": threshold_percentile,
        "method_percentile": method_percentile,
        "precision": precision,
        "max_anomaly": max_anomaly,
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
        "streamed": 1,
        "stream_row_block": row_block,
        "stream_n_tiles": n_tiles,
    }
    if method_anomaly == "detrend_harmonic":
        attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean, "std_normalise": std_normalise})
    elif method_anomaly == "shifting_baseline":
        attrs.update({"window_year_baseline": window_year_baseline, "smooth_days_baseline": smooth_days_baseline})
    elif method_anomaly in ("fixed_baseline", "detrend_fixed_baseline"):
        if method_anomaly == "detrend_fixed_baseline":
            attrs.update({"detrend_orders": detrend_orders, "force_zero_mean": force_zero_mean})
        if reference_period is not None:
            attrs["reference_period"] = list(reference_period)
    if method_extreme == "hobday_extreme":
        attrs["window_days_hobday"] = window_days_hobday
    zarr_lite.create_group(out_path, attrs, mode="a")

    logger.info(f"Streamed preprocessing complete: {n_tiles} tiles -> {out_path}")
    return zarr_lite.open_zarr(out_path, lazy=True)
