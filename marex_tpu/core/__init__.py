"""Core array & calendar layer for marex_tpu."""

from .field import (
    Coord,
    Field,
    FieldSet,
    as_field,
    broadcast,
    concat,
    from_xarray,
    full_like,
    isfinite,
    ones_like,
    zeros_like,
)
from .timeaxis import (
    TimeIndexInfo,
    daily_times,
    decompose_time,
    doy_window_indices,
    gather_from_year_doy,
    scatter_to_year_doy,
)

__all__ = [
    "Coord",
    "Field",
    "FieldSet",
    "as_field",
    "broadcast",
    "concat",
    "from_xarray",
    "full_like",
    "isfinite",
    "ones_like",
    "zeros_like",
    "TimeIndexInfo",
    "daily_times",
    "decompose_time",
    "doy_window_indices",
    "gather_from_year_doy",
    "scatter_to_year_doy",
]
