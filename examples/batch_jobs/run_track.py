"""Batch track job (role-equivalent of the reference's batch run_track.py).

Production parameter set mirrors the reference submit_track.sh defaults:
R_fill=12, T_fill=4, area_filter_absolute=600, overlap=0.25, 0.25-deg areas.
MAREX_MESH=1 shards the tracking over every visible device.
"""

import os

import marex_tpu as marEx
from marex_tpu.io import open_zarr, to_zarr

marEx.helper.start_local_cluster()

extremes = open_zarr(os.environ.get("MAREX_INPUT", "extremes.zarr"))

tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=int(os.environ.get("MAREX_R_FILL", "12")),
    T_fill=int(os.environ.get("MAREX_T_FILL", "4")),
    area_filter_absolute=int(os.environ.get("MAREX_AREA_FILTER", "600")),
    overlap_threshold=float(os.environ.get("MAREX_OVERLAP", "0.25")),
    grid_resolution=float(os.environ.get("MAREX_GRID_RES", "0.25")),
    allow_merging=True,
    nn_partitioning=True,
    quiet=bool(os.environ.get("MAREX_QUIET")),
    mesh=True if os.environ.get("MAREX_MESH") == "1" else None,
)
events, merges = tr.run(return_merges=True)

to_zarr(events, os.environ.get("MAREX_OUTPUT", "events.zarr"))
to_zarr(merges, os.environ.get("MAREX_MERGES", "merges.zarr"))
print("track complete:", events.attrs["N_events_final"], "events")
