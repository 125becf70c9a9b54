"""
Century-scale, larger-than-memory pipeline: zarr -> streamed detect ->
streamed tracking -> zarr.

The reference processes datasets far larger than RAM by keeping every stage
lazy over Dask chunks (README.md:161); MarEx-TPU streams the same pipeline
through bounded-memory tiles/blocks with bit-identical results. Neither
stage ever materialises the full dataset: host RSS and device memory are
bounded by the tile/block working set, so a 100-year 0.25-degree store
(~150 GB f32) runs on one GPU — duration only affects wall time.

Usage:
    python streamed_century.py /path/to/sst_century.zarr /path/to/output
"""

import os
import sys

import marex_tpu as marEx
from marex_tpu.io import zarr_lite


def main(sst_store: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    extremes_store = os.path.join(out_dir, "extremes.zarr")
    events_store = os.path.join(out_dir, "events.zarr")

    # ---- stage 1: streamed detect ---------------------------------------
    # Latitude-row tiles stream through the fused detect programs; outputs
    # are region-written into the extremes store. The production methods
    # (shifting_baseline + hobday_extreme) are bit-exact with the in-memory
    # path.
    ds = marEx.preprocess_data_streamed(
        sst_store,
        extremes_store,
        method_anomaly="shifting_baseline",
        method_extreme="hobday_extreme",
        threshold_percentile=95,
        window_year_baseline=15,
        smooth_days_baseline=21,
        window_days_hobday=11,
        memory_budget_mb=4096,
    )

    # ---- stage 2: streamed tracking --------------------------------------
    # A lazy zarr-backed Field feeds the tracker; run_streamed() streams
    # morphology, area filtering, the blockwise scan march and the event
    # relabeling over time blocks, region-writing ID_field into the events
    # store (production parameters: submit_track.sh:20-28).
    lazy = zarr_lite.open_zarr(extremes_store, lazy=True)
    tracker = marEx.tracker(
        lazy["extreme_events"],
        ds.mask,
        R_fill=12,
        T_fill=4,
        area_filter_absolute=600,
        allow_merging=True,
        nn_partitioning=True,
        overlap_threshold=0.25,
        grid_resolution=0.25,
    )
    events, merges = tracker.run_streamed(
        events_store, memory_budget_mb=4096, return_merges=True
    )

    print(
        f"events: {events.attrs['N_events_final']}, "
        f"merges: {events.attrs['total_merges']}, "
        f"ID_field -> {events_store}"
    )


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
