"""
MarEx-TPU streamed tracking: larger-than-memory merge/split event tracking.

The reference tracks century-scale datasets by keeping every stage lazy over
Dask chunks with zarr checkpoints between stages (``/root/reference/README.md:161``,
``marEx/track.py:1234-1368``, the zarr-region batched split/merge
``track.py:3804-4814``). This module is the device counterpart built on
the blockwise scan march (:func:`marex_tpu.ops.march.scan_march` with
``resume=``): the input binary-extremes zarr store streams through
morphology -> per-slice CCL -> area filtering -> the split/merge march ->
event relabeling in TIME BLOCKS, so host RSS and HBM are bounded by the
block working set while the results are bit-identical to the in-memory
tracker (pinned by tests/test_streaming.py).

Pipeline (mirrors tracker.run, track.py:1162-1232):

1. **Pass A (preprocess + label)** — stream blocks with a ``2*T_fill`` halo:
   spatial fill, temporal gap fill, per-slice CCL; write dense per-slice
   labels to a temp zarr; collect per-slice counts and object areas (small).
2. **Filter (host)** — replicate ``filter_small_objects`` semantics exactly
   (quartile/absolute threshold, the reference's drop-first-object quirk on
   grids, the unstructured ``>50``/``>5`` pre-filter) from the collected
   per-slice areas; build per-slice dense renumber maps.
3. **Pass B (march)** — stream label blocks through the resumable scan
   march: each block applies its renumber map on device, stages its initial
   object components into the carried table, prepends the previous block's
   final boundary slice, and runs ONE device program; final local labels
   stream to a second temp zarr.
4. **Epilogue** — the shared host epilogue (end-of-series consolidation,
   thresholded overlap list, object table, merge genealogy) and the
   overlap-graph union-find, exactly as in-memory.
5. **Pass C (relabel + stats)** — stream final label blocks through
   local->global map + event lookup; write ``ID_field`` region-wise to the
   output zarr; accumulate the per-(time, event) tables (global_ID, area,
   centroid, presence) blockwise.

Only ``allow_merging=True`` runs are streamed (the production configuration);
no-merge runs use the in-memory two-level CCL or mesh time-sharding.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .core.field import Coord, Field, FieldSet
from .exceptions import ConfigurationError
from .io import zarr_lite
from .logging_config import get_logger, log_timing
from .ops import march as _march
from .ops import properties as _props

logger = get_logger(__name__)


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def run_tracking_streamed(
    tr,
    out_path: str,
    memory_budget_mb: int = 4096,
    block_T: Optional[int] = None,
    return_merges: bool = False,
    keep_temp: bool = False,
):
    """
    Stream the full tracking pipeline of ``tr`` (a configured
    :class:`marex_tpu.track.tracker`, whose ``data_bin`` may be backed by a
    lazy zarr array) into ``out_path``. Returns the same
    ``events_ds[, merges_ds]`` as :meth:`tracker.run`, with ``ID_field``
    lazily backed by the output store.
    """
    import jax.numpy as jnp

    from . import track as _trackmod

    if not tr.allow_merging:
        raise ConfigurationError(
            "Streamed tracking covers merge/split-aware runs (allow_merging=True)",
            details="No-merge tracking labels events with the two-level 3-D CCL, which has its own memory tiling",
            suggestions=[
                "Set allow_merging=True (the production configuration)",
                "For no-merge runs, use tracker.run() — its CCL already tiles over time blocks",
            ],
        )

    T = tr.data_bin.sizes[tr.timedim]
    sdims = tr._spatial_dims()
    sshape = tuple(tr.data_bin.sizes[d] for d in sdims)
    S = int(np.prod(sshape))
    unstr = tr.unstructured_grid
    wrap = (not tr.regional_mode) and not unstr
    W = sshape[-1] if not unstr else S

    if block_T is None:
        per_slice = S * 24  # bool input + int32 labels + fused temporaries
        block_T = int(max(8, min(T, (memory_budget_mb * 2**20) // max(per_slice, 1))))
    halo = 2 * int(tr.T_fill)
    logger.info(f"Streamed tracking: T={T}, block_T={block_T}, halo={halo}, spatial={sshape}")

    if tr.temp_dir:
        os.makedirs(tr.temp_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="marex_trkstream_", dir=tr.temp_dir or None)
    lab_store = os.path.join(tmp, "labels_local.zarr")
    fin_store = os.path.join(tmp, "labels_final.zarr")
    for store in (lab_store, fin_store):
        zarr_lite.create_group(store)
        zarr_lite.create_array(
            store, "labels", (T,) + sshape, np.int32, (tr.timedim,) + sdims,
            chunks=(block_T,) + sshape, compressor="zlib",
        )

    src = tr.data_bin.data

    # ---- Pass A: morphology + per-slice CCL + per-object areas -----------
    counts_old = np.zeros(T, np.int64)
    areas_per_slice: list = [None] * T
    total_raw = 0.0
    with log_timing(logger, "Streamed preprocess + per-slice labeling", log_memory=True):
        for s0 in range(0, T, block_T):
            s1 = min(s0 + block_T, T)
            e0, e1 = max(0, s0 - halo), min(T, s1 + halo)
            raw = np.asarray(src[e0:e1])
            dev = jnp.asarray(raw.astype(bool))
            total_raw += float(tr.compute_area(dev[s0 - e0 : s1 - e0]).sum())
            filled = tr.fill_holes(dev)
            closed = tr.fill_time_gaps(filled)
            interior = closed[s0 - e0 : s1 - e0]
            labels_b, counts_b = tr._label_slices(interior)
            counts_old[s0:s1] = counts_b
            Lb = int(counts_b.max()) if counts_b.size else 0
            if Lb:
                flat = labels_b.reshape(s1 - s0, -1)
                ones = jnp.ones((flat.shape[1],), jnp.float32)
                areas_tl = np.asarray(_props.label_sums(flat, ones, Lb))
            for t in range(s0, s1):
                n = int(counts_old[t])
                areas_per_slice[t] = areas_tl[t - s0, 1 : n + 1].copy() if n else np.empty(0, np.float32)
            zarr_lite.write_region(lab_store, "labels", (s0,) + (0,) * len(sshape), np.asarray(labels_b))
            del labels_b, dev, filled, closed, interior

    # ---- Filter (host): exact filter_small_objects semantics -------------
    object_areas = np.concatenate([a for a in areas_per_slice]) if T else np.empty(0)
    if object_areas.size == 0:
        raise _trackmod.TrackingError(
            "No objects found for area-based filtering",
            details={"objects_count": 0, "area_filter_quartile": tr.area_filter_quartile},
            suggestions=["Check if input data contains any extreme events"],
        )
    if unstr:
        # generic unstructured branch (track.py filter_small_objects)
        min_sz = 5 if tr._use_absolute_filtering else 50
        object_areas_f = object_areas[object_areas > min_sz]
        if len(object_areas_f) == 0:
            raise _trackmod.TrackingError(
                "No objects found for area-based filtering",
                details={"objects_count": 0, "grid_type": "unstructured"},
                suggestions=["Check if input data contains any extreme events"],
            )
        N_prefiltered = int(len(object_areas_f))
        if tr._use_absolute_filtering:
            area_threshold = float(tr.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas_f, tr.area_filter_quartile * 100))
        N_filtered = int(np.sum(object_areas_f > area_threshold))
        keep_per_slice = [a > area_threshold for a in areas_per_slice]
        stats_areas = object_areas_f
    else:
        # grid roots branch incl. the reference's drop-first-object quirk
        N_prefiltered = int(object_areas.size)
        if tr._use_absolute_filtering:
            area_threshold = float(tr.area_filter_absolute)
        else:
            area_threshold = float(np.percentile(object_areas, tr.area_filter_quartile * 100.0))
        keep_per_slice = [a >= area_threshold for a in areas_per_slice]
        t_first = int(np.argmax(counts_old > 0)) if (counts_old > 0).any() else -1
        if t_first >= 0 and len(keep_per_slice[t_first]):
            keep_per_slice[t_first] = keep_per_slice[t_first].copy()
            keep_per_slice[t_first][0] = False
        N_filtered = int(sum(int(k.sum()) for k in keep_per_slice))
        stats_areas = object_areas

    counts_new = np.array([int(k.sum()) for k in keep_per_slice], np.int64)
    offsets_new = np.concatenate([[0], np.cumsum(counts_new)[:-1]]).astype(np.int64)
    total_new = int(counts_new.sum())
    Lmax_old = int(counts_old.max()) if counts_old.size else 0
    Lmax_new = int(counts_new.max()) if counts_new.size else 0

    def _remap_rows(s0: int, s1: int) -> np.ndarray:
        """Per-slice old-dense -> new-dense renumber rows for one block
        (0 = dropped/background) — built per block so the (T, Lmax) table
        never materialises at century scale."""
        rows = np.zeros((s1 - s0, Lmax_old + 1), np.int32)
        for t in range(s0, s1):
            k = keep_per_slice[t]
            if len(k):
                rows[t - s0, 1 : len(k) + 1] = np.where(k, np.cumsum(k), 0)
        return rows

    accepted_area = float(stats_areas[stats_areas > area_threshold].sum())
    total_area_IDed = float(stats_areas.sum())
    accepted_area_fraction = accepted_area / total_area_IDed if total_area_IDed else 0.0

    # ---- Pass B: blockwise scan march -------------------------------------
    import jax

    @jax.jit
    def _remap_block(lab, rows):
        flat = lab.reshape(lab.shape[0], -1)
        out = jax.vmap(lambda row, lf: row[jnp.clip(lf, 0, rows.shape[1] - 1)])(rows, flat)
        return out.reshape(lab.shape)

    def _stage_rows(comps, alive, ids, rows):
        comps = comps.at[ids].set(rows, mode="drop")
        alive = alive.at[ids].set(True, mode="drop")
        return comps, alive

    _stage_rows = jax.jit(_stage_rows, donate_argnums=(0, 1))

    mode = "unstr" if unstr else "grid"
    mesh_data = (
        (
            jnp.asarray(tr.neighbours_int),
            jnp.asarray(tr.lat.astype(np.float32)),
            jnp.asarray(tr.lon.astype(np.float32)),
            jnp.asarray(tr.cell_area),
            jnp.float32(tr.mean_cell_area),
        )
        if unstr
        else None
    )
    sizes = dict(
        L=max(_pow2(2 * Lmax_new + 16), 32),
        MP=min(max(_pow2(4 * Lmax_new), 128), 2048),
        K=8,
        P=_trackmod.MAX_PARENTS,
        NID=_pow2(2 * total_new + 1024),
        MAXC=128,
        MAXM=4096,
        MAXWIN=(_pow2(int(sshape[-1])) if unstr else min(128, sshape[0])) if tr.nn_partitioning else 8,
        LN=32,
        # partition row band (see track.py): child latitude band only
        HC=64 if (not unstr and sshape[0] >= 160) else 0,
    )
    lab_lazy = zarr_lite.LazyZarrArray(os.path.join(lab_store, "labels"))

    def _comps_for(lab_new, Lb):
        if unstr:
            c4 = _props.unstructured_label_comps(
                lab_new, mesh_data[1], mesh_data[2], mesh_data[3], Lb
            )
            return jnp.pad(c4, ((0, 0), (0, 0), (0, 2)))
        return _props.grid_label_comps(lab_new, Lb)

    out = None
    total_processed = 0.0
    with log_timing(logger, "Streamed split/merge march", log_memory=True):
        for attempt in range(7):
            L = sizes["L"]
            NID = sizes["NID"]
            MPc = sizes["MP"]
            msizes = _march.MarchSizes(**sizes)
            gmap_host = np.zeros((T, L + 2), np.int32)
            for t in range(T):
                n = int(counts_new[t])
                if n:
                    g0 = int(offsets_new[t]) + 1
                    gmap_host[t, 1 : n + 1] = np.arange(g0, g0 + n, dtype=np.int32)
            pga_h = np.full((T, MPc), -1, np.int32)
            pgb_h = np.full((T, MPc), -1, np.int32)
            pgw_h = np.zeros((T, MPc), np.float32)
            comps_dev = jnp.zeros((NID, 6), jnp.float32)
            alive_dev = jnp.zeros((NID,), bool)
            resume = None
            flags = 0
            total_processed = 0.0
            s0 = 0
            while s0 < T:
                s1 = min(s0 + block_T, T)
                ext0 = s0 if s0 == 0 else s0 - 1
                lab_old = jnp.asarray(np.asarray(lab_lazy[s0:s1]))
                rows_dev = jnp.asarray(_remap_rows(s0, s1))
                lab_new = _remap_block(lab_old, rows_dev)
                total_processed += float(tr.compute_area(lab_new > 0).sum())
                # stage this block's initial object rows into the carried table
                Lb = max(int(counts_new[s0:s1].max()), 1)
                comps_blk = np.asarray(_comps_for(lab_new, Lb))
                n_rows = int(counts_new[s0:s1].sum())
                ids_pad = np.full(max(_pow2(max(n_rows, 1)), 8), NID, np.int64)
                rows_pad = np.zeros((len(ids_pad), 6), np.float32)
                j = 0
                for t in range(s0, s1):
                    n = int(counts_new[t])
                    if n:
                        g0 = int(offsets_new[t]) + 1
                        ids_pad[j : j + n] = np.arange(g0, g0 + n)
                        rows_pad[j : j + n] = comps_blk[t - s0, 1 : n + 1]
                        j += n
                comps_dev, alive_dev = _stage_rows(
                    comps_dev, alive_dev, jnp.asarray(ids_pad), jnp.asarray(rows_pad)
                )
                if s0 == 0:
                    labels_ext = lab_new
                else:
                    labels_ext = jnp.concatenate([out["labels"][-1:].reshape((1,) + lab_new.shape[1:]), lab_new])
                shp = (labels_ext.shape[0], 1, S) if unstr else labels_ext.shape
                out = _march.scan_march(
                    labels_ext.reshape(shp),
                    jnp.asarray(counts_new[ext0:s1].astype(np.int32)),
                    jnp.asarray(gmap_host[ext0:s1]),
                    comps_dev,
                    alive_dev,
                    resume["next_new"] if resume is not None else jnp.int32(total_new + 1),
                    jnp.float32(tr.overlap_threshold),
                    msizes,
                    bool(tr.nn_partitioning),
                    wrap,
                    mode=mode,
                    mesh=mesh_data,
                    resume=(dict(resume, comps=comps_dev, alive=alive_dev) if resume is not None else None),
                    t0=ext0,
                )
                tr._count_dispatch("march_scan")
                flags = int(out["flags"])
                if flags:
                    break
                gmap_host[ext0:s1] = np.asarray(out["gmap"])
                pga_h[ext0:s1] = np.asarray(out["pga"])
                pgb_h[ext0:s1] = np.asarray(out["pgb"])
                pgw_h[ext0:s1] = np.asarray(out["pgw"])
                fin = out["labels"] if s0 == 0 else out["labels"][1:]
                zarr_lite.write_region(
                    fin_store, "labels", (s0,) + (0,) * len(sshape),
                    np.asarray(fin, dtype=np.int32).reshape((s1 - s0,) + sshape),
                )
                comps_dev = out["comps"]
                alive_dev = out["alive"]
                resume = dict(
                    pga=out["pga"][-1:], pgb=out["pgb"][-1:], pgw=out["pgw"][-1:],
                    next_new=out["next_new"], m_cnt=out["m_cnt"], m_t=out["m_t"],
                    m_np=out["m_np"], m_parents=out["m_parents"],
                    m_children=out["m_children"], m_areas=out["m_areas"],
                    flags=out["flags"], nonconv=out["nonconv"], deleted=out["deleted"],
                    missing=out["missing"], perr=out["perr"],
                )
                s0 = s1
            if flags & _march.FLAG_P:
                perr = np.asarray(out["perr"])
                raise _trackmod.TrackingError(
                    "Too many parent objects for tracking",
                    details=f"Child {int(perr[1])} has {int(perr[2])} parents (limit: {_trackmod.MAX_PARENTS})",
                    suggestions=["Increase overlap_threshold to reduce fragmentation"],
                    context={"child_id": int(perr[1]), "n_parents": int(perr[2])},
                )
            if flags == 0:
                break
            if flags & _march.FLAG_MP:
                sizes["MP"] = min(sizes["MP"] * 4, 1 << 14)
            if flags & _march.FLAG_K:
                sizes["K"] *= 2
            if flags & _march.FLAG_L:
                sizes["L"] *= 2
            if flags & _march.FLAG_MAXC:
                sizes["MAXC"] *= 2
            if flags & _march.FLAG_MAXM:
                sizes["MAXM"] *= 4
            if flags & _march.FLAG_NID:
                sizes["NID"] *= 2
            if flags & _march.FLAG_WIN:
                sizes["MAXWIN"] = min(sizes["MAXWIN"] * 2, S if unstr else sshape[0])
            if flags & _march.FLAG_LN:
                sizes["LN"] *= 2
            sizes["LN"] = max(sizes["LN"], 2 * sizes["K"])
            logger.info(f"Streamed march capacity retry {attempt + 1}: flags={flags:#x} -> {sizes}")
            out = None
        if out is None:
            raise _trackmod.TrackingError(
                "Streamed scan march exceeded capacity retries",
                suggestions=["Increase memory_budget_mb", "Run the in-memory tracker on a time shard"],
            )

    # ---- shared host epilogue --------------------------------------------
    table, overlap_list, merge_events = tr._march_epilogue(
        gmap_host, pga_h, pgb_h, pgw_h, out, T, W, unstr, wrap
    )

    object_stats = (
        total_area_IDed,
        N_prefiltered,
        N_filtered,
        area_threshold,
        accepted_area_fraction,
        (total_raw / total_processed) if total_processed else 0.0,
    )

    # ---- Pass C: streamed cluster rename + stats --------------------------
    with log_timing(logger, "Streamed event relabeling + statistics", log_memory=True):
        events_ds, N_events = _cluster_rename_streamed(
            tr, fin_store, gmap_host, table, overlap_list, merge_events,
            out_path, block_T, sshape, unstr, wrap,
        )

    events_ds = tr.run_stats_attributes(events_ds, merge_events, object_stats, N_events)

    if not keep_temp:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    if return_merges:
        return events_ds, merge_events
    return events_ds


def _cluster_rename_streamed(
    tr, fin_store, gmap_host, table, overlap_list, merge_events,
    out_path, block_T, sshape, unstr, wrap,
):
    """Blockwise counterpart of tracker._cluster_rename (track.py:2809-3331):
    identical union-find clustering; the field remap, the per-(time, event)
    global-ID scatter and the event statistics stream block by block into the
    output store."""
    import jax.numpy as jnp

    from .ops import label as _label  # noqa: F401  (parity with in-memory imports)
    from .ops import overlap as _overlap
    from .track import MAX_PARENTS

    T = gmap_host.shape[0]

    field_ids = table.ids()
    if len(overlap_list):
        overlap_ids = np.unique(overlap_list.astype(np.int64))
        overlap_ids = overlap_ids[overlap_ids > 0]
        all_ids = np.unique(np.concatenate([field_ids.astype(np.int64), overlap_ids]))
    else:
        all_ids = field_ids.astype(np.int64)
    comp = _overlap.union_find_components(
        overlap_list.astype(np.int64) if len(overlap_list) else np.empty((0, 2), np.int64), all_ids
    )
    n_events = int(comp.max()) + 1 if len(comp) else 0
    logger.info(f"Identified {n_events} connected components (events) [streamed]")

    max_id = int(max(int(gmap_host.max()), all_ids.max() if len(all_ids) else 0))
    lookup = np.zeros(max_id + 2, dtype=np.int32)
    lookup[all_ids] = comp.astype(np.int32) + 1
    lookup_dev = jnp.asarray(lookup)

    N = n_events
    zarr_lite.create_group(out_path)
    sdims_t = tr._spatial_dims()
    zarr_lite.create_array(
        out_path, "ID_field", (T,) + sshape, np.int32, (tr.timedim,) + sdims_t,
        chunks=(block_T,) + sshape, compressor="zlib",
    )
    # per-(time, event) tables stream to the store too: at century scale
    # they are tens of GB and must never materialise whole on the host
    have_merges = "parent_IDs" in merge_events.data_vars and merge_events["parent_IDs"].shape[0] > 0
    sibling = int(merge_events["parent_IDs"].shape[1]) if have_merges else MAX_PARENTS
    NW = max(N, 1)
    zarr_lite.create_array(out_path, "global_ID", (T, NW), np.int32, (tr.timedim, "ID"), chunks=(block_T, NW))
    zarr_lite.create_array(out_path, "area", (T, NW), np.float32, (tr.timedim, "ID"), chunks=(block_T, NW))
    zarr_lite.create_array(
        out_path, "centroid", (2, T, NW), np.float32, ("component", tr.timedim, "ID"), chunks=(2, block_T, NW)
    )
    zarr_lite.create_array(out_path, "presence", (T, NW), bool, (tr.timedim, "ID"), chunks=(block_T, NW))
    zarr_lite.create_array(
        out_path, "merge_ledger", (T, NW, sibling), np.int32, (tr.timedim, "ID", "sibling_ID"),
        chunks=(block_T, NW, sibling),
    )

    time_vals = np.asarray(tr.data_bin.coords[tr.timecoord].values)
    merge_rows_by_t: Dict[int, list] = {}
    if have_merges:
        pids_all = merge_events["parent_IDs"].values
        mtimes = merge_events["merge_time"].values
        time_to_idx = {v: i for i, v in enumerate(time_vals)}
        for m in range(pids_all.shape[0]):
            tixd = time_to_idx.get(mtimes[m])
            if tixd is not None:
                merge_rows_by_t.setdefault(tixd, []).append(m)

    first_idx = np.full(N + 1, -1, np.int64)
    last_idx = np.zeros(N + 1, np.int64)

    lab_lazy = zarr_lite.LazyZarrArray(os.path.join(fin_store, "labels"))
    cellw = jnp.asarray(tr.cell_area) if not unstr else None
    for s0 in range(0, T, block_T):
        s1 = min(s0 + block_T, T)
        loc = jnp.asarray(np.asarray(lab_lazy[s0:s1]))
        rows = jnp.asarray(gmap_host[s0:s1])
        mapped = _march.map_to_global(loc.reshape(s1 - s0, 1, -1), rows).reshape(loc.shape)
        new_field = jnp.take(lookup_dev, jnp.clip(mapped, 0, max_id + 1))
        zarr_lite.write_region(out_path, "ID_field", (s0,) + (0,) * len(sshape), np.asarray(new_field))
        gid_b = np.zeros((s1 - s0, NW), np.int32)
        area_b = np.full((s1 - s0, NW), np.nan, np.float32)
        clat_b = np.zeros((s1 - s0, NW), np.float32)
        clon_b = np.zeros((s1 - s0, NW), np.float32)
        if N:
            nf = new_field.reshape(s1 - s0, -1)
            of = mapped.reshape(s1 - s0, -1)
            gid_b = np.asarray(_props.event_global_id(nf, of, N))[:, 1:]
            if unstr:
                a_b, la_b, lo_b = _props.unstructured_label_props(
                    new_field, jnp.asarray(tr.lat), jnp.asarray(tr.lon), jnp.asarray(tr.cell_area), N
                )
                a_b = np.asarray(a_b)[:, 1:]
                clat_b = np.asarray(la_b)[:, 1:]
                clon_b = np.asarray(lo_b)[:, 1:]
            else:
                a_b, cy_b, cx_b = _props.grid_label_props(new_field, N, wrap=wrap, cell_weights=cellw)
                cy_b = _props.interp_coord(cy_b, jnp.asarray(tr.lat.astype(np.float32)))
                cx_b = _props.interp_coord(cx_b, jnp.asarray(tr.lon.astype(np.float32)))
                pres_d = a_b > 0
                a_b = np.asarray(a_b)[:, 1:]
                clat_b = np.asarray(jnp.where(pres_d, cy_b, jnp.nan))[:, 1:]
                clon_b = np.asarray(jnp.where(pres_d, cx_b, jnp.nan))[:, 1:]
            area_b = np.where(a_b > 0, a_b, np.nan).astype(np.float32)
        pres_b = gid_b > 0
        # incremental first/last presence (time_start/time_end)
        any_rows = pres_b.any(axis=0)
        col_first = s0 + pres_b.argmax(axis=0)
        col_last = s0 + (s1 - s0 - 1) - pres_b[::-1].argmax(axis=0)
        upd = np.flatnonzero(any_rows) + 1
        newly = upd[first_idx[upd] < 0]
        first_idx[newly] = col_first[newly - 1]
        last_idx[upd] = col_last[upd - 1]

        ledger_b = np.full((s1 - s0, NW, sibling), -1, np.int32)
        for tixd in range(s0, s1):
            for m in merge_rows_by_t.get(tixd, ()):
                parents_old = pids_all[m][pids_all[m] > 0]
                parents_new = lookup[np.clip(parents_old, 0, max_id + 1)]
                parents_new = parents_new[parents_new > 0]
                if tr.merge_ledger_mode == "reference":
                    for pn in parents_new:
                        ledger_b[tixd - s0, pn - 1, :] = pn
                else:
                    for pn in parents_new:
                        k = min(len(parents_new), sibling)
                        ledger_b[tixd - s0, pn - 1, :k] = parents_new[:k]

        zarr_lite.write_region(out_path, "global_ID", (s0, 0), gid_b)
        zarr_lite.write_region(out_path, "area", (s0, 0), area_b)
        zarr_lite.write_region(out_path, "centroid", (0, s0, 0), np.stack([clat_b, clon_b]))
        zarr_lite.write_region(out_path, "presence", (s0, 0), pres_b)
        zarr_lite.write_region(out_path, "merge_ledger", (s0, 0, 0), ledger_b)

    never = first_idx < 0
    # match the in-memory argmax semantics for never-present ids
    first_idx[never] = 0
    last_idx[never] = T - 1
    time_start = time_vals[first_idx]
    time_end = time_vals[last_idx]

    tdims = (tr.timedim,)
    sdims = tr._spatial_dims()
    coords = dict(tr.data_bin.coords)
    id_coord = Coord("ID", np.arange(1, N + 1, dtype=np.int32))

    def _lazy(name):
        if N == 0:  # zero-width tables (no events): lazy (T, 1) stores would misalign
            arr = zarr_lite.LazyZarrArray(os.path.join(out_path, name))
            if name == "ID_field":
                return arr
            a = np.asarray(arr)
            return a[:, :0] if a.ndim >= 2 and name != "centroid" else a[..., :0]
        return zarr_lite.LazyZarrArray(os.path.join(out_path, name))

    id_c = {**coords, "ID": id_coord}
    events_ds = FieldSet(
        {
            "ID_field": Field(_lazy("ID_field"), tdims + sdims, coords, name="ID_field"),
            "global_ID": Field(_lazy("global_ID"), (tr.timedim, "ID"), id_c, name="global_ID"),
            "area": Field(_lazy("area"), (tr.timedim, "ID"), id_c, name="area"),
            "centroid": Field(
                _lazy("centroid"),
                ("component", tr.timedim, "ID"),
                {**id_c, "component": Coord("component", np.array([0, 1]))},
                name="centroid",
            ),
            "presence": Field(_lazy("presence"), (tr.timedim, "ID"), id_c, name="presence"),
            "time_start": Field(time_start[1:], ("ID",), {"ID": id_coord}, name="time_start"),
            "time_end": Field(time_end[1:], ("ID",), {"ID": id_coord}, name="time_end"),
            "merge_ledger": Field(
                _lazy("merge_ledger"),
                (tr.timedim, "ID", "sibling_ID"),
                {**id_c, "sibling_ID": Coord("sibling_ID", np.arange(sibling))},
                name="merge_ledger",
            ),
        },
        attrs={},
    )
    return events_ds, N
