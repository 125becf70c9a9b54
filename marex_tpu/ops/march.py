"""
Fully on-device merge march for both grid types (gridded and unstructured).

The split/merge march of the reference (track.py:3337-3802) is inherently
sequential over timesteps: each step consolidates the previous slice against
the one before it, then iteratively partitions every multi-parent child of
the current slice. The previous design batched each step's work into
device programs but still walked timesteps on the host, paying one or more
host<->device roundtrips per merge-active step — the dominant cost on a
high-latency device link (hundreds of dispatches at ~30 ms each).

This module moves the ENTIRE march into one ``lax.scan`` over timesteps, so
the whole split/merge phase is ~3 dispatches total regardless of merge
density. The design that makes this possible:

* **Slice-local labels.** Each slice keeps dense local ids (1..L) and a
  carried ``(T, L)`` local->global map. Overlap-pair keys are
  ``a_local * (L+1) + b_local`` — always int32-safe, unlike global-id packed
  keys which overflow 2**31 at production object counts.
* **Consolidation is pure bookkeeping.** Renaming a child object into its
  sibling only rewrites the local->global map and the object table — no
  pixel relabel program at all.
* **Analytic object properties.** The table stores the six raw components of
  the reference's periodic-centroid formula (area, sum_y, sum_x,
  count_right-of-center, edge-zone hit counts; track.py:2075-2107), so merged
  objects' properties combine exactly by addition — no pixel recompute.
* **Carried pair slots.** Overlap triples per slice pair live in fixed
  ``(T-1, MP)`` slot arrays, refreshed in-scan only when a partition rewrites
  a slice, and updated analytically under renames.

Capacities (pair slots, children per iteration, parents per child, locals
per slice, ledger length, id space, EDT window) are static buckets; every
overflow raises a flag carried through the scan, and the host wrapper
retries with the offending bucket doubled (a rare recompile) or falls back
to the per-step device march.

Semantics are kept identical to the sequential march — consolidation
ordering (parents ascending, children in pair-row order, first-child
targets, chain resolution, dead-first-child group skips), <=10 merge
iterations per step with the same convergence warning, new-id allocation
order (children ascending, parents in row order), and the merge-ledger
row order. ``tests/test_scan_march.py`` pins equality against the host
march.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from .properties import EDGE_ZONE

_INF = np.float32(np.inf)
_IMAX = np.int32(2**31 - 1)


class MarchSizes(NamedTuple):
    """Static capacity buckets of one compiled march program."""

    L: int        # max local labels per slice (incl. partition pieces)
    MP: int       # overlap-pair slots per slice pair
    K: int        # max merging children per iteration
    P: int        # max parents per child (MAX_PARENTS)
    NID: int      # global id capacity
    MAXC: int     # max consolidation renames per step
    MAXM: int     # merge-ledger capacity
    MAXWIN: int   # static pad of the EDT row window
    LN: int       # dense (child, parent) lane capacity of the partition
    HC: int = 0   # partition row-band height (0 = full-grid partition)


@partial(jax.jit, donate_argnums=(0,))
def write_time_block_donated(out: jax.Array, block: jax.Array, start) -> jax.Array:
    """In-place (donated) write of one time block into the label accumulator
    (the blockwise march's assembly step; a list+concatenate would hold the
    full-size field twice — see track._split_and_merge_scan)."""
    return jax.lax.dynamic_update_slice_in_dim(out, block, start, axis=0)


# flag bit positions (carried int32 bitmask)
FLAG_MP = 1 << 0      # pair slots overflowed
FLAG_K = 1 << 1       # >K merging children in one iteration
FLAG_P = 1 << 2       # >P parents for one child (reference raises)
FLAG_L = 1 << 3      # local-label capacity overflowed
FLAG_MAXC = 1 << 4    # consolidation rename slots overflowed
FLAG_MAXM = 1 << 5    # merge ledger overflowed
FLAG_NID = 1 << 6     # global id capacity overflowed
FLAG_WIN = 1 << 7     # EDT row window smaller than the NN distance cap
FLAG_LN = 1 << 8      # partition lane capacity overflowed


# ---------------------------------------------------------------------------
# slot-array primitives
# ---------------------------------------------------------------------------


def _extract_pairs_local(prev_loc: jax.Array, cur_loc: jax.Array, MP: int, stride: int, cell_w=None):
    """Distinct (a_local, b_local, weight) triples between two local label
    slices: sort the packed int32 keys once, segment-sum the run weights,
    and compact the first MP distinct runs into slots (ascending key order,
    -1 padded) — O(S log S) total, vs the old iterative min-extraction's
    O(MP*S) sequential slot scan (the march's worst asymptotic term at
    production pair counts). ``cell_w`` weights each overlapping cell
    (None = pixel counts; cell areas on unstructured meshes, track.py
    _cell_weights). The fourth return value flags an overflowing (possibly
    truncated) slot list."""
    a = prev_loc.reshape(-1).astype(jnp.int32)
    b = cur_loc.reshape(-1).astype(jnp.int32)
    both = jnp.logical_and(a > 0, b > 0)
    key = jnp.where(both, a * stride + b, _IMAX)
    # One sort is the whole O(S) cost. Everything downstream is MP-sized:
    # run boundaries of the sorted keys are located with searchsorted over
    # the (nondecreasing) run-id array, so no full-field scatter or gather
    # survives.
    if cell_w is None:
        ks = jax.lax.sort(key)
        ws = None
    else:
        wf = jnp.where(both, cell_w.reshape(-1).astype(jnp.float32), 0.0)
        ks, ws = jax.lax.sort((key, wf), num_keys=1)
    valid = ks != _IMAX
    first = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    first = jnp.logical_and(first, valid)
    rid = jnp.cumsum(first.astype(jnp.int32)) - 1  # run id per element
    # runs past the MP slots share the drop index MP with the invalid tail,
    # so rid stays nondecreasing and indices_are_sorted below holds
    rid = jnp.where(valid, jnp.minimum(rid, MP), MP)
    n_runs = jnp.sum(first.astype(jnp.int32))

    sl = jnp.arange(MP, dtype=jnp.int32)
    starts = jnp.searchsorted(rid, sl, side="left").astype(jnp.int32)
    has_run = sl < jnp.minimum(n_runs, MP)
    kslot = ks[jnp.clip(starts, 0, ks.shape[0] - 1)]
    pa = jnp.where(has_run, kslot // stride, -1)
    pb = jnp.where(has_run, kslot % stride, -1)
    if ws is None:
        # pixel counts: the run length IS the aggregated weight
        ends = jnp.searchsorted(rid, sl, side="right").astype(jnp.int32)
        wagg = jnp.where(has_run, (ends - starts).astype(jnp.float32), 0.0)
    else:
        # cell-area weights: keep the in-order scatter-add (bitwise equal
        # to the pre-sort aggregation; a cumsum difference would lose
        # float32 precision against large running totals)
        wagg = jnp.zeros((MP,), jnp.float32).at[rid].add(
            ws, mode="drop", indices_are_sorted=True
        )
    return pa, pb, wagg, n_runs > MP


def _sort_aggregate_global(ga: jax.Array, gb: jax.Array, w: jax.Array, MP: int):
    """Sort MP pair slots by (global_a, global_b) ascending with invalid
    slots last, summing weights of duplicate pairs (duplicates arise when
    two locals map to one consolidated global id)."""
    invalid = ga < 0
    ga_s = jnp.where(invalid, _IMAX, ga)
    gb_s = jnp.where(invalid, _IMAX, gb)
    o1 = jnp.argsort(gb_s, stable=True)
    ga1, gb1, w1 = ga_s[o1], gb_s[o1], w[o1]
    o2 = jnp.argsort(ga1, stable=True)
    ga2, gb2, w2 = ga1[o2], gb1[o2], w1[o2]
    valid = ga2 != _IMAX

    prev_same = jnp.concatenate(
        [jnp.zeros((1,), bool), jnp.logical_and(ga2[1:] == ga2[:-1], gb2[1:] == gb2[:-1])]
    )
    prev_same = jnp.logical_and(prev_same, valid)
    first = jnp.logical_and(valid, jnp.logical_not(prev_same))
    grp = jnp.cumsum(jnp.logical_not(prev_same).astype(jnp.int32)) - 1
    wagg = jax.ops.segment_sum(jnp.where(valid, w2, 0.0), grp, num_segments=MP)

    pos = jnp.cumsum(first.astype(jnp.int32)) - 1
    idx = jnp.where(first, pos, MP)
    out_ga = jnp.full((MP,), -1, jnp.int32).at[idx].set(ga2, mode="drop")
    out_gb = jnp.full((MP,), -1, jnp.int32).at[idx].set(gb2, mode="drop")
    out_w = jnp.zeros((MP,), jnp.float32).at[idx].set(wagg[grp], mode="drop")
    return out_ga, out_gb, out_w


def _map_pairs_to_global(pa_loc, pb_loc, pw, gmap_a_row, gmap_b_row, MP):
    """Map local pair slots through the local->global rows and restore the
    sorted-aggregated invariant."""
    va = pa_loc > 0
    ga = jnp.where(va, gmap_a_row[jnp.clip(pa_loc, 0, gmap_a_row.shape[0] - 1)], -1)
    gb = jnp.where(va, gmap_b_row[jnp.clip(pb_loc, 0, gmap_b_row.shape[0] - 1)], -1)
    return _sort_aggregate_global(ga, gb, pw, MP)


def _rename_slots(vals: jax.Array, olds: jax.Array, news: jax.Array):
    """Replace every occurrence of olds[j] by news[j] in a slot array.
    Callers pre-resolve chains and olds are distinct (a consumed child is
    consumed once), so one first-match compare matrix replaces the
    sequential pair scan — a single fused op instead of MAXC dependent
    iterations."""
    valid = olds >= 0
    m = jnp.logical_and(vals[:, None] == olds[None, :], valid[None, :])
    has = jnp.any(m, axis=1)
    j = jnp.argmax(m, axis=1)
    return jnp.where(has, news[j], vals)


def _threshold_keep(ga, gb, w, area, alive, thr, NID):
    """Overlap-fraction filter of one slot list against the live object
    table (the march's _enforce_threshold)."""
    va = ga >= 0
    ia = jnp.clip(ga, 0, NID - 1)
    ib = jnp.clip(gb, 0, NID - 1)
    ok = jnp.logical_and(va, jnp.logical_and(alive[ia], alive[ib]))
    min_area = jnp.minimum(area[ia], area[ib])
    frac_ok = jnp.logical_and(min_area > 0, w / jnp.maximum(min_area, 1e-30) >= thr)
    return jnp.logical_and(ok, frac_ok)


def _comps_to_centroid(comps: jax.Array, W: int, wrap: bool):
    """(cy, cx) from the six raw components, the EDGE_ZONE periodic
    recentring formula of grid_mask_props (track.py:2075-2107)."""
    area = jnp.maximum(comps[..., 0], 1e-30)
    cy = comps[..., 1] / area
    cx_plain = comps[..., 2] / area
    cx_adj = (comps[..., 2] - W * comps[..., 3]) / area
    cx_adj = jnp.where(cx_adj < 0, cx_adj + W, cx_adj)
    if wrap:
        wrapped = jnp.logical_and(comps[..., 4] > 0, comps[..., 5] > 0)
    else:
        wrapped = jnp.zeros(comps.shape[:-1], bool)
    cx = jnp.where(wrapped, cx_adj, cx_plain)
    return cy, cx


def _comps_to_latlon(comps: jax.Array):
    """(clat_deg, clon_deg) from the additive spherical components
    ``[area, sum a*x, sum a*y, sum a*z]`` (unstructured_label_comps layout;
    the spherical-centroid formula of track.py:2195-2230)."""
    wx, wy, wz = comps[..., 1], comps[..., 2], comps[..., 3]
    norm = jnp.sqrt(wx * wx + wy * wy + wz * wz)
    norm = jnp.where(norm > 0, norm, 1.0)
    clat = jnp.rad2deg(jnp.arcsin(jnp.clip(wz / norm, -1.0, 1.0)))
    clon = jnp.rad2deg(jnp.arctan2(wy, wx))
    clon = jnp.where(clon > 180.0, clon - 360.0, jnp.where(clon < -180.0, clon + 360.0, clon))
    return clat, clon


def _mask_comps(mask: jax.Array):
    """Six raw property components of one boolean (H, W) mask."""
    H, W = mask.shape
    y_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    m = mask.astype(jnp.float32)
    return jnp.stack(
        [
            jnp.sum(m),
            jnp.sum(m * y_idx),
            jnp.sum(m * x_idx),
            jnp.sum(m * (x_idx > W / 2)),
            jnp.sum(m * (x_idx < EDGE_ZONE)),
            jnp.sum(m * (x_idx >= W - EDGE_ZONE)),
        ]
    )


# ---------------------------------------------------------------------------
# EDT partition with a dynamic (traced) row window
# ---------------------------------------------------------------------------


def _row_distance_periodic(mask: jax.Array, wrap: bool) -> jax.Array:
    """1-D distance (in cells) to the nearest True along the last axis,
    periodic when ``wrap``. Closed form via prefix mins: the forward
    distance is ``min_{j<=i}(BIG·[!m_j] - j) + i`` and the wrap-around term
    adds W — two cummins and a handful of elementwise passes, fully
    parallel (no sequential lax.scan over the axis)."""
    W = mask.shape[-1]
    BIG = jnp.float32(4 * W)
    x = jnp.arange(W, dtype=jnp.float32)
    src_f = jnp.where(mask, -x, BIG)  # m_j - j with m_j = 0 at sources
    src_b = jnp.where(mask, x, BIG)   # m_j + j
    fwd = jax.lax.cummin(src_f, axis=mask.ndim - 1) + x
    bwd = jax.lax.cummin(src_b, axis=mask.ndim - 1, reverse=True) - x
    if wrap:
        tot_f = jnp.min(src_f, axis=-1, keepdims=True)
        tot_b = jnp.min(src_b, axis=-1, keepdims=True)
        fwd = jnp.minimum(fwd, tot_f + W + x)
        bwd = jnp.minimum(bwd, tot_b + W - x)
    d = jnp.minimum(fwd, bwd)
    return jnp.where(d >= 2 * W, _INF, d)


_COL_CHUNK = 8  # column-pass offsets handled per fori iteration


def _edt_dynwin(
    parent_masks: jax.Array,
    win_dyn: jax.Array,
    MAXWIN: int,
    wrap: bool,
    out_r0: jax.Array | int = 0,
    out_h: int | None = None,
):
    """Exact squared EDT per parent with the column pass restricted to a
    TRACED row window (cost scales with the actual window, not with H).
    Exact for all distances <= win_dyn; callers ensure win_dyn covers the
    NN distance cap (flagging FLAG_WIN otherwise). Offsets are processed in
    chunks of _COL_CHUNK per fori iteration to amortise loop overhead; the
    chunk may overshoot the window, which only adds true (larger-offset)
    distance candidates and never loosens the envelope.

    ``out_r0``/``out_h`` restrict the OUTPUT to rows [out_r0, out_r0+out_h):
    distances are still exact (reads reach +-win_dyn beyond the band) but
    the expensive accumulation runs over ``out_h`` rows instead of H —
    callers that only consume distances inside a child row band (the merge
    partition) pay for the band, not the grid."""
    Pm, Hm, Wm = parent_masks.shape
    OH = Hm if out_h is None else out_h
    out_r0 = jnp.asarray(out_r0, jnp.int32)
    d1 = _row_distance_periodic(parent_masks, wrap)
    d1sq = jnp.where(jnp.isinf(d1), _INF, d1 * d1)
    padded = jnp.pad(
        d1sq, ((0, 0), (MAXWIN, MAXWIN + _COL_CHUNK), (0, 0)), constant_values=_INF
    )

    def body(c, acc):
        base = c * _COL_CHUNK
        sl = jax.lax.dynamic_slice(
            padded, (0, MAXWIN + base - win_dyn + out_r0, 0), (Pm, OH + _COL_CHUNK - 1, Wm)
        )
        for u in range(_COL_CHUNK):
            dy = (base + u - win_dyn).astype(jnp.float32)
            acc = jnp.minimum(acc, sl[:, u : u + OH] + dy * dy)
        return acc

    acc0 = jnp.full((Pm, OH, Wm), _INF)
    n_chunks = (2 * win_dyn + _COL_CHUNK) // _COL_CHUNK
    return jax.lax.fori_loop(0, n_chunks, body, acc0)


def _centroid_assign(cents: jax.Array, valid: jax.Array, H: int, W: int, wrap: bool):
    y = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    dy = y[None] - cents[:, 0][:, None, None]
    dx = x[None] - cents[:, 1][:, None, None]
    if wrap:
        half = W / 2.0
        dx = jnp.where(dx > half, dx - W, dx)
        dx = jnp.where(dx < -half, dx + W, dx)
    d2 = dy * dy + dx * dx
    d2 = jnp.where(valid[:, None, None], d2, _INF)
    return jnp.argmin(d2, axis=0).astype(jnp.int32)


def _partition_batch(
    gprev, cur_loc, child_loc, piece_loc, parent_gids, pvalid, cents, mdist, win_dyn,
    sizes: MarchSizes, nn: bool, wrap: bool,
):
    """Partition all K merging children of one iteration: assign each child
    cell to its nearest parent (exact capped EDT with centroid fallback, or
    pure centroid assignment), write piece LOCAL ids, and return the six raw
    property components per piece — one fused program, zero host round-trips
    (the in-scan analogue of partition_children_grid_batched).

    The valid (child, parent) slots are compacted into LN dense LANES before
    the heavy per-lane EDT, because typical merges have ~2 parents against
    the P=10 padding. Children are spatially disjoint, so masking each
    lane's distances to its own child's cells makes ONE global argmin over
    lanes equal the per-child argmin — with identical tie-breaking (lanes
    preserve (child asc, parent-row) order, so the lowest parent slot wins
    ties exactly like the padded argmin did).

    Returns (new_cur, piece components (K, P, 6), lane-overflow flag).
    """
    H, W = cur_loc.shape
    K, P = parent_gids.shape
    LN = sizes.LN

    valid = jnp.logical_and(pvalid, (child_loc > 0)[:, None])
    vflat = valid.reshape(-1)
    pos = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    idx = jnp.where(vflat, pos, LN)
    n_lanes = jnp.sum(vflat.astype(jnp.int32))
    overflow = n_lanes > LN

    def compact(x, fill):
        return jnp.full((LN,), fill, x.dtype).at[idx].set(x.reshape(-1), mode="drop")

    lane_child = compact(jnp.broadcast_to(child_loc[:, None], (K, P)), 0)
    lane_parent = compact(parent_gids, 0)
    lane_piece = compact(piece_loc, 0)
    lane_cy = compact(cents[..., 0], 0.0)
    lane_cx = compact(cents[..., 1], 0.0)
    lane_md = compact(jnp.broadcast_to(mdist[:, None], (K, P)), 0.0)
    lane_kp = jnp.full((LN,), K * P, jnp.int32).at[idx].set(
        jnp.arange(K * P, dtype=jnp.int32), mode="drop"
    )
    lane_valid = jnp.arange(LN) < n_lanes

    def core(r0, OUT_H):
        """Assignment + property contraction over rows [r0, r0+OUT_H).
        Children are guaranteed inside the band (the caller derives it from
        their row extent), so restricting every per-cell array to the band
        is exact — the EDT still reads +-win_dyn rows beyond it."""
        cur_band = jax.lax.dynamic_slice(cur_loc, (r0, 0), (OUT_H, W))
        cell_child = jnp.logical_and(
            cur_band[None] == lane_child[:, None, None], lane_valid[:, None, None]
        )  # (LN, OUT_H, W)
        in_child = jnp.any(cell_child, axis=0)

        # centroid fallback (and the whole assignment when nn=False)
        y = jax.lax.broadcasted_iota(jnp.float32, (OUT_H, W), 0) + r0.astype(jnp.float32)
        x = jax.lax.broadcasted_iota(jnp.float32, (OUT_H, W), 1)
        dy = y[None] - lane_cy[:, None, None]
        dx = x[None] - lane_cx[:, None, None]
        if wrap:
            half = W / 2.0
            dx = jnp.where(dx > half, dx - W, dx)
            dx = jnp.where(dx < -half, dx + W, dx)
        cd = dy * dy + dx * dx
        cd = jnp.where(cell_child, cd, _INF)
        fallback = jnp.argmin(cd, axis=0).astype(jnp.int32)

        if nn:
            pmask = jnp.logical_and(
                gprev[None] == lane_parent[:, None, None], lane_valid[:, None, None]
            )
            d2 = _edt_dynwin(pmask, win_dyn, sizes.MAXWIN, wrap, out_r0=r0, out_h=OUT_H)
            d = jnp.sqrt(d2)
            d = jnp.where(d <= lane_md[:, None, None], d, _INF)
            d = jnp.where(cell_child, d, _INF)
            best = jnp.argmin(d, axis=0).astype(jnp.int32)
            reached = jnp.isfinite(jnp.min(d, axis=0))
            lane_sel = jnp.where(reached, best, fallback)
        else:
            lane_sel = fallback

        upd = jnp.where(in_child, lane_piece[lane_sel], 0)
        new_band = jnp.where(upd > 0, upd, cur_band)
        new_cur = jax.lax.dynamic_update_slice(cur_loc, new_band, (r0, 0))

        # per-lane property components in one contraction
        y_f = y.reshape(-1)
        x_f = x.reshape(-1)
        wall = jnp.stack(
            [
                jnp.ones_like(x_f),
                y_f,
                x_f,
                (x_f > W / 2).astype(jnp.float32),
                (x_f < EDGE_ZONE).astype(jnp.float32),
                (x_f >= W - EDGE_ZONE).astype(jnp.float32),
            ]
        )  # (6, S_band)
        one_hot = jnp.logical_and(
            lane_sel[None] == jnp.arange(LN)[:, None, None], in_child[None]
        ).reshape(LN, -1)
        comps_lane = jnp.einsum(
            "ls,cs->lc", one_hot.astype(jnp.float32), wall, precision=jax.lax.Precision.HIGHEST
        )  # (LN, 6)

        pcomps = (
            jnp.zeros((K * P + 1, 6), jnp.float32)
            .at[lane_kp].set(comps_lane, mode="drop")[: K * P]
            .reshape(K, P, 6)
        )
        return new_cur, pcomps, overflow

    HC = int(getattr(sizes, "HC", 0))
    if not HC or HC >= H:
        return core(jnp.int32(0), H)

    # child row band: the heavy per-cell work only has to cover rows holding
    # child cells — on tall grids that is a small latitude band
    lut = jnp.zeros((sizes.L + 2,), bool).at[jnp.clip(child_loc, 0, sizes.L + 1)].set(
        child_loc > 0, mode="drop"
    )
    lut = lut.at[0].set(False)
    row_any = jnp.any(lut[jnp.clip(cur_loc, 0, sizes.L + 1)], axis=1)  # (H,)
    r_idx = jnp.arange(H, dtype=jnp.int32)
    r0 = jnp.min(jnp.where(row_any, r_idx, H))
    r1 = jnp.max(jnp.where(row_any, r_idx, -1)) + 1
    band = r1 - r0
    use_crop = jnp.logical_and(band > 0, band <= HC)
    r0c = jnp.clip(r0, 0, H - HC)
    return jax.lax.cond(
        use_crop,
        lambda: core(r0c, HC),
        lambda: core(jnp.int32(0), H),
    )


def _partition_batch_unstr(
    gprev, cur_loc, child_loc, piece_loc, parent_gids, pvalid, cents, mdist, win_dyn,
    sizes: MarchSizes, nn: bool, neighbours, lat_deg, lon_deg, cell_area,
):
    """Unstructured analogue of :func:`_partition_batch`: multi-source BFS
    hop distance from each parent's overlap seeds with a TRACED depth
    (``win_dyn`` covers the batch max hop cap), haversine centroid fallback
    for unreached cells, per-piece additive spherical components — the
    in-scan analogue of partition_children_unstructured_batched. ``cents``
    holds (clat, clon) in degrees; ``mdist`` the per-child hop caps."""
    C = cur_loc.shape[-1]
    gp = gprev.reshape(C)
    cur = cur_loc.reshape(C)
    K, P = parent_gids.shape
    LN = sizes.LN

    valid = jnp.logical_and(pvalid, (child_loc > 0)[:, None])
    vflat = valid.reshape(-1)
    pos = jnp.cumsum(vflat.astype(jnp.int32)) - 1
    idx = jnp.where(vflat, pos, LN)
    n_lanes = jnp.sum(vflat.astype(jnp.int32))
    overflow = n_lanes > LN

    def compact(x, fill):
        return jnp.full((LN,), fill, x.dtype).at[idx].set(x.reshape(-1), mode="drop")

    lane_child = compact(jnp.broadcast_to(child_loc[:, None], (K, P)), 0)
    lane_parent = compact(parent_gids, 0)
    lane_piece = compact(piece_loc, 0)
    lane_clat = compact(cents[..., 0], 0.0)
    lane_clon = compact(cents[..., 1], 0.0)
    lane_md = compact(jnp.broadcast_to(mdist[:, None], (K, P)), 0.0)
    lane_kp = jnp.full((LN,), K * P, jnp.int32).at[idx].set(
        jnp.arange(K * P, dtype=jnp.int32), mode="drop"
    )
    lane_valid = jnp.arange(LN) < n_lanes

    cell_child = jnp.logical_and(cur[None] == lane_child[:, None], lane_valid[:, None])  # (LN, C)
    in_child = jnp.any(cell_child, axis=0)

    # haversine fallback (and the whole assignment when nn=False) —
    # haversine_to_centroids semantics (partition.py:374-389)
    lat = jnp.deg2rad(lat_deg.astype(jnp.float32))
    lon = jnp.deg2rad(lon_deg.astype(jnp.float32))
    plat = jnp.deg2rad(lane_clat)
    plon = jnp.deg2rad(lane_clon)
    dlat = plat[:, None] - lat[None, :]
    dlon = plon[:, None] - lon[None, :]
    aa = jnp.sin(dlat / 2) ** 2 + jnp.cos(lat)[None, :] * jnp.cos(plat)[:, None] * jnp.sin(dlon / 2) ** 2
    hd = 2 * jnp.arctan2(jnp.sqrt(aa), jnp.sqrt(jnp.maximum(1 - aa, 0.0)))
    hd = jnp.where(cell_child, hd, _INF)
    fallback = jnp.argmin(hd, axis=0).astype(jnp.int32)

    if nn:
        pmask = jnp.logical_and(gp[None] == lane_parent[:, None], lane_valid[:, None])
        seeds = jnp.logical_and(pmask, cell_child)
        nb_idx = jnp.maximum(neighbours, 0)
        nb_valid = neighbours >= 0

        # BFS with EXACT early exit: hop distances arrive in increasing
        # order, so once every child cell holds a visit within its lane's
        # cap, later arrivals can never win the argmin — and a stalled
        # frontier can never change anything. The reference hop cap
        # (sqrt(area)-scaled, hundreds of hops on ICON-scale meshes) is a
        # distance BOUND, not a required depth; typical merges cover the
        # child in O(child diameter) steps.
        def cond(state):
            visited, dist, d, done = state
            return jnp.logical_and(d < win_dyn, jnp.logical_not(done))

        def body(state):
            visited, dist, d, _ = state
            g = jnp.logical_and(visited[:, nb_idx], nb_valid[None])
            new_visited = jnp.logical_or(visited, jnp.any(g, axis=1))
            newly = jnp.logical_and(new_visited, jnp.logical_not(visited))
            dist = jnp.where(newly, (d + 1).astype(jnp.float32), dist)
            capped = jnp.where(dist <= lane_md[:, None], dist, _INF)
            covered = jnp.all(jnp.logical_or(~in_child, jnp.isfinite(jnp.min(capped, axis=0))))
            stalled = jnp.logical_not(jnp.any(newly))
            return new_visited, dist, d + 1, jnp.logical_or(covered, stalled)

        dist0 = jnp.where(seeds, 0.0, _INF)
        _, dist, _, _ = jax.lax.while_loop(
            cond, body, (seeds, dist0, jnp.int32(0), jnp.bool_(False))
        )
        d = jnp.where(dist <= lane_md[:, None], dist, _INF)
        d = jnp.where(cell_child, d, _INF)
        best = jnp.argmin(d, axis=0).astype(jnp.int32)
        reached = jnp.isfinite(jnp.min(d, axis=0))
        lane_sel = jnp.where(reached, best, fallback)
    else:
        lane_sel = fallback

    upd = jnp.where(in_child, lane_piece[lane_sel], 0)
    new_cur = jnp.where(upd > 0, upd, cur)

    # per-lane additive spherical components (area, a*x, a*y, a*z, 0, 0)
    a = cell_area.astype(jnp.float32)
    cl = jnp.cos(lat)
    zero = jnp.zeros_like(a)
    wall = jnp.stack([a, a * cl * jnp.cos(lon), a * cl * jnp.sin(lon), a * jnp.sin(lat), zero, zero])  # (6, C)
    one_hot = jnp.logical_and(lane_sel[None] == jnp.arange(LN)[:, None], in_child[None])  # (LN, C)
    comps_lane = jnp.einsum(
        "ls,cs->lc", one_hot.astype(jnp.float32), wall, precision=jax.lax.Precision.HIGHEST
    )  # (LN, 6)

    pcomps = (
        jnp.zeros((K * P + 1, 6), jnp.float32)
        .at[lane_kp].set(comps_lane, mode="drop")[: K * P]
        .reshape(K, P, 6)
    )
    return new_cur.reshape(cur_loc.shape), pcomps, overflow


# ---------------------------------------------------------------------------
# the march
# ---------------------------------------------------------------------------


def _consolidate(state, pairs_back, keep, same_a, multi, sizes: MarchSizes):
    """One consolidation pass (track.py:3422-3429 semantics): among the
    thresholded back-pairs, every parent with more than one child has its
    children renamed into the FIRST child (pair-row order); groups whose
    first child is already consumed are skipped entirely. Returns the rename
    table (chains resolved) to apply to maps, pairs and the object table.
    ``keep``/``same_a``/``multi`` are precomputed by the caller, which gates
    this whole (sequential) pass on ``any(multi)``."""
    comps, alive = state
    ga, gb, w = pairs_back
    MP, MAXC, NID = sizes.MP, sizes.MAXC, sizes.NID

    idx = jnp.arange(MP, dtype=jnp.int32)
    gf = jnp.min(jnp.where(same_a, idx[None, :], MP), axis=1)  # first kept slot per group

    # compact the multi slots (ascending slot order preserved) into MAXC
    # lanes so the inherently sequential alive/rename walk runs over the
    # handful of actual candidates instead of all MP slots
    cand = jnp.logical_and(multi, idx != gf)  # non-first members of multi groups
    pos = jnp.cumsum(cand.astype(jnp.int32)) - 1
    lane_idx = jnp.where(cand, pos, MAXC)
    n_cand = jnp.sum(cand.astype(jnp.int32))
    lane_b = jnp.full((MAXC,), -1, jnp.int32).at[lane_idx].set(gb, mode="drop")
    first_b_all = gb[jnp.clip(gf, 0, MP - 1)]
    lane_first = jnp.full((MAXC,), -1, jnp.int32).at[lane_idx].set(first_b_all, mode="drop")
    lane_valid0 = jnp.arange(MAXC) < jnp.minimum(n_cand, MAXC)

    def lane_body(j, carry):
        alive_c, ren_old, ren_new, rc = carry
        b_i = lane_b[j]
        first_b = lane_first[j]
        cond = jnp.logical_and(
            lane_valid0[j],
            jnp.logical_and(
                alive_c[jnp.clip(first_b, 0, NID - 1)], alive_c[jnp.clip(b_i, 0, NID - 1)]
            ),
        )
        k = jnp.minimum(rc, MAXC - 1)
        ren_old = ren_old.at[k].set(jnp.where(cond, b_i, ren_old[k]))
        ren_new = ren_new.at[k].set(jnp.where(cond, first_b, ren_new[k]))
        alive_c = alive_c.at[jnp.clip(b_i, 0, NID - 1)].set(
            jnp.where(cond, False, alive_c[jnp.clip(b_i, 0, NID - 1)])
        )
        rc = rc + cond.astype(jnp.int32)
        return alive_c, ren_old, ren_new, rc

    ren_old0 = jnp.full((MAXC,), -1, jnp.int32)
    ren_new0 = jnp.full((MAXC,), -1, jnp.int32)
    alive2, ren_old, ren_new, rc = jax.lax.fori_loop(
        0, MAXC, lane_body, (alive, ren_old0, ren_new0, jnp.int32(0))
    )
    rc = jnp.where(n_cand > MAXC, n_cand, rc)  # overflow -> FLAG_MAXC upstream

    # resolve chains by pointer jumping over the (old -> new) function
    def jump(_, rn):
        def one(x):
            m = jnp.logical_and(ren_old == x, ren_old >= 0)
            has = jnp.any(m)
            j = jnp.argmax(m)
            return jnp.where(has, rn[j], x)

        return jax.vmap(one)(rn)

    ren_res = jax.lax.fori_loop(0, 8, jump, ren_new)

    # combine components of the consumed objects into their final targets
    valid_r = ren_old >= 0
    src = jnp.clip(jnp.where(valid_r, ren_old, NID), 0, NID)
    dst = jnp.where(valid_r, jnp.clip(ren_res, 0, NID - 1), NID)
    add = jnp.where(valid_r[:, None], comps[jnp.clip(src, 0, NID - 1)], 0.0)
    comps2 = comps.at[dst].add(add, mode="drop")
    return comps2, alive2, ren_old, ren_res, rc


@partial(jax.jit, static_argnames=("sizes", "nn", "wrap", "mode"))
def scan_march(
    labels: jax.Array,      # (T, H, W) int32 per-slice-local dense labels
    counts: jax.Array,      # (T,) int32 initial locals per slice
    gmap0: jax.Array,       # (T, L+2) int32 initial local -> global (col 0 = 0)
    comps0: jax.Array,      # (NID, 6) float32 initial components
    alive0: jax.Array,      # (NID,) bool
    next_new0: jax.Array,   # () int32 first free global id
    thr: jax.Array,         # () float32 overlap threshold
    sizes: MarchSizes,
    nn: bool,
    wrap: bool,
    mode: str = "grid",     # "grid" | "unstr"
    mesh=None,              # unstr: (neighbours (3,C), lat_deg, lon_deg, cell_area, mean_cell_area)
    resume=None,            # carried state from a previous block (streamed tracking)
    t0: jax.Array | int = 0,  # global time index of labels[0]
):
    """The complete split/merge march as ONE device program. Returns final
    local labels, the local->global map, the object table, the pair state,
    the merge ledger and the overflow flags. Requires T >= 2.

    ``mode='unstr'`` runs the mesh variant: labels are (T, 1, C), the
    object table carries additive spherical components, partitioning is
    BFS hop distance from overlap seeds with haversine centroid fallback
    (partition_children_unstructured_batched semantics), and the NN hop
    cap follows the reference's mean-cell-area formula.

    **Blockwise streaming**: the scan carry (object table, pair rows,
    ledger) IS the streaming state, so the march runs over a time block at
    a time. For block b>0 the caller prepends the previous block's final
    slice as ``labels[0]`` (with its gmap row in ``gmap0[0]``), passes the
    previous block's returned dict as ``resume`` (carrying comps/alive/
    next_new/m_cnt/ledger/flags/nonconv/deleted/missing/perr and the
    back-pair row), and sets ``t0`` to the global index of ``labels[0]``.
    Pair-row index j of the returned ``pga/pgb/pgw`` holds pairs
    (slice j-1 -> slice j) in block-local indexing; row 0 is the carried
    back row (updated in place by boundary consolidations — the caller
    must write it back over its stored copy), as must the returned
    ``gmap`` row 0."""
    T, H, W = labels.shape
    L, MP, K, P, NID = sizes.L, sizes.MP, sizes.K, sizes.P, sizes.NID
    cell_w = mesh[3] if mode == "unstr" else None
    MAXM = sizes.MAXM
    # the (T, H, W) label stacks are the march's dominant buffers at
    # production shape; locals (incl. partition pieces) are < L, so they
    # store as int16 whenever L fits — the scan upcasts one slice at a time
    out_dtype = jnp.int16 if (L + 2 <= np.iinfo(np.int16).max) else jnp.int32
    GR = L + 2  # map-row length: locals 1..L, col 0 background, col L+1 spare
    stride = L + 2
    t0 = jnp.asarray(t0, jnp.int32)

    # ---- prologue: initial pair lists for every consecutive slice pair ----
    def init_pairs(t):
        pa, pb, pw, of = _extract_pairs_local(labels[t], labels[t + 1], MP, stride, cell_w)
        ga, gb, w = _map_pairs_to_global(pa, pb, pw, gmap0[t], gmap0[t + 1], MP)
        return ga, gb, w, of

    pga_n, pgb_n, pgw_n, of0 = jax.lax.map(init_pairs, jnp.arange(T - 1, dtype=jnp.int32))
    if resume is None:
        back = (
            jnp.full((1, MP), -1, jnp.int32),
            jnp.full((1, MP), -1, jnp.int32),
            jnp.zeros((1, MP), jnp.float32),
        )
        flags_in = jnp.int32(0)
        ledger = dict(
            m_t=jnp.zeros((MAXM,), jnp.int32),
            m_np=jnp.zeros((MAXM,), jnp.int32),
            m_parents=jnp.zeros((MAXM, P), jnp.int32),
            m_children=jnp.zeros((MAXM, P), jnp.int32),
            m_areas=jnp.zeros((MAXM, P), jnp.float32),
        )
        m_cnt0 = jnp.int32(0)
        nonconv0 = deleted0 = missing0 = jnp.int32(0)
        perr0 = jnp.full((3,), -1, jnp.int32)
    else:
        back = (resume["pga"][-1:], resume["pgb"][-1:], resume["pgw"][-1:])
        flags_in = resume["flags"]
        ledger = {k: resume[k] for k in ("m_t", "m_np", "m_parents", "m_children", "m_areas")}
        m_cnt0 = resume["m_cnt"]
        nonconv0 = resume["nonconv"]
        deleted0 = resume["deleted"]
        missing0 = resume["missing"]
        perr0 = resume["perr"]
        comps0 = resume["comps"]
        alive0 = resume["alive"]
        next_new0 = resume["next_new"]
    # pair row j = pairs(slice j-1 -> slice j); row 0 = carried back row
    pga = jnp.concatenate([back[0], pga_n])
    pgb = jnp.concatenate([back[1], pgb_n])
    pgw = jnp.concatenate([back[2], pgw_n])
    flags0 = (flags_in | jnp.where(jnp.any(of0), FLAG_MP, 0)).astype(jnp.int32)

    def step(carry, xs):
        (prev, gmap, pga, pgb, pgw, comps, alive, next_new, m_cnt, ledger, flags,
         nonconv, deleted, missing, dirty, perr) = carry
        cur, count_t, t = xs
        cur = cur.astype(jnp.int32)
        g = t0 + t  # global time index (ledger rows, reference guards)
        lused = count_t

        gmap_prev = jax.lax.dynamic_slice(gmap, (t - 1, 0), (1, GR))[0]
        gmap_cur = jax.lax.dynamic_slice(gmap, (t, 0), (1, GR))[0]

        def get_pairs(arrs, i):
            a, b, ww = arrs
            return (
                jax.lax.dynamic_slice(a, (i, 0), (1, MP))[0],
                jax.lax.dynamic_slice(b, (i, 0), (1, MP))[0],
                jax.lax.dynamic_slice(ww, (i, 0), (1, MP))[0],
            )

        def set_pairs(arrs, i, vals):
            a, b, ww = arrs
            na, nb, nw = vals
            return (
                jax.lax.dynamic_update_slice(a, na[None], (i, 0)),
                jax.lax.dynamic_update_slice(b, nb[None], (i, 0)),
                jax.lax.dynamic_update_slice(ww, nw[None], (i, 0)),
            )

        # ---- refresh the current pair row if the previous step's
        # partition dirtied it (pair row t = pairs(slice t-1 -> slice t))
        def do_refresh(args):
            pairs, flags = args
            pa, pb, pw, of = _extract_pairs_local(prev, cur, MP, stride, cell_w)
            vals = _map_pairs_to_global(pa, pb, pw, gmap_prev, gmap_cur, MP)
            return set_pairs(pairs, t, vals), flags | jnp.where(of, FLAG_MP, 0)

        (pga, pgb, pgw), flags = jax.lax.cond(
            dirty, do_refresh, lambda a: a, ((pga, pgb, pgw), flags)
        )

        # ---- consolidation of slice t-1 using pairs(t-2 -> t-1) ----
        def do_consolidate(args):
            gmap, pairs, comps, alive, gmap_prev, flags = args
            back = get_pairs(pairs, t - 1)
            ga_b, gb_b, w_b = back
            keep = _threshold_keep(ga_b, gb_b, w_b, comps[:, 0], alive, thr, NID)
            same_a = jnp.logical_and(
                ga_b[None, :] == ga_b[:, None], keep[None, :] & keep[:, None]
            )
            multi = jnp.logical_and(keep, jnp.sum(same_a, axis=1) > 1)

            # the sequential rename machinery (slot fori, chain resolution,
            # pair re-sorts) only runs when some parent actually has multiple
            # thresholded children — most steps skip it entirely
            def heavy(args2):
                gmap, pairs, comps, alive, gmap_prev, flags = args2
                comps2, alive2, ren_old, ren_res, rc = _consolidate(
                    (comps, alive), back, keep, same_a, multi, sizes
                )
                flags = flags | jnp.where(rc > sizes.MAXC, FLAG_MAXC, 0)
                # local->global row of slice t-1
                row = _rename_slots(gmap_prev, ren_old, ren_res)
                gmap = jax.lax.dynamic_update_slice(gmap, row[None], (t - 1, 0))
                # back row (t-1): b side renamed; current row (t): a side renamed
                bb2 = _rename_slots(gb_b, ren_old, ren_res)
                pairs = set_pairs(pairs, t - 1, _sort_aggregate_global(ga_b, bb2, w_b, MP))
                fa, fb, fw = get_pairs(pairs, t)
                fa2 = _rename_slots(fa, ren_old, ren_res)
                pairs = set_pairs(pairs, t, _sort_aggregate_global(fa2, fb, fw, MP))
                return gmap, pairs, comps2, alive2, row, flags

            return jax.lax.cond(jnp.any(multi), heavy, lambda a: a, args)

        gmap, (pga, pgb, pgw), comps, alive, gmap_prev, flags = jax.lax.cond(
            g >= 2,
            do_consolidate,
            lambda a: a,
            (gmap, (pga, pgb, pgw), comps, alive, gmap_prev, flags),
        )

        # ---- iterative merge resolution at slice t (<=10 iterations) ----
        def loop_cond(st):
            return jnp.logical_and(st["it"] < 10, st["pending"])

        def loop_body(st):
            cur = st["cur"]
            comps, alive = st["comps"], st["alive"]
            ga, gb, w = st["pairs"]
            gmap_cur = st["gmap_cur"]

            keep = _threshold_keep(ga, gb, w, comps[:, 0], alive, thr, NID)
            same_b = jnp.logical_and(gb[None, :] == gb[:, None], keep[None, :] & keep[:, None])
            cnt_b = jnp.sum(same_b, axis=1)
            merging = jnp.logical_and(keep, cnt_b > 1)
            has = jnp.any(merging)

            def do_partition(st):
                cur, comps, alive = st["cur"], st["comps"], st["alive"]
                ga, gb, w = st["pairs"]
                gmap_cur = st["gmap_cur"]
                next_new, lused = st["next_new"], st["lused"]
                m_cnt, ledger, flags = st["m_cnt"], st["ledger"], st["flags"]
                perr = st["perr"]

                # distinct merging children, ascending global id
                def child_slot(prev_c, _):
                    cand = jnp.where(jnp.logical_and(merging, gb > prev_c), gb, _IMAX)
                    c = jnp.min(cand)
                    return c, jnp.where(c != _IMAX, c, -1)

                _, childs = jax.lax.scan(child_slot, jnp.int32(-1), None, length=K)
                childs = childs.astype(jnp.int32)
                child_valid = childs >= 0
                n_children = jnp.sum(child_valid.astype(jnp.int32))
                # distinct merging children (slots are (a,b)-sorted, so equal
                # b values are NOT adjacent — count first-occurrences pairwise)
                idx_mp = jnp.arange(MP, dtype=jnp.int32)
                msame = jnp.logical_and(gb[None, :] == gb[:, None], merging[None, :] & merging[:, None])
                mfirst = jnp.min(jnp.where(msame, idx_mp[None, :], MP), axis=1)
                n_merging_total = jnp.sum(jnp.logical_and(merging, idx_mp == mfirst).astype(jnp.int32))
                flags = flags | jnp.where(n_merging_total > K, FLAG_K, 0)

                # parents of each child, pair-row (ascending) order
                def parents_of(c):
                    m = jnp.logical_and(gb == c, keep)
                    order = jnp.argsort(jnp.where(m, jnp.arange(MP, dtype=jnp.int32), MP))
                    sel = order[:P]
                    pvalid = m[sel]
                    return (
                        jnp.where(pvalid, ga[sel], 0),
                        jnp.where(pvalid, w[sel], 0.0),
                        pvalid,
                        jnp.sum(m.astype(jnp.int32)),
                    )

                par_g, par_w, pvalid, n_par = jax.vmap(parents_of)(jnp.where(child_valid, childs, -1))
                n_par = jnp.where(child_valid, n_par, 0)
                over_p = jnp.logical_and(child_valid, n_par > P)
                flags = flags | jnp.where(jnp.any(over_p), FLAG_P, 0)
                first_over = jnp.argmax(over_p)
                perr = jnp.where(
                    jnp.logical_and(jnp.any(over_p), perr[0] < 0),
                    jnp.stack([g, childs[first_over], n_par[first_over]]),
                    perr,
                )

                # new global ids: children ascending, parents in row order
                n_new = jnp.where(child_valid, jnp.maximum(n_par - 1, 0), 0)
                cum = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(n_new)[:-1]])
                total_new = jnp.sum(n_new)
                flags = flags | jnp.where(next_new + total_new > NID, FLAG_NID, 0)
                flags = flags | jnp.where(lused + total_new > L, FLAG_L, 0)

                pidx = jnp.arange(P, dtype=jnp.int32)[None, :]
                piece_g = jnp.where(
                    pidx == 0,
                    childs[:, None],
                    next_new + cum[:, None] + pidx - 1,
                )
                piece_g = jnp.where(pvalid, piece_g, 0)

                # piece LOCAL ids: slot 0 reuses the child's local id
                child_loc = jax.vmap(
                    lambda c: jnp.where(
                        c >= 0,
                        jnp.argmax(jnp.where(gmap_cur == c, 1, 0)).astype(jnp.int32),
                        0,
                    )
                )(childs)
                piece_l = jnp.where(
                    pidx == 0, child_loc[:, None], lused + cum[:, None] + pidx - 1 + 1
                )
                piece_l = jnp.where(pvalid, piece_l, 0)

                # register new locals in the map row of slice t (sentinel GR
                # falls outside the row and is dropped)
                flat_l = jnp.where(
                    jnp.logical_and(pvalid, jnp.logical_and(pidx > 0, piece_l <= L)), piece_l, GR
                ).reshape(-1)
                flat_g = piece_g.reshape(-1)
                gmap_cur = gmap_cur.at[flat_l].set(flat_g, mode="drop")

                # merge ledger rows (child order)
                mrow = jnp.clip(m_cnt + jnp.cumsum(child_valid.astype(jnp.int32)) - 1, 0, MAXM - 1)
                mrow = jnp.where(child_valid, mrow, MAXM)
                ledger = dict(
                    m_t=ledger["m_t"].at[mrow].set(g, mode="drop"),
                    m_np=ledger["m_np"].at[mrow].set(jnp.minimum(n_par, P), mode="drop"),
                    m_parents=ledger["m_parents"].at[mrow].set(par_g, mode="drop"),
                    m_children=ledger["m_children"].at[mrow].set(piece_g, mode="drop"),
                    m_areas=ledger["m_areas"].at[mrow].set(par_w, mode="drop"),
                )
                m_cnt2 = m_cnt + n_children
                flags = flags | jnp.where(m_cnt2 > MAXM, FLAG_MAXM, 0)

                # parent centroids + NN caps from the live table
                pc = jnp.clip(par_g, 0, NID - 1)
                if mode == "unstr":
                    clat, clon = _comps_to_latlon(comps[pc])
                    cents = jnp.stack([clat, clon], axis=-1)
                else:
                    cy, cx = _comps_to_centroid(comps[pc], W, wrap)
                    cents = jnp.stack([cy, cx], axis=-1)
                cents = jnp.where(pvalid[..., None], cents, 0.0)
                par_area = jnp.where(pvalid, comps[pc, 0], 0.0)
                max_area = jnp.max(par_area, axis=1)
                if mode == "unstr":
                    # hop cap: max(int(sqrt(A/mean_cell_area)*2), 20) * 2
                    # (track.py:1478 / reference track.py:5172)
                    mca = mesh[4]
                    mdist = jnp.maximum(jnp.floor(jnp.sqrt(max_area / mca) * 2.0), 20.0) * 2.0
                else:
                    mdist = jnp.maximum(jnp.floor(jnp.sqrt(max_area) * 3.0), 40.0)
                mdist = jnp.where(child_valid, mdist, 0.0)
                win_dyn = jnp.ceil(jnp.max(mdist)).astype(jnp.int32)
                # a window of H rows always covers the grid (y is not
                # periodic) and W cells of BFS saturate any mesh, so only
                # flag when the bucket can actually grow
                win_bound = W if mode == "unstr" else H
                if nn and sizes.MAXWIN < win_bound:
                    flags = flags | jnp.where(win_dyn > sizes.MAXWIN, FLAG_WIN, 0)
                win_dyn = jnp.clip(win_dyn, 0, sizes.MAXWIN)

                gprev = gmap_prev[jnp.clip(prev, 0, L + 1)]
                if mode == "unstr":
                    new_cur, pcomps, lane_of = _partition_batch_unstr(
                        gprev, cur, child_loc * child_valid, piece_l, par_g, pvalid,
                        cents, mdist, win_dyn, sizes, nn,
                        mesh[0], mesh[1], mesh[2], mesh[3],
                    )
                else:
                    new_cur, pcomps, lane_of = _partition_batch(
                        gprev, cur, child_loc * child_valid, piece_l, par_g, pvalid,
                        cents, mdist, win_dyn, sizes, nn, wrap,
                    )
                flags = flags | jnp.where(lane_of, FLAG_LN, 0)

                # table updates: pieces with area > 0 live; an empty piece 0
                # deletes the child (parents split/morphed); empty new pieces
                # are simply never added
                flat_gid = jnp.clip(jnp.where(pvalid, piece_g, NID).reshape(-1), 0, NID)
                flat_comps = pcomps.reshape(-1, 6)
                has_area = flat_comps[:, 0] > 0
                comps = comps.at[flat_gid].set(
                    jnp.where(has_area[:, None], flat_comps, comps[jnp.clip(flat_gid, 0, NID - 1)]),
                    mode="drop",
                )
                alive = alive.at[flat_gid].set(
                    jnp.where(pvalid.reshape(-1), has_area, alive[jnp.clip(flat_gid, 0, NID - 1)]),
                    mode="drop",
                )
                deleted_now = jnp.sum(
                    jnp.logical_and(jnp.logical_and(pvalid[:, 0], child_valid), pcomps[:, 0, 0] <= 0)
                )
                missing_now = jnp.sum(
                    jnp.logical_and(
                        jnp.logical_and(pvalid, pidx > 0), pcomps[..., 0] <= 0
                    )
                )

                # refresh pairs(t-1 -> t) from the rewritten slice
                pa, pb, pw_, of = _extract_pairs_local(prev, new_cur, MP, stride, cell_w)
                ga2, gb2, w2 = _map_pairs_to_global(pa, pb, pw_, gmap_prev, gmap_cur, MP)
                flags = flags | jnp.where(of, FLAG_MP, 0)

                return dict(
                    st,
                    cur=new_cur,
                    comps=comps,
                    alive=alive,
                    pairs=(ga2, gb2, w2),
                    gmap_cur=gmap_cur,
                    next_new=next_new + total_new,
                    lused=lused + total_new,
                    m_cnt=m_cnt2,
                    ledger=ledger,
                    flags=flags,
                    perr=perr,
                    deleted=st["deleted"] + deleted_now.astype(jnp.int32),
                    missing=st["missing"] + missing_now.astype(jnp.int32),
                    pending=jnp.bool_(True),
                    touched=jnp.bool_(True),
                )

            def no_partition(st):
                return dict(st, pending=jnp.bool_(False))

            st = jax.lax.cond(has, do_partition, no_partition, st)
            return dict(st, it=st["it"] + 1)

        st0 = dict(
            it=jnp.int32(0),
            pending=jnp.bool_(True),
            touched=jnp.bool_(False),
            cur=cur,
            comps=comps,
            alive=alive,
            pairs=get_pairs((pga, pgb, pgw), t),
            gmap_cur=gmap_cur,
            next_new=next_new,
            lused=lused,
            m_cnt=m_cnt,
            ledger=ledger,
            flags=flags,
            perr=perr,
            deleted=deleted,
            missing=missing,
        )
        st = jax.lax.while_loop(loop_cond, loop_body, st0)

        nonconv = nonconv + jnp.logical_and(st["it"] >= 10, st["pending"]).astype(jnp.int32)
        pga, pgb, pgw = set_pairs((pga, pgb, pgw), t, st["pairs"])
        gmap = jax.lax.dynamic_update_slice(gmap, st["gmap_cur"][None], (t, 0))

        carry = (
            st["cur"], gmap, pga, pgb, pgw, st["comps"], st["alive"], st["next_new"],
            st["m_cnt"], st["ledger"], st["flags"], nonconv, st["deleted"], st["missing"],
            st["touched"], st["perr"],
        )
        return carry, prev.astype(out_dtype)

    init = (
        labels[0].astype(jnp.int32), gmap0, pga, pgb, pgw, comps0, alive0, next_new0,
        m_cnt0, ledger, flags0, nonconv0, deleted0, missing0,
        jnp.bool_(False), perr0,
    )
    xs = (labels[1:], counts[1:], jnp.arange(1, T, dtype=jnp.int32))
    (last, gmap, pga, pgb, pgw, comps, alive, next_new, m_cnt, ledger, flags,
     nonconv, deleted, missing, dirty, perr), ys = jax.lax.scan(step, init, xs)

    final_labels = jnp.concatenate([ys, last[None].astype(out_dtype)], axis=0)
    return dict(
        labels=final_labels,
        gmap=gmap,
        pga=pga,
        pgb=pgb,
        pgw=pgw,
        comps=comps,
        alive=alive,
        next_new=next_new,
        m_cnt=m_cnt,
        flags=flags,
        nonconv=nonconv,
        deleted=deleted,
        missing=missing,
        perr=perr,
        **ledger,
    )


@jax.jit
def map_to_global(labels: jax.Array, gmap: jax.Array) -> jax.Array:
    """Final local -> global relabel: one gather per slice."""

    def one(lab, row):
        return row[jnp.clip(lab, 0, row.shape[0] - 1)]

    return jax.vmap(one)(labels, gmap)


# in-place variant for the in-memory march's final relabel: the local-label
# stack is dead afterwards, and at production shape aliasing the output onto
# it saves a full-field (~4.5 GB) buffer at the peak
map_to_global_donated = jax.jit(map_to_global, donate_argnums=(0,))


@partial(jax.jit, static_argnames=("time_block",))
def map_to_global_blocked(labels: jax.Array, gmap: jax.Array, time_block: int = 64) -> jax.Array:
    """:func:`map_to_global` computed per time block into an in-place output
    carry: the monolithic batched gather's working set (int16 label stack +
    int32 index temp + int32 output ~ 11 GB at production shape) would sit
    next to the live pipeline buffers; blockwise execution bounds the
    transient to one block (~0.5 GB). Used for the
    int16 stack (which the donated variant cannot alias anyway)."""
    T = labels.shape[0]
    tb = min(time_block, T)
    n_blocks = -(-T // tb)
    starts = jnp.minimum(jnp.arange(n_blocks, dtype=jnp.int32) * tb, T - tb)

    def write(i, acc):
        s0 = starts[i]
        lab = jax.lax.dynamic_slice_in_dim(labels, s0, tb, axis=0)
        rows = jax.lax.dynamic_slice_in_dim(gmap, s0, tb, axis=0)
        # clamped final block recomputes overlapped rows with identical values
        return jax.lax.dynamic_update_slice_in_dim(acc, map_to_global(lab, rows), s0, axis=0)

    out0 = jnp.zeros(labels.shape, jnp.int32)
    return jax.lax.fori_loop(0, n_blocks, write, out0)
