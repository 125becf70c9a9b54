"""
Child-object partitioning kernels for split/merge tracking.

Device re-design of the reference's Numba partitioning kernels
(track.py:4826-5419):

* ``wrapped_euclidian_distance_mask_parallel``  -> dense wrapped-distance
  argmin over parent centroids (:func:`centroid_assign_grid`)
* ``partition_nn_grid``       -> exact Euclidean distance transform per
  parent (separable two-pass EDT: periodic 1-D row scan + column lower
  envelope), then argmin. The reference approximates nearest-cell search with
  a coarse bucket grid; the EDT here is exact, capped at the same
  ``max_distance`` with the same parent-centroid fallback.
* ``partition_nn_unstructured``  -> multi-source hop-distance BFS by iterated
  neighbour-graph dilation from the parent∩child seed region, haversine
  centroid fallback for unreached cells.
* ``partition_centroid_unstructured`` -> vectorised haversine argmin.

All kernels take a *padded* parent axis (static ``P = max_parents``) with a
validity mask so shapes stay static under jit.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp

_INF = np.float32(np.inf)


# ----------------------------------------------------------------------------
# Structured grid
# ----------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("wrap",))
def centroid_assign_grid(
    parent_centroids: jax.Array, parent_valid: jax.Array, shape_y: jax.Array, wrap: bool = True
) -> jax.Array:
    """
    Parent-index assignment of every grid cell by wrapped Euclidean distance
    to parent centroids (pixel coordinates), cf. track.py:4826-4884.

    parent_centroids : (P, 2) float32 (cy, cx) pixel coords
    parent_valid : (P,) bool
    shape_y : (H, W) any array fixing the grid shape (values unused)

    Returns (H, W) int32 parent index (argmin; ties -> lowest index).
    """
    H, W = shape_y.shape
    y = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    cy = parent_centroids[:, 0]
    cx = parent_centroids[:, 1]
    dy = y[None] - cy[:, None, None]
    dx = x[None] - cx[:, None, None]
    if wrap:
        half = W / 2.0
        dx = jnp.where(dx > half, dx - W, dx)
        dx = jnp.where(dx < -half, dx + W, dx)
    d2 = dy * dy + dx * dx
    d2 = jnp.where(parent_valid[:, None, None], d2, _INF)
    return jnp.argmin(d2, axis=0).astype(jnp.int32)


def _row_distance_periodic(mask: jax.Array, wrap: bool) -> jax.Array:
    """
    1-D distance (in cells) to the nearest True along the last axis, periodic
    when ``wrap``.  mask : (..., W) bool -> float32 distances (inf if empty).
    """
    W = mask.shape[-1]
    x = jnp.moveaxis(mask, -1, 0)  # (W, ...)

    def fwd(carry, m):
        d = jnp.where(m, 0.0, carry + 1.0)
        return d, d

    init = jnp.full(x.shape[1:], jnp.float32(W * 4))
    if wrap:
        # two passes around the circle capture wrap-around sources
        carry, d1 = jax.lax.scan(fwd, init, x)
        _, d1b = jax.lax.scan(fwd, carry, x)
        d_fwd = d1b
    else:
        _, d_fwd = jax.lax.scan(fwd, init, x)

    xr = x[::-1]
    if wrap:
        carry, d2 = jax.lax.scan(fwd, init, xr)
        _, d2b = jax.lax.scan(fwd, carry, xr)
        d_bwd = d2b[::-1]
    else:
        _, d2 = jax.lax.scan(fwd, init, xr)
        d_bwd = d2[::-1]

    d = jnp.minimum(d_fwd, d_bwd)
    d = jnp.where(d >= W * 2, _INF, d)
    return jnp.moveaxis(d, 0, -1)


@partial(jax.jit, static_argnames=("wrap", "row_window"))
def euclidean_distance_transform_grid(
    parent_masks: jax.Array, wrap: bool = True, row_window: int = 0
) -> jax.Array:
    """
    Exact squared Euclidean distance to the nearest True cell, per parent,
    periodic in x.  Two-pass separable EDT.

    parent_masks : (P, H, W) bool
    row_window : when > 0, the column pass only scans seed rows within
        ``row_window`` of each output row — distances beyond the window come
        out too large, which is EXACT for every distance <= row_window (the
        merge march caps distances at ``max_distance`` and passes a window
        covering the cap). Cuts the column-pass cost from O(H^2 P W) to
        O(H P W window).

    Returns (P, H, W) float32 squared distances (inf where parent empty).
    """
    P, H, W = parent_masks.shape
    d1 = _row_distance_periodic(parent_masks, wrap)  # (P, H, W) distance within row
    d1sq = jnp.where(jnp.isinf(d1), _INF, d1 * d1)

    if row_window and 2 * row_window + 1 < H:
        win = int(row_window)
        padded = jnp.pad(d1sq, ((0, 0), (win, win), (0, 0)), constant_values=_INF)
        dy2 = (jnp.arange(-win, win + 1, dtype=jnp.float32)) ** 2

        def per_row_w(y0):
            seg = jax.lax.dynamic_slice(padded, (0, y0, 0), (P, 2 * win + 1, W))
            return jnp.min(seg + dy2[None, :, None], axis=1)  # (P, W)

        out = jax.lax.map(per_row_w, jnp.arange(H))
        return jnp.moveaxis(out, 0, 1)

    yy = jnp.arange(H, dtype=jnp.float32)

    def per_row(y0):
        dy2 = (yy - y0) ** 2  # (H,)
        v = d1sq + dy2[None, :, None]  # (P, H, W)
        return jnp.min(v, axis=1)  # (P, W)

    out = jax.lax.map(per_row, yy)  # (H, P, W)
    return jnp.moveaxis(out, 0, 1)


@partial(jax.jit, static_argnames=("wrap", "row_window"))
def partition_nn_grid(
    child_mask: jax.Array,
    parent_masks: jax.Array,
    parent_valid: jax.Array,
    parent_centroids: jax.Array,
    max_distance: jax.Array,
    wrap: bool = True,
    row_window: int = 0,
) -> jax.Array:
    """
    Assign every cell to its nearest parent *cell* (exact EDT, capped at
    ``max_distance``), falling back to nearest parent *centroid* for cells
    beyond the cap — the semantics of track.py:4972-5113. ``row_window``
    must cover ``max_distance`` when nonzero (see
    :func:`euclidean_distance_transform_grid`).

    Returns (H, W) int32 parent index.
    """
    d2 = euclidean_distance_transform_grid(parent_masks, wrap, row_window)  # (P, H, W)
    d = jnp.sqrt(d2)
    d = jnp.where(parent_valid[:, None, None], d, _INF)
    d = jnp.where(d <= max_distance, d, _INF)

    assign = jnp.argmin(d, axis=0).astype(jnp.int32)
    reached = jnp.isfinite(jnp.min(d, axis=0))

    fallback = centroid_assign_grid(parent_centroids, parent_valid, child_mask, wrap)
    return jnp.where(reached, assign, fallback)


# ----------------------------------------------------------------------------
# Unstructured mesh
# ----------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("nn", "wrap", "row_window"))
def partition_children_grid_batched(
    prev_labels: jax.Array,
    cur_labels: jax.Array,
    child_ids: jax.Array,
    piece_ids: jax.Array,
    parent_ids: jax.Array,
    parent_valid: jax.Array,
    parent_cents: jax.Array,
    max_dist: jax.Array,
    nn: bool,
    wrap: bool,
    row_window: int = 0,
) -> jax.Array:
    """
    Partition ALL merging children of one timestep iteration in ONE device
    program — the batched analogue of the reference's parallel split/merge
    (track.py:3804-4814). Children are spatially disjoint and parents live
    in the (unchanged) previous slice, so batching is exactly equivalent to
    the sequential per-child loop; it removes the per-event mask uploads /
    assignment downloads that dominate merge-dense tracking over a slow
    device link.

    prev_labels, cur_labels : (H, W) int32 label slices at t-1 / t
    child_ids    : (K,) int32 merging child ids (0 = inactive slot)
    piece_ids    : (K, P) int32 replacement ids per parent slot
    parent_ids   : (K, P) int32 parent ids at t-1 (0 = invalid)
    parent_valid : (K, P) bool
    parent_cents : (K, P, 2) float32 (y, x) pixel centroids
    max_dist     : (K,) float32 NN search cap per child

    Returns the updated (H, W) int32 current slice.
    """

    from .properties import grid_mask_props

    def one(cid, pids, valid, piece, cents, mdist):
        child_mask = jnp.logical_and(cur_labels == cid, cid > 0)
        if nn:
            pmasks = jnp.logical_and(prev_labels[None] == pids[:, None, None], valid[:, None, None])
            assign = partition_nn_grid(child_mask, pmasks, valid, cents, mdist, wrap, row_window)
        else:
            assign = centroid_assign_grid(cents, valid, child_mask, wrap)
        update = jnp.where(child_mask, piece[assign], 0)
        # per-piece props in the SAME program (saves a dispatch roundtrip)
        P = pids.shape[0]
        piece_masks = jnp.logical_and(child_mask[None], assign[None] == jnp.arange(P)[:, None, None])
        pr = jax.vmap(lambda m: grid_mask_props(m, wrap))(piece_masks)  # (P, 3)
        return update, pr

    updates, props = jax.vmap(one)(child_ids, parent_ids, parent_valid, piece_ids, parent_cents, max_dist)
    upd = jnp.max(updates, axis=0)  # children are disjoint
    return jnp.where(upd > 0, upd, cur_labels), props


@jax.jit
def relabel_values_slice(labels: jax.Array, olds: jax.Array, news: jax.Array) -> jax.Array:
    """Apply (old -> new) id renames to one label slice in a single program
    (the consolidation renames of the merge march). Renames are applied
    against the ORIGINAL values — callers pre-resolve chains."""

    def body(out, pair):
        old, new = pair
        return jnp.where(jnp.logical_and(labels == old, old > 0), new, out), None

    out, _ = jax.lax.scan(body, labels, (olds, news))
    return out


@partial(jax.jit, static_argnames=("wrap",))
def relabel_and_props_slice(
    labels: jax.Array, olds: jax.Array, news: jax.Array, targets: jax.Array, wrap: bool
):
    """Consolidation renames + recomputed props of the surviving targets in
    ONE device program (one dispatch roundtrip instead of two)."""
    from .properties import grid_mask_props

    out = relabel_values_slice(labels, olds, news)
    props = jax.vmap(lambda oid: grid_mask_props(jnp.logical_and(out == oid, oid > 0), wrap))(targets)
    return out, props


@partial(jax.jit, static_argnames=("nn", "hop_cap"))
def partition_children_unstructured_batched(
    prev_labels: jax.Array,
    cur_labels: jax.Array,
    child_ids: jax.Array,
    piece_ids: jax.Array,
    parent_ids: jax.Array,
    parent_valid: jax.Array,
    parent_cents: jax.Array,
    caps: jax.Array,
    neighbours: jax.Array,
    lat_deg: jax.Array,
    lon_deg: jax.Array,
    cell_area: jax.Array,
    nn: bool,
    hop_cap: int,
):
    """
    Batched unstructured child partitioning + per-piece spherical props in
    one program — the mesh analogue of :func:`partition_children_grid_batched`
    and the device counterpart of the reference's batched parallel
    split/merge (track.py:3804-4814). The BFS runs to the static ``hop_cap``
    (batch maximum, bucketed by the caller) and each child's own cap is
    enforced by masking, which is semantics-identical to per-child BFS caps.

    prev_labels, cur_labels : (C,) int32 label slices at t-1 / t
    caps : (K,) float32 per-child NN distance caps (hops)
    returns (updated (C,) int32 slice, props (K, P, 3) [area, clat, clon])
    """
    from .properties import unstructured_mask_props

    def one(cid, pids, valid, piece, cents, cap):
        child_mask = jnp.logical_and(cur_labels == cid, cid > 0)
        if nn:
            pmasks = jnp.logical_and(prev_labels[None] == pids[:, None], valid[:, None])
            seeds = jnp.logical_and(pmasks, child_mask[None])
            dist = hop_distance_unstructured(seeds, neighbours, hop_cap)
            dist = jnp.where(dist <= cap, dist, _INF)
            dist = jnp.where(valid[:, None], dist, _INF)
            assign = jnp.argmin(dist, axis=0).astype(jnp.int32)
            reached = jnp.isfinite(jnp.min(dist, axis=0))
            hd = haversine_to_centroids(lat_deg, lon_deg, cents)
            hd = jnp.where(valid[:, None], hd, _INF)
            fallback = jnp.argmin(hd, axis=0).astype(jnp.int32)
            assign = jnp.where(reached, assign, fallback)
        else:
            assign = partition_centroid_unstructured(cents, valid, lat_deg, lon_deg)
        update = jnp.where(child_mask, piece[assign], 0)
        P = pids.shape[0]
        piece_masks = jnp.logical_and(child_mask[None], assign[None] == jnp.arange(P)[:, None])
        pr = jax.vmap(lambda m: unstructured_mask_props(m, lat_deg, lon_deg, cell_area))(piece_masks)
        return update, pr

    updates, props = jax.vmap(one)(child_ids, parent_ids, parent_valid, piece_ids, parent_cents, caps)
    upd = jnp.max(updates, axis=0)
    return jnp.where(upd > 0, upd, cur_labels), props


@partial(jax.jit, static_argnames=())
def relabel_and_props_unstructured(
    labels: jax.Array,
    olds: jax.Array,
    news: jax.Array,
    targets: jax.Array,
    lat_deg: jax.Array,
    lon_deg: jax.Array,
    cell_area: jax.Array,
):
    """Unstructured consolidation: renames + recomputed spherical props of the
    surviving targets in one device program."""
    from .properties import unstructured_mask_props

    out = relabel_values_slice(labels, olds, news)
    props = jax.vmap(
        lambda oid: unstructured_mask_props(jnp.logical_and(out == oid, oid > 0), lat_deg, lon_deg, cell_area)
    )(targets)
    return out, props


@partial(jax.jit, static_argnames=("max_distance",))
def hop_distance_unstructured(seed_masks: jax.Array, neighbours: jax.Array, max_distance: int) -> jax.Array:
    """
    Multi-source hop distance from each parent's seed region by iterated
    graph dilation (the BFS of track.py:5189-5222).

    seed_masks : (P, C) bool
    Returns (P, C) float32 hop counts (inf where unreached within cap).
    """
    idx = jnp.maximum(neighbours, 0)
    valid = neighbours >= 0

    def body(d, state):
        visited, dist = state
        g = visited[:, idx]  # (P, 3, C)
        g = jnp.logical_and(g, valid[None])
        new_visited = jnp.logical_or(visited, jnp.any(g, axis=1))
        newly = jnp.logical_and(new_visited, ~visited)
        dist = jnp.where(newly, (d + 1).astype(jnp.float32), dist)
        return new_visited, dist

    dist0 = jnp.where(seed_masks, 0.0, _INF)
    visited, dist = jax.lax.fori_loop(0, max_distance, body, (seed_masks, dist0))
    return dist


@jax.jit
def haversine_to_centroids(lat_deg: jax.Array, lon_deg: jax.Array, parent_centroids: jax.Array) -> jax.Array:
    """
    Great-circle angular distance from every cell to each parent centroid
    (track.py:5406-5411).

    lat_deg, lon_deg : (C,); parent_centroids : (P, 2) degrees (lat, lon)
    Returns (P, C) float32.
    """
    lat = jnp.deg2rad(lat_deg.astype(jnp.float32))
    lon = jnp.deg2rad(lon_deg.astype(jnp.float32))
    plat = jnp.deg2rad(parent_centroids[:, 0:1].astype(jnp.float32))
    plon = jnp.deg2rad(parent_centroids[:, 1:2].astype(jnp.float32))
    dlat = plat - lat[None, :]
    dlon = plon - lon[None, :]
    a = jnp.sin(dlat / 2) ** 2 + jnp.cos(lat)[None, :] * jnp.cos(plat) * jnp.sin(dlon / 2) ** 2
    return 2 * jnp.arctan2(jnp.sqrt(a), jnp.sqrt(jnp.maximum(1 - a, 0.0)))


@partial(jax.jit, static_argnames=("max_distance",))
def partition_nn_unstructured(
    child_mask: jax.Array,
    parent_masks: jax.Array,
    parent_valid: jax.Array,
    parent_centroids: jax.Array,
    neighbours: jax.Array,
    lat_deg: jax.Array,
    lon_deg: jax.Array,
    max_distance: int,
) -> jax.Array:
    """
    Nearest-parent partitioning on the mesh: BFS frontier expansion from each
    parent's overlap with the child (hop distance), haversine centroid
    fallback for unreached cells (track.py:5116-5242).

    Returns (C,) int32 parent index for every cell.
    """
    seeds = jnp.logical_and(parent_masks, child_mask[None, :])
    seeds = jnp.logical_and(seeds, parent_valid[:, None])
    dist = hop_distance_unstructured(seeds, neighbours, max_distance)
    dist = jnp.where(parent_valid[:, None], dist, _INF)

    assign = jnp.argmin(dist, axis=0).astype(jnp.int32)
    reached = jnp.isfinite(jnp.min(dist, axis=0))

    hd = haversine_to_centroids(lat_deg, lon_deg, parent_centroids)
    hd = jnp.where(parent_valid[:, None], hd, _INF)
    fallback = jnp.argmin(hd, axis=0).astype(jnp.int32)
    return jnp.where(reached, assign, fallback)


@jax.jit
def partition_centroid_unstructured(
    parent_centroids: jax.Array, parent_valid: jax.Array, lat_deg: jax.Array, lon_deg: jax.Array
) -> jax.Array:
    """Closest-parent-centroid assignment on the sphere (track.py:5356-5419)."""
    hd = haversine_to_centroids(lat_deg, lon_deg, parent_centroids)
    hd = jnp.where(parent_valid[:, None], hd, _INF)
    return jnp.argmin(hd, axis=0).astype(jnp.int32)
