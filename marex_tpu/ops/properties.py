"""
Per-object property kernels: areas & centroids via segment reductions.

Device replacement for skimage ``regionprops_table`` per slice
(track.py:2332-2390) and the unstructured spherical-centroid accumulation
(track.py:2159-2250): one scatter-add pass per quantity, vectorised over the
whole (time, space) block, with the reference's periodic-longitude centroid
fix (track.py:2050-2107) reproduced from per-label edge flags.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

EDGE_ZONE = 100  # cells from the x-boundary counting as "near the edge" (track.py:2075-2076)


def _map_row_blocks(fn, arrays, T: int, tb: int):
    """
    Apply ``fn`` over ``tb``-row blocks of (T, ...) ``arrays`` and stitch the
    per-row outputs back in order — WITHOUT padding T to a block multiple
    (``jnp.pad`` materialises a second full-size copy of each input, ~5 GB
    per field at production shape). The final block's start is clamped into
    bounds, so overlapped rows are recomputed with identical values and the
    row scatter routes every block row to its true position.

    fn : (block_0, block_1, ...) -> (tb, ...) per-row output
    returns (T, ...) stacked outputs.
    """
    n_blocks = -(-T // tb)
    starts = jnp.minimum(jnp.arange(n_blocks, dtype=jnp.int32) * tb, T - tb)

    def blk(t0):
        return fn(*[jax.lax.dynamic_slice_in_dim(a, t0, tb, axis=0) for a in arrays])

    out = jax.lax.map(blk, starts)  # (n_blocks, tb, ...)
    rows = (starts[:, None] + jnp.arange(tb, dtype=jnp.int32)[None, :]).reshape(-1)
    flat = out.reshape((n_blocks * tb,) + out.shape[2:])
    return jnp.zeros((T,) + flat.shape[1:], flat.dtype).at[rows].set(flat)


@partial(jax.jit, static_argnames=("n_labels",))
def label_sums(labels: jax.Array, weights: jax.Array, n_labels: int) -> jax.Array:
    """
    Segment-sum of ``weights`` by label.

    labels : (T, *spatial) int32 in [0, n_labels] — rank-polymorphic: 3-D
        grid fields are flattened PER BLOCK (a whole-field (T, S) reshape can
        be a relayout copy, ~4.5 GB at production shape)
    weights : (S,) flat per-cell, or (T, *spatial) float32
    returns (T, n_labels + 1) — index 0 is background.
    """
    T = labels.shape[0]
    sp = labels.shape[1:]
    S = 1
    for d in sp:
        S *= int(d)
    per_cell = weights.ndim == 1
    weights = weights.astype(jnp.float32)
    if n_labels <= 96:
        # small label ranges: one fused compare+reduce pass per label in
        # place of a full-field scatter-add
        wbc = weights.reshape(sp)[None] if per_cell else weights
        red = tuple(range(1, labels.ndim))
        cols = [
            jnp.sum(jnp.where(labels == lbl, wbc, 0.0), axis=red) for lbl in range(n_labels + 1)
        ]
        return jnp.stack(cols, axis=1)
    # large label ranges: per-row scatter-add, tiled over row blocks so the
    # iota/index temporaries stay bounded (full-width they are several GB at
    # production scale)
    tb = min(64, T)

    def blk(lb, *wrest):
        lb = lb.reshape(lb.shape[0], S)
        wb = wrest[0].reshape(lb.shape) if wrest else jnp.broadcast_to(weights[None], lb.shape)
        t_idx = jax.lax.broadcasted_iota(jnp.int32, lb.shape, 0)
        return jnp.zeros((lb.shape[0], n_labels + 1), jnp.float32).at[t_idx, lb].add(wb)

    arrays = (labels,) if per_cell else (labels, weights)
    return _map_row_blocks(blk, arrays, T, tb)


@partial(jax.jit, static_argnames=("n_events", "time_block"))
def event_global_id(new_flat: jax.Array, old_flat: jax.Array, n_events: int, time_block: int = 64) -> jax.Array:
    """
    (time, ID) table of the ORIGINAL object id each event carries at each
    time (track.py:2937-2992) — a per-row max-combining scatter, tiled over
    row blocks (the full-width iota/index temporaries are several GB at
    production scale).

    new_flat : (T, *spatial) int32 event ids (1..n_events, 0 = background);
        rank-polymorphic — grid fields are flattened per block, never whole
    old_flat : (T, *spatial) int32 original object ids
    returns (T, n_events + 1) int32, column 0 unused
    """
    T = new_flat.shape[0]
    tb = min(time_block, T)

    def blk(nfb, ofb):
        nfb = nfb.reshape(nfb.shape[0], -1)
        ofb = ofb.reshape(nfb.shape)
        t_idx = jax.lax.broadcasted_iota(jnp.int32, nfb.shape, 0)
        cols = jnp.where(nfb > 0, nfb, n_events + 1)
        return jnp.zeros((nfb.shape[0], n_events + 2), jnp.int32).at[t_idx, cols].max(ofb)

    return _map_row_blocks(blk, (new_flat, old_flat), T, tb)[:, : n_events + 1]


@partial(jax.jit, static_argnames=("n_events", "time_block"))
def event_global_id_lookup(old_flat: jax.Array, lookup: jax.Array, n_events: int, time_block: int = 64) -> jax.Array:
    """
    :func:`event_global_id` with the NEW ids derived in-block via
    ``lookup[old]`` instead of passed as a second full-size field. The
    cluster-rename stage uses this to build the (time, ID) table BEFORE the
    full-field remap, so the remap can donate the old-id buffer — at
    production shape that removes a 4.5 GB concurrent allocation.
    """
    T = old_flat.shape[0]
    tb = min(time_block, T)

    if n_events <= 64:
        # unrolled compare+max: n_events fused compare+reduce passes in
        # place of a scatter-max over (tb, S) — the same trade as
        # label.select_labels
        def blk(ofb):
            ofb = ofb.reshape(ofb.shape[0], -1)
            nfb = jnp.take(lookup, ofb)
            cols = [jnp.zeros((ofb.shape[0],), jnp.int32)]
            for e in range(1, n_events + 1):
                cols.append(jnp.max(jnp.where(nfb == e, ofb, 0), axis=1))
            return jnp.stack(cols, axis=1)

        out = _map_row_blocks(blk, (old_flat,), T, tb)
        return out

    def blk(ofb):
        ofb = ofb.reshape(ofb.shape[0], -1)
        nfb = jnp.take(lookup, ofb)
        t_idx = jax.lax.broadcasted_iota(jnp.int32, nfb.shape, 0)
        cols = jnp.where(nfb > 0, nfb, n_events + 1)
        return jnp.zeros((nfb.shape[0], n_events + 2), jnp.int32).at[t_idx, cols].max(ofb)

    return _map_row_blocks(blk, (old_flat,), T, tb)[:, : n_events + 1]


@partial(jax.jit, static_argnames=("n_labels",))
def grid_label_comps(labels: jax.Array, n_labels: int) -> jax.Array:
    """
    Raw per-label property components on a regular grid — the six sums the
    periodic-centroid formula (track.py:2075-2107) is built from:
    ``[area, sum_y, sum_x, count(x > W/2), count(x < EDGE_ZONE),
    count(x >= W - EDGE_ZONE)]``. Unlike :func:`grid_label_props` this
    returns the components themselves, which combine EXACTLY under object
    merges by addition — the on-device merge march's analytic object table.

    labels : (T, H, W) int32 dense in [0, n_labels]
    Returns (T, n_labels + 1, 6) float32.
    """
    T, H, W = labels.shape
    y_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0).reshape(H * W)
    x_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1).reshape(H * W)
    w = jnp.ones((H * W,), jnp.float32)
    wall = jnp.stack(
        [
            w,
            y_idx,
            x_idx,
            (x_idx > W / 2).astype(jnp.float32),
            (x_idx < EDGE_ZONE).astype(jnp.float32),
            (x_idx >= W - EDGE_ZONE).astype(jnp.float32),
        ]
    )  # (6, S)

    def block(lfb):
        lfb = lfb.reshape(lfb.shape[0], H * W)  # per-block flatten, not whole-field

        def per_label(_, lbl):
            m = (lfb == lbl).astype(jnp.float32)
            return None, jnp.einsum("ks,ts->tk", wall, m, precision=jax.lax.Precision.HIGHEST)

        _, out = jax.lax.scan(per_label, None, jnp.arange(n_labels + 1, dtype=jnp.int32))
        return jnp.moveaxis(out, 0, 1)

    return _map_row_blocks(block, (labels,), T, min(64, T))


@partial(jax.jit, static_argnames=("n_labels",))
def unstructured_label_comps(
    labels: jax.Array, lat_deg: jax.Array, lon_deg: jax.Array, cell_area: jax.Array, n_labels: int
) -> jax.Array:
    """
    Raw additive property components per label on an unstructured mesh: the
    four sums the spherical-centroid formula (track.py:2195-2230) is built
    from — ``[area, sum a*x, sum a*y, sum a*z]`` with (x, y, z) the unit-
    sphere embedding. Like :func:`grid_label_comps` these combine EXACTLY
    under object merges by addition (the scan march's object table).

    labels : (T, C) int32 dense in [0, n_labels]
    Returns (T, n_labels + 1, 4) float32.
    """
    T, C = labels.shape
    lat = jnp.deg2rad(lat_deg.astype(jnp.float32))
    lon = jnp.deg2rad(lon_deg.astype(jnp.float32))
    cos_lat = jnp.cos(lat)
    a = cell_area.astype(jnp.float32)
    wall = jnp.stack([a, a * cos_lat * jnp.cos(lon), a * cos_lat * jnp.sin(lon), a * jnp.sin(lat)])  # (4, C)

    def block(lfb):
        def per_label(_, lbl):
            m = (lfb == lbl).astype(jnp.float32)
            return None, jnp.einsum("ks,ts->tk", wall, m, precision=jax.lax.Precision.HIGHEST)

        _, out = jax.lax.scan(per_label, None, jnp.arange(n_labels + 1, dtype=jnp.int32))
        return jnp.moveaxis(out, 0, 1)

    return _map_row_blocks(block, (labels,), T, min(64, T))


@partial(jax.jit, static_argnames=("n_labels", "wrap"))
def grid_label_props(
    labels: jax.Array, n_labels: int, wrap: bool, cell_weights: jax.Array | None = None
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Areas + (y, x) pixel centroids per label on a regular grid, with the
    reference's periodic-boundary recentring: when a label touches both x
    edges, x indices greater than Nx/2 are shifted by -Nx before averaging
    and the mean re-wrapped positive (track.py:2085-2097).

    labels : (T, H, W) int32 dense in [0, n_labels]
    cell_weights : optional (H, W) weights (physical cell areas); when None,
        area = pixel count and centroids are unweighted (regionprops parity).

    Returns
    -------
    areas : (T, n_labels + 1) float32
    cy, cx : (T, n_labels + 1) float32 pixel-coordinate centroids (NaN where absent)
    """
    T, H, W = labels.shape
    y_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0).reshape(H * W)
    x_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1).reshape(H * W)

    if cell_weights is None:
        w = jnp.ones((H * W,), jnp.float32)
    else:
        w = cell_weights.reshape(H * W).astype(jnp.float32)

    wy = w * y_idx
    wx = w * x_idx
    wr = w * (x_idx > W / 2)
    fl = (x_idx < EDGE_ZONE).astype(jnp.float32)
    fr = (x_idx >= W - EDGE_ZONE).astype(jnp.float32)

    if n_labels <= 4096:
        # all six reductions share each label's equality mask: ONE fused pass
        # per label instead of six separate label_sums sweeps. The label loop
        # is a lax.scan (sequential scheduling — an unrolled loop let XLA keep
        # every (T, S) mask alive concurrently and OOM at production scale)
        # and rows are tiled via lax.map like every other whole-field kernel.
        wall = jnp.stack([w, wy, wx, wr, fl, fr])  # (6, S)

        def block(lfb):
            lfb = lfb.reshape(lfb.shape[0], H * W)  # per-block flatten

            def per_label(_, lbl):
                m = (lfb == lbl).astype(jnp.float32)  # (TB, S)
                sums = jnp.einsum("ks,ts->tk", wall, m, precision=jax.lax.Precision.HIGHEST)  # (TB, 6)
                return None, sums

            _, out = jax.lax.scan(per_label, None, jnp.arange(n_labels + 1, dtype=jnp.int32))
            return jnp.moveaxis(out, 0, 1)  # (TB, n_labels+1, 6)

        stacked = _map_row_blocks(block, (labels,), T, min(64, T))
        areas = stacked[..., 0]
        sum_y = stacked[..., 1]
        sum_x = stacked[..., 2]
        cnt_right = stacked[..., 3]
        near_left = stacked[..., 4] > 0
        near_right = stacked[..., 5] > 0
    else:
        areas = label_sums(labels, w, n_labels)
        sum_y = label_sums(labels, wy, n_labels)
        sum_x = label_sums(labels, wx, n_labels)
        cnt_right = label_sums(labels, wr, n_labels)
        near_left = label_sums(labels, fl, n_labels) > 0
        near_right = label_sums(labels, fr, n_labels) > 0

    safe = jnp.maximum(areas, 1e-30)
    cy = sum_y / safe
    cx_plain = sum_x / safe
    cx_adj = (sum_x - W * cnt_right) / safe
    cx_adj = jnp.where(cx_adj < 0, cx_adj + W, cx_adj)

    wrapped = jnp.logical_and(near_left, near_right) if wrap else jnp.zeros_like(near_left)
    cx = jnp.where(wrapped, cx_adj, cx_plain)

    present = areas > 0
    cy = jnp.where(present, cy, jnp.nan)
    cx = jnp.where(present, cx, jnp.nan)
    areas = jnp.where(present, areas, 0.0)
    return areas, cy, cx


def grid_mask_props(mask: jax.Array, wrap: bool) -> jax.Array:
    """(area, cy, cx) of ONE boolean (H, W) mask with the march's EDGE_ZONE
    periodic recentring rule (track.py:2075-2107). Returns a (3,) float32."""
    H, W = mask.shape
    y_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x_idx = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    w = mask.astype(jnp.float32)
    area = jnp.sum(w)
    safe = jnp.maximum(area, 1e-30)
    cy = jnp.sum(w * y_idx) / safe
    sum_x = jnp.sum(w * x_idx)
    cnt_right = jnp.sum(w * (x_idx > W / 2))
    cx_plain = sum_x / safe
    cx_adj = (sum_x - W * cnt_right) / safe
    cx_adj = jnp.where(cx_adj < 0, cx_adj + W, cx_adj)
    near_l = jnp.any(jnp.logical_and(mask, x_idx < EDGE_ZONE))
    near_r = jnp.any(jnp.logical_and(mask, x_idx >= W - EDGE_ZONE))
    wrapped = jnp.logical_and(near_l, near_r) if wrap else jnp.bool_(False)
    cx = jnp.where(wrapped, cx_adj, cx_plain)
    return jnp.stack([area, cy, cx])


@partial(jax.jit, static_argnames=("wrap",))
def slice_props_for_ids_grid(labels: jax.Array, ids: jax.Array, wrap: bool) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    (area, cy, cx) for SPECIFIC ids on one (H, W) label slice — the device
    analogue of the merge march's per-id host recompute. One fused masked
    multi-reduction per id, vmapped; ids 0-padded.

    Returns (M,) float32 triples; area 0 marks an absent id.
    """
    props = jax.vmap(lambda oid: grid_mask_props(jnp.logical_and(labels == oid, oid > 0), wrap))(ids)
    return props[:, 0], props[:, 1], props[:, 2]


def unstructured_mask_props(mask: jax.Array, lat_deg: jax.Array, lon_deg: jax.Array, cell_area: jax.Array) -> jax.Array:
    """(area, clat, clon) of ONE boolean (C,) mask: cell-area weighted
    spherical centroid (track.py:2195-2230), matching the march's host
    recompute bit-for-bit in formula. Returns a (3,) float32."""
    w = jnp.where(mask, cell_area, 0.0).astype(jnp.float32)
    area = jnp.sum(w)
    lat_r = jnp.radians(lat_deg)
    lon_r = jnp.radians(lon_deg)
    x = jnp.sum(w * jnp.cos(lat_r) * jnp.cos(lon_r))
    y = jnp.sum(w * jnp.cos(lat_r) * jnp.sin(lon_r))
    z = jnp.sum(w * jnp.sin(lat_r))
    norm = jnp.maximum(jnp.sqrt(x * x + y * y + z * z), 1e-30)
    clat = jnp.degrees(jnp.arcsin(jnp.clip(z / norm, -1, 1)))
    clon = jnp.degrees(jnp.arctan2(y / norm, x / norm))
    clon = jnp.where(clon > 180, clon - 360, clon)
    clon = jnp.where(clon < -180, clon + 360, clon)
    return jnp.stack([area, clat, clon])


@partial(jax.jit, static_argnames=("n_labels",))
def unstructured_label_props(
    labels: jax.Array, lat_deg: jax.Array, lon_deg: jax.Array, cell_area: jax.Array, n_labels: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Area-weighted spherical centroids per label on an unstructured mesh:
    accumulate Cartesian (x, y, z) weighted by cell area, renormalise, and
    convert back to (lat, lon) degrees in [-90, 90] x [-180, 180]
    (track.py:2195-2230).

    labels : (T, C) int32 dense in [0, n_labels]

    Returns areas, clat, clon — each (T, n_labels + 1) float32.
    """
    lat = jnp.deg2rad(lat_deg.astype(jnp.float32))
    lon = jnp.deg2rad(lon_deg.astype(jnp.float32))
    cos_lat = jnp.cos(lat)
    x = cos_lat * jnp.cos(lon)
    y = cos_lat * jnp.sin(lon)
    z = jnp.sin(lat)
    a = cell_area.astype(jnp.float32)

    areas = label_sums(labels, a, n_labels)
    wx = label_sums(labels, a * x, n_labels)
    wy = label_sums(labels, a * y, n_labels)
    wz = label_sums(labels, a * z, n_labels)

    norm = jnp.sqrt(wx**2 + wy**2 + wz**2)
    norm = jnp.where(norm > 0, norm, 1.0)
    wx, wy, wz = wx / norm, wy / norm, wz / norm

    clat = jnp.rad2deg(jnp.arcsin(jnp.clip(wz, -1.0, 1.0)))
    clon = jnp.rad2deg(jnp.arctan2(wy, wx))
    clon = jnp.where(clon > 180.0, clon - 360.0, jnp.where(clon < -180.0, clon + 360.0, clon))

    present = areas > 0
    clat = jnp.where(present, clat, jnp.nan)
    clon = jnp.where(present, clon, jnp.nan)
    return areas, clat, clon


@jax.jit
def interp_coord(pix: jax.Array, coord_values: jax.Array) -> jax.Array:
    """Linear pixel-index -> coordinate interpolation (np.interp semantics)."""
    n = coord_values.shape[0]
    return jnp.interp(pix, jnp.arange(n, dtype=jnp.float32), coord_values.astype(jnp.float32))
