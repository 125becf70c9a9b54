"""
Connected-component labeling (CCL) as fixed-point min-label propagation.

Device replacement for the reference's labeling substrate:

* per-timestep 2-D labeling with 8-connectivity and periodic longitude
  <- dask_image.ndmeasure.label(structure 2-D, wrap_axes=(2,))
     (track.py:2007-2034)
* full 3-D spatio-temporal labeling (time connectivity, Scannell-style)
  <- dask_image label with a full 3x3x3 structure (track.py:2011-2013)
* per-timestep labeling over unstructured neighbour graphs
  <- scipy csgraph connected_components per slice (track.py:1947-1999)

Algorithm: every active cell starts labeled with its own flat index, then a
fused 3x3(x3) neighbourhood-min stencil iterates to a fixpoint inside one
lax.while_loop, accelerated by two gather-free long-range mechanisms:

* segmented-min sweeps (lax.associative_scan) flood whole active runs along
  an axis in one O(log n) pass — along time every 3-D iteration (event
  durations dominate diameters) and along y/x every 2nd iteration;
* every ``jump_every`` iterations a pointer-jumping pass
  (label <- label[label]) compresses remaining pathological paths; jumps
  are full-field gathers, so they stay rare.

Labels are then densified to 1..N by a rank-over-roots cumsum (on device).

The stencil step is plain XLA: the 9-way min of shifted slices, the pad and
the mask fuse into one elementwise kernel. On an NVIDIA H100 80GB HBM3 at a
700 W power limit, one masked iteration over a (16, 720, 1440) block
(16.6M cells; int32 read + bool read + int32 write = 149 MB) took 166.6 us:
896 GB/s, 26.8% of the card's 3.35 TB/s (chip_smoke.py phase 3). A
hand-written kernel could only win by keeping several fixpoint iterations
in shared memory (temporal blocking), a question for when a trace puts the
fixpoint on top.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BIG = np.int32(2**31 - 1)

def _pad_spatial(lab: jax.Array, wrap_x: bool) -> jax.Array:
    """Pad (T, H, W) by one ring: BIG rows in y, wrap or BIG columns in x."""
    if wrap_x:
        x = jnp.concatenate([lab[..., -1:], lab, lab[..., :1]], axis=-1)
    else:
        x = jnp.pad(lab, ((0, 0), (0, 0), (1, 1)), constant_values=2**31 - 1)
    return jnp.pad(x, ((0, 0), (1, 1), (0, 0)), constant_values=2**31 - 1)


def _min_pool_3x3(lab: jax.Array, wrap_x: bool) -> jax.Array:
    """
    3x3 neighbourhood min over the trailing (H, W) axes of a (T, H, W) label
    map (out-of-range = _BIG; periodic in x when ``wrap_x``) — expressed as a
    9-way elementwise min of shifted views, which XLA fuses into one stencil
    pass on the accelerator and vectorises on CPU (lax.reduce_window is
    scalar-slow on the CPU backend).
    """
    T, H, W = lab.shape
    x = _pad_spatial(lab, wrap_x)
    m = x[:, 0:H, 0:W]
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) == (0, 0):
                continue
            m = jnp.minimum(m, x[:, dy : dy + H, dx : dx + W])
    return m


def _min_pool_3x3x3(lab: jax.Array, wrap_x: bool) -> jax.Array:
    """Full 3x3x3 spatio-temporal neighbourhood min of a (T, H, W) map:
    spatial 9-way min, then a 3-way min over +-1 time shifts."""
    T = lab.shape[0]
    plane = _min_pool_3x3(lab, wrap_x)
    tpad = jnp.pad(plane, ((1, 1), (0, 0), (0, 0)), constant_values=2**31 - 1)
    return jnp.minimum(jnp.minimum(tpad[0:T], tpad[1 : T + 1]), tpad[2 : T + 2])


def _segmented_min_sweep(lab: jax.Array, active: jax.Array, axis: int) -> jax.Array:
    """
    Bidirectional segmented-min scan along ``axis``: every contiguous run of
    active cells receives the run's minimum label in one O(log n) pass
    (lax.associative_scan with a (value, reset-flag) monoid).  Runs of active
    cells along an axis are connected, so this is always a sound propagation
    step — it accelerates convergence from O(diameter) stencil iterations to
    O(shape complexity), without any gathers.
    """

    def combine(a, b):
        v1, f1 = a
        v2, f2 = b
        v = jnp.where(f2, v2, jnp.minimum(v1, v2))
        return v, jnp.logical_or(f1, f2)

    flags = ~active
    vf, _ = jax.lax.associative_scan(combine, (lab, flags), axis=axis)
    vb, _ = jax.lax.associative_scan(combine, (lab, flags), axis=axis, reverse=True)
    return jnp.where(active, jnp.minimum(vf, vb), _BIG)


def _sweep_xy(lab: jax.Array, active: jax.Array, wrap_x: bool) -> jax.Array:
    """One x-then-y segmented-min sweep round over the trailing (H, W) axes,
    periodic-aware along x: a run crossing the longitude seam (active at both
    col 0 and col W-1 of a row) is ONE component, but the plain segmented
    scan treats it as two — leaving seam-crossing objects to converge via the
    1-cell-per-iteration stencil only (measured 41 fixpoint iterations vs ~8
    on a production-shape block whose blobs cross the seam). Exchanging the
    two boundary runs' minima and re-sweeping makes seam propagation O(1)
    per round for ~2x the x-sweep cost — a ~5x net fixpoint win on global
    (wrapped) grids."""
    s = _segmented_min_sweep(lab, active, lab.ndim - 1)
    if wrap_x:
        first = s[..., :1]
        last = s[..., -1:]
        both = jnp.logical_and(active[..., :1], active[..., -1:])
        seam = jnp.minimum(first, last)
        s = jnp.concatenate(
            [jnp.where(both, seam, first), s[..., 1:-1], jnp.where(both, seam, last)],
            axis=-1,
        )
        s = _segmented_min_sweep(s, active, lab.ndim - 1)
    return _segmented_min_sweep(s, active, lab.ndim - 2)


def _jump(lab_flat: jax.Array) -> jax.Array:
    """One pointer-jumping hop on (..., N) flat labels (BIG = inactive).

    A hop is a full-field gather, dearer than a stencil pass, so callers
    invoke this only every ``jump_every`` iterations — a fast path for
    typical blob diameters with a logarithmic escape hatch for pathological
    filaments."""
    idx = jnp.where(lab_flat == _BIG, 0, lab_flat)
    hopped = jnp.take_along_axis(lab_flat, idx, axis=-1)
    return jnp.where(lab_flat == _BIG, _BIG, jnp.minimum(lab_flat, hopped))


def _roots_fixpoint_block(data: jax.Array, wrap_x: bool, max_iters: int, jump_every: int) -> jax.Array:
    """Converged per-slice min-label roots of one (TB, H, W) time block —
    the CCL fixpoint loop shared by every 2-D labeling entry point. Blocks
    are independent (per-slice labeling), so callers lax.map over them:
    intermediates stay bounded at production scale AND each block's
    while_loop runs only its own iteration count."""
    TB, H, W = data.shape
    flat_idx = jnp.arange(H * W, dtype=jnp.int32).reshape(1, H, W)
    lab = jnp.where(data, jnp.broadcast_to(flat_idx, (TB, H, W)), _BIG)

    def step(state):
        lab, _, it = state
        m = jnp.where(data, _min_pool_3x3(lab, wrap_x), _BIG)
        # long-range run sweeps: every 2nd iteration, propagate along whole
        # active rows/columns in one pass (bounds iterations by shape
        # complexity instead of blob diameter)
        m = jax.lax.cond(
            (it % 2) == 1,
            lambda x: _sweep_xy(x, data, wrap_x),
            lambda x: x,
            m,
        )
        mf = m.reshape(TB, H * W)
        mf = jax.lax.cond(
            (it % jump_every) == jump_every - 1,
            lambda x: _jump(_jump(x)),
            lambda x: x,
            mf,
        )
        new = mf.reshape(TB, H, W)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    lab, _, _ = jax.lax.while_loop(cond, step, (lab, jnp.bool_(True), jnp.int32(0)))
    return lab.reshape(TB, H * W)


# Largest per-block cell count for the fixpoint programs: 16 slices of
# 720 x 1440 at the production shape. At that block size on an H100 the
# per-slice labels of a 1095 x 720 x 1440 field equal the host C++
# labeller's bit for bit, and merge tracking equals the per-step march
# (chip_smoke.py phases 3-4). The bound was first set to dodge a compiler
# fault of the previous accelerator at ~60M-cell blocks; whether larger
# blocks pay on the GPU is not measured yet.
_BLOCK_CELL_BUDGET = 16 * 1024 * 1024


def _map_time_blocks(fn, data: jax.Array, time_block: int):
    """Apply ``fn`` ((TB, H, W) block -> pytree) over time blocks via lax.map
    (scan, not vmap, so each block's while_loop stops at its own iteration
    count and intermediates stay one block in size); the time axis
    is padded with inactive slices to a block multiple. ``time_block`` is an
    upper bound — the effective block is clamped so a block never exceeds
    ``_BLOCK_CELL_BUDGET`` cells."""
    T = data.shape[0]
    cells_per_slice = int(np.prod(data.shape[1:]))
    tb = min(time_block, T, max(1, _BLOCK_CELL_BUDGET // max(cells_per_slice, 1)))
    n_blocks = -(-T // tb)
    T_pad = n_blocks * tb
    if T_pad != T:
        data = jnp.pad(data, ((0, T_pad - T),) + ((0, 0),) * (data.ndim - 1), constant_values=False)
    blocks = data.reshape((n_blocks, tb) + data.shape[1:])
    return jax.lax.map(fn, blocks)


@partial(jax.jit, static_argnames=("wrap_x", "max_iters", "jump_every", "time_block"))
def label_slices_grid(
    data: jax.Array, wrap_x: bool = True, max_iters: int = 4096, jump_every: int = 128, time_block: int = 64
) -> Tuple[jax.Array, jax.Array]:
    """
    Per-timestep 2-D CCL with 8-connectivity, tiled over ``time_block``
    slices (per-slice labeling is time-independent).

    Parameters
    ----------
    data : (T, H, W) bool
    wrap_x : periodic in the last (longitude) axis

    Returns
    -------
    labels : (T, H, W) int32, densified per slice (1..n_t, 0 = background)
    counts : (T,) int32 number of components per slice
    """
    T, H, W = data.shape
    flat_idx = jnp.arange(H * W, dtype=jnp.int32)

    def block(d):
        TB = d.shape[0]
        labf = _roots_fixpoint_block(d, wrap_x, max_iters, jump_every)
        is_root = jnp.logical_and(d.reshape(TB, H * W), labf == flat_idx[None])
        rank = jnp.cumsum(is_root.astype(jnp.int32), axis=1)  # inclusive rank
        idx = jnp.where(labf == _BIG, 0, labf)
        dense = jnp.where(labf == _BIG, 0, jnp.take_along_axis(rank, idx, axis=1))
        return dense.reshape(TB, H, W), rank[:, -1]

    dense, counts = _map_time_blocks(block, data, time_block)
    return dense.reshape(-1, H, W)[:T], counts.reshape(-1)[:T]


@partial(jax.jit, static_argnames=("wrap_x", "max_iters", "jump_every"))
def label_spacetime_grid(
    data: jax.Array, wrap_x: bool = True, max_iters: int = 8192, jump_every: int = 64
) -> Tuple[jax.Array, jax.Array]:
    """
    Full 3-D (time, y, x) CCL with 3x3x3 connectivity — events connected
    across time including spatio-temporal diagonals, the
    ``time_connectivity=True`` path of the reference (track.py:2011-2013).

    Returns
    -------
    labels : (T, H, W) int32 globally dense (1..N, 0 = background)
    n : ()   int32 total number of events
    """
    T, H, W = data.shape
    N = T * H * W
    flat_idx = jnp.arange(N, dtype=jnp.int32).reshape(T, H, W)
    lab = jnp.where(data, flat_idx, _BIG)

    def step(state):
        lab, _, it = state
        m = _min_pool_3x3x3(lab, wrap_x)
        m = jnp.where(data, m, _BIG)
        # event durations dominate diameters: sweep whole active runs along
        # time every iteration, and along y/x every 2nd (measured optimum on
        # a 105M-cell block: 0.51s vs 0.74s at every 4th, 1.8s at every 1st)
        m = _segmented_min_sweep(m, data, 0)
        m = jax.lax.cond(
            (it % 2) == 1,
            lambda x: _sweep_xy(x, data, wrap_x),
            lambda x: x,
            m,
        )
        mf = m.reshape(1, N)
        mf = jax.lax.cond(
            (it % jump_every) == jump_every - 1,
            lambda x: _jump(_jump(x)),
            lambda x: x,
            mf,
        )
        new = mf.reshape(T, H, W)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    lab, _, _ = jax.lax.while_loop(cond, step, (lab, jnp.bool_(True), jnp.int32(0)))

    labf = lab.reshape(N)
    is_root = jnp.logical_and(data.reshape(N), labf == jnp.arange(N, dtype=jnp.int32))
    rank = jnp.cumsum(is_root.astype(jnp.int32))
    idx = jnp.where(labf == _BIG, 0, labf)
    dense = jnp.where(labf == _BIG, 0, rank[idx])
    return dense.reshape(T, H, W), rank[-1]


def _unstr_block(d, flat_idx, nb_idx, nb_valid, max_iters: int, jump_every: int):
    """Converged dense per-slice labels of one (TB, C) block."""
    lab = jnp.where(d, flat_idx, _BIG)

    def step(state):
        lab, _, it = state
        g = lab[:, nb_idx]  # (TB, K, C)
        g = jnp.where(nb_valid[None], g, _BIG)
        m = jnp.minimum(lab, jnp.min(g, axis=1))
        m = jnp.where(d, m, _BIG)
        m = jax.lax.cond(
            (it % jump_every) == jump_every - 1,
            lambda x: _jump(_jump(x)),
            lambda x: x,
            m,
        )
        return m, jnp.any(m != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    lab, _, _ = jax.lax.while_loop(cond, step, (lab, jnp.bool_(True), jnp.int32(0)))

    is_root = jnp.logical_and(d, lab == flat_idx)
    rank = jnp.cumsum(is_root.astype(jnp.int32), axis=1)
    idx = jnp.where(lab == _BIG, 0, lab)
    dense = jnp.where(lab == _BIG, 0, jnp.take_along_axis(rank, idx, axis=1))
    return dense, rank[:, -1]


@partial(jax.jit, static_argnames=("max_iters", "jump_every", "time_block"))
def _label_slices_unstructured_fused(
    data: jax.Array, neighbours: jax.Array, max_iters: int, jump_every: int, time_block: int
) -> Tuple[jax.Array, jax.Array]:
    T, C = data.shape
    flat_idx = jnp.arange(C, dtype=jnp.int32)[None, :]
    nb_idx = jnp.maximum(neighbours, 0)  # (K, C)
    nb_valid = neighbours >= 0

    def block(d):
        return _unstr_block(d, flat_idx, nb_idx, nb_valid, max_iters, jump_every)

    dense, counts = _map_time_blocks(block, data, time_block)
    return dense.reshape(-1, C)[:T], counts.reshape(-1)[:T]


@partial(jax.jit, donate_argnums=(0,))
def _write_time_block(out: jax.Array, block: jax.Array, start: jax.Array) -> jax.Array:
    """In-place (donated) write of one time block into the accumulator."""
    return jax.lax.dynamic_update_slice_in_dim(out, block, start, axis=0)


@partial(jax.jit, static_argnames=("max_iters", "jump_every"))
def _unstr_block_jit(d, neighbours, max_iters: int, jump_every: int):
    C = d.shape[1]
    flat_idx = jnp.arange(C, dtype=jnp.int32)[None, :]
    return _unstr_block(d, flat_idx, jnp.maximum(neighbours, 0), neighbours >= 0, max_iters, jump_every)


def label_slices_unstructured(
    data: jax.Array, neighbours: jax.Array, max_iters: int = 4096, jump_every: int = 16, time_block: int = 64
) -> Tuple[jax.Array, jax.Array]:
    """
    Per-timestep CCL on an unstructured triangular mesh, tiled over
    ``time_block`` slices (per-slice labeling is time-independent).

    data : (T, C) bool (already masked)
    neighbours : (K, C) int32 0-based adjacency, -1 = missing (the tracker
        passes the SYMMETRIZED table — csgraph directed=False semantics)

    Returns per-slice dense labels (1..n_t per slice, 0 = background) and
    per-slice counts — the ID convention of the reference's per-slice
    csgraph labeling (track.py:1947-1999).

    Above a handful of blocks the time blocks are looped on the HOST with
    one shared compiled per-block program instead of a fused
    lax.map(while_loop) program, so the label field is assembled into one
    donated accumulator block by block. Costs ~one dispatch per block.
    """
    T, C = data.shape
    tb = min(time_block, T, max(1, _BLOCK_CELL_BUDGET // max(C, 1)))
    n_blocks = -(-T // tb)
    if n_blocks <= 4:
        return _label_slices_unstructured_fused(data, neighbours, max_iters, jump_every, time_block)

    data = jnp.asarray(data)
    neighbours = jnp.asarray(neighbours)
    T_pad = n_blocks * tb
    if T_pad != T:
        data = jnp.pad(data, ((0, T_pad - T), (0, 0)), constant_values=False)
    # assemble into a donated accumulator: at ICON scale the label field is
    # ~3 GB and a concatenate of all blocks would transiently hold it twice
    dense = jnp.zeros((T_pad, C), jnp.int32)
    count_blocks = []
    for b in range(n_blocks):
        db, cb = _unstr_block_jit(
            jax.lax.dynamic_slice_in_dim(data, b * tb, tb, axis=0), neighbours, max_iters, jump_every
        )
        dense = _write_time_block(dense, db, jnp.int32(b * tb))
        count_blocks.append(np.asarray(cb))
    counts = jnp.asarray(np.concatenate(count_blocks)[:T])
    return dense[:T], counts


def _offset_labels_impl(labels: jax.Array, counts: jax.Array) -> jax.Array:
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    shape = (labels.shape[0],) + (1,) * (labels.ndim - 1)
    return jnp.where(labels > 0, labels + offsets.reshape(shape), 0)


offset_labels_across_time = jax.jit(_offset_labels_impl)
offset_labels_across_time.__doc__ = """
    Make per-slice labels globally unique by cumulative offsets — the
    cumsum-shift trick of track.py:2762-2764.

    labels : (T, ...) int32 per-slice dense labels
    counts : (T,) per-slice component counts
    """

# In-place variant for the tracking hot path: at production shape the label
# field is ~4.5 GB, so aliasing the output onto the (never reused) input
# halves this step's device-memory peak.
offset_labels_donated = jax.jit(_offset_labels_impl, donate_argnums=(0,))


@partial(jax.jit, donate_argnums=(1,))
def remap_labels_donated(lookup: jax.Array, labels: jax.Array) -> jax.Array:
    """Full-field ``lookup[labels]`` with the label buffer donated (the
    final event remap of the two-level CCL; the input is dead after)."""
    return jnp.take(lookup, labels)


@partial(jax.jit, static_argnames=("n_labels",))
def select_labels(labels: jax.Array, keep: jax.Array, n_labels: int) -> jax.Array:
    """
    Per-slice label filter: ``out[t, c] = keep[t, labels[t, c]]`` computed as
    an unrolled compare-OR over the (small) label range instead of a flat
    gather: n_labels fused elementwise passes, for modest per-slice object
    counts (callers fall back to take_along_axis otherwise).

    labels : (T, S) int32 per-slice dense labels (0 = background)
    keep   : (T, n_labels + 1) bool
    """
    T, S = labels.shape
    out = jnp.zeros((T, S), bool)
    for lbl in range(1, n_labels + 1):
        out = jnp.logical_or(out, jnp.logical_and(keep[:, lbl : lbl + 1], labels == lbl))
    return out


@partial(jax.jit, static_argnames=("wrap_x", "max_iters", "jump_every", "time_block"))
def label_slices_grid_roots(
    data: jax.Array, wrap_x: bool = True, max_iters: int = 4096, jump_every: int = 128, time_block: int = 64
) -> Tuple[jax.Array, jax.Array]:
    """
    Per-timestep 2-D CCL returning RAW root labels (each component labeled by
    its minimum flat index; _BIG = background) plus per-slice counts — i.e.
    :func:`label_slices_grid` without the densification pass, whose
    rank-lookup is a flat full-field gather. Callers that
    only need per-object reductions can stay in root space (see
    :func:`extract_root_areas` / :func:`apply_root_keep`). Tiled over
    ``time_block`` slices like :func:`label_slices_grid`.
    """
    T, H, W = data.shape
    flat_idx = jnp.arange(H * W, dtype=jnp.int32)

    def block(d):
        TB = d.shape[0]
        labf = _roots_fixpoint_block(d, wrap_x, max_iters, jump_every)
        is_root = jnp.logical_and(d.reshape(TB, H * W), labf == flat_idx[None])
        return labf, jnp.sum(is_root.astype(jnp.int32), axis=1)

    labf, counts = _map_time_blocks(block, data, time_block)
    return labf.reshape(-1, H * W)[:T], counts.reshape(-1)[:T]


@partial(jax.jit, static_argnames=("n_max",))
def extract_root_areas(root_flat: jax.Array, n_max: int) -> Tuple[jax.Array, jax.Array]:
    """
    Enumerate each slice's root label ids in ascending order together with
    their pixel areas, gather-free: the j-th root is the minimum label value
    strictly greater than the (j-1)-th — one fused compare+reduce pass per
    object slot, so 2*n_max bandwidth-bound passes total instead of a flat
    gather + scatter.

    root_flat : (T, S) int32 root labels (_BIG = background)
    returns (root_ids (T, n_max) int32 with _BIG padding, areas (T, n_max) f32)
    """
    T, S = root_flat.shape
    ids = []
    areas = []
    prev = jnp.full((T, 1), -1, jnp.int32)
    for _ in range(n_max):
        cand = jnp.where(root_flat > prev, root_flat, _BIG)
        r = jnp.min(cand, axis=1, keepdims=True)  # (T, 1)
        a = jnp.sum((root_flat == r).astype(jnp.float32), axis=1)
        ids.append(r[:, 0])
        areas.append(jnp.where(r[:, 0] == _BIG, 0.0, a))
        prev = r
    return jnp.stack(ids, axis=1), jnp.stack(areas, axis=1)


@jax.jit
def apply_root_keep(root_flat: jax.Array, root_ids: jax.Array, keep: jax.Array) -> jax.Array:
    """
    Filter in root space: ``out[t, c] = any_j (keep[t, j] and
    root_flat[t, c] == root_ids[t, j])`` — unrolled compare-OR passes, the
    root-space analogue of :func:`select_labels`.

    root_flat : (T, S) int32; root_ids : (T, J) int32; keep : (T, J) bool
    """
    T, S = root_flat.shape
    out = jnp.zeros((T, S), bool)
    for j in range(root_ids.shape[1]):
        out = jnp.logical_or(
            out, jnp.logical_and(keep[:, j : j + 1], root_flat == root_ids[:, j : j + 1])
        )
    return out


@partial(jax.jit, static_argnames=("wrap_x", "max_iters", "jump_every"))
def label_spacetime_roots(
    data: jax.Array, wrap_x: bool = True, max_iters: int = 8192, jump_every: int = 64
) -> Tuple[jax.Array, jax.Array]:
    """
    3-D spatio-temporal CCL returning RAW root labels (flat (T*H*W,) int32,
    _BIG = background) plus the total component count — the fixpoint loop of
    :func:`label_spacetime_grid` without the densification pass. Pair with
    :func:`densify_spacetime_roots` for a gather-free dense relabel when the
    event count is modest.
    """
    T, H, W = data.shape
    N = T * H * W
    flat_idx = jnp.arange(N, dtype=jnp.int32).reshape(T, H, W)
    lab = jnp.where(data, flat_idx, _BIG)

    def step(state):
        lab, _, it = state
        m = jnp.where(data, _min_pool_3x3x3(lab, wrap_x), _BIG)
        m = _segmented_min_sweep(m, data, 0)
        m = jax.lax.cond(
            (it % 2) == 1,
            lambda x: _sweep_xy(x, data, wrap_x),
            lambda x: x,
            m,
        )
        mf = m.reshape(1, N)
        mf = jax.lax.cond(
            (it % jump_every) == jump_every - 1,
            lambda x: _jump(_jump(x)),
            lambda x: x,
            mf,
        )
        new = mf.reshape(T, H, W)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    lab, _, _ = jax.lax.while_loop(cond, step, (lab, jnp.bool_(True), jnp.int32(0)))
    labf = lab.reshape(N)
    is_root = jnp.logical_and(data.reshape(N), labf == jnp.arange(N, dtype=jnp.int32))
    return labf, jnp.sum(is_root.astype(jnp.int32))


@partial(jax.jit, static_argnames=("n_pad",))
def densify_spacetime_roots(labf: jax.Array, n_pad: int) -> jax.Array:
    """
    Gather-free dense relabel of 3-D root labels: the component's dense id is
    the number of root values <= its own root. The (<= n_pad) sorted roots
    come from one top_k pass and the rank is a fused broadcast
    compare+reduce instead of the cumsum+flat-gather densification.

    labf : (N,) int32 converged root labels (_BIG = background)
    returns (N,) int32 dense labels in 1..n (0 = background)
    """
    N = labf.shape[0]
    active = labf != _BIG
    is_root = jnp.logical_and(active, labf == jnp.arange(N, dtype=jnp.int32))
    top, _ = jax.lax.top_k(jnp.where(is_root, -labf, -_BIG), n_pad)
    roots = -top  # ascending, padded with _BIG
    dense = jnp.sum(
        (labf[:, None] >= roots[None, :]) & (roots[None, :] != _BIG), axis=1, dtype=jnp.int32
    )
    return jnp.where(active, dense, 0)


def _sorted_row_core(row: jax.Array):
    """Shared per-row machinery of the count-robust sorted kernels: stable
    sort of (root, column) pairs, run boundaries by neighbour compare, run
    lengths by cummax/cummin scans, dense ranks by cumsum. ``row`` is one
    (S,) slice of root labels; designed to be vmapped in time tiles."""
    S = row.shape[0]
    col = jnp.arange(S, dtype=jnp.int32)
    sv, si = jax.lax.sort((row, col), dimension=0, num_keys=1)
    active = sv != _BIG
    prev = jnp.concatenate([jnp.full((1,), -1, sv.dtype), sv[:-1]])
    is_start = active & (sv != prev)
    nxt = jnp.concatenate([sv[1:], jnp.full((1,), -2, sv.dtype)])
    is_end = active & (sv != nxt)
    sp = jax.lax.cummax(jnp.where(is_start, col, -1))
    ne = jax.lax.cummin(jnp.where(is_end, col + 1, S), reverse=True)
    area_sorted = jnp.where(active, (ne - sp).astype(jnp.float32), 0.0)
    rank = jnp.cumsum(is_start.astype(jnp.int32))  # dense id at sorted pos
    return sv, si, active, is_start, area_sorted, rank


@partial(jax.jit, static_argnames=("n_max", "time_block"))
def slice_root_stats_sorted(root_flat: jax.Array, n_max: int, time_block: int = 128):
    """
    Count-robust per-slice object statistics in O(S log S) — the
    no-object-cap replacement for the trace-time unrolled
    :func:`extract_root_areas`/:func:`apply_root_keep` chain beyond its
    ~64-object sweet spot (the reference's np.unique path,
    track.py:1785-1806). Processed in ``time_block`` row tiles via lax.map
    so intermediate memory stays bounded at production scale (a full-width
    sort of a century of 0.25 deg labels would hold ~6 full-size
    temporaries).

    root_flat : (T, S) int32 converged root labels (_BIG = background)

    Returns
    -------
    root_ids  : (T, n_max) int32 ascending per-slice root ids, _BIG padded
    areas     : (T, n_max) float32 object pixel areas, 0 padded
    area_cell : (T, S) float32 per-cell component area (0 = background)
    counts    : (T,) int32 per-slice object counts
    """
    T, S = root_flat.shape

    def per_row(row):
        sv, si, active, is_start, area_sorted, rank = _sorted_row_core(row)
        area_cell = jnp.zeros((S,), jnp.float32).at[si].set(area_sorted)
        slot = jnp.where(is_start & (rank <= n_max), rank - 1, n_max)
        ids = jnp.full((n_max + 1,), _BIG, jnp.int32).at[slot].set(jnp.where(is_start, sv, _BIG))[:n_max]
        areas = jnp.zeros((n_max + 1,), jnp.float32).at[slot].set(jnp.where(is_start, area_sorted, 0.0))[:n_max]
        return ids, areas, area_cell, rank[-1]

    ids, areas, area_cell, counts = jax.lax.map(per_row, root_flat, batch_size=min(time_block, T))
    return ids, areas, area_cell, counts


def _densify_slices_sorted_impl(root_flat: jax.Array, time_block: int = 128):
    T, S = root_flat.shape

    def per_row(row):
        sv, si, active, is_start, area_sorted, rank = _sorted_row_core(row)
        dense = jnp.zeros((S,), jnp.int32).at[si].set(jnp.where(active, rank, 0))
        return dense, rank[-1]

    return jax.lax.map(per_row, root_flat, batch_size=min(time_block, T))


densify_slices_sorted = partial(jax.jit, static_argnames=("time_block",))(_densify_slices_sorted_impl)
densify_slices_sorted.__doc__ = """
    Count-robust per-slice dense relabel (rank order identical to
    :func:`label_slices_grid`) in O(S log S), tiled over time rows like
    :func:`slice_root_stats_sorted`.

    root_flat : (T, S) int32 converged root labels (_BIG = background)
    returns (dense (T, S) int32 labels 1..n_t per slice, counts (T,) int32)
    """

# In-place variant (see offset_labels_donated): the root buffer is dead
# after densification in the tracking hot path, so alias the dense output
# onto it instead of holding two full label fields.
densify_slices_sorted_donated = partial(
    jax.jit, static_argnames=("time_block",), donate_argnums=(0,)
)(_densify_slices_sorted_impl)


@jax.jit
def densify_spacetime_sorted(labf: jax.Array):
    """
    Count-robust dense relabel of 3-D root labels in O(N log N): the sorted
    machinery of :func:`slice_root_stats_sorted` on the flat array — no
    event-count cap (replaces :func:`densify_spacetime_roots` beyond its
    top_k padding and the cumsum+flat-gather fallback).

    labf : (N,) int32 converged root labels (_BIG = background)
    returns (dense (N,) int32 labels 1..n, n () int32)
    """
    N = labf.shape[0]
    col = jnp.arange(N, dtype=jnp.int32)
    sv, si = jax.lax.sort((labf, col), dimension=0, num_keys=1)
    active = sv != _BIG
    prev = jnp.concatenate([jnp.full((1,), -1, sv.dtype), sv[:-1]])
    is_start = active & (sv != prev)
    rank = jnp.cumsum(is_start.astype(jnp.int32))
    dense_sorted = jnp.where(active, rank, 0)
    dense = jnp.zeros((N,), jnp.int32).at[si].set(dense_sorted)
    return dense, rank[-1]


@jax.jit
def densify_slice_roots(root_flat: jax.Array, root_ids: jax.Array) -> jax.Array:
    """
    Gather-free per-slice dense relabel: ``out[t, c] = j + 1`` where
    ``root_flat[t, c] == root_ids[t, j]`` (0 elsewhere). ``root_ids`` comes
    from :func:`extract_root_areas` (ascending, _BIG-padded), so the dense
    ids match :func:`label_slices_grid`'s rank order exactly — one fused
    compare+select pass per object slot instead of a flat gather.
    """
    dense = jnp.zeros(root_flat.shape, jnp.int32)
    for j in range(root_ids.shape[1]):
        rid = root_ids[:, j : j + 1]
        hit = jnp.logical_and(rid != _BIG, root_flat == rid)
        dense = jnp.where(hit, jnp.int32(j + 1), dense)
    return dense
