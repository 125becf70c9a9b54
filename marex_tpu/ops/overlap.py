"""
Temporal overlap-graph kernels.

Device replacement for the reference's per-slice overlap extraction
(``check_overlap_slice`` track.py:2396-2452) and global aggregation
(``find_overlapping_objects`` track.py:2454-2504): for each pair of
consecutive timesteps, the (parent id, child id, overlap weight) list is
computed on device by a sort + run-length segment-sum over packed pair keys,
emitted into a fixed-size padded buffer (static shapes), then aggregated.

``key_stride`` is a TRACED argument everywhere: the merge march calls these
kernels with a stride derived from ``next_new_id``, which changes after
every id allocation — a static stride recompiled the kernel on almost every
march step (measured 645 ms/call on the dev chip, the dominant cost of
merge-dense tracking before this fix).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_INVALID = np.int32(2**31 - 1)


@partial(jax.jit, static_argnames=("max_pairs",))
def overlap_pairs_slice(
    ids_a: jax.Array,
    ids_b: jax.Array,
    weights: jax.Array,
    max_pairs: int,
    key_stride: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Unique (id_a, id_b) pairs with summed overlap weight for one slice pair.

    ids_a, ids_b : (S,) int32 label fields at t and t+1 (0 = background).
        Labels must be < key_stride and key_stride**2 < 2**31.
    weights : (S,) float32 per-cell overlap weight (1.0 for pixel counts,
        cell areas for unstructured grids).
    max_pairs : static output capacity; excess unique pairs are dropped
        (callers should size this generously and check the overflow flag).

    Returns
    -------
    pair_a, pair_b : (max_pairs,) int32 (padded with -1)
    pair_w : (max_pairs,) float32 summed weights
    """
    both = jnp.logical_and(ids_a > 0, ids_b > 0)
    key = jnp.where(both, ids_a * key_stride + ids_b, _INVALID)

    order = jnp.argsort(key)
    k_sorted = key[order]
    w_sorted = jnp.where(both, weights, 0.0)[order]

    is_start = jnp.concatenate([jnp.ones(1, bool), k_sorted[1:] != k_sorted[:-1]])
    seg_id = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    # invalid keys sort last; cap their segment ids out of range so they drop
    seg_id = jnp.where(k_sorted == _INVALID, max_pairs, seg_id)

    pair_w = jax.ops.segment_sum(w_sorted, seg_id, num_segments=max_pairs)
    pair_key = jnp.full((max_pairs,), -1, jnp.int32)
    pair_key = pair_key.at[seg_id].set(k_sorted, mode="drop")

    valid = pair_key >= 0
    pair_a = jnp.where(valid, pair_key // key_stride, -1)
    pair_b = jnp.where(valid, pair_key % key_stride, -1)
    return pair_a, pair_b, pair_w


@partial(jax.jit, static_argnames=("max_pairs",))
def pairs_between_stacks(
    a: jax.Array, b: jax.Array, weights: jax.Array, max_pairs: int, key_stride: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Co-located (a, b) pairs between two ALIGNED label stacks, vmapped over
    rows — the generalisation of :func:`overlap_pairs_all` used for
    spatially-shifted adjacency edges (3x3x3 time connectivity).

    a, b : (N, S) int32 label fields; weights : (S,) float32

    Returns (N, max_pairs) triples.
    """
    f = jax.vmap(lambda x, y: overlap_pairs_slice(x, y, weights, max_pairs, key_stride))
    return f(a, b)


@partial(jax.jit, static_argnames=("max_pairs",))
def overlap_pairs_all(
    labels: jax.Array, weights: jax.Array, max_pairs: int, key_stride: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Overlap pairs between every consecutive timestep pair, vmapped.

    labels : (T, S) int32 globally-unique-per-slice label fields
    weights : (S,) float32 cell weights

    Returns (T-1, max_pairs) triples (a, b, w); a precedes b in time.
    """
    return pairs_between_stacks(labels[:-1], labels[1:], weights, max_pairs, key_stride)


@partial(jax.jit, static_argnames=("max_pairs", "dy", "dx", "wrap_x", "time_block"))
def adjacency_pairs_shift(
    labels: jax.Array,
    max_pairs: int,
    key_stride: int,
    dy: int,
    dx: int,
    wrap_x: bool,
    time_block: int = 64,
) -> Tuple[jax.Array, jax.Array]:
    """
    Weightless co-located (id_t, id_t+1) pairs between slice t shifted by
    (dy, dx) and slice t+1 — ONE of the nine inter-slice edge sets of full
    3x3x3 spatio-temporal connectivity. Fused shift + key extraction, tiled
    over ``time_block`` row pairs via lax.map with dynamic slices out of the
    resident label field, so per-shift peak memory is a tile, not the field.

    labels : (T, H, W) int32 globally-unique per-slice labels (0 = bg)
    returns (T-1, max_pairs) int32 (pa, pb), -1 padded, ascending keys
    """
    T, H, W = labels.shape
    if T < 2:
        z = jnp.full((0, max_pairs), -1, jnp.int32)
        return z, z
    tb = min(time_block, T - 1)
    n_blocks = -(-(T - 1) // tb)
    # clamp the final block's start into bounds instead of padding the field:
    # jnp.pad would materialise a second full-size copy (~5 GB at production
    # shape) for the program's whole duration. Overlapping rows recompute
    # identical values (row r depends only on label rows r, r+1) and the
    # scatter below routes every block row to its true position.
    starts = jnp.minimum(jnp.arange(n_blocks, dtype=jnp.int32) * tb, T - 1 - tb)

    def shift_a(a):
        if dx != 0:
            if wrap_x:
                a = jnp.roll(a, dx, axis=2)
            else:
                rolled = jnp.roll(a, dx, axis=2)
                idx = jnp.arange(W)
                band = (idx < dx) if dx > 0 else (idx >= W + dx)
                a = jnp.where(band[None, None, :], 0, rolled)
        if dy != 0:
            rolled = jnp.roll(a, dy, axis=1)
            idy = jnp.arange(H)
            band = (idy < dy) if dy > 0 else (idy >= H + dy)
            a = jnp.where(band[None, :, None], 0, rolled)
        return a

    def blk(t0):
        seg = jax.lax.dynamic_slice(labels, (t0, 0, 0), (tb + 1, H, W))
        a = shift_a(seg[:-1]).reshape(tb, H * W)
        b = seg[1:].reshape(tb, H * W)
        both = jnp.logical_and(a > 0, b > 0)
        key = jnp.where(both, a * key_stride + b, _INVALID)
        prev = jnp.full((tb, 1), -1, jnp.int32)
        pa, pb = [], []
        for _ in range(max_pairs):
            cand = jnp.where(key > prev, key, _INVALID)
            k = jnp.min(cand, axis=1, keepdims=True)
            valid = k[:, 0] != _INVALID
            pa.append(jnp.where(valid, k[:, 0] // key_stride, -1))
            pb.append(jnp.where(valid, k[:, 0] % key_stride, -1))
            prev = k
        return jnp.stack(pa, axis=1), jnp.stack(pb, axis=1)

    pa, pb = jax.lax.map(blk, starts)
    rows = (starts[:, None] + jnp.arange(tb, dtype=jnp.int32)[None, :]).reshape(-1)
    out_pa = jnp.zeros((T - 1, max_pairs), jnp.int32).at[rows].set(pa.reshape(-1, max_pairs))
    out_pb = jnp.zeros((T - 1, max_pairs), jnp.int32).at[rows].set(pb.reshape(-1, max_pairs))
    return out_pa, out_pb


@partial(jax.jit, static_argnames=("max_pairs", "time_block"))
def consecutive_pairs_tiled(
    labels: jax.Array, weights: jax.Array, max_pairs: int, key_stride: int, time_block: int = 64
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Overlap triples between every consecutive row pair of a (T, S) label
    stack, min-extraction per row, tiled over ``time_block`` row pairs via
    dynamic slices (the full-width extraction materialises several (T-1, S)
    temporaries — multiple GB at production scale).

    Returns (T-1, max_pairs) (pa, pb, pw), -1 padded, ascending keys.
    """
    T, S = labels.shape
    if T < 2:
        z = jnp.full((0, max_pairs), -1, jnp.int32)
        return z, z, jnp.zeros((0, max_pairs), jnp.float32)
    tb = min(time_block, T - 1)
    n_blocks = -(-(T - 1) // tb)
    # clamped starts + row scatter instead of padding (see
    # adjacency_pairs_shift: the pad is a full-size field copy)
    starts = jnp.minimum(jnp.arange(n_blocks, dtype=jnp.int32) * tb, T - 1 - tb)

    def blk(t0):
        seg = jax.lax.dynamic_slice(labels, (t0, 0), (tb + 1, S))
        a, b = seg[:-1], seg[1:]
        both = jnp.logical_and(a > 0, b > 0)
        key = jnp.where(both, a * key_stride + b, _INVALID)
        w = jnp.where(both, jnp.broadcast_to(weights[None, :], key.shape), 0.0)
        prev = jnp.full((tb, 1), -1, jnp.int32)
        pa, pb, pw = [], [], []
        for _ in range(max_pairs):
            cand = jnp.where(key > prev, key, _INVALID)
            k = jnp.min(cand, axis=1, keepdims=True)
            s = jnp.sum(jnp.where(key == k, w, 0.0), axis=1)
            valid = k[:, 0] != _INVALID
            pa.append(jnp.where(valid, k[:, 0] // key_stride, -1))
            pb.append(jnp.where(valid, k[:, 0] % key_stride, -1))
            pw.append(jnp.where(valid, s, 0.0))
            prev = k
        return jnp.stack(pa, axis=1), jnp.stack(pb, axis=1), jnp.stack(pw, axis=1)

    pa, pb, pw = jax.lax.map(blk, starts)
    rows = (starts[:, None] + jnp.arange(tb, dtype=jnp.int32)[None, :]).reshape(-1)
    return (
        jnp.zeros((T - 1, max_pairs), jnp.int32).at[rows].set(pa.reshape(-1, max_pairs)),
        jnp.zeros((T - 1, max_pairs), jnp.int32).at[rows].set(pb.reshape(-1, max_pairs)),
        jnp.zeros((T - 1, max_pairs), jnp.float32).at[rows].set(pw.reshape(-1, max_pairs)),
    )


@partial(jax.jit, static_argnames=("max_pairs",))
def pairs_between_stacks_extract(
    a: jax.Array, b: jax.Array, weights: jax.Array, max_pairs: int, key_stride: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Sort-free min-extraction variant of :func:`pairs_between_stacks`
    (see :func:`overlap_pairs_all_extract`)."""
    both = jnp.logical_and(a > 0, b > 0)
    key = jnp.where(both, a * key_stride + b, _INVALID)  # (N, S)
    w = jnp.where(both, jnp.broadcast_to(weights[None, :], key.shape), 0.0)

    prev = jnp.full((key.shape[0], 1), -1, jnp.int32)
    pa, pb, pw = [], [], []
    for _ in range(max_pairs):
        cand = jnp.where(key > prev, key, _INVALID)
        k = jnp.min(cand, axis=1, keepdims=True)  # (N, 1)
        s = jnp.sum(jnp.where(key == k, w, 0.0), axis=1)
        valid = k[:, 0] != _INVALID
        pa.append(jnp.where(valid, k[:, 0] // key_stride, -1))
        pb.append(jnp.where(valid, k[:, 0] % key_stride, -1))
        pw.append(jnp.where(valid, s, 0.0))
        prev = k
    return jnp.stack(pa, axis=1), jnp.stack(pb, axis=1), jnp.stack(pw, axis=1)


def aggregate_pairs_host(
    pair_a: np.ndarray, pair_b: np.ndarray, pair_w: np.ndarray
) -> np.ndarray:
    """
    Merge per-slice padded pair lists into a unique (N, 3) array summing
    weights of duplicate pairs (an object pair can overlap in several chunks
    only across slice boundaries; kept for parity with track.py:2489-2503).
    """
    a = np.asarray(pair_a).ravel()
    b = np.asarray(pair_b).ravel()
    w = np.asarray(pair_w).ravel()
    valid = a >= 0
    a, b, w = a[valid], b[valid], w[valid]
    if len(a) == 0:
        return np.empty((0, 3), dtype=np.float64)
    key = a.astype(np.int64) * np.int64(2**31) + b.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    sums = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(sums, inv, w)
    out = np.column_stack([(uniq // 2**31).astype(np.float64), (uniq % 2**31).astype(np.float64), sums])
    return out


def union_find_components(pairs: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """
    Connected components of the overlap graph (host union-find; native C++
    when available) — replaces scipy csgraph at track.py:2876-2884.

    pairs : (N, 2) int array of edges between node ids
    node_ids : (M,) all node ids present

    Returns (M,) component index (0..K-1) aligned with node_ids order.
    """
    from .._native import union_find

    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    return union_find(pairs, np.asarray(node_ids, dtype=np.int64))


@partial(jax.jit, static_argnames=("cap",))
def compact_pairs(pair_a: jax.Array, pair_b: jax.Array, pair_w: jax.Array, cap: int):
    """
    Compact padded (T, max_pairs) pair buffers into dense (cap,) arrays in
    row-major order (valid entries only). Keeps host downloads proportional to
    the number of real pairs instead of the padded device capacity.
    """
    a = pair_a.reshape(-1)
    b = pair_b.reshape(-1)
    w = pair_w.reshape(-1)
    valid = a >= 0
    pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
    idx = jnp.where(valid, pos, cap)
    out_a = jnp.zeros((cap,), a.dtype).at[idx].set(a, mode="drop")
    out_b = jnp.zeros((cap,), b.dtype).at[idx].set(b, mode="drop")
    out_w = jnp.zeros((cap,), w.dtype).at[idx].set(w, mode="drop")
    return out_a, out_b, out_w


@partial(jax.jit, static_argnames=("max_pairs",))
def overlap_pairs_all_extract(
    labels: jax.Array, weights: jax.Array, max_pairs: int, key_stride: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """
    Sort-free variant of :func:`overlap_pairs_all` for modest per-slice pair
    counts: distinct packed keys are enumerated per row by iterative
    min-extraction (one fused compare+reduce pass per pair slot), avoiding
    the 105M-key argsort entirely. Same padded output contract (ascending
    keys, -1 padding), so the caller's overflow check (last column occupied)
    works unchanged.
    """
    a, b = labels[:-1], labels[1:]
    both = jnp.logical_and(a > 0, b > 0)
    key = jnp.where(both, a * key_stride + b, _INVALID)  # (T-1, S)
    w = jnp.where(both, jnp.broadcast_to(weights[None, :], key.shape), 0.0)

    prev = jnp.full((key.shape[0], 1), -1, jnp.int32)
    pa, pb, pw = [], [], []
    for _ in range(max_pairs):
        cand = jnp.where(key > prev, key, _INVALID)
        k = jnp.min(cand, axis=1, keepdims=True)  # (T-1, 1)
        s = jnp.sum(jnp.where(key == k, w, 0.0), axis=1)
        valid = k[:, 0] != _INVALID
        pa.append(jnp.where(valid, k[:, 0] // key_stride, -1))
        pb.append(jnp.where(valid, k[:, 0] % key_stride, -1))
        pw.append(jnp.where(valid, s, 0.0))
        prev = k
    return jnp.stack(pa, axis=1), jnp.stack(pb, axis=1), jnp.stack(pw, axis=1)
