"""
Native (C++) host-runtime loader.

Compiles ``csrc/marex_host.cpp`` into a shared library on first use (g++,
cached next to the package) and exposes it through ctypes; every entry point
has a pure-numpy fallback so the framework works without a toolchain.
Disable with ``MAREX_DISABLE_NATIVE=1``.

The device owns the array math; this layer accelerates the host-side graph
bookkeeping of the tracker (overlap-pair aggregation, union-find event
clustering, in-place label renames) — the role Numba played in the reference
(track.py:4826-5468).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

from typing import Optional

import numpy as np

from .logging_config import get_logger

logger = get_logger(__name__)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _source_path() -> Optional[str]:
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (
        os.path.join(here, "..", "csrc", "marex_host.cpp"),
        os.path.join(here, "csrc", "marex_host.cpp"),
    ):
        if os.path.exists(cand):
            return os.path.abspath(cand)
    return None


def _build(src: str) -> Optional[str]:
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(out_dir, exist_ok=True)
    so_path = os.path.join(out_dir, "libmarex_host.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(src):
        return so_path
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", src, "-o", so_path],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return so_path
    except Exception as e:  # pragma: no cover - toolchain missing
        logger.debug(f"native build failed ({e}); using numpy fallbacks")
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library, or None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MAREX_DISABLE_NATIVE", "").strip() in ("1", "true"):
        return None
    src = _source_path()
    if src is None:
        return None
    so = _build(src)
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
        lib.marex_overlap_pairs.restype = ctypes.c_int64
        lib.marex_overlap_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.marex_union_find.restype = None
        lib.marex_union_find.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.marex_replace_value.restype = ctypes.c_int64
        lib.marex_replace_value.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.marex_lz4_decompress.restype = ctypes.c_int64
        lib.marex_lz4_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.marex_unstr_slice_ccl.restype = ctypes.c_int64
        lib.marex_unstr_slice_ccl.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.marex_track_nomerge.restype = ctypes.c_int64
        lib.marex_track_nomerge.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        logger.debug("native host runtime loaded")
    except Exception as e:  # pragma: no cover
        logger.debug(f"native load failed ({e}); using numpy fallbacks")
        _lib = None
    return _lib


def has_native() -> bool:
    return get_lib() is not None


# ----------------------------------------------------------------------------
# Wrappers with numpy fallback
# ----------------------------------------------------------------------------


def overlap_pairs(ids_a: np.ndarray, ids_b: np.ndarray, weights: Optional[np.ndarray]) -> np.ndarray:
    """Unique positive (a, b) pairs with summed weights -> (N, 3) float64."""
    lib = get_lib()
    a = np.ascontiguousarray(ids_a.reshape(-1), dtype=np.int32)
    b = np.ascontiguousarray(ids_b.reshape(-1), dtype=np.int32)
    if lib is not None:
        w = None if weights is None else np.ascontiguousarray(weights.reshape(-1), dtype=np.float32)
        cap = int(min(len(a), 4 * 1024 * 1024)) + 1
        while True:
            out_a = np.empty(cap, np.int64)
            out_b = np.empty(cap, np.int64)
            out_w = np.empty(cap, np.float64)
            # returns the TOTAL unique-pair count (may exceed cap): grow & retry
            n = lib.marex_overlap_pairs(
                a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                None if w is None else w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(a),
                cap,
                out_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            if n <= cap:
                break
            cap = int(n)
        return np.column_stack([out_a[:n].astype(np.float64), out_b[:n].astype(np.float64), out_w[:n]])

    # numpy fallback
    both = (a > 0) & (b > 0)
    if not both.any():
        return np.empty((0, 3), dtype=np.float64)
    av = a[both].astype(np.int64)
    bv = b[both].astype(np.int64)
    key = (av << 31) | bv
    if weights is None:
        uniq, counts = np.unique(key, return_counts=True)
        sums = counts.astype(np.float64)
    else:
        uniq, inv = np.unique(key, return_inverse=True)
        sums = np.zeros(len(uniq))
        np.add.at(sums, inv, weights.reshape(-1)[both].astype(np.float64))
    return np.column_stack([(uniq >> 31).astype(np.float64), (uniq & ((1 << 31) - 1)).astype(np.float64), sums])


def union_find(edges: np.ndarray, node_ids: np.ndarray) -> np.ndarray:
    """Connected components: edges (N,2), node_ids (M,) -> (M,) comp index."""
    lib = get_lib()
    node_ids = np.ascontiguousarray(node_ids, dtype=np.int64)
    if lib is not None:
        ea = np.ascontiguousarray(edges[:, 0] if len(edges) else np.empty(0), dtype=np.int64)
        eb = np.ascontiguousarray(edges[:, 1] if len(edges) else np.empty(0), dtype=np.int64)
        comp = np.empty(len(node_ids), np.int32)
        lib.marex_union_find(
            ea.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            eb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ea),
            node_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(node_ids),
            comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return comp

    # numpy fallback (path-compressing loop)
    id_to_idx = {int(v): i for i, v in enumerate(node_ids)}
    parent = np.arange(len(node_ids), dtype=np.int64)

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for aa, bb in np.asarray(edges).reshape(-1, 2):
        ia = id_to_idx.get(int(aa))
        ib = id_to_idx.get(int(bb))
        if ia is None or ib is None:
            continue
        ra, rb = find(ia), find(ib)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(i) for i in range(len(node_ids))])
    _, comp = np.unique(roots, return_inverse=True)
    return comp.astype(np.int32)


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """
    LZ4 block-format decompression (the payload format inside blosc frames,
    the reference ecosystem's default zarr codec). Native C++ fast path with
    a pure-Python fallback.
    """
    lib = get_lib()
    if lib is not None:
        sbuf = np.frombuffer(src, dtype=np.uint8)
        dbuf = np.empty(dst_size, dtype=np.uint8)
        n = lib.marex_lz4_decompress(
            sbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(sbuf),
            dbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dst_size,
        )
        if n < 0:
            raise ValueError("malformed LZ4 block")
        return dbuf[:n].tobytes()
    return _lz4_decompress_py(src, dst_size)


def _lz4_decompress_py(src: bytes, dst_size: int) -> bytes:
    """Pure-Python LZ4 block decoder (fallback when no C++ toolchain)."""
    dst = bytearray(dst_size)
    si, di, n = 0, 0, len(src)
    while si < n:
        token = src[si]
        si += 1
        lit = token >> 4
        if lit == 15:
            while True:
                x = src[si]
                si += 1
                lit += x
                if x != 255:
                    break
        if lit:
            dst[di : di + lit] = src[si : si + lit]
            si += lit
            di += lit
        if si >= n:
            break
        offset = src[si] | (src[si + 1] << 8)
        si += 2
        if offset == 0 or offset > di:
            raise ValueError("malformed LZ4 block")
        mlen = token & 15
        if mlen == 15:
            while True:
                x = src[si]
                si += 1
                mlen += x
                if x != 255:
                    break
        mlen += 4
        if offset >= mlen:
            dst[di : di + mlen] = dst[di - offset : di - offset + mlen]
            di += mlen
        else:
            for _ in range(mlen):
                dst[di] = dst[di - offset]
                di += 1
    return bytes(dst[:di])


def replace_value(arr: np.ndarray, old_val: int, new_val: int) -> int:
    """In-place replacement; returns count."""
    lib = get_lib()
    if lib is not None and arr.dtype == np.int32 and arr.flags["C_CONTIGUOUS"]:
        return int(
            lib.marex_replace_value(
                arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                arr.size,
                int(old_val),
                int(new_val),
            )
        )
    m = arr == old_val
    arr[m] = new_val
    return int(m.sum())


# Output-buffer pool: on this VM host, FIRST-TOUCH page faults run at
# ~0.2 GB/s while warm pages fill at ~8 GB/s (measured; madvise(HUGEPAGE)
# does not help), so materialising a fresh 4.5 GB ID field costs ~25 s of
# pure page faulting at production shape. The pool hands out the buffers
# themselves and gates reuse on the buffer's refcount being back at the
# pool-only baseline: every NumPy view DERIVED from a result (slice,
# reshape, transpose) points its .base at the pooled buffer (base chains
# collapse), so the refcount catches holders that a weakref to the
# handed-out array would miss — results and their views are safe to hold.
_POOL: dict = {}  # key -> [buffer, miss_streak]


def _pooled_empty(shape, dtype) -> np.ndarray:
    import sys

    key = (tuple(int(s) for s in shape), np.dtype(dtype).str)
    ent = _POOL.get(key)
    if ent is not None:
        base = ent[0]
        # refcount baseline = pool list entry + local `base` + getrefcount
        # argument = 3; anything above means the previous result (or a view
        # of it) is still alive and the buffer must not be reused
        if sys.getrefcount(base) > 3 and ent[1] == 0:
            # one whole-heap collect per miss STREAK: results often sit in
            # reference cycles (FieldSet graphs) that only the generational
            # GC breaks — worth ~20 s of page faults at production shape.
            # Consecutive misses mean a direct strong reference is holding
            # the buffer; no collect can release that, so don't pay the
            # full-heap pause again until a reuse succeeds.
            import gc

            gc.collect()
        if sys.getrefcount(base) == 3:  # previous result released
            ent[1] = 0
            return base
        ent[1] = 1
    buf = np.empty(shape, dtype)
    _POOL[key] = [buf, 0]
    return buf


def track_nomerge(
    bits: np.ndarray, T: int, H: int, W: int, wrap_x: bool,
    area_filter_absolute, area_filter_quartile, drop_first: bool,
):
    """The whole gridded no-merge post-morphology pipeline on the host:
    per-slice 2-D CCL, object areas, area threshold (absolute or quantile
    with np.percentile linear interpolation), the reference's
    drop-first-object quirk, and 3x3x3 spatio-temporal event labeling of the
    kept objects — one native call over the bit-packed field.

    bits : (T, H, ceil(W/8)) uint8, numpy packbits(bitorder='little') rows
    Returns (id_field (T, H, W) int32 final event ids,
    bool_field (T, H, W) bool filtered binary field, n_events,
    counts (T,) int32 pre-filter per-slice object counts,
    object_areas (n_obj,) float64, threshold, n_kept) or None when the
    native library is unavailable (callers fall back to the device kernels).
    The two field outputs come from a warm buffer pool (see _pooled_empty);
    they are safe to hold, but releasing them promptly lets the next call
    reuse the warm pages.
    """
    lib = get_lib()
    if lib is None:
        return None
    bits = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    id_field = _pooled_empty((T, H, W), np.int32)
    bool_field = _pooled_empty((T, H, W), np.bool_)
    counts = np.empty(T, np.int32)
    thr = ctypes.c_double()
    n_pre = ctypes.c_int64()
    n_kept = ctypes.c_int64()
    if area_filter_absolute is not None:
        thr_mode, thr_value = 0, float(area_filter_absolute)
    else:
        thr_mode, thr_value = 1, float(area_filter_quartile)
    cap = 1 << 20
    while True:
        areas = np.empty(cap, np.float64)
        n_events = int(
            lib.marex_track_nomerge(
                bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                T, H, W, int(wrap_x), thr_mode, thr_value, int(drop_first),
                id_field.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                bool_field.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                areas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                cap,
                ctypes.byref(thr),
                ctypes.byref(n_pre),
                ctypes.byref(n_kept),
            )
        )
        if n_events >= 0:
            return (
                id_field, bool_field, n_events, counts,
                areas[: n_pre.value], float(thr.value), int(n_kept.value),
            )
        cap *= 4


def unstr_slice_ccl(bits: np.ndarray, T: int, C: int, neighbours: np.ndarray):
    """Host per-slice CCL over an unstructured neighbour graph.

    bits : (T, ceil(C/8)) uint8 (packbits bitorder='little'), already masked
    neighbours : (K, C) int32, -1 = missing, SYMMETRIZED
    Returns (labels (T, C) int16 dense per-slice ids from the warm buffer
    pool, counts (T,) int32) or None when the native library is missing or
    a slice exceeds int16 label capacity (callers fall back to the device
    kernel).
    """
    lib = get_lib()
    if lib is None:
        return None
    bits = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    neighbours = np.ascontiguousarray(neighbours, dtype=np.int32)
    K = neighbours.shape[0]
    labels = _pooled_empty((T, C), np.int16)
    counts = np.empty(T, np.int32)
    n = int(
        lib.marex_unstr_slice_ccl(
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            T, C,
            neighbours.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            K,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    )
    if n < 0:
        return None
    return labels, counts
