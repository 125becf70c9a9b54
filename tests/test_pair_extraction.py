"""Oracle tests for the march's overlap-pair extraction kernel.

``ops.march._extract_pairs_local`` is the scan march's per-slice-pair floor
cost (reference semantics: the unique (parent_label, child_label, overlap)
triples between consecutive time slices, ``/root/reference/marEx/track.py``
``check_overlap_slice``). The kernel was redesigned round 5 from
argsort+scatter to one sort + searchsorted run lookup; these tests pin it
against a pure-numpy oracle across slot capacities, overflow, ties and
cell-area weighting so any future rewrite stays bit-compatible.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from marex_tpu.ops import march as M


def oracle_pairs(prev, cur, MP, stride, cell_w=None):
    """Pure-numpy reference: distinct (a, b) label pairs in ascending
    packed-key order, weight = overlap cell count (or summed cell area),
    truncated to the first MP pairs, -1/0 padded."""
    a = prev.reshape(-1).astype(np.int64)
    b = cur.reshape(-1).astype(np.int64)
    w = np.ones_like(a, dtype=np.float64) if cell_w is None else cell_w.reshape(-1).astype(np.float64)
    both = (a > 0) & (b > 0)
    keys = a[both] * stride + b[both]
    ws = w[both]
    uniq = np.unique(keys)
    pa = np.full((MP,), -1, np.int32)
    pb = np.full((MP,), -1, np.int32)
    wagg = np.zeros((MP,), np.float32)
    for i, k in enumerate(uniq[:MP]):
        pa[i] = k // stride
        pb[i] = k % stride
        wagg[i] = np.float32(ws[keys == k].sum())
    return pa, pb, wagg, len(uniq) > MP


def run_kernel(prev, cur, MP, stride, cell_w=None):
    cw = None if cell_w is None else jnp.asarray(cell_w)
    pa, pb, w, of = M._extract_pairs_local(jnp.asarray(prev), jnp.asarray(cur), MP, stride, cw)
    return np.asarray(pa), np.asarray(pb), np.asarray(w), bool(np.asarray(of))


class TestPairExtractionOracle:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("MP", [4, 16, 128])
    def test_random_fields_match_oracle(self, seed, MP):
        rng = np.random.default_rng(seed)
        L = 9
        stride = L + 2
        prev = rng.integers(0, L + 1, (23, 31)).astype(np.int32)
        cur = rng.integers(0, L + 1, (23, 31)).astype(np.int32)
        exp = oracle_pairs(prev, cur, MP, stride)
        got = run_kernel(prev, cur, MP, stride)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        np.testing.assert_allclose(got[2], exp[2], rtol=0, atol=0)
        assert got[3] == exp[3]

    def test_no_overlap_returns_empty_slots(self):
        prev = np.zeros((8, 8), np.int32)
        cur = np.zeros((8, 8), np.int32)
        prev[:4] = 1
        cur[4:] = 2  # disjoint supports -> no (a>0, b>0) cell
        pa, pb, w, of = run_kernel(prev, cur, 8, 16)
        assert (pa == -1).all() and (pb == -1).all()
        assert (w == 0).all() and not of

    def test_single_pair_weight_is_overlap_area(self):
        prev = np.zeros((10, 10), np.int32)
        cur = np.zeros((10, 10), np.int32)
        prev[2:7, 2:7] = 3
        cur[4:9, 4:9] = 5
        pa, pb, w, of = run_kernel(prev, cur, 4, 8)
        assert pa[0] == 3 and pb[0] == 5
        assert w[0] == 9.0  # 3x3 overlap
        assert (pa[1:] == -1).all() and not of

    def test_ascending_packed_key_order(self):
        # parent 2 overlaps children 1 and 3; parent 1 overlaps child 3:
        # slot order must be (1,3), (2,1), (2,3) by packed key
        prev = np.array([[1, 1, 2, 2, 2, 2]], np.int32)
        cur = np.array([[3, 3, 1, 1, 3, 3]], np.int32)
        pa, pb, w, _ = run_kernel(prev, cur, 8, 8)
        assert list(pa[:3]) == [1, 2, 2]
        assert list(pb[:3]) == [3, 1, 3]
        np.testing.assert_array_equal(w[:3], [2.0, 2.0, 2.0])

    def test_overflow_truncates_to_smallest_keys_and_flags(self):
        # 6 distinct pairs but MP=4: keep the 4 smallest packed keys, flag
        prev = np.repeat(np.arange(1, 7, dtype=np.int32), 5)[None, :]
        cur = np.tile(np.arange(1, 6, dtype=np.int32), 6)[None, :]
        MP, stride = 4, 8
        exp = oracle_pairs(prev, cur, MP, stride)
        got = run_kernel(prev, cur, MP, stride)
        assert got[3] is True and exp[3] is True
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        np.testing.assert_array_equal(got[2], exp[2])

    def test_exactly_mp_pairs_not_flagged(self):
        prev = np.array([[1, 1, 2, 2]], np.int32)
        cur = np.array([[1, 2, 1, 2]], np.int32)
        pa, pb, w, of = run_kernel(prev, cur, 4, 8)
        assert not of
        assert list(pa) == [1, 1, 2, 2] and list(pb) == [1, 2, 1, 2]

    def test_background_never_pairs(self):
        # label 0 on either side excludes the cell entirely
        prev = np.array([[0, 1, 1, 0]], np.int32)
        cur = np.array([[1, 0, 1, 1]], np.int32)
        pa, pb, w, of = run_kernel(prev, cur, 4, 8)
        assert pa[0] == 1 and pb[0] == 1 and w[0] == 1.0
        assert (pa[1:] == -1).all()

    def test_cell_area_weights_summed_in_order(self):
        rng = np.random.default_rng(7)
        prev = rng.integers(0, 4, (1, 64)).astype(np.int32)
        cur = rng.integers(0, 4, (1, 64)).astype(np.int32)
        cw = rng.uniform(0.25, 4.0, (1, 64)).astype(np.float32)
        MP, stride = 16, 8
        exp = oracle_pairs(prev, cur, MP, stride, cw)
        got = run_kernel(prev, cur, MP, stride, cw)
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        # float32 in-order summation vs float64 oracle: tight tolerance
        np.testing.assert_allclose(got[2], exp[2], rtol=1e-6)

    def test_cell_area_weights_with_overflow(self):
        # more distinct pairs than slots, with cell weights: the runs past
        # MP are dropped and the kept slots still sum their own weights
        # (the weighted scatter's indices stay sorted past the overflow)
        rng = np.random.default_rng(5)
        prev = rng.integers(0, 7, (3, 50)).astype(np.int32)
        cur = rng.integers(0, 7, (3, 50)).astype(np.int32)
        cw = rng.uniform(0.25, 4.0, (3, 50)).astype(np.float32)
        MP, stride = 8, 9
        exp = oracle_pairs(prev, cur, MP, stride, cw)
        got = run_kernel(prev, cur, MP, stride, cw)
        assert exp[3] and got[3]
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        np.testing.assert_allclose(got[2], exp[2], rtol=1e-6)

    def test_cell_area_weighting_bitwise_vs_inorder_sum(self):
        # the kernel must sum each run's weights in ascending-cell order
        # (stable sort), making the result bit-reproducible run to run
        rng = np.random.default_rng(11)
        prev = rng.integers(0, 3, (5, 40)).astype(np.int32)
        cur = rng.integers(0, 3, (5, 40)).astype(np.int32)
        cw = rng.uniform(0.5, 2.0, (5, 40)).astype(np.float32)
        w1 = run_kernel(prev, cur, 8, 5, cw)[2]
        w2 = run_kernel(prev, cur, 8, 5, cw)[2]
        np.testing.assert_array_equal(w1, w2)

    def test_int16_labels_accepted(self):
        prev = np.array([[1, 2]], np.int16)
        cur = np.array([[2, 2]], np.int16)
        pa, pb, w, _ = run_kernel(prev, cur, 4, 8)
        assert list(pa[:2]) == [1, 2] and list(pb[:2]) == [2, 2]
        np.testing.assert_array_equal(w[:2], [1.0, 1.0])

    def test_large_label_ids_near_stride(self):
        # labels at the top of the local range must pack/unpack exactly
        L = 510
        stride = L + 2
        prev = np.full((2, 3), L, np.int32)
        cur = np.full((2, 3), L - 1, np.int32)
        pa, pb, w, _ = run_kernel(prev, cur, 4, stride)
        assert pa[0] == L and pb[0] == L - 1 and w[0] == 6.0
