// marex_host: native host-side runtime kernels for marex_tpu.
//
// The device owns the array math (XLA); these C++ kernels cover the
// host-side graph bookkeeping of the tracker's merge march, where the
// reference relied on Numba-JIT (track.py:4826-5468) and numpy unique/ufunc
// reductions:
//   * overlap-pair aggregation  (check_overlap_slice, track.py:2396-2452)
//   * union-find connected components over the event graph
//     (cluster step, track.py:2876-2884)
//   * in-place label renames used by ID consolidation (track.py:2632)
//
// Built as a plain shared library, called through ctypes — no pybind11
// dependency.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <cstdio>
#include <cstdlib>
#include <ctime>

extern "C" {

// Aggregate unique (a, b) pairs with summed weights over cells where both
// labels are positive. Writes at most `capacity` pairs but always returns the
// TOTAL number of unique pairs found, so callers can detect overflow, grow
// the buffer, and retry.
int64_t marex_overlap_pairs(const int32_t* a, const int32_t* b, const float* w,
                            int64_t n, int64_t capacity, int64_t* out_a,
                            int64_t* out_b, double* out_w) {
  std::unordered_map<int64_t, double> acc;
  acc.reserve(1024);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t ai = a[i];
    const int32_t bi = b[i];
    if (ai > 0 && bi > 0) {
      const int64_t key = (static_cast<int64_t>(ai) << 31) | static_cast<int64_t>(bi);
      acc[key] += w ? static_cast<double>(w[i]) : 1.0;
    }
  }
  // emit sorted by key for deterministic output
  std::vector<std::pair<int64_t, double>> items(acc.begin(), acc.end());
  std::sort(items.begin(), items.end());
  int64_t count = 0;
  for (const auto& kv : items) {
    if (count >= capacity) break;
    out_a[count] = kv.first >> 31;
    out_b[count] = kv.first & ((1LL << 31) - 1);
    out_w[count] = kv.second;
    ++count;
  }
  return static_cast<int64_t>(items.size());
}

// Path-compressed union-find over an edge list. node_ids must be sorted
// ascending; comp receives 0-based component indices ordered by smallest
// member.
static int64_t uf_find(std::vector<int64_t>& parent, int64_t i) {
  int64_t root = i;
  while (parent[root] != root) root = parent[root];
  while (parent[i] != root) {
    int64_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

void marex_union_find(const int64_t* edge_a, const int64_t* edge_b,
                      int64_t n_edges, const int64_t* node_ids,
                      int64_t n_nodes, int32_t* comp_out) {
  std::unordered_map<int64_t, int64_t> index;
  index.reserve(n_nodes * 2);
  for (int64_t i = 0; i < n_nodes; ++i) index[node_ids[i]] = i;

  std::vector<int64_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

  for (int64_t e = 0; e < n_edges; ++e) {
    auto ia = index.find(edge_a[e]);
    auto ib = index.find(edge_b[e]);
    if (ia == index.end() || ib == index.end()) continue;
    int64_t ra = uf_find(parent, ia->second);
    int64_t rb = uf_find(parent, ib->second);
    if (ra != rb) parent[ra > rb ? ra : rb] = (ra < rb ? ra : rb);
  }

  // densify component ids in order of first appearance (root index order)
  std::unordered_map<int64_t, int32_t> remap;
  remap.reserve(n_nodes);
  int32_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t r = uf_find(parent, i);
    auto it = remap.find(r);
    if (it == remap.end()) {
      remap[r] = next;
      comp_out[i] = next;
      ++next;
    } else {
      comp_out[i] = it->second;
    }
  }
}

// LZ4 block-format decompression (safe: bounds-checked). Used by the
// zarr-lite reader to decode blosc/lz4 chunks (the reference ecosystem's
// default codec) without external compression libraries. Returns the number
// of bytes written to dst, or -1 on malformed input.
int64_t marex_lz4_decompress(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_capacity) {
  int64_t si = 0;
  int64_t di = 0;
  while (si < src_len) {
    const uint8_t token = src[si++];
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t x;
      do {
        if (si >= src_len) return -1;
        x = src[si++];
        lit += x;
      } while (x == 255);
    }
    if (si + lit > src_len || di + lit > dst_capacity) return -1;
    std::memcpy(dst + di, src + si, static_cast<size_t>(lit));
    si += lit;
    di += lit;
    if (si >= src_len) break;  // last sequence has no match part
    // match
    if (si + 2 > src_len) return -1;
    const int64_t offset = static_cast<int64_t>(src[si]) |
                           (static_cast<int64_t>(src[si + 1]) << 8);
    si += 2;
    if (offset == 0 || offset > di) return -1;
    int64_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t x;
      do {
        if (si >= src_len) return -1;
        x = src[si++];
        mlen += x;
      } while (x == 255);
    }
    mlen += 4;
    if (di + mlen > dst_capacity) return -1;
    int64_t from = di - offset;
    if (offset >= mlen) {
      std::memcpy(dst + di, dst + from, static_cast<size_t>(mlen));
      di += mlen;
    } else {
      for (int64_t k = 0; k < mlen; ++k) dst[di + k] = dst[from + k];
      di += mlen;
    }
  }
  return di;
}


// ---------------------------------------------------------------------------
// Host CCL fast path for the gridded no-merge tracking pipeline.
//
// CCL is a pointer-chasing problem, which a run-based single-pass pipeline
// on one host core does well, and the binary field ships over the device
// link bit-packed (142 MB at 1095 x 720 x 1440), so the transfer can
// amortise. Semantics replicate
// ops/label.label_slices_grid (8-connectivity, optional periodic x, dense
// per-slice ids in ascending min-flat-index order), the area filter
// (track.py:1755-1906 incl. the drop-first-object quirk of
// track.py:1890-1891) and label_spacetime two-level (3x3x3 connectivity,
// event ids in first-appearance order) — pinned bit-exact against the
// device kernels in tests/test_host_ccl.py.
// ---------------------------------------------------------------------------

}  // extern "C"

namespace {

struct RunRec {
  int32_t row;
  int32_t a;      // first column
  int32_t b;      // last column (inclusive)
  int32_t obj;    // object id (slice-local dense, then reused for paint)
};

inline int32_t ccl_find(std::vector<int32_t>& p, int32_t i) {
  int32_t r = i;
  while (p[r] != r) r = p[r];
  while (p[i] != r) { int32_t n = p[i]; p[i] = r; i = n; }
  return r;
}

inline void ccl_union(std::vector<int32_t>& p, int32_t a, int32_t b) {
  int32_t ra = ccl_find(p, a), rb = ccl_find(p, b);
  if (ra == rb) return;
  if (ra < rb) p[rb] = ra; else p[ra] = rb;
}

// Word-scan run extraction from one bit-packed row (little bitorder).
inline void row_runs(const uint8_t* bits, int W, int32_t row,
                     std::vector<RunRec>& out) {
  const int nw = (W + 63) >> 6;
  int cur_start = -1;
  for (int wi = 0; wi < nw; ++wi) {
    uint64_t w = 0;
    const int nb = ((wi + 1) * 64 <= W) ? 8 : ((W - wi * 64) + 7) >> 3;
    std::memcpy(&w, bits + wi * 8, static_cast<size_t>(nb));
    const int valid = (W - wi * 64 >= 64) ? 64 : (W - wi * 64);
    if (valid < 64) w &= (valid == 64) ? ~0ull : ((1ull << valid) - 1);
    const int base = wi << 6;
    if (cur_start >= 0) {
      if (w == ~0ull) continue;  // full word of 1s: run continues
      const int fz = __builtin_ctzll(~w);  // first zero bit
      if (fz > 0) w &= ~((1ull << fz) - 1);
      out.push_back({row, static_cast<int32_t>(cur_start),
                     static_cast<int32_t>(base + fz - 1), -1});
      cur_start = -1;
    }
    while (w) {
      const int s = __builtin_ctzll(w);
      const uint64_t low = (s == 0) ? 0ull : ((1ull << s) - 1);
      const uint64_t inv = ~(w | low);
      if (!inv) {  // run extends past word end
        cur_start = base + s;
        break;
      }
      const int e = __builtin_ctzll(inv);
      out.push_back({row, static_cast<int32_t>(base + s),
                     static_cast<int32_t>(base + e - 1), -1});
      w &= ~((e == 64) ? ~0ull : ((1ull << e) - 1));
    }
    if (cur_start >= 0 && w == 0 && wi + 1 < nw) continue;
  }
  if (cur_start >= 0)
    out.push_back({row, static_cast<int32_t>(cur_start),
                   static_cast<int32_t>(W - 1), -1});
}

}  // namespace

extern "C" {

// The whole gridded no-merge post-morphology pipeline in one call:
// per-slice 2-D CCL -> object areas -> area threshold (absolute value or
// quantile of the pre-filter areas, np.percentile linear interpolation) ->
// drop-first-object quirk -> 3x3x3 spatio-temporal event labeling of the
// kept objects -> final id field in first-appearance order.
//
//   bits      : T*H*ceil(W/8) bytes (numpy packbits bitorder='little')
//   thr_mode  : 0 = absolute (thr_value is the cutoff, keep area >= thr),
//               1 = quantile (thr_value in [0,1])
//   id_out    : T*H*W int32 (overwritten) — final event ids, 0 background
//   counts_out: T int32 — PRE-filter objects per slice
//   areas_out : areas_cap float64 — pre-filter object areas, slice-major in
//               per-slice dense-id order
//   thr_out   : resolved threshold; n_pre/n_kept: object counts
// Returns the number of events, or -1 if areas_cap is too small.
int64_t marex_track_nomerge(const uint8_t* bits, int64_t T, int64_t H,
                            int64_t W, int wrap_x, int thr_mode,
                            double thr_value, int drop_first,
                            int32_t* id_out, uint8_t* bool_out,
                            int32_t* counts_out,
                            double* areas_out, int64_t areas_cap,
                            double* thr_out, int64_t* n_pre_out,
                            int64_t* n_kept_out) {
  const bool timing = std::getenv("MAREX_NATIVE_TIMING") != nullptr;
  struct timespec ts0, ts1;
  auto lap = [&](const char* name) {
    if (!timing) return;
    clock_gettime(CLOCK_MONOTONIC, &ts1);
    std::fprintf(stderr, "[native] %s: %.2fs\n", name,
                 (ts1.tv_sec - ts0.tv_sec) + 1e-9 * (ts1.tv_nsec - ts0.tv_nsec));
    ts0 = ts1;
  };
  clock_gettime(CLOCK_MONOTONIC, &ts0);
  const int64_t Wb = (W + 7) >> 3;
  std::vector<RunRec> runs;            // all runs, slice-major
  std::vector<int64_t> row_start;      // (T*(H+1)) offsets into runs
  row_start.resize(T * (H + 1));
  std::vector<int64_t> obj_offset(T + 1, 0);  // global object id offsets
  std::vector<double> areas;           // per object (pre-filter)
  std::vector<int64_t> minidx;         // per object min global flat index
  std::vector<int32_t> parent;         // per-slice run union-find (reused)

  for (int64_t t = 0; t < T; ++t) {
    const int64_t slice_run0 = static_cast<int64_t>(runs.size());
    for (int64_t y = 0; y < H; ++y) {
      row_start[t * (H + 1) + y] = static_cast<int64_t>(runs.size());
      row_runs(bits + (t * H + y) * Wb, static_cast<int>(W),
               static_cast<int32_t>(y), runs);
    }
    row_start[t * (H + 1) + H] = static_cast<int64_t>(runs.size());
    const int64_t R = static_cast<int64_t>(runs.size()) - slice_run0;
    RunRec* sr = runs.data() + slice_run0;
    const int64_t* rs = row_start.data() + t * (H + 1);
    parent.assign(R, 0);
    for (int64_t i = 0; i < R; ++i) parent[i] = static_cast<int32_t>(i);
    for (int64_t y = 0; y < H; ++y) {
      const int64_t c0 = rs[y] - slice_run0, c1 = rs[y + 1] - slice_run0;
      if (wrap_x && c1 - c0 >= 2 && sr[c0].a == 0 && sr[c1 - 1].b == W - 1)
        ccl_union(parent, static_cast<int32_t>(c0), static_cast<int32_t>(c1 - 1));
      if (y == 0) continue;
      const int64_t p0 = rs[y - 1] - slice_run0, p1 = rs[y] - slice_run0;
      int64_t j = p0;
      for (int64_t i = c0; i < c1; ++i) {
        const int32_t a = sr[i].a, b = sr[i].b;
        while (j < p1 && sr[j].b + 1 < a) ++j;
        for (int64_t k = j; k < p1 && sr[k].a <= b + 1; ++k)
          ccl_union(parent, static_cast<int32_t>(i), static_cast<int32_t>(k));
        if (wrap_x && p1 > p0) {
          if (a == 0 && sr[p1 - 1].b == W - 1)
            ccl_union(parent, static_cast<int32_t>(i), static_cast<int32_t>(p1 - 1));
          if (b == W - 1 && sr[p0].a == 0)
            ccl_union(parent, static_cast<int32_t>(i), static_cast<int32_t>(p0));
        }
      }
    }
    // dense ids in ascending min-flat-index order (= first run in scan order)
    int32_t n = 0;
    for (int64_t i = 0; i < R; ++i) {
      const int32_t r = ccl_find(parent, static_cast<int32_t>(i));
      if (sr[r].obj == -1) {  // unvisited root (markers are <= -2)
        ++n;
        sr[r].obj = -(n + 1);  // mark root with -(dense_id+1)
        areas.push_back(0.0);
        minidx.push_back(t * H * W + static_cast<int64_t>(sr[i].row) * W + sr[i].a);
      }
    }
    for (int64_t i = 0; i < R; ++i) {
      const int32_t r = ccl_find(parent, static_cast<int32_t>(i));
      const int32_t id = -sr[r].obj - 1;  // 1-based dense id (root marker)
      areas[obj_offset[t] + id - 1] += sr[i].b - sr[i].a + 1;
      if (i != r) sr[i].obj = id;  // roots rewritten after the loop
    }
    for (int64_t i = 0; i < R; ++i)
      if (sr[i].obj < 0) sr[i].obj = -sr[i].obj - 1;  // root markers -> ids
    counts_out[t] = n;
    obj_offset[t + 1] = obj_offset[t] + n;
  }
  lap("pass A (runs + per-slice CCL)");
  const int64_t n_obj = obj_offset[T];
  if (n_obj > areas_cap) return -1;
  std::memcpy(areas_out, areas.data(), sizeof(double) * n_obj);
  *n_pre_out = n_obj;

  // threshold. n_obj == 0 (all-background field) must NOT reach the
  // percentile path: rank would go negative and sorted[0] dereference an
  // empty vector. Return a clean zero-event result instead — the Python
  // caller raises the reference's TrackingError on zero pre-filter objects.
  if (n_obj == 0) {
    *thr_out = 0.0;
    *n_kept_out = 0;
    std::memset(id_out, 0, sizeof(int32_t) * T * H * W);
    std::memset(bool_out, 0, static_cast<size_t>(T * H * W));
    return 0;
  }
  double thr;
  if (thr_mode == 0) {
    thr = thr_value;
  } else {
    // np.percentile default linear interpolation on the sorted areas
    std::vector<double> sorted(areas);
    std::sort(sorted.begin(), sorted.end());
    const double rank = thr_value * static_cast<double>(n_obj - 1);
    const int64_t lo = static_cast<int64_t>(rank);
    const int64_t hi = lo + 1 < n_obj ? lo + 1 : lo;
    const double frac = rank - static_cast<double>(lo);
    thr = sorted[lo] * (1.0 - frac) + sorted[hi] * frac;
  }
  *thr_out = thr;

  std::vector<uint8_t> keep(n_obj);
  for (int64_t i = 0; i < n_obj; ++i) keep[i] = areas[i] >= thr;
  if (drop_first) {
    for (int64_t t = 0; t < T; ++t)
      if (counts_out[t] > 0) { keep[obj_offset[t]] = 0; break; }
  }
  int64_t n_kept = 0;
  for (int64_t i = 0; i < n_obj; ++i) n_kept += keep[i];
  *n_kept_out = n_kept;

  lap("threshold");
  // 3x3x3 cross-slice unions among kept objects, run-interval based
  std::vector<int32_t> gparent(n_obj);
  for (int64_t i = 0; i < n_obj; ++i) gparent[i] = static_cast<int32_t>(i);
  for (int64_t t = 0; t + 1 < T; ++t) {
    const int64_t* ra = row_start.data() + t * (H + 1);
    const int64_t* rb = row_start.data() + (t + 1) * (H + 1);
    for (int64_t y = 0; y < H; ++y) {
      const int64_t a0 = ra[y], a1 = ra[y + 1];
      if (a0 == a1) continue;
      const int64_t ylo = y > 0 ? y - 1 : 0;
      const int64_t yhi = y + 1 < H ? y + 1 : H - 1;
      for (int64_t yy = ylo; yy <= yhi; ++yy) {
        const int64_t b0 = rb[yy], b1 = rb[yy + 1];
        if (b0 == b1) continue;
        int64_t j = b0;
        for (int64_t i = a0; i < a1; ++i) {
          if (!keep[obj_offset[t] + runs[i].obj - 1]) continue;
          const int32_t a = runs[i].a, b = runs[i].b;
          while (j > b0 && runs[j - 1].b + 1 >= a) --j;
          while (j < b1 && runs[j].b + 1 < a) ++j;
          for (int64_t k = j; k < b1 && runs[k].a <= b + 1; ++k) {
            if (!keep[obj_offset[t + 1] + runs[k].obj - 1]) continue;
            ccl_union(gparent, static_cast<int32_t>(obj_offset[t] + runs[i].obj - 1),
                      static_cast<int32_t>(obj_offset[t + 1] + runs[k].obj - 1));
          }
          if (wrap_x) {
            if (a == 0 && runs[b1 - 1].b == W - 1 &&
                keep[obj_offset[t + 1] + runs[b1 - 1].obj - 1])
              ccl_union(gparent, static_cast<int32_t>(obj_offset[t] + runs[i].obj - 1),
                        static_cast<int32_t>(obj_offset[t + 1] + runs[b1 - 1].obj - 1));
            if (b == W - 1 && runs[b0].a == 0 &&
                keep[obj_offset[t + 1] + runs[b0].obj - 1])
              ccl_union(gparent, static_cast<int32_t>(obj_offset[t] + runs[i].obj - 1),
                        static_cast<int32_t>(obj_offset[t + 1] + runs[b0].obj - 1));
          }
        }
      }
    }
  }

  lap("pass B (3-D unions)");
  // component min flat index -> first-appearance rank -> final ids
  std::vector<int64_t> comp_min(n_obj, INT64_MAX);
  for (int64_t i = 0; i < n_obj; ++i) {
    if (!keep[i]) continue;
    const int32_t r = ccl_find(gparent, static_cast<int32_t>(i));
    if (minidx[i] < comp_min[r]) comp_min[r] = minidx[i];
  }
  std::vector<std::pair<int64_t, int32_t>> order;
  for (int64_t i = 0; i < n_obj; ++i)
    if (keep[i] && ccl_find(gparent, static_cast<int32_t>(i)) == i)
      order.push_back({comp_min[i], static_cast<int32_t>(i)});
  std::sort(order.begin(), order.end());
  std::vector<int32_t> lookup(n_obj, 0);
  for (int64_t e = 0; e < static_cast<int64_t>(order.size()); ++e)
    lookup[order[e].second] = static_cast<int32_t>(e + 1);
  for (int64_t i = 0; i < n_obj; ++i)
    if (keep[i]) lookup[i] = lookup[ccl_find(gparent, static_cast<int32_t>(i))];

  lap("rank");
  // paint the output fields (memset + kept runs only). Callers pass
  // POOLED buffers: on this class of VM host, first-touch page faults run
  // at ~0.2 GB/s while warm pages fill at ~8 GB/s, so reusing an
  // already-touched buffer is a ~20 s difference at production shape.
  std::memset(id_out, 0, sizeof(int32_t) * T * H * W);
  std::memset(bool_out, 0, static_cast<size_t>(T * H * W));
  for (int64_t t = 0; t < T; ++t) {
    const int64_t r0 = row_start[t * (H + 1)], r1 = row_start[t * (H + 1) + H];
    int32_t* slab = id_out + t * H * W;
    uint8_t* bslab = bool_out + t * H * W;
    for (int64_t i = r0; i < r1; ++i) {
      const int32_t fid = lookup[obj_offset[t] + runs[i].obj - 1];
      if (!fid) continue;
      const int64_t base0 = static_cast<int64_t>(runs[i].row) * W + runs[i].a;
      const int32_t len = runs[i].b - runs[i].a + 1;
      int32_t* p = slab + base0;
      for (int32_t c = 0; c < len; ++c) p[c] = fid;
      std::memset(bslab + base0, 1, static_cast<size_t>(len));
    }
  }
  lap("paint");
  return static_cast<int64_t>(order.size());
}


// Per-slice CCL over an unstructured neighbour graph on the host — the
// ICON-scale analogue of marex_track_nomerge's pass A: host union-find over
// the active cells, the alternative to the device's gather-based per-slice
// fixpoint. Labels are dense per slice
// (1..n_t, 0 background) in ascending min-cell-index order — the exact
// convention of ops.label.label_slices_unstructured (reference semantics:
// scipy csgraph per slice, marEx/track.py:1947-1999). Written int16 so the
// label field uploads back over the ~90 MB/s link at half the bytes.
//
//   bits       : T * ceil(C/8) bytes (packbits bitorder='little'),
//                already masked
//   neighbours : (K, C) int32, -1 = missing; must be SYMMETRIZED
// Returns total object count, or -2 if some slice exceeds 32767 objects.
int64_t marex_unstr_slice_ccl(const uint8_t* bits, int64_t T, int64_t C,
                              const int32_t* neighbours, int64_t K,
                              int16_t* labels_out, int32_t* counts_out) {
  const int64_t Cb = (C + 7) >> 3;
  std::vector<int32_t> parent(C);
  std::vector<int32_t> active;
  active.reserve(1 << 16);
  int64_t total = 0;
  for (int64_t t = 0; t < T; ++t) {
    const uint8_t* sb = bits + t * Cb;
    int16_t* slab = labels_out + t * C;
    std::memset(slab, 0, sizeof(int16_t) * C);
    active.clear();
    for (int64_t wi = 0; wi < Cb; wi += 8) {
      uint64_t w = 0;
      const int64_t nb = (wi + 8 <= Cb) ? 8 : (Cb - wi);
      std::memcpy(&w, sb + wi, static_cast<size_t>(nb));
      int64_t base = wi << 3;
      while (w) {
        const int b = __builtin_ctzll(w);
        const int64_t c = base + b;
        if (c < C) active.push_back(static_cast<int32_t>(c));
        w &= w - 1;
      }
    }
    for (const int32_t i : active) parent[i] = i;
    for (const int32_t i : active) {
      for (int64_t k = 0; k < K; ++k) {
        const int32_t j = neighbours[k * C + i];
        if (j < 0) continue;
        if (!((sb[j >> 3] >> (j & 7)) & 1)) continue;  // neighbour inactive
        ccl_union(parent, i, j);
      }
    }
    int32_t n = 0;
    for (const int32_t i : active) {
      const int32_t r = ccl_find(parent, i);
      if (r == i) {
        if (n == 32767) return -2;
        slab[i] = static_cast<int16_t>(++n);
      } else {
        slab[i] = slab[r];  // r < i (min-union) -> already assigned
      }
    }
    counts_out[t] = n;
    total += n;
  }
  return total;
}


// Replace every occurrence of `old_val` with `new_val`; returns #replaced.
int64_t marex_replace_value(int32_t* arr, int64_t n, int32_t old_val,
                            int32_t new_val) {
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (arr[i] == old_val) {
      arr[i] = new_val;
      ++count;
    }
  }
  return count;
}

}  // extern "C"
