// The mesh obstacles' narrow phases, per lane: the device body of kernel J
// (obstacle.cu) and of kernel H's sweeps against mesh obstacles (gs.cu).
//
// The same steps in the same order as the plain versions,
// admm_elastic_tpu_torch/collision/passive.py PassiveMeshSDF /
// PassiveMeshExact (the JAX package's passive.py:120-179, :332-546):
// - SDF: u = clip((p - origin) / h, 0, dims - 1.000001) (the bound in the
//   dtype, the division by h IEEE); i0 = floor(u), f = u - i0; the 8 corner
//   rows of vals4 in dk-fastest order, each corner row clamped to the last
//   node as an XLA gather clamps; the weights (wx wy) wz; the blend summed in
//   corner order from the first term; the normal over max(|n|, 1e-30);
// - exact: the cell floor((p - origin) / h), clamped as a float before it
//   becomes an int (a lane far outside, or NaN, is out of the grid); Ericson's
//   closest point over the cell's candidates in table order, the first of
//   least squared distance; that triangle's closest point again and the
//   pseudonormal of its region (eps 1e-5, the JAX package's override order);
//   the sign from (p - closest) . n < 0 in a tet-occupied cell.
// Every operation is an IEEE-rounded intrinsic (no contraction into an fma),
// every dot product and norm in component order, every max / min
// NaN-propagating (common.cuh), every constant T(...): kernel and plain
// version agree bit for bit on the card.
//
// The compaction of the near lanes and of the fallback lanes ranks them by a
// prefix count in lane order (block_rank within a block; kernel J adds the
// counts of the blocks before it), as jax.lax.top_k orders a 0/1 mask; no
// atomic slot allocation, which would reorder them.
//
// The exact walk over a cell's candidates is spread over a group of threads
// (candidates): each thread walks every g-th entry of the row and the group
// keeps the first of least squared distance by xor shuffles. The pick is the
// serial walk's, since the first least in table order does not depend on the
// order in which the entries are visited.
#pragma once

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

// IEEE-rounded operations: nvcc would contract a * b + c into an fma, which
// the plain version's separate tensor operations do not.
template <typename T> struct Op;
template <> struct Op<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float floor(float a) { return floorf(a); }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Op<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double floor(double a) { return ::floor(a); }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

template <typename T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  using O = Op<T>;
  return O::add(O::add(O::mul(a[0], b[0]), O::mul(a[1], b[1])), O::mul(a[2], b[2]));
}

// torch.clamp_min(d, 1e-30): NaN stays NaN
template <typename T>
__device__ __forceinline__ T floor30(T d) {
  return d < T(1e-30) ? T(1e-30) : d;
}

// n / max(|n|, 1e-30), the norm summed in component order
template <typename T>
__device__ __forceinline__ void unit3(T n[3]) {
  using O = Op<T>;
  const T den = floor30(O::sqrt(dot3(n, n)));
#pragma unroll
  for (int r = 0; r < 3; ++r) n[r] = O::div(n[r], den);
}

template <typename T>
__device__ __forceinline__ T clip01(T v) {
  return minp(maxp(v, T(0)), T(1));
}

constexpr double kBig = 1e30;  // a no-hit lane's distance, T(kBig) in the dtype
// Obstacle kinds beside gs.cu's Floor (0) and Sphere (1).
enum MeshKind { MESH_SDF = 2, MESH_EXACT = 3 };
// A mesh obstacle's description as the wrappers pass it: kMeshInts ints
// (kind, dims x3, near_lanes, kf, table16, n_tris, fallback_lanes, n_nodes)
// and kMeshPtrs pointers (origin, h, vals4, minv, tri_abc, nrm, face_table,
// face_count, tet_count), with capture_cells a double.
constexpr int kMeshInts = 10;
constexpr int kMeshPtrs = 9;

template <typename T>
struct Mesh {
  int kind, dims[3], near_lanes, kf, table16, n_tris, fallback_lanes, n_nodes;
  double capture_cells;
  const T* origin;                // [3]
  const T* h;                     // [1]
  const T* vals4;                 // SDF [G, 4]
  const double* minv;             // SDF [G]
  const T* tri_abc;               // exact [F, 3, 3]
  const T* nrm;                   // exact [F, 7, 3]
  const void* face_table;         // exact [C, kf] int16 (table16) or int32
  const int* face_count;          // exact [C]
  const signed char* tet_count;   // exact [C] 0/1
};

template <typename T>
Mesh<T> mesh_from(const int* ints, const uint64_t* ptrs, double capture_cells) {
  Mesh<T> m;
  m.kind = ints[0];
  for (int r = 0; r < 3; ++r) m.dims[r] = ints[1 + r];
  m.near_lanes = ints[4];
  m.kf = ints[5];
  m.table16 = ints[6];
  m.n_tris = ints[7];
  m.fallback_lanes = ints[8];
  m.n_nodes = ints[9];
  m.capture_cells = capture_cells;
  m.origin = reinterpret_cast<const T*>(ptrs[0]);
  m.h = reinterpret_cast<const T*>(ptrs[1]);
  m.vals4 = reinterpret_cast<const T*>(ptrs[2]);
  m.minv = reinterpret_cast<const double*>(ptrs[3]);
  m.tri_abc = reinterpret_cast<const T*>(ptrs[4]);
  m.nrm = reinterpret_cast<const T*>(ptrs[5]);
  m.face_table = reinterpret_cast<const void*>(ptrs[6]);
  m.face_count = reinterpret_cast<const int*>(ptrs[7]);
  m.tet_count = reinterpret_cast<const signed char*>(ptrs[8]);
  return m;
}

// The exclusive prefix count of flag over the block's THREADS threads in
// thread order, and (total) the block's count; every thread calls it. sm
// holds THREADS / 32 ints.
template <int THREADS>
__device__ __forceinline__ int block_rank(bool flag, int* sm, int& total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  const int before = __popc(m & ((1u << lane) - 1u));
  if (lane == 0) sm[w] = __popc(m);
  __syncthreads();
  if (w == 0) {
    int v = lane < kWarps ? sm[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane < kWarps) sm[lane] = v;  // inclusive, by warp
  }
  __syncthreads();
  const int out = (w == 0 ? 0 : sm[w - 1]) + before;
  total = sm[kWarps - 1];
  __syncthreads();  // sm free again
  return out;
}

// --- SDF -----------------------------------------------------------------------

// The base node of p's cell and its in-cell fractions f.
template <typename T>
__device__ __forceinline__ int sdf_cell(const Mesh<T>& o, const T p[3], T f[3]) {
  using O = Op<T>;
  const T h = o.h[0];
  int i[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T top = O::sub(T(o.dims[r]), T(1.000001));
    const T u = minp(maxp(O::div(O::sub(p[r], o.origin[r]), h), T(0)), top);
    const T fl = O::floor(u);
    i[r] = fl == fl ? static_cast<int>(fl) : 0;  // a NaN lane: cell 0, NaN fractions
    f[r] = O::sub(u, T(i[r]));
  }
  return (i[0] * o.dims[1] + i[1]) * o.dims[2] + i[2];
}

// Whether a lane of cell base may be in contact: the cube's least corner < 0.
template <typename T>
__device__ __forceinline__ bool sdf_near(const Mesh<T>& o, int base) {
  return o.minv[base] < 0.0;
}

// The blended distance of cell base at fractions f, and the unit normal n.
template <typename T>
__device__ __forceinline__ T sdf_blend(const Mesh<T>& o, int base, const T f[3], T n[3]) {
  using O = Op<T>;
  const T wx[2] = {O::sub(T(1), f[0]), f[0]};
  const T wy[2] = {O::sub(T(1), f[1]), f[1]};
  const T wz[2] = {O::sub(T(1), f[2]), f[2]};
  T acc[4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int di = c >> 2, dj = (c >> 1) & 1, dk = c & 1;
    const T w = O::mul(O::mul(wx[di], wy[dj]), wz[dk]);
    int row = base + (di * o.dims[1] + dj) * o.dims[2] + dk;
    row = row < o.n_nodes - 1 ? row : o.n_nodes - 1;
    const T* v = o.vals4 + static_cast<int64_t>(row) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const T t = O::mul(w, v[q]);
      acc[q] = c == 0 ? t : O::add(acc[q], t);
    }
  }
  n[0] = acc[1];
  n[1] = acc[2];
  n[2] = acc[3];
  unit3(n);
  return acc[0];
}

// --- exact ---------------------------------------------------------------------

// p's cell, clipped into the grid, and whether p lies in the grid.
template <typename T>
__device__ __forceinline__ int exact_cell(const Mesh<T>& o, const T p[3], bool& in_grid) {
  using O = Op<T>;
  const T h = o.h[0];
  int c[3];
  in_grid = true;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T fl = O::floor(O::div(O::sub(p[r], o.origin[r]), h));
    in_grid = in_grid && fl >= T(0) && fl < T(o.dims[r]);
    c[r] = fl >= T(0) ? (fl < T(o.dims[r] - 1) ? static_cast<int>(fl) : o.dims[r] - 1) : 0;
  }
  return (c[0] * o.dims[1] + c[1]) * o.dims[2] + c[2];
}

template <typename T>
__device__ __forceinline__ bool exact_near_tet(const Mesh<T>& o, int cid) {
  return __ldg(o.tet_count + cid) > 0;
}

template <typename T>
__device__ __forceinline__ int table_at(const Mesh<T>& o, int64_t i) {
  return o.table16 ? static_cast<int>(__ldg(static_cast<const short*>(o.face_table) + i))
                   : __ldg(static_cast<const int*>(o.face_table) + i);
}

// The 9 corner values of triangle fid (a, b, c), through the read-only path.
// (Staging the soup in shared memory was measured in turns in J and in H and
// did not win: PERF.md.)
template <typename T>
__device__ __forceinline__ void corners(const Mesh<T>& o, int fid, T abc[9]) {
  const int64_t at = static_cast<int64_t>(fid) * 9;
#pragma unroll
  for (int r = 0; r < 9; ++r) abc[r] = __ldg(o.tri_abc + at + r);
}

// Ericson's closest point on triangle abc (9 values: a, b, c): cl and its
// barycentric v, w (passive.py _pt_tri_closest).
template <typename T>
__device__ __forceinline__ void pt_tri_closest(const T p[3], const T* abc, T cl[3], T& v, T& w) {
  using O = Op<T>;
  const T tiny = T(1e-30);
  T a[3], ab[3], ac[3], ap[3], bp[3], cp[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a[r] = abc[r];
    ab[r] = O::sub(abc[3 + r], a[r]);
    ac[r] = O::sub(abc[6 + r], a[r]);
    ap[r] = O::sub(p[r], a[r]);
    bp[r] = O::sub(p[r], abc[3 + r]);
    cp[r] = O::sub(p[r], abc[6 + r]);
  }
  const T d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  const T d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  const T d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const T va = O::sub(O::mul(d3, d6), O::mul(d5, d4));
  const T vb = O::sub(O::mul(d5, d2), O::mul(d1, d6));
  const T vc = O::sub(O::mul(d1, d4), O::mul(d3, d2));
  const T denom = maxp(O::add(O::add(va, vb), vc), tiny);
  v = clip01(O::div(vb, denom));
  w = clip01(O::div(vc, denom));
  if (d1 <= T(0) && d2 <= T(0)) {
    v = T(0);
    w = T(0);
  }
  if (d3 >= T(0) && d4 <= d3) {
    v = T(1);
    w = T(0);
  }
  if (d6 >= T(0) && d5 <= d6) {
    v = T(0);
    w = T(1);
  }
  if (vc <= T(0) && d1 >= T(0) && d3 <= T(0)) {
    v = clip01(O::div(d1, maxp(O::sub(d1, d3), tiny)));
    w = T(0);
  }
  if (vb <= T(0) && d2 >= T(0) && d6 <= T(0)) {
    v = T(0);
    w = clip01(O::div(d2, maxp(O::sub(d2, d6), tiny)));
  }
  const T d43 = O::sub(d4, d3), d56 = O::sub(d5, d6);
  if (va <= T(0) && d43 >= T(0) && d56 >= T(0)) {
    const T e = clip01(O::div(d43, maxp(O::add(d43, d56), tiny)));
    v = O::sub(T(1), e);
    w = e;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) cl[r] = O::add(O::add(a[r], O::mul(v, ab[r])), O::mul(w, ac[r]));
}

// |p - closest|^2 on triangle fid.
template <typename T>
__device__ __forceinline__ T tri_d2(const Mesh<T>& o, const T p[3], int fid) {
  using O = Op<T>;
  T abc[9], cl[3], v, w;
  corners(o, fid, abc);
  pt_tri_closest(p, abc, cl, v, w);
  const T d[3] = {O::sub(p[0], cl[0]), O::sub(p[1], cl[1]), O::sub(p[2], cl[2])};
  return dot3(d, d);
}

// The closest point on triangle fid, again, and the unit pseudonormal of its
// region: 0 face, 1-3 vertex a/b/c, 4-6 edge ab/bc/ca, in the override order.
template <typename T>
__device__ __forceinline__ void feature(const Mesh<T>& o, const T p[3], int fid, T cl[3], T n[3]) {
  using O = Op<T>;
  T abc[9], v, w;
  corners(o, fid, abc);
  pt_tri_closest(p, abc, cl, v, w);
  const T eps = T(1e-5), one_m = O::sub(T(1), eps);
  const T u = O::sub(O::sub(T(1), v), w);
  int idx = 0;
  if (u <= eps) idx = 5;
  if (v <= eps) idx = 6;
  if (w <= eps) idx = 4;
  if (w >= one_m) idx = 3;
  if (v >= one_m) idx = 2;
  if (v <= eps && w <= eps) idx = 1;
  const T* r = o.nrm + (static_cast<int64_t>(fid) * 7 + idx) * 3;
  n[0] = __ldg(r);
  n[1] = __ldg(r + 1);
  n[2] = __ldg(r + 2);
  unit3(n);
}

// The threads that walk one entry's candidates where a block of threads
// owns n entries: the largest power of two <= 32 with g n <= threads and no
// wider than a row of the table (kf), whose threads past its end would only
// add rounds to the reduction (ops/cuda_obstacle.py j_group).
__device__ __forceinline__ int group_size(int n, int threads, int kf) {
  int g = 32;
  while (g > 1 && (g * n > threads || g > kf)) g >>= 1;
  return g;
}

// The candidates of cell cid (none where !valid) by a group of g threads (g a
// power of two, at most 32, aligned in its warp; group_size chooses it; every
// thread of the group
// calls this with the same p, cid and valid): thread t of the group walks
// entries t, t + g, ... of the cell's row, the group's loads of the table
// consecutive, and keeps the first least (d2, k) of its own entries under a
// strict d2 < best from kBig; the group then keeps the least d2, the lower k
// on a tie. That is the serial walk's pick, the first of least squared
// distance in table order; a NaN d2 is never picked, and with no entry below
// kBig (an empty row, every d2 NaN or >= 1e30) the pick is entry 0, as the
// plain version's argmin over an all-masked row. -> dist, the pick's closest
// point cl and normal n, any_face (a candidate was there), the same bits in
// every thread of the group.
template <typename T>
__device__ __forceinline__ void candidates(const Mesh<T>& o, const T p[3], int cid, bool valid,
                                           int g, T& dist, T cl[3], T n[3], bool& any_face) {
  using O = Op<T>;
  const int lane = threadIdx.x & 31;
  const unsigned group = g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane & ~(g - 1));
  const int cnt = valid ? __ldg(o.face_count + cid) : 0;
  const int64_t row = static_cast<int64_t>(cid) * o.kf;
  T best = T(kBig);
  int j = INT_MAX;  // none of this thread's entries below kBig
  for (int k = lane & (g - 1); k < cnt; k += g) {
    const T d2 = tri_d2(o, p, table_at(o, row + k));
    if (d2 < best) {
      best = d2;
      j = k;
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) {
    const T b2 = __shfl_xor_sync(group, best, off);
    const int j2 = __shfl_xor_sync(group, j, off);
    if (b2 < best || (b2 == best && j2 < j)) {
      best = b2;
      j = j2;
    }
  }
  if (j == INT_MAX) j = 0;  // best is kBig
  dist = O::sqrt(maxp(best, T(0)));
  any_face = cnt > 0;
  feature(o, p, table_at(o, row + j), cl, n);
}

// The deep fallback of one lane by a whole warp: the first of least squared
// distance over every triangle of the soup (each thread takes every 32nd in
// order, then the warp keeps the least, the lower index on a tie) -> dist,
// cl, n, the same in every thread of the warp.
template <typename T>
__device__ __forceinline__ void brute_force_warp(const Mesh<T>& o, const T p[3], T& dist, T cl[3],
                                                 T n[3]) {
  using O = Op<T>;
  const int lane = threadIdx.x & 31;
  T best = T(0);
  int j = INT_MAX;
  for (int t = lane; t < o.n_tris; t += 32) {
    const T d2 = tri_d2(o, p, t);
    if (j == INT_MAX || d2 < best) {
      best = d2;
      j = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T b2 = __shfl_xor_sync(0xffffffffu, best, off);
    const int j2 = __shfl_xor_sync(0xffffffffu, j, off);
    if (j2 != INT_MAX && (j == INT_MAX || b2 < best || (b2 == best && j2 < j))) {
      best = b2;
      j = j2;
    }
  }
  dist = O::sqrt(maxp(best, T(0)));
  feature(o, p, j, cl, n);
}

// The signed distance of an evaluated lane after the fallback: no face ->
// 1e30; inside where (p - cl) . n < 0 in a tet-occupied cell.
template <typename T>
__device__ __forceinline__ T exact_signed(const T p[3], T dist, const T cl[3], const T n[3],
                                          bool any_face, bool near_tet) {
  using O = Op<T>;
  const T d[3] = {O::sub(p[0], cl[0]), O::sub(p[1], cl[1]), O::sub(p[2], cl[2])};
  const bool inside = dot3(d, n) < T(0) && any_face && near_tet;
  return any_face ? (inside ? -dist : dist) : T(kBig);
}

}  // namespace
