// Kernel K: the self-collision detection of one collider, merged into the
// solver's dynamic rows; and kernel L's standalone launch (dyn_rows.cuh).
//
// K has no Pallas original. It replaces the jnp detect_dynamic of
// admm_elastic_tpu/collision/dynamic.py (:196-316) for one collider, and the
// merge across colliders of admm_elastic_tpu/solver.py _detect (:112-130).
// The plain version is admm_elastic_tpu_torch/collision/dynamic.py
// (detect_dynamic, then merge); chip_smoke.py holds K to it bit for bit, in
// float32 and float64. Every operation is an IEEE-rounded intrinsic in the
// plain version's order (no contraction into an fma), every dot product and
// norm summed in component order, every clamp NaN-propagating (maxp / minp),
// every constant T(...).
//
// Four launches on the stream, one call:
// 1. frames, a thread a tet: the edge matrix e (columns x1 - x0, x2 - x0,
//    x3 - x0), det3 (r0 . (r1 x r2)), the guard |det| > 1e-30, inv3 of e (the
//    identity where the guard fails) by the adjugate, and x0;
// 2. point in tet, a thread a query vertex: its barycentrics b = einv (q -
//    x0) by rows, b0 = 1 - ((b1 + b2) + b3), in each tet in index order, the
//    first inside (all four >= 0) that does not hold the query vertex: the
//    lowest tet index, which the plain version takes by argmax; with
//    candidates (the hash-grid broad phase above BROADPHASE_MIN_TETS, built by
//    the wrapper with torch.argsort(stable=True) and torch.searchsorted as the
//    JAX package builds it outside any kernel), the lowest inside among the
//    query's candidates;
// 3. rank, one block: the hits numbered in query order by a block-wide prefix
//    count (block_rank, as kernel J ranks its lanes), the first HIT_CAP listed,
//    hit_overflow where there are more (the solver's overflow flag);
// 4. nearest face, a warp a listed hit: the hit point in the rest pose
//    (((b0 r0 + b1 r1) + b2 r2) + b3 r3), then Ericson's closest point on each
//    rest surface triangle, lane l walking faces l, l + 32, ...; the distance
//    sqrt of the component sum; a face that holds the query vertex at the
//    dtype's max; the first of least distance by `<` within a lane, then
//    across the warp by (distance, face index), which is the serial walk's
//    pick. The face (global ids), its barycentrics and its rest normal go to
//    the rows where the vertex has no row yet (the first collider's hit per
//    vertex), and the row is set.
// Its bound is operations: the pair tests (H x T dense, H x the candidates
// broad) and the face walk (hits x F). This first form spends one thread per
// query vertex on the pair tests, a few hundred threads at the paths' shapes,
// and is latency-bound: a later PR can spread a query over a warp.
//
// L (dyn_rows.cuh): out = base + each vertex's face-corner terms, C^T y or
// diag(C^T C), one thread a vertex walking its table entries in order.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "dyn_rows.cuh"
#include "obstacle_body.cuh"

namespace {

constexpr int kFrame = 13;  // a tet's frame: einv (9, row-major), x0 (3), the guard (1)
constexpr int kRankThreads = 1024;
constexpr int kQueryThreads = 128;
constexpr int kFaceWarps = 4;  // warps a block in the face walk

template <typename T>
struct KArgs {
  const T* x;              // [N, 3]
  const int* tets;         // [T, 4] global
  const T* rest;           // [V, 3] local rest positions
  const int* faces;        // [F, 3] local
  const int64_t* surf;     // [H] the query vertices
  const int* cand;         // [H, C] candidate tets (T: none), or null (every tet)
  T* frames;               // scratch [T, kFrame]
  int* qtet;               // scratch [H]: the hit tet, -1 for none
  T* qbary;                // scratch [H, 4]
  int* list;               // scratch [hit_cap]: the listed hits' queries
  int* count;              // scratch [1]: the listed hits
  unsigned char* d_mask;   // [H] in/out: the rows
  int64_t* d_face;         // [H, 3]
  T* d_barys;              // [H, 3]
  T* d_normal;             // [H, 3]
  int* overflow;           // [1] |= 1 where HIT_CAP dropped a hit
  int n_tets, n_faces, h, c, hit_cap, offset;
};

template <typename T>
__device__ __forceinline__ void cross3(const T a[3], const T b[3], T o[3]) {
  using O = Op<T>;
  o[0] = O::sub(O::mul(a[1], b[2]), O::mul(a[2], b[1]));
  o[1] = O::sub(O::mul(a[2], b[0]), O::mul(a[0], b[2]));
  o[2] = O::sub(O::mul(a[0], b[1]), O::mul(a[1], b[0]));
}

// rows r0, r1, r2: r0 . (r1 x r2)
template <typename T>
__device__ __forceinline__ T det_rows(const T m[3][3]) {
  T c[3];
  cross3(m[1], m[2], c);
  return dot3(m[0], c);
}

template <typename T>
__global__ void dyn_frames_kernel(const __grid_constant__ KArgs<T> a) {
  using O = Op<T>;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.n_tets) return;
  T x4[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t v = a.tets[t * 4 + k];
#pragma unroll
    for (int r = 0; r < 3; ++r) x4[k][r] = a.x[v * 3 + r];
  }
  T e[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) e[i][j] = O::sub(x4[j + 1][i], x4[0][i]);
  const bool safe = fabs(det_rows(e)) > T(1e-30);
  if (!safe)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) e[i][j] = i == j ? T(1) : T(0);
  const T d = det_rows(e);
  const T sd = fabs(d) < T(1e-300) ? T(1) : d;
  T c[3][3];  // c[j]: the cross product of the rows other than j
  cross3(e[1], e[2], c[0]);
  cross3(e[2], e[0], c[1]);
  cross3(e[0], e[1], c[2]);
  T* f = a.frames + (int64_t)t * kFrame;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) f[i * 3 + j] = O::div(c[j][i], sd);
#pragma unroll
  for (int r = 0; r < 3; ++r) f[9 + r] = x4[0][r];
  f[12] = safe ? T(1) : T(0);
}

// Whether q lies in tet t (not holding vertex v): its barycentrics in b4.
template <typename T>
__device__ __forceinline__ bool inside_tet(const KArgs<T>& a, int t, const T q[3], int64_t v,
                                           T b4[4]) {
  using O = Op<T>;
  const T* f = a.frames + (int64_t)t * kFrame;
  if (f[12] == T(0)) return false;
  T dq[3], b[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) dq[r] = O::sub(q[r], f[9 + r]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    b[i] = O::add(O::add(O::mul(f[i * 3], dq[0]), O::mul(f[i * 3 + 1], dq[1])),
                  O::mul(f[i * 3 + 2], dq[2]));
  const T b0 = O::sub(T(1), O::add(O::add(b[0], b[1]), b[2]));
  if (!(b0 >= T(0) && b[0] >= T(0) && b[1] >= T(0) && b[2] >= T(0))) return false;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (a.tets[t * 4 + k] == v) return false;
  b4[0] = b0;
  b4[1] = b[0];
  b4[2] = b[1];
  b4[3] = b[2];
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kQueryThreads) dyn_query_kernel(const __grid_constant__ KArgs<T> a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.h) return;
  const int64_t v = a.surf[h];
  T q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) q[r] = a.x[v * 3 + r];
  int best = INT_MAX;
  T bb[4] = {T(0), T(0), T(0), T(0)};
  if (a.cand == nullptr) {
    for (int t = 0; t < a.n_tets; ++t) {
      T b4[4];
      if (inside_tet(a, t, q, v, b4)) {
        best = t;
#pragma unroll
        for (int k = 0; k < 4; ++k) bb[k] = b4[k];
        break;
      }
    }
  } else {
    const int* row = a.cand + (int64_t)h * a.c;
    for (int s = 0; s < a.c; ++s) {
      const int t = row[s];
      T b4[4];
      if (t < a.n_tets && t < best && inside_tet(a, t, q, v, b4)) {
        best = t;
#pragma unroll
        for (int k = 0; k < 4; ++k) bb[k] = b4[k];
      }
    }
  }
  a.qtet[h] = best == INT_MAX ? -1 : best;
#pragma unroll
  for (int k = 0; k < 4; ++k) a.qbary[h * 4 + k] = bb[k];
}

template <typename T>
__global__ void __launch_bounds__(kRankThreads) dyn_rank_kernel(const __grid_constant__ KArgs<T> a) {
  __shared__ int smi[kRankThreads / 32];
  const int cap = a.h < a.hit_cap ? a.h : a.hit_cap;
  int total = 0;
  for (int b0 = 0; b0 < a.h; b0 += kRankThreads) {
    const int h = b0 + threadIdx.x;
    const bool hit = h < a.h && a.qtet[h] >= 0;
    int chunk;
    const int r = total + block_rank<kRankThreads>(hit, smi, chunk);
    if (hit && r < cap) a.list[r] = h;
    total += chunk;
  }
  if (threadIdx.x == 0) {
    *a.count = total < cap ? total : cap;
    if (total > cap) *a.overflow |= 1;
  }
}

template <typename T>
__device__ __forceinline__ T nonzero30(T d) {
  return fabs(d) < T(1e-30) ? T(1) : d;
}

// Ericson's closest point on triangle abc to p: closest and barycentrics, in
// the plain _closest_point_triangle's order.
template <typename T>
__device__ __forceinline__ void closest_tri(const T p[3], const T A[3], const T B[3], const T C[3],
                                            T cl[3], T bary[3]) {
  using O = Op<T>;
  T ab[3], ac[3], ap[3], bp[3], cp[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    ab[r] = O::sub(B[r], A[r]);
    ac[r] = O::sub(C[r], A[r]);
    ap[r] = O::sub(p[r], A[r]);
    bp[r] = O::sub(p[r], B[r]);
    cp[r] = O::sub(p[r], C[r]);
  }
  const T d1 = dot3(ab, ap), d2 = dot3(ac, ap), d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  const T d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  const T va = O::sub(O::mul(d3, d6), O::mul(d5, d4));
  const T vb = O::sub(O::mul(d5, d2), O::mul(d1, d6));
  const T vc = O::sub(O::mul(d1, d4), O::mul(d3, d2));
  const T den = nonzero30(O::add(O::add(va, vb), vc));
  T v = O::div(vb, den), w = O::div(vc, den);
  const bool in_a = d1 <= T(0) && d2 <= T(0);
  const bool in_b = d3 >= T(0) && d4 <= d3;
  const bool in_c = d6 >= T(0) && d5 <= d6;
  const bool on_ab = vc <= T(0) && d1 >= T(0) && d3 <= T(0);
  const T t_ab = O::div(d1, nonzero30(O::sub(d1, d3)));
  const bool on_ac = vb <= T(0) && d2 >= T(0) && d6 <= T(0);
  const T t_ac = O::div(d2, nonzero30(O::sub(d2, d6)));
  const T d43 = O::sub(d4, d3), d56 = O::sub(d5, d6);
  const bool on_bc = va <= T(0) && d43 >= T(0) && d56 >= T(0);
  const T t_bc = O::div(d43, nonzero30(O::add(d43, d56)));
  if (on_bc) {
    v = O::sub(T(1), t_bc);
    w = t_bc;
  }
  if (on_ac) {
    v = T(0);
    w = minp(maxp(t_ac, T(0)), T(1));
  }
  if (on_ab) {
    v = minp(maxp(t_ab, T(0)), T(1));
    w = T(0);
  }
  if (in_c) {
    v = T(0);
    w = T(1);
  }
  if (in_b) {
    v = T(1);
    w = T(0);
  }
  if (in_a) {
    v = T(0);
    w = T(0);
  }
  v = minp(maxp(v, T(0)), T(1));
  w = minp(maxp(w, T(0)), maxp(O::sub(T(1), v), T(0)));
#pragma unroll
  for (int r = 0; r < 3; ++r) cl[r] = O::add(O::add(A[r], O::mul(v, ab[r])), O::mul(w, ac[r]));
  bary[0] = O::sub(O::sub(T(1), v), w);
  bary[1] = v;
  bary[2] = w;
}

template <typename T>
__device__ __forceinline__ void rest_of(const KArgs<T>& a, int local, T p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = a.rest[(int64_t)local * 3 + r];
}

template <typename T>
__global__ void __launch_bounds__(kFaceWarps * 32) dyn_face_kernel(const __grid_constant__ KArgs<T> a) {
  using O = Op<T>;
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kFaceWarps + (threadIdx.x >> 5);
  if (slot >= *a.count) return;  // the whole warp
  const int h = a.list[slot];
  const int64_t v = a.surf[h];
  const int t = a.qtet[h];
  T p[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T rk[3];
    rest_of(a, a.tets[t * 4 + k] - a.offset, rk);
    const T bk = a.qbary[h * 4 + k];
#pragma unroll
    for (int r = 0; r < 3; ++r) p[r] = k == 0 ? O::mul(bk, rk[r]) : O::add(p[r], O::mul(bk, rk[r]));
  }
  const int local_q = static_cast<int>(v - a.offset);
  const T big = Lim<T>::max();
  T best = big, bbar[3] = {T(0), T(0), T(0)};
  int bf = INT_MAX;  // none yet: the first face is taken whatever its distance
  for (int f = lane; f < a.n_faces; f += 32) {
    const int i0 = a.faces[f * 3], i1 = a.faces[f * 3 + 1], i2 = a.faces[f * 3 + 2];
    T d, bar[3];
    if (i0 == local_q || i1 == local_q || i2 == local_q) {
      d = big;
      bar[0] = bar[1] = bar[2] = T(0);
    } else {
      T A[3], B[3], C[3], cl[3], diff[3];
      rest_of(a, i0, A);
      rest_of(a, i1, B);
      rest_of(a, i2, C);
      closest_tri(p, A, B, C, cl, bar);
#pragma unroll
      for (int r = 0; r < 3; ++r) diff[r] = O::sub(cl[r], p[r]);
      d = O::sqrt(dot3(diff, diff));
    }
    if (bf == INT_MAX || d < best) {
      best = d;
      bf = f;
#pragma unroll
      for (int r = 0; r < 3; ++r) bbar[r] = bar[r];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T od = __shfl_xor_sync(0xffffffffu, best, off);
    const int of = __shfl_xor_sync(0xffffffffu, bf, off);
    T ob[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) ob[r] = __shfl_xor_sync(0xffffffffu, bbar[r], off);
    if (of != INT_MAX && (bf == INT_MAX || od < best || (od == best && of < bf))) {
      best = od;
      bf = of;
#pragma unroll
      for (int r = 0; r < 3; ++r) bbar[r] = ob[r];
    }
  }
  if (lane != 0 || a.d_mask[h] || bf == INT_MAX) return;
  const int i0 = a.faces[bf * 3], i1 = a.faces[bf * 3 + 1], i2 = a.faces[bf * 3 + 2];
  T A[3], B[3], C[3], e1[3], e2[3], n[3];
  rest_of(a, i0, A);
  rest_of(a, i1, B);
  rest_of(a, i2, C);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    e1[r] = O::sub(B[r], A[r]);
    e2[r] = O::sub(C[r], A[r]);
  }
  cross3(e1, e2, n);
  const T nn = floor30(O::sqrt(dot3(n, n)));
  a.d_face[h * 3] = (int64_t)i0 + a.offset;
  a.d_face[h * 3 + 1] = (int64_t)i1 + a.offset;
  a.d_face[h * 3 + 2] = (int64_t)i2 + a.offset;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a.d_barys[h * 3 + r] = bbar[r];
    a.d_normal[h * 3 + r] = O::div(n[r], nn);
  }
  a.d_mask[h] = 1;
}

// ptrs: x, tets, rest, faces, surf, cand (null: every tet), frames, qtet,
// qbary, list, count, d_mask, d_face, d_barys, d_normal, overflow;
// ints: n_tets, n_faces, h, c, hit_cap, offset.
template <typename T>
int detect(const uint64_t* p, const int* ints, void* stream) {
  KArgs<T> a;
  a.x = reinterpret_cast<const T*>(p[0]);
  a.tets = reinterpret_cast<const int*>(p[1]);
  a.rest = reinterpret_cast<const T*>(p[2]);
  a.faces = reinterpret_cast<const int*>(p[3]);
  a.surf = reinterpret_cast<const int64_t*>(p[4]);
  a.cand = reinterpret_cast<const int*>(p[5]);
  a.frames = reinterpret_cast<T*>(p[6]);
  a.qtet = reinterpret_cast<int*>(p[7]);
  a.qbary = reinterpret_cast<T*>(p[8]);
  a.list = reinterpret_cast<int*>(p[9]);
  a.count = reinterpret_cast<int*>(p[10]);
  a.d_mask = reinterpret_cast<unsigned char*>(p[11]);
  a.d_face = reinterpret_cast<int64_t*>(p[12]);
  a.d_barys = reinterpret_cast<T*>(p[13]);
  a.d_normal = reinterpret_cast<T*>(p[14]);
  a.overflow = reinterpret_cast<int*>(p[15]);
  a.n_tets = ints[0];
  a.n_faces = ints[1];
  a.h = ints[2];
  a.c = ints[3];
  a.hit_cap = ints[4];
  a.offset = ints[5];
  if (a.h <= 0 || a.n_tets <= 0) return 0;
  if (a.hit_cap < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dyn_frames_kernel<T><<<(a.n_tets + 255) / 256, 256, 0, s>>>(a);
  dyn_query_kernel<T><<<(a.h + kQueryThreads - 1) / kQueryThreads, kQueryThreads, 0, s>>>(a);
  dyn_rank_kernel<T><<<1, kRankThreads, 0, s>>>(a);
  const int cap = a.h < a.hit_cap ? a.h : a.hit_cap;
  dyn_face_kernel<T><<<(cap + kFaceWarps - 1) / kFaceWarps, kFaceWarps * 32, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- kernel L's standalone launch ----------------------------------------------

template <typename T>
struct LArgs {
  DynRows<T> rows;
  const T* base;  // [N, 3]
  const T* y;     // [H] the rows' values (DYN_CT)
  T* out;         // [N, 3]
  int n, mode;
};

template <typename T>
__global__ void dyn_gather_kernel(const __grid_constant__ LArgs<T> a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.n) return;
  const T ck = *a.rows.ck;
  T acc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k] = a.base[(int64_t)v * 3 + k];
  if (a.mode == DYN_CT) {
    const T* y = a.y;
    dyn_corners_ct(a.rows, v, ck, [y](int64_t r) { return y[r]; }, acc);
  } else {
    dyn_corners_diag(a.rows, v, ck, acc);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) a.out[(int64_t)v * 3 + k] = acc[k];
}

// ptrs: mask, vidx, face, barys, normal, ck, order, start, base, y (DYN_CT;
// else null), out; ints: n, h, mode.
template <typename T>
int gather(const uint64_t* p, const int* ints, void* stream) {
  LArgs<T> a;
  a.rows.mask = reinterpret_cast<const unsigned char*>(p[0]);
  a.rows.vidx = reinterpret_cast<const int64_t*>(p[1]);
  a.rows.face = reinterpret_cast<const int64_t*>(p[2]);
  a.rows.barys = reinterpret_cast<const T*>(p[3]);
  a.rows.normal = reinterpret_cast<const T*>(p[4]);
  a.rows.ck = reinterpret_cast<const T*>(p[5]);
  a.rows.order = reinterpret_cast<const int64_t*>(p[6]);
  a.rows.start = reinterpret_cast<const int64_t*>(p[7]);
  a.rows.slot = nullptr;
  a.base = reinterpret_cast<const T*>(p[8]);
  a.y = reinterpret_cast<const T*>(p[9]);
  a.out = reinterpret_cast<T*>(p[10]);
  a.n = ints[0];
  a.rows.h = ints[1];
  a.mode = ints[2];
  if (a.n <= 0) return 0;
  if (a.mode == DYN_CT && a.y == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dyn_gather_kernel<T><<<(a.n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admm_dyn_detect_f32(const uint64_t* p, const int* ints, void* stream) {
  return detect<float>(p, ints, stream);
}
extern "C" int admm_dyn_detect_f64(const uint64_t* p, const int* ints, void* stream) {
  return detect<double>(p, ints, stream);
}
extern "C" int admm_dyn_gather_f32(const uint64_t* p, const int* ints, void* stream) {
  return gather<float>(p, ints, stream);
}
extern "C" int admm_dyn_gather_f64(const uint64_t* p, const int* ints, void* stream) {
  return gather<double>(p, ints, stream);
}
