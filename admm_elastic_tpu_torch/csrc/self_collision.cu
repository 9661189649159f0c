// Kernel K: the self-collision detection of every collider in one call,
// merged into the solver's dynamic rows; and kernel L's standalone launch
// (dyn_rows.cuh).
//
// K has no Pallas original. It replaces the jnp detect_dynamic of
// admm_elastic_tpu/collision/dynamic.py (:196-316), once per collider, and
// the merge across colliders of admm_elastic_tpu/solver.py _detect
// (:112-130). The plain version is admm_elastic_tpu_torch/collision/
// dynamic.py (detect_dynamic, then merge, collider by collider);
// chip_smoke.py holds K to it bit for bit, in float32 and float64. Every
// operation is an IEEE-rounded intrinsic in the plain version's order (no
// contraction into an fma), every dot product and norm summed in component
// order, every clamp NaN-propagating (maxp / minp), every constant T(...).
//
// The colliders come as one table (collision/dynamic.ColliderTable, built
// once at initialize): their tets (global vertex ids), rest vertices and
// faces (local to their collider) concatenated, and a row of kInfo ints a
// collider (its first tet, tet count, first rest vertex, first face, face
// count, vertex offset, cell capacity). Four launches on the stream, one
// call, whatever the number of colliders:
// 1. frames, a thread a tet of the table: the edge matrix e (columns x1 - x0,
//    x2 - x0, x3 - x0), det3 (r0 . (r1 x r2)), the guard |det| > 1e-30,
//    inv3 of e (the identity where the guard fails) by the adjugate, and x0:
//    kFrame values a tet, a tet's values contiguous;
// 2. point in tet, a warp a (collider, query vertex), kQueryWarps warps a
//    block, a collider's blocks together. The barycentrics b = einv (q -
//    x0) by rows, b0 = 1 - ((b1 + b2) + b3); a hit is inside (all four >= 0)
//    and does not hold the query vertex; the pick is the lowest tet index,
//    which the plain version takes by argmax (dense) or amin (broad).
//    Dense (the collider's tets at most BROADPHASE_MIN_TETS): the block
//    stages a tile of the collider's frames (Tile<T>::kMax tets at most) in
//    shared memory, copied by consecutive threads from the contiguous
//    frames; each warp walks the tile 32 tets at a time in index order, lane
//    l taking tet base + l, and __ballot_sync of the hits: the first chunk
//    with one gives the lowest tet, base + __ffs - 1, whose lane writes it
//    and its barycentrics. The block stages the next tile only while one of
//    its warps has no hit (__syncthreads_or).
//    Broad (the hash-grid broad phase): the wrapper makes each tet's cell
//    key and each query's cell with the plain version's arithmetic and
//    sorts the keys (torch.sort, stable), as the JAX package sorts outside
//    any kernel; lanes 0-26 take the 27 cells around the query's, find the
//    cell's run in the sorted keys by a binary search (torch.searchsorted's
//    left side), walk at most cell_cap slots while the key matches and keep
//    the lowest inside tet. The warp's pick is their integer minimum
//    (__reduce_min_sync), which does not depend on the walk order: the
//    plain version's pick over _broad_phase_candidates' rows. A cell whose
//    slot past cell_cap still matches its key sets the overflow flag;
// 3. rank, a block a collider: its hits numbered in query order by a
//    block-wide prefix count (block_rank, as kernel J ranks its lanes), the
//    first HIT_CAP listed, hit_overflow where there are more, each (collider,
//    query) marked listed or not;
// 4. nearest face, a block a listed hit of any collider. The merge first: a
//    query takes the listed hit of the lowest-index collider that lists it,
//    where its row is not set yet (the sequential merge's first collider's
//    hit per vertex). Then the hit point in the rest pose (((b0 r0 + b1 r1) +
//    b2 r2) + b3 r3), Ericson's closest point on each rest surface triangle
//    of the collider, thread l walking faces l, l + kFaceThreads, ...; the
//    distance sqrt of the component sum; a face that holds the query vertex
//    at the dtype's max; the first of least distance by `<` within a thread,
//    then across the block by (distance, face index), which is the serial
//    walk's pick. The face (global ids), its barycentrics and its rest normal go to
//    the row, and the row is set.
// The overflow flag is ORed by integer atomics (order-free); no float
// atomic. Its bound is operations: the pair tests (H x T dense, H x the
// candidates broad) and the face walk (hits x F). ADMM_K_PHASES=n (a
// measurement's build, tools/k_anatomy.py) launches the first n phases only.
// Reading the dense tiles' frames from global memory (L1 / L2) in place of
// staging them was measured and dropped (PERF.md §6).
//
// L (dyn_rows.cuh): out = base + each vertex's face-corner terms, C^T y or
// diag(C^T C), one thread a vertex walking its table entries in order.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dyn_rows.cuh"
#include "obstacle_body.cuh"

#ifndef ADMM_K_PHASES
#define ADMM_K_PHASES 4
#endif


namespace {

constexpr int kFrame = 13;  // a tet's frame: einv (9, row-major), x0 (3), the guard (1)
constexpr int kInfo = 7;    // a collider's row of the table's info
enum { I_TET0, I_NTETS, I_REST0, I_FACE0, I_NFACES, I_VOFF, I_CELLCAP };
constexpr int kRankThreads = 1024;
constexpr int kQueryWarps = 8;  // warps a block in the point-in-tet phase
constexpr int kFaceThreads = 256;  // a block a listed hit in the face walk

// Tets a dense tile: 104 KB of frames, two blocks an SM.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int kMax = 2048; };
template <> struct Tile<double> { static constexpr int kMax = 1024; };

template <typename T>
struct KArgs {
  const T* x;              // [N, 3]
  const int* tets;         // [T, 4] global
  const T* rest;           // [V, 3] the colliders' rest positions
  const int* faces;        // [F, 3] local to their collider
  const int* info;         // [C, kInfo]
  const int64_t* surf;     // [H] the query vertices
  const int* keys;         // [T] broad colliders: their tets' cell keys sorted, at their
                           // first tet (null where no collider is broad)
  const int64_t* order;    // [T] the sort's permutation (tet ids local to the collider)
  const int* qcell;        // [C, H, 3] broad colliders: each query's cell
  T* frames;               // scratch [T, kFrame]
  int* qtet;               // scratch [C, H]: the hit tet (local), -1 for none
  T* qbary;                // scratch [C, H, 4]
  unsigned char* listed;   // scratch [C, H]: the hit is listed (under HIT_CAP)
  int* list;               // scratch [C, cap]: the listed hits' queries
  int* count;              // scratch [C]: the listed hits
  unsigned char* d_mask;   // [H] in/out: the rows
  int64_t* d_face;         // [H, 3]
  T* d_barys;              // [H, 3]
  T* d_normal;             // [H, 3]
  int* overflow;           // [1] |= 1 where a cell's capacity or HIT_CAP dropped a hit
  int n_colliders, n_tets, h, cap, broad_min, tile;
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
    const int64_t v = a.tets[(int64_t)t * 4 + k];
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

// Whether q lies in the tet of frame f and corners tet4 (and the tet does
// not hold vertex v): its barycentrics in b4.
template <typename T>
__device__ __forceinline__ bool inside_tet(const T* f, const int* tet4, const T q[3], int64_t v,
                                           T b4[4]) {
  using O = Op<T>;
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
    if (tet4[k] == v) return false;
  b4[0] = b0;
  b4[1] = b[0];
  b4[2] = b[1];
  b4[3] = b[2];
  return true;
}

// The int32 hash (dynamic._cell_keys: int32 sums and products wrapping,
// XORed) of neighbour k (0-26) of cell qc, the offsets in meshgrid order.
__device__ __forceinline__ int cell_key(const int* qc, int k) {
  const unsigned x = static_cast<unsigned>(qc[0]) + static_cast<unsigned>(k / 9 - 1);
  const unsigned y = static_cast<unsigned>(qc[1]) + static_cast<unsigned>(k / 3 % 3 - 1);
  const unsigned z = static_cast<unsigned>(qc[2]) + static_cast<unsigned>(k % 3 - 1);
  return static_cast<int>((x * 73856093u) ^ (y * 19349663u) ^ (z * 83492791u));
}

template <typename T>
__global__ void __launch_bounds__(kQueryWarps * 32)
    dyn_query_kernel(const __grid_constant__ KArgs<T> a) {
  extern __shared__ __align__(16) unsigned char k_smem[];
  const int lane = threadIdx.x & 31;
  const int per = (a.h + kQueryWarps - 1) / kQueryWarps;  // a collider's blocks
  const int c = blockIdx.x / per;
  const int h = (blockIdx.x - c * per) * kQueryWarps + (threadIdx.x >> 5);
  const int* inf = a.info + c * kInfo;
  const int tet0 = inf[I_TET0], nt = inf[I_NTETS];
  const bool query = h < a.h;  // the warp's
  int64_t v = 0;
  T q[3] = {T(0), T(0), T(0)};
  if (query) {
    v = a.surf[h];
#pragma unroll
    for (int r = 0; r < 3; ++r) q[r] = a.x[v * 3 + r];
  }
  const T* frames = a.frames + (int64_t)tet0 * kFrame;
  const int* tets = a.tets + (int64_t)tet0 * 4;
  int best = -1;  // the lane's pick
  T bb[4] = {T(0), T(0), T(0), T(0)};
  if (nt > a.broad_min) {  // the whole block: a collider's blocks
    if (query) {
      int mine = INT_MAX;
      T mb[4] = {T(0), T(0), T(0), T(0)};
      if (lane < 27) {
        const int key = cell_key(a.qcell + ((int64_t)c * a.h + h) * 3, lane);
        const int* ks = a.keys + tet0;
        const int64_t* order = a.order + tet0;
        int lo = 0, hi = nt;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ks[mid] < key)
            lo = mid + 1;
          else
            hi = mid;
        }
        const int cap = inf[I_CELLCAP];
        for (int s = lo; s < lo + cap && s < nt && ks[s] == key; ++s) {
          const int t = static_cast<int>(order[s]);
          T b4[4];
          if (t < mine &&
              inside_tet(frames + (int64_t)t * kFrame, tets + (int64_t)t * 4, q, v, b4)) {
            mine = t;
#pragma unroll
            for (int k = 0; k < 4; ++k) mb[k] = b4[k];
          }
        }
        if (lo + cap < nt && ks[lo + cap] == key) atomicOr(a.overflow, 1);
      }
      const int m = __reduce_min_sync(0xffffffffu, mine);
      const unsigned who = __ballot_sync(0xffffffffu, mine == m && m != INT_MAX);
      if (who && lane == __ffs(who) - 1) {
        best = m;
#pragma unroll
        for (int k = 0; k < 4; ++k) bb[k] = mb[k];
      }
    }
  } else {
    T* sf = reinterpret_cast<T*>(k_smem);  // [tile, kFrame]
    bool open = query;                       // the warp's: no hit yet
    for (int base = 0; base < nt; base += a.tile) {
      if (!__syncthreads_or(open)) break;  // also: every warp is done with the last tile
      const int n = min(a.tile, nt - base);
      const T* src = frames + (int64_t)base * kFrame;
      // every copy in flight at once (cp.async), not one load's latency each
      for (int i = threadIdx.x; i < n * kFrame; i += blockDim.x)
        __pipeline_memcpy_async(sf + i, src + i, sizeof(T));
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (open) {
        for (int j0 = 0; j0 < n; j0 += 32) {
          const int j = j0 + lane;
          T b4[4];
          const bool in = j < n && inside_tet(sf + j * kFrame, tets + (int64_t)(base + j) * 4,
                                              q, v, b4);
          const unsigned m = __ballot_sync(0xffffffffu, in);
          if (m) {
            if (lane == __ffs(m) - 1) {
              best = base + j;
#pragma unroll
              for (int k = 0; k < 4; ++k) bb[k] = b4[k];
            }
            open = false;
            break;
          }
        }
      }
    }
  }
  if (!query) return;
  // the lane holding the pick writes it; lane 0 a miss
  const unsigned w = __ballot_sync(0xffffffffu, best >= 0);
  if (lane != (w ? __ffs(w) - 1 : 0)) return;
  const int64_t row = (int64_t)c * a.h + h;
  a.qtet[row] = best;
#pragma unroll
  for (int k = 0; k < 4; ++k) a.qbary[row * 4 + k] = bb[k];
}

template <typename T>
__global__ void __launch_bounds__(kRankThreads) dyn_rank_kernel(const __grid_constant__ KArgs<T> a) {
  __shared__ int smi[kRankThreads / 32];
  const int c = blockIdx.x;
  const int64_t row = (int64_t)c * a.h;
  int total = 0;
  for (int b0 = 0; b0 < a.h; b0 += kRankThreads) {
    const int h = b0 + threadIdx.x;
    const bool hit = h < a.h && a.qtet[row + h] >= 0;
    int chunk;
    const int r = total + block_rank<kRankThreads>(hit, smi, chunk);
    const bool in = hit && r < a.cap;
    if (h < a.h) a.listed[row + h] = in;
    if (in) a.list[c * a.cap + r] = h;
    total += chunk;
  }
  if (threadIdx.x == 0) {
    a.count[c] = total < a.cap ? total : a.cap;
    if (total > a.cap) atomicOr(a.overflow, 1);
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
__device__ __forceinline__ void rest_of(const T* rest, int i, T p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = rest[(int64_t)i * 3 + r];
}

// The first least by (distance, face index) of two picks, a face index of
// INT_MAX for none: the serial walk's first of least distance, whatever the
// order in which the picks meet.
template <typename T>
__device__ __forceinline__ void take_least(T& best, int& bf, T bbar[3], T od, int of,
                                           const T ob[3]) {
  if (of != INT_MAX && (bf == INT_MAX || od < best || (od == best && of < bf))) {
    best = od;
    bf = of;
#pragma unroll
    for (int r = 0; r < 3; ++r) bbar[r] = ob[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kFaceThreads)
    dyn_face_kernel(const __grid_constant__ KArgs<T> a) {
  using O = Op<T>;
  constexpr int kWarps = kFaceThreads / 32;
  __shared__ T s_d[kWarps], s_b[kWarps][3];
  __shared__ int s_f[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x / a.cap, i = blockIdx.x - c * a.cap;
  if (i >= a.count[c]) return;  // the whole block
  const int h = a.list[c * a.cap + i];
  // the merge: the row is the lowest listing collider's, where it is not set
  // yet (only that collider's block writes it, below)
  if (a.d_mask[h]) return;
  for (int e = 0; e < c; ++e)
    if (a.listed[(int64_t)e * a.h + h]) return;
  const int* inf = a.info + c * kInfo;
  const T* rest = a.rest + (int64_t)inf[I_REST0] * 3;
  const int* faces = a.faces + (int64_t)inf[I_FACE0] * 3;
  const int* tet = a.tets + ((int64_t)inf[I_TET0] + a.qtet[(int64_t)c * a.h + h]) * 4;
  const int n_faces = inf[I_NFACES], offset = inf[I_VOFF];
  const T* bary = a.qbary + ((int64_t)c * a.h + h) * 4;
  const int64_t v = a.surf[h];
  T p[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T rk[3];
    rest_of(rest, tet[k] - offset, rk);
    const T bk = bary[k];
#pragma unroll
    for (int r = 0; r < 3; ++r) p[r] = k == 0 ? O::mul(bk, rk[r]) : O::add(p[r], O::mul(bk, rk[r]));
  }
  const int local_q = static_cast<int>(v - offset);
  const T big = Lim<T>::max();
  T best = big, bbar[3] = {T(0), T(0), T(0)};
  int bf = INT_MAX;  // none yet: the first face is taken whatever its distance
  for (int f = threadIdx.x; f < n_faces; f += kFaceThreads) {
    const int i0 = faces[f * 3], i1 = faces[f * 3 + 1], i2 = faces[f * 3 + 2];
    T d, bar[3];
    if (i0 == local_q || i1 == local_q || i2 == local_q) {
      d = big;
      bar[0] = bar[1] = bar[2] = T(0);
    } else {
      T A[3], B[3], C[3], cl[3], diff[3];
      rest_of(rest, i0, A);
      rest_of(rest, i1, B);
      rest_of(rest, i2, C);
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
    T ob[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) ob[r] = __shfl_xor_sync(0xffffffffu, bbar[r], off);
    take_least(best, bf, bbar, __shfl_xor_sync(0xffffffffu, best, off),
               __shfl_xor_sync(0xffffffffu, bf, off), ob);
  }
  if (lane == 0) {
    s_d[w] = best;
    s_f[w] = bf;
#pragma unroll
    for (int r = 0; r < 3; ++r) s_b[w][r] = bbar[r];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < kWarps; ++k) take_least(best, bf, bbar, s_d[k], s_f[k], s_b[k]);
  if (bf == INT_MAX) return;
  const int i0 = faces[bf * 3], i1 = faces[bf * 3 + 1], i2 = faces[bf * 3 + 2];
  T A[3], B[3], C[3], e1[3], e2[3], n[3];
  rest_of(rest, i0, A);
  rest_of(rest, i1, B);
  rest_of(rest, i2, C);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    e1[r] = O::sub(B[r], A[r]);
    e2[r] = O::sub(C[r], A[r]);
  }
  cross3(e1, e2, n);
  const T nn = floor30(O::sqrt(dot3(n, n)));
  a.d_face[h * 3] = (int64_t)i0 + offset;
  a.d_face[h * 3 + 1] = (int64_t)i1 + offset;
  a.d_face[h * 3 + 2] = (int64_t)i2 + offset;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    a.d_barys[h * 3 + r] = bbar[r];
    a.d_normal[h * 3 + r] = O::div(n[r], nn);
  }
  a.d_mask[h] = 1;
}

// ptrs: x, tets, rest, faces, info, surf, keys, order, qcell (the last three
// null where no collider is broad), frames, qtet, qbary, listed, list,
// count, d_mask, d_face, d_barys, d_normal, overflow; ints: n_colliders,
// n_tets (the table's), h, hit_cap, broad_min (BROADPHASE_MIN_TETS: a
// collider with more tets is broad), dense_max (the most tets of a dense
// collider, 0 for none), n_broad (the broad colliders).
template <typename T>
int detect(const uint64_t* p, const int* ints, void* stream) {
  KArgs<T> a;
  a.x = reinterpret_cast<const T*>(p[0]);
  a.tets = reinterpret_cast<const int*>(p[1]);
  a.rest = reinterpret_cast<const T*>(p[2]);
  a.faces = reinterpret_cast<const int*>(p[3]);
  a.info = reinterpret_cast<const int*>(p[4]);
  a.surf = reinterpret_cast<const int64_t*>(p[5]);
  a.keys = reinterpret_cast<const int*>(p[6]);
  a.order = reinterpret_cast<const int64_t*>(p[7]);
  a.qcell = reinterpret_cast<const int*>(p[8]);
  a.frames = reinterpret_cast<T*>(p[9]);
  a.qtet = reinterpret_cast<int*>(p[10]);
  a.qbary = reinterpret_cast<T*>(p[11]);
  a.listed = reinterpret_cast<unsigned char*>(p[12]);
  a.list = reinterpret_cast<int*>(p[13]);
  a.count = reinterpret_cast<int*>(p[14]);
  a.d_mask = reinterpret_cast<unsigned char*>(p[15]);
  a.d_face = reinterpret_cast<int64_t*>(p[16]);
  a.d_barys = reinterpret_cast<T*>(p[17]);
  a.d_normal = reinterpret_cast<T*>(p[18]);
  a.overflow = reinterpret_cast<int*>(p[19]);
  a.n_colliders = ints[0];
  a.n_tets = ints[1];
  a.h = ints[2];
  const int hit_cap = ints[3];
  a.broad_min = ints[4];
  const int dense_max = ints[5], n_broad = ints[6];
  if (a.h <= 0 || a.n_tets <= 0 || a.n_colliders <= 0) return 0;
  if (hit_cap < 1 || (n_broad > 0 && !(a.keys && a.order && a.qcell)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.cap = a.h < hit_cap ? a.h : hit_cap;
  a.tile = dense_max > 0 ? ((dense_max + 31) / 32 * 32 < Tile<T>::kMax ? (dense_max + 31) / 32 * 32
                                                                        : Tile<T>::kMax)
                         : 0;
  const int smem = a.tile * kFrame * static_cast<int>(sizeof(T));
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        dyn_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (a.h + kQueryWarps - 1) / kQueryWarps;
  dyn_frames_kernel<T><<<(a.n_tets + 255) / 256, 256, 0, s>>>(a);
  if (ADMM_K_PHASES >= 2)
    dyn_query_kernel<T><<<a.n_colliders * per, kQueryWarps * 32, smem, s>>>(a);
  if (ADMM_K_PHASES >= 3) dyn_rank_kernel<T><<<a.n_colliders, kRankThreads, 0, s>>>(a);
  if (ADMM_K_PHASES >= 4) dyn_face_kernel<T><<<a.n_colliders * a.cap, kFaceThreads, 0, s>>>(a);
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
