// Kernel G: the whole preconditioned-CG global solve in one launch.
//
// It has no Pallas original. It replaces the jnp loop
// admm_elastic_tpu/solvers/pcg.py solve_T (:304-348) with PCGData.apply_T and
// precondition_T (:82-155) inside it: a lax.while_loop that stops on a device
// value. The port's timestep is one captured CUDA graph, where the host cannot
// branch, and as plain PyTorch one trip would be tens of small launches; here
// the loop, its exit test and its trip count stay on the card. The plain
// version is admm_elastic_tpu_torch/solvers/pcg.py solve_T; chip_smoke.py holds
// this kernel to it (float64: the same trips and x within 1e-10).
//
// The loop is the JAX package's, guards included:
//   tol2 = max(tol, 64 eps)^2 max(b.b, tiny); r = b - A x0; z = M^-1 r; p = z
//   done = r.r < tol2 (checked before the first trip, so a solve may take 0)
//   while !done and k < max_iters:
//     Ap = A p; alpha = rz / (|p.Ap| < tiny ? 1 : p.Ap)
//     x += alpha p; r -= alpha Ap; z = M^-1 r; rz' = r.z
//     beta = rz' / (|rz| < tiny ? 1 : rz); p = z + beta p; done = r.r < tol2
// and the trips are added to a device counter (Solver's inner iterations).
//
// A x (PCGData.apply_T, in the banded vertex order): diag = mass + pin +
// stiffness (summed on the host in diag()'s order), the bands in their order
// (circular: (j + o) mod N), then the rest-ELL in its column order (stored
// column-major by ops/cuda_pcg.py, so that a warp's reads coalesce). With an
// RCM permutation the whole solve runs in the banded order: b and x0 are read
// through perm, x is written back through it, and the two-grid tables come
// remapped (ops/cuda_pcg.py). spmv_format="ell" is the same apply with no band.
// M^-1: Jacobi, or the two-grid V-cycle of PCGData.precondition with omega 0.7:
// z = omega d^-1 r; res = r - A z; rc = P^T res (agg_gather in table order);
// ec = coarse_inv rc (full FP32, one warp per row, a fixed tree); z += ec[agg];
// z += omega d^-1 (r - A z).
//
// Its bound is latency, not bytes: a trip is a chain of phases, each a row
// pass over all N that other threads' results feed (2 a Jacobi trip, 6 a
// two-grid one), and each phase a few chains of dependent loads at L2
// latency. tools/g_h_anatomy.py split the parent's trip (PERF.md): a phase's
// barrier and totals cost 2-4.6 us; the row work more, above all in the
// two-grid V-cycle, whose rc gather (a thread per coarse row, 24 dependent
// index-then-value loads) and coarse matvec (33 dependent loads a lane) were
// most of a 67 us trip. So each row's neighbours are loaded kNb at a time
// before their ordered sums; rc is a warp per coarse row, its lanes loading
// the row's entries together and the sum taken in table order from them by
// shuffles; the coarse matvec loads 16 columns a lane at a time (8 in
// float64). Every sum
// keeps the parent's order, so that x is the parent's, bit for bit.
//
// Two forms of one kernel, the same arithmetic in the same order:
// - CLUSTER, one thread-block cluster of at most 16 blocks of 256 or 512
//   threads, one vertex a thread (so N <= 8,192): every vector
//   the solve writes lives in the blocks' shared memory, each block owning a
//   contiguous span of the banded order, and a neighbour's value is read
//   through distributed shared memory (DSMEM); a phase ends with the
//   cluster's hardware barrier, and the chunks' partial dots sit in the
//   owners' shared memory. Launched with cudaLaunchKernelEx and a cluster
//   dimension. Its phases cost less (a cluster barrier 0.4-0.8 us against a
//   grid barrier's 1.0-1.6) but its row work runs on fewer SMs: it won on
//   the torus (11 blocks of 512 against 21 of 256) and on 1-2 blocks, and
//   lost at 16 blocks (8,192 vertices; and 15,616 on blocks of 1,024, since
//   dropped) and on the bunny's rest-ELL, whose random columns read across
//   the cluster (PERF.md). ops/cuda_pcg.py chooses it where at most 11
//   blocks cover N and the rows have no rest-ELL.
// - GRID, otherwise: persistent blocks of 256 threads, at most as many as
//   can be resident together (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//   SMs) and at most one per 256-vertex chunk; a block walks chunks b,
//   b + grid, ..., a thread one vertex (its three components) of a chunk, the
//   same vertex in every phase. A grid-wide barrier (grid_sync: integer
//   atomics with acquire and release order, no float atomic anywhere)
//   follows each phase whose output other blocks read. Vectors live in
//   global memory; data that other blocks wrote in this launch is read with
//   __ldcg (L2, not the SM's own L1). Launched cooperatively
//   (cudaLaunchCooperativeKernel): the runtime refuses a grid that cannot be
//   resident at once, which the barrier needs.
// Both capture into the step's CUDA graph. A launch that is refused raises.
//
// Phases: two per Jacobi trip (after A p and its dot, after the update and
// its dots), six per two-grid trip (A p; the update; res = r - A z; rc; ec;
// the second smoothing and its dots). p = z + beta p needs no phase of its
// own: the apply forms p of each neighbour from z and the last p as it reads
// them (one fma, the same bits wherever it is formed), and each thread keeps
// its own vertex's p in a second buffer for the next trip. z + ec[agg], the
// coarse correction, has no phase either: the second smoothing forms it
// wherever it reads z (one add, the same bits), and writes the smoothed z
// into a second buffer, which the next trip's apply reads.
// Dots: each chunk's partial is a fixed shuffle tree over its 256 vertices,
// written once; after the barrier every block sums all partials the same way
// (a chunk-strided sum per thread, then the tree), so every block holds the
// same bits, takes the same branch, and the dots and the trip count are the
// same in every run, whatever the form or the grid size.
//
// The penalty form (PEN, AL-PCG's (A + C^T C) x = b^, replacing the jnp
// solve of admm_elastic_tpu/solvers/alcg.py:73-127): without dynamic rows
// C^T C is block-diagonal per vertex, pn pn^T with pn the masked ck-scaled
// contact normal ([N, 3], zero off contact), so the apply adds
// pn_j (pn_j . v_j) to each vertex's row (the three products in component
// order), and the Jacobi inverse, and the two-grid smoother's, is per
// component, 1 / (diag + diag(C^T C)), formed by the wrapper as the plain
// version forms it. The coarse correction stays A's. The unpenalized kernel
// is the other instantiation, unchanged. Its plain twin is
// admm_elastic_tpu_torch/solvers/alcg.py penalty_solve.
//
// DYN, the penalty form with the self-collision rows (AL-PCG with colliders,
// the JAX package's pcg.solve on A + C^T C, alcg.py:105-107): the dynamic
// rows couple a vertex to its face's three, so C^T C is not block-diagonal.
// Each apply is then two phases: the active rows' C v (a thread a row,
// dyn_rows.cuh, v read through the banded order's inverse permutation, into
// global scratch RD), a barrier, and the apply above with each vertex's C^T RD
// added (its own row's term, then its face corners in table order, as kernel
// L sums them). The Jacobi inverse 1 / (diag + diag(C^T C)) comes from the
// wrapper, the dynamic rows' terms included. Jacobi only: the wrapper raises
// for the two-grid preconditioner. Its plain twin is
// admm_elastic_tpu_torch/solvers/alcg.py penalty_solve_dyn.
//
// done (null, or a flag on the device): where it is set when the kernel
// starts, the solve takes no trip and returns x0. Uzawa's Schur trips, all
// in the captured step and predicated on that flag, skip their inner solve
// by it (solvers/uzawa.py).

#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "dyn_rows.cuh"
#include "grid_sync.cuh"

// Anatomy builds (tools/g_h_anatomy.py): with ADMM_G_ANATOMY=1 the phases do
// no row work (the barriers, the block sums and the totals remain) and the
// exit test is ignored, so a solve takes max_iters trips. The shipped build
// is 0.
#ifndef ADMM_G_ANATOMY
#define ADMM_G_ANATOMY 0
#endif

namespace {

namespace cg = cooperative_groups;

constexpr bool kRows = ADMM_G_ANATOMY == 0;
constexpr int kGroup = 256;  // vertices per chunk = threads per chunk group
constexpr int kGroupWarps = kGroup / 32;
constexpr int kClusterThreads = 512;  // the largest block of the cluster form
constexpr int kMaxWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxBands = 64;  // ops/spmv.plan_bands keeps at most 64
// Bands whose loads are issued together. 8 won 5-6 % on the 15,616-vertex
// two-grid solves and lost elsewhere; the rest-ELL batched the same way lost
// 18 % on the bunny (PERF.md).
constexpr int kNb = 4;
enum Slot { S_PAP = 0, S_RZ = 1, S_RR = 2, S_BB = 3, kSlots = 4 };
// The solve's vectors ([N, 3] each): x, r, z, the smoothed z (two-grid), the
// two p buffers, A p, and the two-grid residual.
enum Vec { V_X = 0, V_R, V_Z, V_ZS, V_P0, V_P1, V_AP, V_RES, kVecs };

template <typename T> struct Fl;
template <> struct Fl<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Fl<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

template <typename T>
struct Args {
  const T* b;              // [N, 3], vertex order
  const T* x0;             // [N, 3], vertex order
  T* x_out;                // [N, 3], vertex order
  const int64_t* perm;     // [N] or null: row j of the banded order is vertex perm[j]
  const T* diag;           // [N] banded order
  const T* inv_d;          // [N] banded order, 1 / diag
  const T* bands;          // [n_bands, N]
  const int* rest_cols;    // [k_rest, N], banded order
  const T* rest_vals;      // [k_rest, N]
  const int* agg;          // [N] banded order, or null (Jacobi)
  const int* agg_gather;   // [n_coarse, k_agg] banded-order vertices, pad N
  const T* coarse_inv;     // [n_coarse, n_coarse]
  const T* pn;             // [N, 3] banded order: the penalty normals (PEN)
  const T* inv3;           // [N, 3] banded order: 1 / (diag + pn^2) per component (PEN)
  const unsigned char* done;  // null, or: skip the solve where set
  T* vec[kVecs];           // GRID: scratch [N, 3] each (enum Vec); CLUSTER: unused
  T* RC;                   // scratch [n_coarse, 3] each
  T* EC;
  T* parts;                // GRID: scratch [kSlots, n_chunks]
  Barrier* bar;            // GRID: zero before the first launch; left zero by every launch
  int* trips;              // null, or += the trips of this solve
  int n, n_chunks, k_rest, n_bands, circular, k_agg, n_coarse, max_iters;
  int shift;               // CLUSTER: log2 of the vertices (threads) of a block
  T tol, omega;
  int offs[kMaxBands];
  // DYN, after the other forms' fields: the dynamic rows and their table
  // (vertex order), each vertex's banded index (null without a permutation),
  // the rows' C v [H]
  DynRows<T> dyn;
  const int64_t* iperm;
  T* RD;
};

// Where the solve's vectors and partial sums live, and how a thread reaches
// a vertex's: global buffers (GRID), or the cluster's shared memory, vertex
// q in block q >> shift (CLUSTER).
template <typename T, bool CL>
struct Mem {
  T* const* g;   // GRID: the vectors
  T* parts;      // GRID: [kSlots, n_chunks]; CLUSTER: this block's [kSlots, chunks a block]
  T* sm;         // CLUSTER: this block's span of each vector, [kVecs, span, 3]
  int shift, n_chunks;
  unsigned rank;

  // vector v's storage: where this block keeps it (CLUSTER) or all of it
  // (GRID); the vectors' pointers are taken once, not at every read
  __device__ __forceinline__ T* base(int v) const {
    if constexpr (CL)
      return sm + ((size_t)v << shift) * 3;
    else
      return g[v];
  }
  __device__ __forceinline__ T* at(T* b, int j) const {
    if constexpr (CL)
      return b + (size_t)(j & ((1 << shift) - 1)) * 3;
    else
      return b + (int64_t)j * 3;
  }
  // this thread's own vertex (written by this thread only)
  __device__ __forceinline__ T own(T* b, int j, int r) const {
    if constexpr (CL)
      return at(b, j)[r];
    else
      return __ldcg(at(b, j) + r);
  }
  __device__ __forceinline__ void st(T* b, int j, int r, T x) const { at(b, j)[r] = x; }
  // any vertex's three components (another block's, after a barrier); in
  // the cluster one load through the owner's window, its own block's or a
  // remote one picked without a branch
  __device__ __forceinline__ void ld3(T* b, int q, T o[3]) const {
    const T* p = at(b, q);
    if constexpr (CL) {
      const unsigned rk = static_cast<unsigned>(q) >> shift;
      const T* remote = cg::this_cluster().map_shared_rank(p, rk);
      p = rk == rank ? p : remote;
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = p[r];
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = __ldcg(p + r);
    }
  }
  __device__ __forceinline__ T* part(int slot, int c) const {
    if constexpr (CL) {
      const int per = 1 << (shift - 8);  // chunks a block
      return parts + slot * per + (c & (per - 1));
    } else {
      return parts + slot * n_chunks + c;
    }
  }
  __device__ __forceinline__ T ld_part(int slot, int c) const {
    if constexpr (CL) {
      const unsigned rk = static_cast<unsigned>(c) >> (shift - 8);
      const T* p = part(slot, c);
      const T* remote = cg::this_cluster().map_shared_rank(p, rk);
      return *(rk == rank ? p : remote);
    } else {
      return __ldcg(part(slot, c));
    }
  }
};

// The end of a phase: the grid barrier, or the cluster's (arrive with
// release, wait with acquire: the blocks' shared and global writes are seen).
template <bool CL>
__device__ __forceinline__ void phase_sync(Barrier* bar) {
  if constexpr (CL)
    cg::this_cluster().sync();
  else
    grid_sync(bar, gridDim.x);
}

// K sums over each 256-thread group in a fixed tree: shuffles within each
// warp, then over the group's 8 warp sums in its first warp. The result is
// in the group's thread 0. sm: [kMaxWarps * K].
template <typename T, int K>
__device__ __forceinline__ void group_sum(T v[K], T* sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sm[w * K + k] = v[k];
  __syncthreads();
  if ((w & (kGroupWarps - 1)) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = lane < kGroupWarps ? sm[(w + lane) * K + k] : T(0);
#pragma unroll
      for (int off = kGroupWarps / 2; off > 0; off >>= 1)
        v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  __syncthreads();
}

// Write each group's chunk's partial sums to their slots.
template <typename T, int K, bool CL>
__device__ __forceinline__ void put_parts(const Mem<T, CL>& m, int chunk, const int (&slot)[K],
                                          T v[K], T* sm) {
  group_sum<T, K>(v, sm);
  if ((threadIdx.x & (kGroup - 1)) == 0 && chunk < m.n_chunks)
#pragma unroll
    for (int k = 0; k < K; ++k) *m.part(slot[k], chunk) = v[k];
}

// The totals of K slots over all chunks, the same bits in every block and
// every thread: the first group sums the partials chunk-strided, then its
// warps' sums go to sm, and every warp runs the tree over them.
template <typename T, int K, bool CL>
__device__ __forceinline__ void totals(const Mem<T, CL>& m, const int (&slot)[K], T out[K],
                                       T* sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w < kGroupWarps) {
    T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = T(0);
      for (int c = threadIdx.x; c < m.n_chunks; c += kGroup) v[k] += m.ld_part(slot[k], c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) sm[w * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T v = lane < kGroupWarps ? sm[lane * K + k] : T(0);
#pragma unroll
    for (int off = kGroupWarps / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    out[k] = __shfl_sync(0xffffffffu, v, 0);
  }
}

// Vectors the apply reads, a vertex's three components at a time (load3).
// x0, an input of the launch (read once per solve).
template <typename T>
struct In {
  const T* v;
  __device__ __forceinline__ void load3(int q, T o[3]) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) o[r] = __ldcg(v + (int64_t)q * 3 + r);
  }
};

// A vector written earlier in this launch.
template <typename T, bool CL>
struct Vx {
  const Mem<T, CL>& m;
  T* v;
  __device__ __forceinline__ void load3(int q, T o[3]) const { m.ld3(v, q, o); }
};

// p = z + beta p_old of the coming trip, formed where it is read (the first
// trip's p is z).
template <typename T, bool CL>
struct PVec {
  const Mem<T, CL>& m;
  T *z, *p_old;
  T beta;
  bool first;
  __device__ __forceinline__ void load3(int q, T o[3]) const {
    m.ld3(z, q, o);
    if (!first) {
      T po[3];
      m.ld3(p_old, q, po);
#pragma unroll
      for (int r = 0; r < 3; ++r) o[r] = fma(beta, po[r], o[r]);
    }
  }
};

// z + ec[agg], the coarse-corrected z of the V-cycle, formed where it is read.
template <typename T, bool CL>
struct Z2Vec {
  const Mem<T, CL>& m;
  T* z;
  const int* agg;
  const T* ec;
  __device__ __forceinline__ void load3(int q, T o[3]) const {
    const T* e = ec + __ldg(agg + q) * 3;
    m.ld3(z, q, o);
#pragma unroll
    for (int r = 0; r < 3; ++r) o[r] = o[r] + __ldcg(e + r);
  }
};

// DYN: every active row's C v into RD (v indexed in the banded order); the
// caller's barrier follows.
template <typename T, typename V>
__device__ __forceinline__ void dyn_rows(const Args<T>& a, const V& v) {
  const T ck = __ldg(a.dyn.ck);
  const int64_t* ip = a.iperm;
  const auto load = [&v, ip](int64_t q, T o[3]) { v.load3(static_cast<int>(ip ? ip[q] : q), o); };
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < a.dyn.h; r += gridDim.x * blockDim.x)
    if (a.dyn.mask[r]) a.RD[r] = dyn_row_value(a.dyn, r, ck, load);
}

// (A v)[j] for one vertex of the banded order: diag, bands, rest-ELL; with
// PEN, + pn_j (pn_j . v_j); with DYN, + the dynamic rows' C^T of RD. The bands'
// loads are issued kNb at a time, before their sums, which stay in band order;
// the rest-ELL's in the parent's loop, in column order.
template <typename T, bool PEN, typename V, bool DYN = false>
__device__ __forceinline__ void spmv(const Args<T>& a, const V& v, int j, T out[3]) {
  const int n = a.n;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  for (int d0 = 0; d0 < a.n_bands; d0 += kNb) {
    T bd[kNb], x[kNb][3];
    bool ok[kNb];
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
      const int d = d0 + i;
      ok[i] = d < a.n_bands;
      if (ok[i]) {
        int q = j + a.offs[d];
        if (a.circular)
          q = q < 0 ? q + n : (q >= n ? q - n : q);
        else
          ok[i] = q >= 0 && q < n;
        if (ok[i]) {
          bd[i] = __ldg(a.bands + (int64_t)d * n + j);
          v.load3(q, x[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
      if (ok[i]) {
        acc0 += bd[i] * x[i][0];
        acc1 += bd[i] * x[i][1];
        acc2 += bd[i] * x[i][2];
      }
    }
  }
#pragma unroll 4
  for (int k = 0; k < a.k_rest; ++k) {
    const int64_t e = (int64_t)k * n + j;
    const T val = __ldg(a.rest_vals + e);
    T x[3];
    v.load3(__ldg(a.rest_cols + e), x);
    acc0 += val * x[0];
    acc1 += val * x[1];
    acc2 += val * x[2];
  }
  const T dj = __ldg(a.diag + j);
  T xj[3];
  v.load3(j, xj);
  out[0] = dj * xj[0] + acc0;
  out[1] = dj * xj[1] + acc1;
  out[2] = dj * xj[2] + acc2;
  if constexpr (PEN) {
    const int64_t vj = (int64_t)j * 3;
    const T p0 = __ldg(a.pn + vj), p1 = __ldg(a.pn + vj + 1), p2 = __ldg(a.pn + vj + 2);
    const T cx = p0 * xj[0] + p1 * xj[1] + p2 * xj[2];
    out[0] += p0 * cx;
    out[1] += p1 * cx;
    out[2] += p2 * cx;
  }
  if constexpr (DYN) {  // + C^T (C v) of the dynamic rows, RD from the phase before
    const int64_t vo = a.perm ? a.perm[j] : j;
    const T ck = __ldg(a.dyn.ck);
    const T* rd = a.RD;
    const auto y = [rd](int64_t r) { return __ldcg(rd + r); };
    T acc[3];
    dyn_own_ct(a.dyn, vo, ck, y, acc);
    dyn_corners_ct(a.dyn, vo, ck, y, acc);
    out[0] += acc[0];
    out[1] += acc[1];
    out[2] += acc[2];
  }
}

// The Jacobi inverse of vertex j per component: 1 / diag, or with PEN the
// wrapper's 1 / (diag + pn^2).
template <typename T, bool PEN>
__device__ __forceinline__ void inv_of(const Args<T>& a, int j, T id[3]) {
  if constexpr (PEN) {
#pragma unroll
    for (int r = 0; r < 3; ++r) id[r] = __ldg(a.inv3 + j * 3 + r);
  } else {
    const T d = __ldg(a.inv_d + j);
#pragma unroll
    for (int r = 0; r < 3; ++r) id[r] = d;
  }
}

// The chunks of this thread's group: a GRID block walks chunk b, b + grid,
// ...; a CLUSTER block holds its span's chunks at once, one pass.
#define FOR_CHUNKS(c, j)                                                                \
  for (int c##0 = blockIdx.x * (blockDim.x / kGroup); c##0 < a.n_chunks;                \
       c##0 += gridDim.x * (blockDim.x / kGroup))                                       \
    for (int c = c##0 + static_cast<int>(threadIdx.x / kGroup),                         \
             j = c * kGroup + static_cast<int>(threadIdx.x % kGroup), c##_once = 1;     \
         c##_once; c##_once = 0)

// The two-grid V-cycle after z = omega d^-1 r is in V_Z (and a barrier): the
// coarse correction and the second smoothing leave M^-1 r in V_ZS and the
// partials of r.z and r.r in their slots, then a barrier.
template <typename T, bool PEN, bool CL>
__device__ void two_grid(const Args<T>& a, const Mem<T, CL>& m, T* sm) {
  const int n = a.n;
  const T omega = a.omega;
  T* const R = m.base(V_R);
  T* const Z = m.base(V_Z);
  T* const ZS = m.base(V_ZS);
  T* const RES = m.base(V_RES);
  FOR_CHUNKS(c, j) {  // res = r - A z
    if (kRows && j < n) {
      T az[3];
      spmv<T, PEN>(a, Vx<T, CL>{m, Z}, j, az);
#pragma unroll
      for (int r = 0; r < 3; ++r) m.st(RES, j, r, m.own(R, j, r) - az[r]);
    }
  }
  phase_sync<CL>(a.bar);
  // rc = P^T res, in table order: a warp per coarse row, its lanes load the
  // row's entries together, lane 0's order sums them
  const int lane = threadIdx.x & 31;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, nw = (gridDim.x * blockDim.x) >> 5;
  for (int c = wid; kRows && c < a.n_coarse; c += nw) {
    T acc[3] = {T(0), T(0), T(0)};
    for (int e0 = 0; e0 < a.k_agg; e0 += 32) {
      const int e = e0 + lane;
      const int v = e < a.k_agg ? __ldg(a.agg_gather + (int64_t)c * a.k_agg + e) : n;
      T rv[3] = {T(0), T(0), T(0)};
      if (v < n) m.ld3(RES, v, rv);
      const int cnt = a.k_agg - e0 < 32 ? a.k_agg - e0 : 32;
      for (int i = 0; i < cnt; ++i) {
        const bool used = __shfl_sync(0xffffffffu, v, i) < n;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T x = __shfl_sync(0xffffffffu, rv[r], i);
          if (used) acc[r] += x;
        }
      }
    }
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 3; ++r) a.RC[c * 3 + r] = acc[r];
  }
  phase_sync<CL>(a.bar);
  // ec = coarse_inv rc: a warp per row, lane l summing columns l, l + 32, ...
  // in order (kEc columns' loads at a time), then the shuffle tree
  constexpr int kEc = sizeof(T) == 4 ? 16 : 8;
  for (int row = wid; kRows && row < a.n_coarse; row += nw) {
    T acc[3] = {T(0), T(0), T(0)};
    const T* ci = a.coarse_inv + (int64_t)row * a.n_coarse;
    for (int k0 = lane; k0 < a.n_coarse; k0 += 32 * kEc) {
      T w[kEc], x[kEc][3];
#pragma unroll
      for (int i = 0; i < kEc; ++i) {
        const int k = k0 + 32 * i;
        if (k < a.n_coarse) {
          w[i] = __ldg(ci + k);
#pragma unroll
          for (int r = 0; r < 3; ++r) x[i][r] = __ldcg(a.RC + k * 3 + r);
        }
      }
#pragma unroll
      for (int i = 0; i < kEc; ++i)
        if (k0 + 32 * i < a.n_coarse)
#pragma unroll
          for (int r = 0; r < 3; ++r) acc[r] += w[i] * x[i][r];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 3; ++r) a.EC[row * 3 + r] = acc[r];
  }
  phase_sync<CL>(a.bar);
  const int slots[2] = {S_RZ, S_RR};
  const Z2Vec<T, CL> z2{m, Z, a.agg, a.EC};
  FOR_CHUNKS(c, j) {  // z += ec[agg]; z += omega d^-1 (r - A z)
    T v[2] = {T(0), T(0)};
    if (kRows && j < n) {
      T az[3], id[3], zj[3];
      spmv<T, PEN>(a, z2, j, az);
      inv_of<T, PEN>(a, j, id);
      z2.load3(j, zj);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T w = omega * id[r];
        const T rr = m.own(R, j, r);
        const T z = zj[r] + w * (rr - az[r]);
        m.st(ZS, j, r, z);
        v[0] += rr * z;
        v[1] += rr * rr;
      }
    }
    put_parts<T, 2, CL>(m, c, slots, v, sm);
  }
  phase_sync<CL>(a.bar);
}

// GRID: two blocks an SM, so that the resident grid reaches 264 chunks
template <typename T, bool PEN, bool CL, bool DYN>
__global__ void __launch_bounds__(CL ? kClusterThreads : kGroup, CL ? 1 : 2)
    pcg_kernel(const __grid_constant__ Args<T> a) {
  static_assert(PEN || !DYN, "DYN is a penalty form");
  __shared__ T sm[kMaxWarps * 3];
  __shared__ T smt[kGroupWarps * 3];
  extern __shared__ __align__(16) unsigned char dyn[];
  const int n = a.n;
  const bool two = a.agg != nullptr;
  const T tiny = Fl<T>::tiny();
  Mem<T, CL> m;
  m.g = a.vec;
  m.shift = a.shift;
  m.n_chunks = a.n_chunks;
  m.rank = blockIdx.x;
  if constexpr (CL) {
    m.sm = reinterpret_cast<T*>(dyn);
    m.parts = m.sm + ((size_t)kVecs << a.shift) * 3;
    cg::this_cluster().sync();  // every block runs before any reads another's memory
  } else {
    m.sm = nullptr;
    m.parts = a.parts;
  }

  T* const X = m.base(V_X);
  T* const R = m.base(V_R);
  T* const Z = m.base(V_Z);
  T* const AP = m.base(V_AP);

  if (a.done != nullptr && *a.done) {  // no solve: x = x0, no trip
    FOR_CHUNKS(c, j) {
      if (kRows && j < n)
#pragma unroll
        for (int r = 0; r < 3; ++r) a.x_out[j * 3 + r] = a.x0[j * 3 + r];
    }
    return;
  }

  // x = x0 in the banded order; without a permutation the first apply reads
  // x0 itself and x is written beside it, with no barrier in between.
  if (a.perm) {
    FOR_CHUNKS(c, j) {
      if (kRows && j < n)
#pragma unroll
        for (int r = 0; r < 3; ++r) m.st(X, j, r, a.x0[a.perm[j] * 3 + r]);
    }
    phase_sync<CL>(a.bar);
  }
  if constexpr (DYN) {  // the rows' C x0
    if (a.perm)
      dyn_rows(a, Vx<T, CL>{m, X});
    else
      dyn_rows(a, In<T>{a.x0});
    phase_sync<CL>(a.bar);
  }
  {
    const int slots[3] = {S_BB, S_RZ, S_RR};
    FOR_CHUNKS(c, j) {  // r = b - A x; z = M^-1 r (Jacobi)
      T v[3] = {T(0), T(0), T(0)};
      if (kRows && j < n) {
        const int64_t src = a.perm ? a.perm[j] : j;
        T ax[3], id[3];
        if (a.perm) {
          spmv<T, PEN, Vx<T, CL>, DYN>(a, Vx<T, CL>{m, X}, j, ax);
        } else {
          spmv<T, PEN, In<T>, DYN>(a, In<T>{a.x0}, j, ax);
#pragma unroll
          for (int r = 0; r < 3; ++r) m.st(X, j, r, a.x0[j * 3 + r]);
        }
        inv_of<T, PEN>(a, j, id);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T bj = a.b[src * 3 + r];
          const T rr = bj - ax[r];
          m.st(R, j, r, rr);
          if (two) {
            m.st(Z, j, r, (a.omega * id[r]) * rr);
          } else {
            const T z = id[r] * rr;
            m.st(Z, j, r, z);
            v[1] += rr * z;
          }
          v[0] += bj * bj;
          v[2] += rr * rr;
        }
      }
      put_parts<T, 3, CL>(m, c, slots, v, sm);
    }
    phase_sync<CL>(a.bar);
  }
  if (two) two_grid<T, PEN, CL>(a, m, sm);
  T* const zfin = two ? m.base(V_ZS) : Z;  // M^-1 r, which the apply reads
  T t0[3];
  {
    const int slots[3] = {S_BB, S_RZ, S_RR};
    totals<T, 3, CL>(m, slots, t0, smt);
  }
  const T bb = t0[0];
  T rz = t0[1];
  T tol = a.tol < T(64) * Fl<T>::eps() ? T(64) * Fl<T>::eps() : a.tol;
  const T tol2 = tol * tol * (bb < tiny ? tiny : bb);
  bool done = kRows && t0[2] < tol2;
  int k = 0;
  T beta = T(0);
  T* p_old = m.base(V_P0);  // p of the last trip
  T* p_new = m.base(V_P1);  // p of this trip
  while (!done && k < a.max_iters) {
    {
      const int slots[1] = {S_PAP};
      const PVec<T, CL> pv{m, zfin, p_old, beta, k == 0};
      if constexpr (DYN) {  // the rows' C p
        dyn_rows(a, pv);
        phase_sync<CL>(a.bar);
      }
      FOR_CHUNKS(c, j) {  // p = z + beta p; Ap = A p
        T v[1] = {T(0)};
        if (kRows && j < n) {
          T ap[3], pj[3];
          spmv<T, PEN, PVec<T, CL>, DYN>(a, pv, j, ap);
          pv.load3(j, pj);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const T p = pj[r];
            m.st(p_new, j, r, p);
            m.st(AP, j, r, ap[r]);
            v[0] += p * ap[r];
          }
        }
        put_parts<T, 1, CL>(m, c, slots, v, sm);
      }
    }
    phase_sync<CL>(a.bar);
    T pap[1];
    {
      const int slots[1] = {S_PAP};
      totals<T, 1, CL>(m, slots, pap, smt);
    }
    const T alpha = rz / (fabs(pap[0]) < tiny ? T(1) : pap[0]);
    {
      const int slots[2] = {S_RZ, S_RR};
      FOR_CHUNKS(c, j) {  // x, r; z = M^-1 r
        T v[2] = {T(0), T(0)};
        if (kRows && j < n) {
          T id[3];
          inv_of<T, PEN>(a, j, id);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const T p = m.own(p_new, j, r);  // this thread's own, from the phase above
            m.st(X, j, r, m.own(X, j, r) + alpha * p);
            const T rr = m.own(R, j, r) - alpha * m.own(AP, j, r);
            m.st(R, j, r, rr);
            if (two) {
              m.st(Z, j, r, (a.omega * id[r]) * rr);
            } else {
              const T z = id[r] * rr;
              m.st(Z, j, r, z);
              v[0] += rr * z;
              v[1] += rr * rr;
            }
          }
        }
        if (!two) put_parts<T, 2, CL>(m, c, slots, v, sm);
      }
    }
    phase_sync<CL>(a.bar);
    if (two) two_grid<T, PEN, CL>(a, m, sm);
    T t[2];
    {
      const int slots[2] = {S_RZ, S_RR};
      totals<T, 2, CL>(m, slots, t, smt);
    }
    beta = t[0] / (fabs(rz) < tiny ? T(1) : rz);
    done = kRows && t[1] < tol2;
    rz = t[0];
    ++k;
    T* const swap = p_old;
    p_old = p_new;
    p_new = swap;
  }
  FOR_CHUNKS(c, j) {  // x back in the vertex order
    if (kRows && j < n) {
      const int64_t dst = a.perm ? a.perm[j] : j;
#pragma unroll
      for (int r = 0; r < 3; ++r) a.x_out[dst * 3 + r] = m.own(X, j, r);
    }
  }
  if (a.trips != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *a.trips += k;
  if constexpr (CL) cg::this_cluster().sync();  // no block leaves while another reads its memory
}

#undef FOR_CHUNKS

// The resident grid of the GRID form: as many blocks as can be resident at
// once.
template <typename T, bool PEN, bool DYN>
int resident_blocks(int* resident) {
  static int cached = 0;  // per precision and form, for the current device
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel<T, PEN, false, DYN>,
                                                         kGroup, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached = per_sm * sms;
  }
  *resident = cached;
  return 0;
}

// The grid barrier alone, iters times (tools/g_h_anatomy.py).
__global__ void __launch_bounds__(kGroup) barrier_loop_kernel(Barrier* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_sync(bar, gridDim.x);
}

// A cluster's hardware barrier alone, iters times (tools/g_h_anatomy.py).
__global__ void cluster_barrier_kernel(int iters) {
  for (int i = 0; i < iters; ++i) cg::this_cluster().sync();
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, int smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let fn take clusters of up to 16 blocks and smem bytes of dynamic shared
// memory (raised, never lowered, once per size).
template <typename F>
cudaError_t allow_cluster(F* fn, int smem, int* granted) {
  cudaError_t rc = cudaSuccess;
  if (*granted < 0) {
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
    *granted = 0;
  }
  if (smem > *granted) {
    rc = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == cudaSuccess) *granted = smem;
  }
  return rc;
}

// The dynamic shared memory of the CLUSTER form's block: every vector's span
// and the span's partials.
template <typename T>
int cluster_smem(int shift) {
  return static_cast<int>((((size_t)kVecs << shift) * 3 + kSlots * (1 << (shift - 8))) * sizeof(T));
}

template <typename T, bool PEN, bool DYN>
cudaError_t launch_cluster(const Args<T>& a, int cluster, cudaStream_t stream) {
  static int granted = -1;  // per precision and form
  const int smem = cluster_smem<T>(a.shift);
  cudaError_t rc = allow_cluster(pcg_kernel<T, PEN, true, DYN>, smem, &granted);
  if (rc != cudaSuccess) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1 << a.shift, smem, stream, &attr);
  return cudaLaunchKernelEx(&cfg, pcg_kernel<T, PEN, true, DYN>, a);
}

// ptrs: b, x0, x_out, perm, diag, inv_d, bands, rest_cols, rest_vals, agg,
// agg_gather, coarse_inv, X, R, P, Z, AP, Z2, RES, P2, RC, EC, parts, bar,
// trips, pn, inv3, done (null where absent; pn and inv3 both or neither: the
// penalty form), then the DYN form's (null without dynamic rows): mask, vidx,
// face, barys, normal, ck, order, start, slot (null: the query set is every
// vertex), iperm (null: no permutation), RD; ints: n, k_rest, n_bands, circular, k_agg, n_coarse,
// max_iters, grid cap (GRID, 0: the resident grid; tools/g_h_anatomy.py),
// form (0 GRID, 1 CLUSTER), cluster blocks, log2 of a cluster block's
// threads, the dynamic rows' H; offs: the band offsets.
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, const int* offs, double tol, double omega,
           void* stream) {
  Args<T> a;
  a.b = reinterpret_cast<const T*>(ptrs[0]);
  a.x0 = reinterpret_cast<const T*>(ptrs[1]);
  a.x_out = reinterpret_cast<T*>(ptrs[2]);
  a.perm = reinterpret_cast<const int64_t*>(ptrs[3]);
  a.diag = reinterpret_cast<const T*>(ptrs[4]);
  a.inv_d = reinterpret_cast<const T*>(ptrs[5]);
  a.bands = reinterpret_cast<const T*>(ptrs[6]);
  a.rest_cols = reinterpret_cast<const int*>(ptrs[7]);
  a.rest_vals = reinterpret_cast<const T*>(ptrs[8]);
  a.agg = reinterpret_cast<const int*>(ptrs[9]);
  a.agg_gather = reinterpret_cast<const int*>(ptrs[10]);
  a.coarse_inv = reinterpret_cast<const T*>(ptrs[11]);
  const int order[kVecs] = {V_X, V_R, V_P0, V_Z, V_AP, V_ZS, V_RES, V_P1};  // as ptrs 12-19
  for (int i = 0; i < kVecs; ++i) a.vec[order[i]] = reinterpret_cast<T*>(ptrs[12 + i]);
  a.RC = reinterpret_cast<T*>(ptrs[20]);
  a.EC = reinterpret_cast<T*>(ptrs[21]);
  a.parts = reinterpret_cast<T*>(ptrs[22]);
  a.bar = reinterpret_cast<Barrier*>(ptrs[23]);
  a.trips = reinterpret_cast<int*>(ptrs[24]);
  a.pn = reinterpret_cast<const T*>(ptrs[25]);
  a.inv3 = reinterpret_cast<const T*>(ptrs[26]);
  a.done = reinterpret_cast<const unsigned char*>(ptrs[27]);
  if ((a.pn == nullptr) != (a.inv3 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  a.dyn.mask = reinterpret_cast<const unsigned char*>(ptrs[28]);
  a.dyn.vidx = reinterpret_cast<const int64_t*>(ptrs[29]);
  a.dyn.face = reinterpret_cast<const int64_t*>(ptrs[30]);
  a.dyn.barys = reinterpret_cast<const T*>(ptrs[31]);
  a.dyn.normal = reinterpret_cast<const T*>(ptrs[32]);
  a.dyn.ck = reinterpret_cast<const T*>(ptrs[33]);
  a.dyn.order = reinterpret_cast<const int64_t*>(ptrs[34]);
  a.dyn.start = reinterpret_cast<const int64_t*>(ptrs[35]);
  a.dyn.slot = reinterpret_cast<const int*>(ptrs[36]);
  a.iperm = reinterpret_cast<const int64_t*>(ptrs[37]);
  a.RD = reinterpret_cast<T*>(ptrs[38]);
  a.dyn.h = ints[11];
  const bool dyn = a.dyn.mask != nullptr;
  if (dyn && (a.pn == nullptr || a.agg != nullptr || a.RD == nullptr || a.dyn.ck == nullptr ||
              a.dyn.order == nullptr || a.dyn.start == nullptr ||
              (a.perm != nullptr) != (a.iperm != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.n = ints[0];
  a.k_rest = ints[1];
  a.n_bands = ints[2];
  a.circular = ints[3];
  a.k_agg = ints[4];
  a.n_coarse = ints[5];
  a.max_iters = ints[6];
  const int cap = ints[7], form = ints[8], cluster = ints[9];
  a.shift = ints[10];
  a.tol = T(tol);
  a.omega = T(omega);
  if (a.n <= 0) return 0;
  if (a.n_bands < 0 || a.n_bands > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < kMaxBands; ++d) a.offs[d] = d < a.n_bands ? offs[d] : 0;
  a.n_chunks = (a.n + kGroup - 1) / kGroup;
  const bool pen = a.pn != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    // one cluster of `cluster` blocks of 2^shift threads covers every vertex
    if (a.shift < 8 || (1 << a.shift) > kClusterThreads || cluster < 1 ||
        cluster > kMaxCluster || ((int64_t)cluster << a.shift) < a.n)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dyn ? launch_cluster<T, true, true>(a, cluster, s)
                            : pen ? launch_cluster<T, true, false>(a, cluster, s)
                                  : launch_cluster<T, false, false>(a, cluster, s));
  }
  a.shift = 0;
  int grid = 0;
  const int rc = dyn   ? resident_blocks<T, true, true>(&grid)
                 : pen ? resident_blocks<T, true, false>(&grid)
                       : resident_blocks<T, false, false>(&grid);
  if (rc != 0) return rc;
  if (a.n_chunks < grid) grid = a.n_chunks;
  if (cap > 0 && cap < grid) grid = cap;  // a smaller grid (tools/g_h_anatomy.py)
  void* params[] = {&a};
  void* fn = dyn   ? reinterpret_cast<void*>(pcg_kernel<T, true, false, true>)
             : pen ? reinterpret_cast<void*>(pcg_kernel<T, true, false, false>)
                   : reinterpret_cast<void*>(pcg_kernel<T, false, false, false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kGroup), params, 0, s));
}

}  // namespace

extern "C" int admm_pcg_solve_f32(const uint64_t* ptrs, const int* ints, const int* offs,
                                  double tol, double omega, void* stream) {
  return launch<float>(ptrs, ints, offs, tol, omega, stream);
}

extern "C" int admm_pcg_solve_f64(const uint64_t* ptrs, const int* ints, const int* offs,
                                  double tol, double omega, void* stream) {
  return launch<double>(ptrs, ints, offs, tol, omega, stream);
}

// iters grid barriers on grid blocks of kGroup threads (bar: a zeroed Barrier).
extern "C" int admm_pcg_barrier_loop(int grid, int iters, void* bar, void* stream) {
  Barrier* b = static_cast<Barrier*>(bar);
  void* params[] = {&b, &iters};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_loop_kernel), dim3(grid), dim3(kGroup), params, 0,
      static_cast<cudaStream_t>(stream)));
}

// iters cluster barriers in one cluster of `cluster` blocks of `threads`
// threads with smem bytes of dynamic shared memory each.
extern "C" int admm_cluster_barrier_loop(int cluster, int threads, int smem, int iters,
                                         void* stream) {
  static int granted = -1;
  cudaError_t rc = allow_cluster(cluster_barrier_kernel, smem, &granted);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, iters));
}

// How many clusters of `cluster` blocks of `threads` threads, with smem
// bytes of dynamic shared memory each, the card can hold at once (minus a
// CUDA error code on failure).
extern "C" int admm_cluster_capacity(int cluster, int threads, int smem) {
  static int granted = -1;
  cudaError_t rc = allow_cluster(cluster_barrier_kernel, smem, &granted);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, threads, smem, nullptr, &attr);
  int n = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<void*>(cluster_barrier_kernel),
                                        &cfg);
  return rc == cudaSuccess ? n : -static_cast<int>(rc);
}

// The grid the GRID form takes for n vertices (0 on an error).
template <typename T>
int grid_of(int n) {
  int grid = 0;
  if (resident_blocks<T, false, false>(&grid) != 0) return 0;
  const int chunks = (n + kGroup - 1) / kGroup;
  return chunks < grid ? chunks : grid;
}

extern "C" int admm_pcg_grid_f32(int n) { return grid_of<float>(n); }
extern "C" int admm_pcg_grid_f64(int n) { return grid_of<double>(n); }
