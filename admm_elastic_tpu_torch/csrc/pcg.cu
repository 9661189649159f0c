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
// Schedule: persistent blocks of 256 threads, at most as many as can be
// resident together (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) and
// at most one per 256-vertex chunk; a block walks chunks b, b + grid, ...,
// a thread one vertex (its three components) of a chunk, the same vertex in
// every phase. A grid-wide barrier (grid_sync: integer atomics with acquire
// and release order, no float atomic anywhere) follows each phase whose
// output other blocks read: two per Jacobi trip (after A p and its dot, after
// the update and its dots), seven per two-grid trip. p = z + beta p needs no
// phase of its own: the apply forms p of each neighbour from z and the last
// p as it reads them (one fma, the same bits wherever it is formed), and each
// thread keeps its own vertex's p in a second buffer for the next trip.
// Dots: each chunk's partial is a fixed shuffle tree over its 256 vertices,
// written once; after the barrier every block sums all partials the same way
// (a strided sum per thread, then the tree), so every block holds the same
// bits, takes the same branch, and the dots and the trip count are the same
// in every run, whatever the grid size. Data that other blocks wrote in this
// launch is read with __ldcg (L2, not the SM's own L1).
//
// Launched cooperatively (cudaLaunchCooperativeKernel): the runtime refuses a
// grid that cannot be resident at once, which the barrier needs, and a
// cooperative launch captures into the step's CUDA graph.
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
// done (null, or a flag on the device): where it is set when the kernel
// starts, the solve takes no trip and returns x0. Uzawa's Schur trips, all
// in the captured step and predicated on that flag, skip their inner solve
// by it (solvers/uzawa.py).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads per block = vertices per chunk
constexpr int kWarps = kBlock / 32;
constexpr int kMaxBands = 64;  // ops/spmv.plan_bands keeps at most 64
enum Slot { S_PAP = 0, S_RZ = 1, S_RR = 2, S_BB = 3, kSlots = 4 };

template <typename T> struct Fl;
template <> struct Fl<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Fl<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

// The arrivals and the generation sit on cache lines of their own: the
// blocks that wait read the generation while the others add to the count.
struct Barrier {
  unsigned count;  // blocks arrived at the current barrier; 0 between barriers
  unsigned pad[31];
  unsigned gen;    // barriers completed
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
  T* X;                    // scratch [N, 3] each
  T* R;
  T* P;
  T* Z;
  T* AP;
  T* Z2;
  T* RES;
  T* P2;                   // p of the trip after this one
  T* RC;                   // scratch [n_coarse, 3] each
  T* EC;
  T* parts;                // scratch [kSlots, n_chunks]
  Barrier* bar;            // zero before the first launch; left zero by every launch
  int* trips;              // null, or += the trips of this solve
  int n, n_chunks, k_rest, n_bands, circular, k_agg, n_coarse, max_iters;
  T tol, omega;
  int offs[kMaxBands];
};

// Every block arrives, then leaves together; the last to arrive resets the
// count and opens the next generation. Memory order (PTX, device scope): the
// block's writes are ordered before thread 0's arrival by __syncthreads, the
// arrival releases them (an acq_rel add on the count, whose sequence of adds
// the last arrival acquires), the last arrival releases the next generation,
// and the waiting thread 0s acquire it before __syncthreads lets their blocks
// read: the pattern of CUTLASS's GenericBarrier, with no full fence. A block
// that waits more than kBarrierCycles (about 2 s) traps: the launch fails with
// an error instead of hanging, should the grid ever not be resident at once.
constexpr long long kBarrierCycles = 1ll << 32;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void grid_sync(Barrier* bar, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = ld_acquire(&bar->gen);
    if (add_acq_rel(&bar->count, 1u) == nb - 1) {
      st_relaxed(&bar->count, 0u);
      add_release(&bar->gen, 1u);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(&bar->gen) == g) {
        if (clock64() - t0 > kBarrierCycles) __trap();
      }
    }
  }
  __syncthreads();
}

// K sums over the block in a fixed tree: shuffles within each warp, then over
// the warps' sums in warp 0. The result is in thread 0's v.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T v[K], T* sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sm[w * K + k] = v[k];
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = lane < kWarps ? sm[lane * K + k] : T(0);
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1)
        v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    }
  }
  __syncthreads();
}

// Write this chunk's partial sums to their slots (thread 0 holds them).
template <typename T, int K>
__device__ __forceinline__ void put_parts(const Args<T>& a, int chunk, const int (&slot)[K],
                                          T v[K], T* sm) {
  block_sum<T, K>(v, sm);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) a.parts[slot[k] * a.n_chunks + chunk] = v[k];
}

// The totals of K slots over all chunks, the same bits in every block.
template <typename T, int K>
__device__ __forceinline__ void totals(const Args<T>& a, const int (&slot)[K], T out[K], T* sm,
                                       T* bc) {
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = T(0);
    for (int c = threadIdx.x; c < a.n_chunks; c += kBlock)
      v[k] += __ldcg(a.parts + slot[k] * a.n_chunks + c);
  }
  block_sum<T, K>(v, sm);
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) bc[k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = bc[k];
  __syncthreads();
}

// A vector the apply reads: a buffer written earlier in this launch.
template <typename T>
struct Vec {
  const T* v;
  __device__ __forceinline__ T operator()(int64_t i) const { return __ldcg(v + i); }
};

// p = z + beta p_old of the coming trip, formed where it is read (the first
// trip's p is z).
template <typename T>
struct PVec {
  const T* z;
  const T* p_old;
  T beta;
  bool first;
  __device__ __forceinline__ T operator()(int64_t i) const {
    const T zi = __ldcg(z + i);
    return first ? zi : fma(beta, __ldcg(p_old + i), zi);
  }
};

// (A v)[j] for one vertex of the banded order: diag, bands, rest-ELL; with
// PEN, + pn_j (pn_j . v_j).
template <typename T, bool PEN, typename V>
__device__ __forceinline__ void spmv(const Args<T>& a, const V& v, int j, T out[3]) {
  const int n = a.n;
  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
  // Unrolled so that the loads of several bands are in flight at once; the
  // sums stay in band order.
#pragma unroll 4
  for (int d = 0; d < a.n_bands; ++d) {
    int q = j + a.offs[d];
    if (a.circular) {
      q = q < 0 ? q + n : (q >= n ? q - n : q);
    } else if (q < 0 || q >= n) {
      continue;
    }
    const T bd = __ldg(a.bands + (int64_t)d * n + j);
    const int64_t vq = (int64_t)q * 3;
    acc0 += bd * v(vq);
    acc1 += bd * v(vq + 1);
    acc2 += bd * v(vq + 2);
  }
#pragma unroll 4
  for (int k = 0; k < a.k_rest; ++k) {
    const int64_t e = (int64_t)k * n + j;
    const T val = __ldg(a.rest_vals + e);
    const int64_t vq = (int64_t)__ldg(a.rest_cols + e) * 3;
    acc0 += val * v(vq);
    acc1 += val * v(vq + 1);
    acc2 += val * v(vq + 2);
  }
  const T dj = __ldg(a.diag + j);
  const int64_t vj = (int64_t)j * 3;
  out[0] = dj * v(vj) + acc0;
  out[1] = dj * v(vj + 1) + acc1;
  out[2] = dj * v(vj + 2) + acc2;
  if constexpr (PEN) {
    const T p0 = __ldg(a.pn + vj), p1 = __ldg(a.pn + vj + 1), p2 = __ldg(a.pn + vj + 2);
    const T cx = p0 * v(vj) + p1 * v(vj + 1) + p2 * v(vj + 2);
    out[0] += p0 * cx;
    out[1] += p1 * cx;
    out[2] += p2 * cx;
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

// The two-grid V-cycle after z = omega d^-1 r is in Z (and a barrier): the
// coarse correction and the second smoothing leave M^-1 r in Z and the
// partials of r.z and r.r in their slots, then a barrier.
template <typename T, bool PEN>
__device__ void two_grid(const Args<T>& a, T* sm, unsigned nb) {
  const int n = a.n;
  const T omega = a.omega;
  for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // res = r - A z
    const int j = c * kBlock + threadIdx.x;
    if (j < n) {
      T az[3];
      spmv<T, PEN>(a, Vec<T>{a.Z}, j, az);
#pragma unroll
      for (int r = 0; r < 3; ++r) a.RES[j * 3 + r] = __ldcg(a.R + j * 3 + r) - az[r];
    }
  }
  grid_sync(a.bar, nb);
  const int gid = blockIdx.x * kBlock + threadIdx.x, gsize = nb * kBlock;
  for (int c = gid; c < a.n_coarse; c += gsize) {  // rc = P^T res, in table order
    T acc[3] = {T(0), T(0), T(0)};
    for (int e = 0; e < a.k_agg; ++e) {
      const int v = __ldg(a.agg_gather + (int64_t)c * a.k_agg + e);
      if (v >= n) continue;
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[r] += __ldcg(a.RES + (int64_t)v * 3 + r);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) a.RC[c * 3 + r] = acc[r];
  }
  grid_sync(a.bar, nb);
  const int lane = threadIdx.x & 31;
  for (int row = gid >> 5; row < a.n_coarse; row += gsize >> 5) {  // ec = coarse_inv rc
    T acc[3] = {T(0), T(0), T(0)};
    const T* ci = a.coarse_inv + (int64_t)row * a.n_coarse;
    for (int k = lane; k < a.n_coarse; k += 32) {
      const T w = __ldg(ci + k);
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[r] += w * __ldcg(a.RC + k * 3 + r);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 3; ++r) a.EC[row * 3 + r] = acc[r];
  }
  grid_sync(a.bar, nb);
  for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // z += ec[agg]
    const int j = c * kBlock + threadIdx.x;
    if (j < n) {
      const int g = __ldg(a.agg + j);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        a.Z2[j * 3 + r] = __ldcg(a.Z + j * 3 + r) + __ldcg(a.EC + g * 3 + r);
    }
  }
  grid_sync(a.bar, nb);
  const int slots[2] = {S_RZ, S_RR};
  for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // z += omega d^-1 (r - A z)
    const int j = c * kBlock + threadIdx.x;
    T v[2] = {T(0), T(0)};
    if (j < n) {
      T az[3], id[3];
      spmv<T, PEN>(a, Vec<T>{a.Z2}, j, az);
      inv_of<T, PEN>(a, j, id);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T w = omega * id[r];
        const T rr = __ldcg(a.R + j * 3 + r);
        const T z = __ldcg(a.Z2 + j * 3 + r) + w * (rr - az[r]);
        a.Z[j * 3 + r] = z;
        v[0] += rr * z;
        v[1] += rr * rr;
      }
    }
    put_parts<T, 2>(a, c, slots, v, sm);
  }
  grid_sync(a.bar, nb);
}

template <typename T, bool PEN>
__global__ void __launch_bounds__(kBlock) pcg_kernel(const __grid_constant__ Args<T> a) {
  __shared__ T sm[kWarps * 3];
  __shared__ T bc[3];
  const unsigned nb = gridDim.x;
  const int n = a.n;
  const bool two = a.agg != nullptr;
  const T tiny = Fl<T>::tiny();

  if (a.done != nullptr && *a.done) {  // no solve: x = x0, no trip
    for (int c = blockIdx.x; c < a.n_chunks; c += nb) {
      const int j = c * kBlock + threadIdx.x;
      if (j < n)
#pragma unroll
        for (int r = 0; r < 3; ++r) a.x_out[j * 3 + r] = a.x0[j * 3 + r];
    }
    return;
  }

  // x = x0 in the banded order; without a permutation the first apply reads
  // x0 itself and x is written beside it, with no barrier in between.
  Vec<T> x_first{a.x0};
  if (a.perm) {
    for (int c = blockIdx.x; c < a.n_chunks; c += nb) {
      const int j = c * kBlock + threadIdx.x;
      if (j < n)
#pragma unroll
        for (int r = 0; r < 3; ++r) a.X[j * 3 + r] = a.x0[a.perm[j] * 3 + r];
    }
    grid_sync(a.bar, nb);
    x_first.v = a.X;
  }
  {
    const int slots[3] = {S_BB, S_RZ, S_RR};
    for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // r = b - A x; z = M^-1 r (Jacobi)
      const int j = c * kBlock + threadIdx.x;
      T v[3] = {T(0), T(0), T(0)};
      if (j < n) {
        const int64_t src = a.perm ? a.perm[j] : j;
        T ax[3], id[3];
        spmv<T, PEN>(a, x_first, j, ax);
        if (!a.perm)
#pragma unroll
          for (int r = 0; r < 3; ++r) a.X[j * 3 + r] = a.x0[j * 3 + r];
        inv_of<T, PEN>(a, j, id);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const T bj = a.b[src * 3 + r];
          const T rr = bj - ax[r];
          a.R[j * 3 + r] = rr;
          if (two) {
            a.Z[j * 3 + r] = (a.omega * id[r]) * rr;
          } else {
            const T z = id[r] * rr;
            a.Z[j * 3 + r] = z;
            v[1] += rr * z;
          }
          v[0] += bj * bj;
          v[2] += rr * rr;
        }
      }
      put_parts<T, 3>(a, c, slots, v, sm);
    }
    grid_sync(a.bar, nb);
  }
  if (two) two_grid<T, PEN>(a, sm, nb);
  T t0[3];
  {
    const int slots[3] = {S_BB, S_RZ, S_RR};
    totals<T, 3>(a, slots, t0, sm, bc);
  }
  const T bb = t0[0];
  T rz = t0[1];
  T tol = a.tol < T(64) * Fl<T>::eps() ? T(64) * Fl<T>::eps() : a.tol;
  const T tol2 = tol * tol * (bb < tiny ? tiny : bb);
  bool done = t0[2] < tol2;
  int k = 0;
  T beta = T(0);
  T* p_old = a.P;  // p of the last trip
  T* p_new = a.P2;  // p of this trip
  while (!done && k < a.max_iters) {
    {
      const int slots[1] = {S_PAP};
      const PVec<T> pv{a.Z, p_old, beta, k == 0};
      for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // p = z + beta p; Ap = A p
        const int j = c * kBlock + threadIdx.x;
        T v[1] = {T(0)};
        if (j < n) {
          T ap[3];
          spmv<T, PEN>(a, pv, j, ap);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const T p = pv((int64_t)j * 3 + r);
            p_new[j * 3 + r] = p;
            a.AP[j * 3 + r] = ap[r];
            v[0] += p * ap[r];
          }
        }
        put_parts<T, 1>(a, c, slots, v, sm);
      }
    }
    grid_sync(a.bar, nb);
    T pap[1];
    {
      const int slots[1] = {S_PAP};
      totals<T, 1>(a, slots, pap, sm, bc);
    }
    const T alpha = rz / (fabs(pap[0]) < tiny ? T(1) : pap[0]);
    {
      const int slots[2] = {S_RZ, S_RR};
      for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // x, r; z = M^-1 r
        const int j = c * kBlock + threadIdx.x;
        T v[2] = {T(0), T(0)};
        if (j < n) {
          T id[3];
          inv_of<T, PEN>(a, j, id);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const int i = j * 3 + r;
            const T p = p_new[i];  // this thread's own, from the phase above
            a.X[i] = __ldcg(a.X + i) + alpha * p;
            const T rr = __ldcg(a.R + i) - alpha * __ldcg(a.AP + i);
            a.R[i] = rr;
            if (two) {
              a.Z[i] = (a.omega * id[r]) * rr;
            } else {
              const T z = id[r] * rr;
              a.Z[i] = z;
              v[0] += rr * z;
              v[1] += rr * rr;
            }
          }
        }
        if (!two) put_parts<T, 2>(a, c, slots, v, sm);
      }
    }
    grid_sync(a.bar, nb);
    if (two) two_grid<T, PEN>(a, sm, nb);
    T t[2];
    {
      const int slots[2] = {S_RZ, S_RR};
      totals<T, 2>(a, slots, t, sm, bc);
    }
    beta = t[0] / (fabs(rz) < tiny ? T(1) : rz);
    done = t[1] < tol2;
    rz = t[0];
    ++k;
    T* swap = p_old;
    p_old = p_new;
    p_new = swap;
  }
  for (int c = blockIdx.x; c < a.n_chunks; c += nb) {  // x back in the vertex order
    const int j = c * kBlock + threadIdx.x;
    if (j < n) {
      const int64_t dst = a.perm ? a.perm[j] : j;
#pragma unroll
      for (int r = 0; r < 3; ++r) a.x_out[dst * 3 + r] = __ldcg(a.X + j * 3 + r);
    }
  }
  if (a.trips != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *a.trips += k;
}

// The grid: as many blocks as can be resident at once, at most one per chunk.
template <typename T, bool PEN>
int grid_for(int n_chunks, int* grid) {
  static int resident = 0;  // per precision and form, for the current device
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel<T, PEN>, kBlock, 0);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = per_sm * sms;
  }
  *grid = n_chunks < resident ? n_chunks : resident;
  return 0;
}

// ptrs: b, x0, x_out, perm, diag, inv_d, bands, rest_cols, rest_vals, agg,
// agg_gather, coarse_inv, X, R, P, Z, AP, Z2, RES, P2, RC, EC, parts, bar,
// trips, pn, inv3, done (null where absent; pn and inv3 both or neither: the
// penalty form); ints: n, k_rest, n_bands, circular, k_agg, n_coarse,
// max_iters; offs: the band offsets.
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
  T** scratch[] = {&a.X,   &a.R,  &a.P,  &a.Z,  &a.AP,   &a.Z2,
                   &a.RES, &a.P2, &a.RC, &a.EC, &a.parts};
  for (int i = 0; i < 11; ++i) *scratch[i] = reinterpret_cast<T*>(ptrs[12 + i]);
  a.bar = reinterpret_cast<Barrier*>(ptrs[23]);
  a.trips = reinterpret_cast<int*>(ptrs[24]);
  a.pn = reinterpret_cast<const T*>(ptrs[25]);
  a.inv3 = reinterpret_cast<const T*>(ptrs[26]);
  a.done = reinterpret_cast<const unsigned char*>(ptrs[27]);
  if ((a.pn == nullptr) != (a.inv3 == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  a.n = ints[0];
  a.k_rest = ints[1];
  a.n_bands = ints[2];
  a.circular = ints[3];
  a.k_agg = ints[4];
  a.n_coarse = ints[5];
  a.max_iters = ints[6];
  a.tol = T(tol);
  a.omega = T(omega);
  if (a.n <= 0) return 0;
  if (a.n_bands < 0 || a.n_bands > kMaxBands) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < kMaxBands; ++d) a.offs[d] = d < a.n_bands ? offs[d] : 0;
  a.n_chunks = (a.n + kBlock - 1) / kBlock;
  const bool pen = a.pn != nullptr;
  int grid = 0;
  const int rc = pen ? grid_for<T, true>(a.n_chunks, &grid) : grid_for<T, false>(a.n_chunks, &grid);
  if (rc != 0) return rc;
  void* params[] = {&a};
  void* fn = pen ? reinterpret_cast<void*>(pcg_kernel<T, true>)
                 : reinterpret_cast<void*>(pcg_kernel<T, false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kBlock), params, 0,
                                                      static_cast<cudaStream_t>(stream)));
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

// The grid kernel G takes for n vertices (0 on an error).
extern "C" int admm_pcg_grid_f32(int n) {
  int grid = 0;
  return grid_for<float, false>((n + kBlock - 1) / kBlock, &grid) == 0 ? grid : 0;
}

extern "C" int admm_pcg_grid_f64(int n) {
  int grid = 0;
  return grid_for<double, false>((n + kBlock - 1) / kBlock, &grid) == 0 ? grid : 0;
}
