// Kernel H: one nodal-constrained multicolour Gauss-Seidel solve per launch.
//
// It has no Pallas original. It replaces the jnp loop of
// admm_elastic_tpu/solvers/gs.py solve (:147-196) without dynamic rows
// (may_have_dyn=False): a lax.while_loop of SOR sweeps that stops on a device
// value. The port's timestep is one captured CUDA graph, where the host
// cannot branch, and as plain PyTorch a sweep would be some 15 launches per
// colour. The plain version is admm_elastic_tpu_torch/solvers/gs.py solve;
// chip_smoke.py holds this kernel to it (float64: the same sweeps, x within
// 1e-10).
//
// One sweep (the JAX package's color_update for each colour in turn, then
// residual2):
//   per vertex i of the colour:  lux = sum_k vals[i, k] x[cols[i, k]] (column
//     order, from 0); x_gs = (b_i - lux) / diag_i;
//     x_new = (1 - omega) x_i + omega x_gs;
//     the deepest obstacle at x_new (Floor, Sphere; the first of least
//     distance); where it is hit (distance < 0): delta = x_gs - p,
//     (u, v) = the tangent basis of its normal (orthoG: not_n = e_z where
//     n_x > 0.999, else e_x; u = not_n x n, v = n x u, each over
//     max(|.|, 1e-30)), x_new = u (u . delta) + v (v . delta) + p;
//     a pinned vertex takes its target; x_i = x_new
//   then |b - A x|^2 and the exit test |r|^2 < max(tol, 64 eps)^2 max(|b|^2, tiny).
// The vertices of one colour share no row of A, so each thread updates its
// own vertices in place and a barrier follows each colour. Every operation
// of the update is an IEEE-rounded intrinsic (no contraction into an fma), in
// the plain version's order, so on a Floor the kernel gives the plain
// version's x bit for bit; a norm (the Sphere's distance, the tangent basis)
// is summed here in component order and by torch.linalg.norm there, which
// moves a Sphere's contact by rounding. The two sums of squares (|b|^2 and
// the residual) are a fixed tree here and torch.sum there, which can move the
// exit test only where the residual is within rounding of the bound.
//
// Schedule: one block walks every colour; a barrier is a __syncthreads, some
// 30 sweeps x 5 colours a solve. Its bound is latency: a sweep is a chain of
// one dependent pass per colour and a residual pass; the bytes a sweep moves
// (the ELL once) take well under a microsecond at the card's memory rate.
// tools/g_h_anatomy.py split the parent's sweep on floor_gs5k (PERF.md): a
// pass's barrier 0.07 us, its ELL row sum 2.7 of its 4.6 us, the residual
// pass 8.4 us: the row sum is a chain of loads (each entry's column, then x
// at it) at L2 latency, the ELL (212 KB in float32) streaming from L2 into
// the one SM. So, with the same arithmetic in the same order:
// - WIDE block, where a colour is wider than 512 rows (floor_gs5k's 558):
//   1,024 threads, one row a thread a colour, and the ELL read per colour
//   slot, column-major ([C, K, L], built once per system by ops/cuda_gs.py),
//   so that a warp's loads of one entry of its 32 rows are one coalesced
//   read; the residual reads the ELL column-major in the vertex order
//   ([K, N]). Else 512 threads and the ELL by row, as the parent: at 45
//   vertices the ELL sits in L1 and the wider block only adds barrier cost;
// - SHARED form, where x fits the block's shared memory (N x 3 values): x is
//   loaded once, lives in shared memory for the whole solve and is written
//   once; GLOBAL form, for larger N: x in global memory (the block's own
//   writes, seen after __syncthreads). ops/cuda_gs.py chooses the form by N,
//   the dtype and the card's shared memory, and the block by the widest
//   colour;
// - the row's own values (diag, b, x, the pin) are loaded before its sum.
// Loading a row's entries into register arrays before the sum spilled and
// lost at every shape (PERF.md), and was dropped.
// The residual and |b|^2 keep the parent's lanes (thread t < 512 sums rows
// t, t + 512, ... in order) and its 512-thread tree, so the exit test takes
// the same bits and the sweeps are the same. b and the pins come through the
// read-only path. The sweeps taken are added to a device counter (Solver's
// inner iterations). No atomics.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

// Anatomy builds (tools/g_h_anatomy.py), each with the exit test ignored so
// that a solve takes max_iters sweeps: ADMM_H_ANATOMY=1 passes with no row
// work (the __syncthreads chain alone), 2 passes with the ELL row sum alone,
// 3 the full passes without the residual, 4 the residual alone. The shipped
// build is 0.
#ifndef ADMM_H_ANATOMY
#define ADMM_H_ANATOMY 0
#endif

namespace {

constexpr int kAnatomy = ADMM_H_ANATOMY;
// A WIDE block (for colours wider than kLanes rows): 1,024 threads, the ELL
// read per colour slot; else 512 threads, the ELL read by row.
template <bool WIDE>
constexpr int kThreads = WIDE ? 1024 : 512;
constexpr int kLanes = 512;  // the lanes of the residual's and |b|^2's sums (the parent's block)
constexpr int kLaneWarps = kLanes / 32;
constexpr int kMaxObstacles = 8;
enum Kind { FLOOR = 0, SPHERE = 1 };

// IEEE-rounded operations: nvcc would contract a * b + c into an fma, which
// the plain version's separate tensor operations do not.
template <typename T> struct Op;
template <> struct Op<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float eps() { return FLT_EPSILON; }
};
template <> struct Op<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double eps() { return DBL_EPSILON; }
};

template <typename T>
struct Args {
  const int* ell_cols;          // [N, K] off-diagonal columns (pad: column 0, value 0)
  const T* ell_vals;            // [N, K]
  const int* ccols;             // [C, K, L] the same per colour slot, column-major
  const T* cvals;               // [C, K, L]
  const int* tcols;             // [K, N] the same column-major in the vertex order
  const T* tvals;               // [K, N]
  const T* diag;                // [N]
  const int* groups;            // [C, L] vertices of each colour, padded with N
  const T* b;                   // [N, 3]
  const T* x0;                  // [N, 3]
  T* x;                         // [N, 3] out: starts as x0, updated in place
  const unsigned char* pinned;  // [N] bool
  const T* pin_target;          // [N, 3]
  int* sweeps;                  // += the sweeps of this solve
  int n, k, n_colors, width, max_iters, n_obs;
  T omega, tol;
  int kind[kMaxObstacles];
  T par[kMaxObstacles][4];  // Floor: y; Sphere: centre x, y, z, radius
};

// The sum of v over the first kLanes threads in a fixed tree (any others
// hold 0 and take no part); every thread gets it.
template <typename T>
__device__ __forceinline__ T lane_sum(T v, T* sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0 && w < kLaneWarps) sm[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < kLaneWarps ? sm[lane] : T(0);
#pragma unroll
    for (int off = kLaneWarps / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sm[kLaneWarps] = v;
  }
  __syncthreads();
  const T out = sm[kLaneWarps];
  __syncthreads();
  return out;
}

// x: in global memory (GLOBAL) or in the block's shared memory (SHARED).
template <typename T, bool SH>
struct XMem {
  T* v;
  __device__ __forceinline__ T operator[](int64_t i) const { return v[i]; }
  __device__ __forceinline__ void set(int64_t i, T x) const { v[i] = x; }
};

// sum_k vals[row, k] x[cols[row, k]] (column order, from 0) of the row whose
// entry k is at cols[k * stride] and vals[k * stride]; IEEE-rounded for the
// update (RN), as the parent's residual wrote it otherwise (a contracted
// fma).
template <typename T, bool RN, bool SH>
__device__ __forceinline__ void row_sum(const Args<T>& a, const XMem<T, SH>& x, const int* cols,
                                        const T* vals, int64_t stride, T lux[3]) {
  using O = Op<T>;
  lux[0] = lux[1] = lux[2] = T(0);
  for (int kk = 0; kk < a.k; ++kk) {
    const T v = __ldg(vals + kk * stride);
    const int64_t c = (int64_t)__ldg(cols + kk * stride) * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if constexpr (RN)
        lux[r] = O::add(lux[r], O::mul(v, x[c + r]));
      else
        lux[r] += v * x[c + r];
    }
  }
}

template <typename T>
__device__ __forceinline__ T norm3(const T u[3]) {
  using O = Op<T>;
  return O::sqrt(O::add(O::add(O::mul(u[0], u[0]), O::mul(u[1], u[1])), O::mul(u[2], u[2])));
}

// torch.clamp_min(d, 1e-30): NaN stays NaN
template <typename T>
__device__ __forceinline__ T floor30(T d) {
  return d < T(1e-30) ? T(1e-30) : d;
}

// a x b, as the plain _cross forms it
template <typename T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T out[3]) {
  using O = Op<T>;
  out[0] = O::sub(O::mul(a[1], b[2]), O::mul(a[2], b[1]));
  out[1] = O::sub(O::mul(a[2], b[0]), O::mul(a[0], b[2]));
  out[2] = O::sub(O::mul(a[0], b[1]), O::mul(a[1], b[0]));
}

template <typename T>
__device__ __forceinline__ T dot3(const T a[3], const T b[3]) {
  using O = Op<T>;
  return O::add(O::add(O::mul(a[0], b[0]), O::mul(a[1], b[1])), O::mul(a[2], b[2]));
}

// The signed distance, surface point and normal of obstacle o at x.
template <typename T>
__device__ __forceinline__ T signed_distance(const Args<T>& a, int o, const T x[3], T p[3],
                                             T nrm[3]) {
  using O = Op<T>;
  const T* q = a.par[o];
  if (a.kind[o] == FLOOR) {
    p[0] = x[0];
    p[1] = q[0];
    p[2] = x[2];
    nrm[0] = T(0);
    nrm[1] = T(1);
    nrm[2] = T(0);
    return O::sub(x[1], q[0]);
  }
  T dir[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) dir[r] = O::sub(x[r], q[r]);
  const T dist = norm3(dir);
  const T den = floor30(dist);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    nrm[r] = O::div(dir[r], den);
    p[r] = O::add(q[r], O::mul(nrm[r], q[3]));
  }
  return O::sub(dist, q[3]);
}

// One vertex's update of its colour's pass: colour c's slot i, vertex row.
template <typename T, bool SH, bool WIDE>
__device__ __forceinline__ void update_row(const Args<T>& a, const XMem<T, SH>& x, int c, int i,
                                           int row, T one_m) {
  using O = Op<T>;
  // the row's own values first: their loads overlap the sum's
  const T aii = __ldg(a.diag + row);
  const bool pinned = __ldg(a.pinned + row);
  T bi[3], xi[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    bi[r] = __ldg(a.b + row * 3 + r);
    xi[r] = x[row * 3 + r];
  }
  T lux[3];
  if constexpr (WIDE) {
    const int64_t slot = (int64_t)c * a.k * a.width + i;
    row_sum<T, true, SH>(a, x, a.ccols + slot, a.cvals + slot, a.width, lux);
  } else {
    const int64_t e0 = (int64_t)row * a.k;
    row_sum<T, true, SH>(a, x, a.ell_cols + e0, a.ell_vals + e0, 1, lux);
  }
  T xg[3], xn[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xg[r] = O::div(O::sub(bi[r], lux[r]), aii);
    xn[r] = O::add(O::mul(one_m, xi[r]), O::mul(a.omega, xg[r]));
  }
  if (a.n_obs > 0) {
    T p[3], nrm[3];
    T best = signed_distance(a, 0, xn, p, nrm);
    for (int o = 1; o < a.n_obs; ++o) {
      T po[3], no[3];
      const T d = signed_distance(a, o, xn, po, no);
      if (d < best) {  // the first of least distance, as argmin
        best = d;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          p[r] = po[r];
          nrm[r] = no[r];
        }
      }
    }
    if (best < T(0)) {
      T delta[3], u[3], v[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) delta[r] = O::sub(xg[r], p[r]);
      const T not_n[3] = {nrm[0] > T(0.999) ? T(0) : T(1), T(0), nrm[0] > T(0.999) ? T(1) : T(0)};
      cross(not_n, nrm, u);
      T nu = floor30(norm3(u));
#pragma unroll
      for (int r = 0; r < 3; ++r) u[r] = O::div(u[r], nu);
      cross(nrm, u, v);
      nu = floor30(norm3(v));
#pragma unroll
      for (int r = 0; r < 3; ++r) v[r] = O::div(v[r], nu);
      const T du = dot3(u, delta), dv = dot3(v, delta);
#pragma unroll
      for (int r = 0; r < 3; ++r) xn[r] = O::add(O::add(O::mul(u[r], du), O::mul(v[r], dv)), p[r]);
    }
  }
  if (pinned) {
#pragma unroll
    for (int r = 0; r < 3; ++r) xn[r] = __ldg(a.pin_target + row * 3 + r);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) x.set(row * 3 + r, xn[r]);
}

template <typename T, bool SH, bool WIDE>
__global__ void __launch_bounds__(kThreads<WIDE>) gs_kernel(const __grid_constant__ Args<T> a) {
  constexpr int threads = kThreads<WIDE>;
  using O = Op<T>;
  __shared__ T sm[kLaneWarps + 1];
  extern __shared__ __align__(16) unsigned char dyn[];
  const XMem<T, SH> x{SH ? reinterpret_cast<T*>(dyn) : a.x};
  const int n = a.n, tid = threadIdx.x;
  T bb = T(0);
  for (int i = tid; i < n; i += threads)  // x = x0
#pragma unroll
    for (int r = 0; r < 3; ++r) x.set(i * 3 + r, a.x0[i * 3 + r]);
  if (tid < kLanes)
    for (int i = tid; i < n; i += kLanes)
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T bi = __ldg(a.b + i * 3 + r);
        bb += bi * bi;
      }
  bb = lane_sum(bb, sm);  // its barriers also publish x
  const T tol = a.tol < T(64) * O::eps() ? T(64) * O::eps() : a.tol;
  const T tol2 = tol * tol * (bb < O::tiny() ? O::tiny() : bb);
  const T one_m = O::sub(T(1), a.omega);
  int k = 0;
  bool done = false;
  while (!done && k < a.max_iters) {
    for (int c = 0; kAnatomy != 4 && c < a.n_colors; ++c) {
      for (int i = tid; kAnatomy != 1 && i < a.width; i += threads) {
        const int row = __ldg(a.groups + (int64_t)c * a.width + i);
        if (row >= n) continue;
        if (kAnatomy == 2) {
          const int64_t slot = (int64_t)c * a.k * a.width + i, e0 = (int64_t)row * a.k;
          T lux[3];
          if constexpr (WIDE)
            row_sum<T, true, SH>(a, x, a.ccols + slot, a.cvals + slot, a.width, lux);
          else
            row_sum<T, true, SH>(a, x, a.ell_cols + e0, a.ell_vals + e0, 1, lux);
          if (lux[0] == T(-12345.5)) x.set(row * 3, lux[1]);  // keeps the sum
        } else {
          update_row<T, SH, WIDE>(a, x, c, i, row, one_m);
        }
      }
      __syncthreads();
    }
    if (kAnatomy != 0 && kAnatomy != 4) {
      ++k;
      continue;
    }
    T rr = T(0);  // |b - A x|^2
    for (int i = tid; tid < kLanes && i < n; i += kLanes) {
      const T d = __ldg(a.diag + i);
      T bi[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) bi[r] = __ldg(a.b + i * 3 + r);
      T lux[3];
      if constexpr (WIDE)
        row_sum<T, false, SH>(a, x, a.tcols + i, a.tvals + i, n, lux);
      else
        row_sum<T, false, SH>(a, x, a.ell_cols + (int64_t)i * a.k, a.ell_vals + (int64_t)i * a.k, 1,
                              lux);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T res = bi[r] - (d * x[i * 3 + r] + lux[r]);
        rr += res * res;
      }
    }
    rr = lane_sum(rr, sm);
    done = kAnatomy == 0 && rr < tol2;
    ++k;
  }
  if (SH)
    for (int i = tid; i < n; i += threads)  // x out, once
#pragma unroll
      for (int r = 0; r < 3; ++r) a.x[i * 3 + r] = x[i * 3 + r];
  if (tid == 0) *a.sweeps += k;
}

template <typename T, bool WIDE>
cudaError_t launch_form(const Args<T>& a, bool shared, cudaStream_t s) {
  if (shared) {
    static int granted = 0;  // the dynamic shared memory allowed so far
    const int smem = static_cast<int>(a.n * 3 * sizeof(T));
    if (smem > granted) {
      const cudaError_t rc = cudaFuncSetAttribute(
          gs_kernel<T, true, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return rc;
      granted = smem;
    }
    gs_kernel<T, true, WIDE><<<1, kThreads<WIDE>, smem, s>>>(a);
  } else {
    gs_kernel<T, false, WIDE><<<1, kThreads<WIDE>, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// ptrs: ell_cols, ell_vals, ccols, cvals, tcols, tvals, diag, groups, b, x0,
// x, pinned, pin_target, sweeps; ints: n, k, n_colors, width, max_iters, form (0 GLOBAL,
// 1 SHARED), n_obs, kind[n_obs]; par: [n_obs, 4].
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, const double* par, double omega, double tol,
           void* stream) {
  Args<T> a;
  a.ell_cols = reinterpret_cast<const int*>(ptrs[0]);
  a.ell_vals = reinterpret_cast<const T*>(ptrs[1]);
  a.ccols = reinterpret_cast<const int*>(ptrs[2]);
  a.cvals = reinterpret_cast<const T*>(ptrs[3]);
  a.tcols = reinterpret_cast<const int*>(ptrs[4]);
  a.tvals = reinterpret_cast<const T*>(ptrs[5]);
  a.diag = reinterpret_cast<const T*>(ptrs[6]);
  a.groups = reinterpret_cast<const int*>(ptrs[7]);
  a.b = reinterpret_cast<const T*>(ptrs[8]);
  a.x0 = reinterpret_cast<const T*>(ptrs[9]);
  a.x = reinterpret_cast<T*>(ptrs[10]);
  a.pinned = reinterpret_cast<const unsigned char*>(ptrs[11]);
  a.pin_target = reinterpret_cast<const T*>(ptrs[12]);
  a.sweeps = reinterpret_cast<int*>(ptrs[13]);
  a.n = ints[0];
  a.k = ints[1];
  a.n_colors = ints[2];
  a.width = ints[3];
  a.max_iters = ints[4];
  const bool shared = (ints[5] & 1) != 0, wide = (ints[5] & 2) != 0;
  a.n_obs = ints[6];
  a.omega = T(omega);
  a.tol = T(tol);
  if (a.n <= 0) return 0;
  if (a.n_obs < 0 || a.n_obs > kMaxObstacles) return static_cast<int>(cudaErrorInvalidValue);
  for (int o = 0; o < kMaxObstacles; ++o) {
    a.kind[o] = o < a.n_obs ? ints[7 + o] : FLOOR;
    for (int q = 0; q < 4; ++q) a.par[o][q] = o < a.n_obs ? T(par[o * 4 + q]) : T(0);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(wide ? launch_form<T, true>(a, shared, s)
                               : launch_form<T, false>(a, shared, s));
}

}  // namespace

extern "C" int admm_gs_solve_f32(const uint64_t* ptrs, const int* ints, const double* par,
                                 double omega, double tol, void* stream) {
  return launch<float>(ptrs, ints, par, omega, tol, stream);
}

extern "C" int admm_gs_solve_f64(const uint64_t* ptrs, const int* ints, const double* par,
                                 double omega, double tol, void* stream) {
  return launch<double>(ptrs, ints, par, omega, tol, stream);
}

// The shared memory a block may take on the current card, in bytes, static
// and dynamic together (0 on an error).
extern "C" int admm_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return optin;
}
