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
// Schedule: one block of 512 threads walks every colour (the paths' meshes,
// 45 to 1,476 vertices in 6 to 12 colours of at most a few hundred, and any
// larger one by looping); a barrier is a __syncthreads, some 30 sweeps x
// 10 colours a solve. Its bound is latency: a sweep is a chain of one
// dependent pass per colour; the bytes a sweep moves (the ELL once) take well
// under a microsecond at the card's memory rate. x stays in global memory (the
// block's own writes, seen after __syncthreads); the ELL, b and the pins
// through the read-only path. The sweeps taken are added to a device counter
// (Solver's inner iterations). No atomics.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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

// The sum of v over the block in a fixed tree; every thread gets it.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) sm[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < kWarps ? sm[lane] : T(0);
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) sm[kWarps] = v;
  }
  __syncthreads();
  const T out = sm[kWarps];
  __syncthreads();
  return out;
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

// One vertex's update of its colour's pass.
template <typename T>
__device__ __forceinline__ void update_row(const Args<T>& a, int row, T one_m) {
  using O = Op<T>;
  T lux[3] = {T(0), T(0), T(0)};
  const int64_t e0 = (int64_t)row * a.k;
  for (int kk = 0; kk < a.k; ++kk) {
    const T val = __ldg(a.ell_vals + e0 + kk);
    const int64_t c = (int64_t)__ldg(a.ell_cols + e0 + kk) * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) lux[r] = O::add(lux[r], O::mul(val, a.x[c + r]));
  }
  const T aii = __ldg(a.diag + row);
  T xg[3], xn[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xg[r] = O::div(O::sub(__ldg(a.b + row * 3 + r), lux[r]), aii);
    xn[r] = O::add(O::mul(one_m, a.x[row * 3 + r]), O::mul(a.omega, xg[r]));
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
  if (__ldg(a.pinned + row)) {
#pragma unroll
    for (int r = 0; r < 3; ++r) xn[r] = __ldg(a.pin_target + row * 3 + r);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) a.x[row * 3 + r] = xn[r];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gs_kernel(const __grid_constant__ Args<T> a) {
  using O = Op<T>;
  __shared__ T sm[kWarps + 1];
  const int n = a.n, tid = threadIdx.x;
  T bb = T(0);
  for (int i = tid; i < n; i += kThreads)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a.x[i * 3 + r] = a.x0[i * 3 + r];
      const T bi = __ldg(a.b + i * 3 + r);
      bb += bi * bi;
    }
  bb = block_sum(bb, sm);  // its barriers also publish x
  const T tol = a.tol < T(64) * O::eps() ? T(64) * O::eps() : a.tol;
  const T tol2 = tol * tol * (bb < O::tiny() ? O::tiny() : bb);
  const T one_m = O::sub(T(1), a.omega);
  int k = 0;
  bool done = false;
  while (!done && k < a.max_iters) {
    for (int c = 0; c < a.n_colors; ++c) {
      for (int i = tid; i < a.width; i += kThreads) {
        const int row = __ldg(a.groups + (int64_t)c * a.width + i);
        if (row < n) update_row(a, row, one_m);
      }
      __syncthreads();
    }
    T rr = T(0);  // |b - A x|^2
    for (int i = tid; i < n; i += kThreads) {
      T lux[3] = {T(0), T(0), T(0)};
      const int64_t e0 = (int64_t)i * a.k;
      for (int kk = 0; kk < a.k; ++kk) {
        const T val = __ldg(a.ell_vals + e0 + kk);
        const int64_t cc = (int64_t)__ldg(a.ell_cols + e0 + kk) * 3;
#pragma unroll
        for (int r = 0; r < 3; ++r) lux[r] += val * a.x[cc + r];
      }
      const T d = __ldg(a.diag + i);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T res = __ldg(a.b + i * 3 + r) - (d * a.x[i * 3 + r] + lux[r]);
        rr += res * res;
      }
    }
    rr = block_sum(rr, sm);
    done = rr < tol2;
    ++k;
  }
  if (tid == 0) *a.sweeps += k;
}

// ptrs: ell_cols, ell_vals, diag, groups, b, x0, x, pinned, pin_target,
// sweeps; ints: n, k, n_colors, width, max_iters, n_obs, kind[n_obs];
// par: [n_obs, 4].
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, const double* par, double omega, double tol,
           void* stream) {
  Args<T> a;
  a.ell_cols = reinterpret_cast<const int*>(ptrs[0]);
  a.ell_vals = reinterpret_cast<const T*>(ptrs[1]);
  a.diag = reinterpret_cast<const T*>(ptrs[2]);
  a.groups = reinterpret_cast<const int*>(ptrs[3]);
  a.b = reinterpret_cast<const T*>(ptrs[4]);
  a.x0 = reinterpret_cast<const T*>(ptrs[5]);
  a.x = reinterpret_cast<T*>(ptrs[6]);
  a.pinned = reinterpret_cast<const unsigned char*>(ptrs[7]);
  a.pin_target = reinterpret_cast<const T*>(ptrs[8]);
  a.sweeps = reinterpret_cast<int*>(ptrs[9]);
  a.n = ints[0];
  a.k = ints[1];
  a.n_colors = ints[2];
  a.width = ints[3];
  a.max_iters = ints[4];
  a.n_obs = ints[5];
  a.omega = T(omega);
  a.tol = T(tol);
  if (a.n <= 0) return 0;
  if (a.n_obs < 0 || a.n_obs > kMaxObstacles) return static_cast<int>(cudaErrorInvalidValue);
  for (int o = 0; o < kMaxObstacles; ++o) {
    a.kind[o] = o < a.n_obs ? ints[6 + o] : FLOOR;
    for (int q = 0; q < 4; ++q) a.par[o][q] = o < a.n_obs ? T(par[o * 4 + q]) : T(0);
  }
  gs_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
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
