// Kernel A: the fused neo-Hookean tet local step of one ADMM iteration.
//
// Replaces the Pallas kernel admm_elastic_tpu/ops/pallas_kernels.py
// _local_hyper_kernel (:172-185), launched by _local_hyper_call (:200-244,
// pallas_call at :220) behind local_step_tet_hyper_pallas. Per lane t:
//   v  = dix + u
//   U, S, V = signed SVD of v (8 Jacobi sweeps on v^T v, sort, U
//             orthonormalised with fallbacks, det signs; ops/soa.py:172-241)
//   eps-inflation of collapsed elements, |S3|
//   S* = 8 projected active-set Newton steps on psi_NH(s) + k/2 |s - S|^2,
//        Gershgorin damping, 8-step backtracking (ops/hyper_soa.py:136-180)
//   z  = U diag(S*) V^T,  u' = v - z
// The plain version is admm_elastic_tpu_torch/ops/hyper_soa.local_step_plain
// (with ops/soa.py); this file repeats it line for line, in the same order.
//
// Layout: dix, u, z, u' are [9, T] row-major (row = matrix entry), mu, lam,
// kappa, k are [T]. Thread t reads column t of each row, so a warp reads 32
// neighbouring floats per row: coalesced. The ragged edge is masked by
// t < T; no host-side padding. Dead stencil lanes arrive as identity F with
// u = 0 and leave as z = I, u' = 0, finite.
//
// What bounds it on Hopper: arithmetic and registers, not bytes. A lane
// reads 22 values and writes 18 (160 B in f32) but runs ~2-3k flops and
// ~150 transcendental calls (log, sqrt, div) in the Newton loop. Everything
// stays in registers; the Newton and backtracking loops are kept rolled
// (#pragma unroll 1) so the body compiles in seconds and does not spill.
// At the bench size T = 7,680, which is only ~58 lanes per SM, so the block
// is 64 threads: 120 blocks put work on 120 of the 132 SMs, where 256-thread
// blocks would fill only 30.
//
// Where a naive CUDA translation would silently disagree with JAX/PyTorch:
// - constants are written T(...), as JAX casts a Python float to the array
//   dtype: 1e-300 in float rounds to 0, so the singular-det guards
//   (soa.py:278, hyper_soa.py:159) never fire in float32, as in JAX, where
//   fabsf(det) < 1e-300 would be evaluated in double and fire on det == 0;
// - jnp.maximum / torch.maximum propagate NaN, fmaxf/fmax return the other
//   operand: every max / min / clamp below goes through maxp / minp;
// - jnp.sign(0) = 0 (soa.py:126): sgn() returns its argument for 0 and NaN,
//   not copysign;
// - f32 eps constants are kept: 1e-8 in the SVD (soa.py:179), 1e-6 collapse
//   test, 1e-30 J floor, FLT_MAX infeasible value, 1e-9 Newton floor.
// Built without --use_fast_math (it flushes denormals and approximates log,
// sqrt and division); FMA contraction stays on, which the stated float32
// tolerances allow for.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float max() { return FLT_MAX; }
  __device__ static float svd_eps() { return 1e-8f; }
};
template <> struct Lim<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double svd_eps() { return 1e-12; }
};

__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// NaN-propagating max / min (jnp.maximum / jnp.minimum semantics).
template <typename T> __device__ __forceinline__ T maxp(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <typename T> __device__ __forceinline__ T minp(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
// jnp.sign: -1, 0 or 1, NaN for NaN.
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

template <typename T>
__device__ __forceinline__ T det3(const T* a) {
  return a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
         a[2] * (a[3] * a[7] - a[4] * a[6]);
}

// One Jacobi rotation zeroing entry (P, Q) of the symmetric matrix held as
// d[3] (diagonal) and o01, o02, o12; V (row-major 3x3) accumulates columns.
template <typename T, int P, int Q>
__device__ __forceinline__ void rot_pq(T* d, T& o01, T& o02, T& o12, T* V) {
  constexpr int R = 3 - P - Q;
  T& apq = (P == 0 && Q == 1) ? o01 : ((P == 0 && Q == 2) ? o02 : o12);
  // off-diagonals (min(R,P), max(R,P)) and (min(R,Q), max(R,Q))
  T& arp = ((R < P ? R : P) == 0 && (R > P ? R : P) == 1) ? o01
         : (((R < P ? R : P) == 0 && (R > P ? R : P) == 2) ? o02 : o12);
  T& arq = ((R < Q ? R : Q) == 0 && (R > Q ? R : Q) == 1) ? o01
         : (((R < Q ? R : Q) == 0 && (R > Q ? R : Q) == 2) ? o02 : o12);
  const T app = d[P], aqq = d[Q], a_pq = apq, a_rp = arp, a_rq = arq;
  const bool zero = a_pq == T(0);
  T theta = (aqq - app) / (T(2) * (zero ? T(1) : a_pq));
  theta = minp(maxp(theta, T(-1e15)), T(1e15));
  T t = sgn(theta) / (dabs(theta) + dsqrt(theta * theta + T(1)));
  t = zero ? T(0) : t;
  const T c = T(1) / dsqrt(t * t + T(1));
  const T s = t * c;
  d[P] = c * c * app - T(2) * s * c * a_pq + s * s * aqq;
  d[Q] = s * s * app + T(2) * s * c * a_pq + c * c * aqq;
  apq = T(0);
  arp = c * a_rp - s * a_rq;
  arq = s * a_rp + c * a_rq;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T a = V[3 * r + P], b = V[3 * r + Q];
    V[3 * r + P] = c * a - s * b;
    V[3 * r + Q] = s * a + c * b;
  }
}

template <typename T>
__device__ __forceinline__ void swap_cols(T* V, T* w, int i, int j) {
  const bool cond = w[i] < w[j];
  const T wi = w[i], wj = w[j];
  w[i] = cond ? wj : wi;
  w[j] = cond ? wi : wj;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T a = V[3 * r + i], b = V[3 * r + j];
    V[3 * r + i] = cond ? b : a;
    V[3 * r + j] = cond ? a : b;
  }
}

// ops/soa.py signed_svd3_soa: f (row-major) -> U, S, V.
template <typename T>
__device__ void signed_svd3(const T* f, int sweeps, T* U, T* S, T* V) {
  const T eps = Lim<T>::svd_eps();
  // F^T F, compact symmetric form.
  T d[3];
  d[0] = f[0] * f[0] + f[3] * f[3] + f[6] * f[6];
  d[1] = f[1] * f[1] + f[4] * f[4] + f[7] * f[7];
  d[2] = f[2] * f[2] + f[5] * f[5] + f[8] * f[8];
  T o01 = f[0] * f[1] + f[3] * f[4] + f[6] * f[7];
  T o02 = f[0] * f[2] + f[3] * f[5] + f[6] * f[8];
  T o12 = f[1] * f[2] + f[4] * f[5] + f[7] * f[8];
#pragma unroll
  for (int i = 0; i < 9; ++i) V[i] = (i % 4 == 0) ? T(1) : T(0);
#pragma unroll 1
  for (int sw = 0; sw < sweeps; ++sw) {
    rot_pq<T, 0, 1>(d, o01, o02, o12, V);
    rot_pq<T, 0, 2>(d, o01, o02, o12, V);
    rot_pq<T, 1, 2>(d, o01, o02, o12, V);
  }
  T w[3] = {d[0], d[1], d[2]};
  swap_cols(V, w, 0, 1);
  swap_cols(V, w, 0, 2);
  swap_cols(V, w, 1, 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) S[i] = dsqrt(maxp(w[i], T(0)));

  // U = F V / S with orthonormalisation fallbacks.
  T fv[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      fv[3 * r + c] = f[3 * r] * V[c] + f[3 * r + 1] * V[3 + c] + f[3 * r + 2] * V[6 + c];
  T u0[3], u1[3], u2[3];
  const T s0m = maxp(S[0], eps), s1m = maxp(S[1], eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u0[r] = fv[3 * r] / s0m;
    u1[r] = fv[3 * r + 1] / s1m;
  }
  const T n0 = dsqrt(u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2]);
  const bool ok0 = n0 > eps;
  const T inv0 = T(1) / maxp(n0, eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) u0[r] = ok0 ? u0[r] * inv0 : (r == 0 ? T(1) : T(0));

  const T proj = u1[0] * u0[0] + u1[1] * u0[1] + u1[2] * u0[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) u1[r] = u1[r] - proj * u0[r];
  const T n1 = dsqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  const bool ok1 = n1 > eps;
  const T inv1 = T(1) / maxp(n1, eps);
  const bool big0 = dabs(u0[0]) > T(0.9);
  const T ref[3] = {big0 ? T(0) : T(1), big0 ? T(1) : T(0), T(0)};
  T alt[3] = {u0[1] * ref[2] - u0[2] * ref[1], u0[2] * ref[0] - u0[0] * ref[2],
              u0[0] * ref[1] - u0[1] * ref[0]};
  const T altn = dsqrt(maxp(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2], eps * eps));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    alt[r] = alt[r] / altn;
    u1[r] = ok1 ? u1[r] * inv1 : alt[r];
  }
  u2[0] = u0[1] * u1[2] - u0[2] * u1[1];
  u2[1] = u0[2] * u1[0] - u0[0] * u1[2];
  u2[2] = u0[0] * u1[1] - u0[1] * u1[0];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    U[3 * r] = u0[r];
    U[3 * r + 1] = u1[r];
    U[3 * r + 2] = u2[r];
  }
  const T flipV = det3(V) < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int r = 0; r < 3; ++r) V[3 * r + 2] = flipV * V[3 * r + 2];
  S[2] = S[2] * (det3(f) < T(0) ? T(-1) : T(1));
}

// psi_NH(s) + k/2 |s - s0|^2, FLT_MAX / DBL_MAX outside s > 0.
template <typename T>
__device__ __forceinline__ T nh_value(const T* s, const T* s0, T mu, T lam, T k) {
  const bool infeasible = (s[0] <= T(0)) | (s[1] <= T(0)) | (s[2] <= T(0));
  const T d0 = s[0] - s0[0], d1 = s[1] - s0[1], d2 = s[2] - s0[2];
  const T quad = T(0.5) * k * (d0 * d0 + d1 * d1 + d2 * d2);
  const T c0 = maxp(s[0], T(1e-30)), c1 = maxp(s[1], T(1e-30)), c2 = maxp(s[2], T(1e-30));
  const T J = c0 * c1 * c2;
  const T I1 = c0 * c0 + c1 * c1 + c2 * c2;
  const T logI3 = dlog(J * J);
  const T psi = T(0.5) * mu * (I1 - logI3 - T(3)) + T(0.125) * lam * logI3 * logI3;
  return infeasible ? Lim<T>::max() : psi + quad;
}

// ops/hyper_soa.py prox_tet_hyper_tuple (neo-Hookean) on one lane.
template <typename T>
__device__ void prox_nh(const T* f, T mu, T lam, T k, int n_iters, int sweeps, T* z) {
  T U[9], S[3], V[9];
  signed_svd3(f, sweeps, U, S, V);
  const T s0[3] = {S[0], S[1], S[2]};
  const T ceps = T(1e-6);
  const bool collapsed = (dabs(S[0]) < ceps) & (dabs(S[1]) < ceps) & (dabs(S[2]) < ceps);
  T s[3] = {collapsed ? ceps : S[0], collapsed ? ceps : S[1], collapsed ? ceps : S[2]};
  s[2] = dabs(s[2]);

  const T floor_ = T(1e-9);
  const T pin_at = T(1e-9 * 10.0);
  const T tol2 = T(1e-6 * 1e-6);
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    // gradient and Hessian of psi_NH + quad
    const T J = s[0] * s[1] * s[2];
    const T logJ = dlog(J);
    const T lj = lam * logJ;
    T g[3], inv[3], hd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = mu * (s[i] - T(1) / s[i]) + lj / s[i];
      g[i] = g[i] + k * (s[i] - s0[i]);
      inv[i] = T(1) / s[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      hd[i] = mu * (T(1) + inv[i] * inv[i]) + lam * (T(1) - logJ) * inv[i] * inv[i] + k;
    const T h12o = lam * inv[0] * inv[1], h13o = lam * inv[0] * inv[2], h23o = lam * inv[1] * inv[2];

    bool pinned[3];
    T fr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pinned[i] = (s[i] <= pin_at) & (g[i] > T(0));
      fr[i] = pinned[i] ? T(0) : T(1);
      g[i] = g[i] * fr[i];
    }
    const T h11 = hd[0] * fr[0] * fr[0] + (pinned[0] ? T(1) : T(0));
    const T h22 = hd[1] * fr[1] * fr[1] + (pinned[1] ? T(1) : T(0));
    const T h33 = hd[2] * fr[2] * fr[2] + (pinned[2] ? T(1) : T(0));
    const T h12 = h12o * fr[0] * fr[1];
    const T h13 = h13o * fr[0] * fr[2];
    const T h23 = h23o * fr[1] * fr[2];

    // Levenberg damping from the Gershgorin bound.
    const T r1 = h11 - dabs(h12) - dabs(h13);
    const T r2 = h22 - dabs(h12) - dabs(h23);
    const T r3 = h33 - dabs(h13) - dabs(h23);
    const T tau = maxp(T(0), T(1e-6) - minp(minp(r1, r2), r3));

    // ops/soa.py solve3x3_sym_soa
    const T a = h11 + tau, dd = h22 + tau, f2 = h33 + tau, b = h12, c = h13, e = h23;
    const T cA = dd * f2 - e * e;
    const T cB = c * e - b * f2;
    const T cC = b * e - c * dd;
    const T cD = a * f2 - c * c;
    const T cE = b * c - a * e;
    const T cF = a * dd - b * b;
    const T det = a * cA + b * cB + c * cC;
    const bool bad = dabs(det) < T(1e-300);
    const T idet = T(1) / (bad ? T(1) : det);
    T dir[3];
    dir[0] = (cA * g[0] + cB * g[1] + cC * g[2]) * idet;
    dir[1] = (cB * g[0] + cD * g[1] + cE * g[2]) * idet;
    dir[2] = (cC * g[0] + cE * g[1] + cF * g[2]) * idet;
    if (bad) {
      dir[0] = g[0];
      dir[1] = g[1];
      dir[2] = g[2];
    }

    const T f0 = nh_value(s, s0, mu, lam, k);
    T best[3] = {s[0], s[1], s[2]};
    T best_f = f0;
    bool accepted = false;
    T t = T(1);
#pragma unroll 1
    for (int bt = 0; bt < 8; ++bt) {
      T cand[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) cand[i] = maxp(s[i] - t * dir[i], floor_);
      const T fc = nh_value(cand, s0, mu, lam, k);
      const bool take = (!accepted) & (fc < best_f);
      if (take) {
        best[0] = cand[0];
        best[1] = cand[1];
        best[2] = cand[2];
        best_f = fc;
      }
      accepted = accepted | take;
      t = t * T(0.5);
    }
    const T gnorm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
    const T e0 = best[0] - s[0], e1 = best[1] - s[1], e2 = best[2] - s[2];
    const T step2 = e0 * e0 + e1 * e1 + e2 * e2;
    const bool converged = (gnorm2 < tol2) | (step2 < tol2);
    if (!converged) {
      s[0] = best[0];
      s[1] = best[1];
      s[2] = best[2];
    }
  }

  // z = U diag(s) V^T
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T us0 = s[0] * U[3 * r], us1 = s[1] * U[3 * r + 1], us2 = s[2] * U[3 * r + 2];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[3 * r + c] = us0 * V[3 * c] + us1 * V[3 * c + 1] + us2 * V[3 * c + 2];
  }
}

template <typename T>
__global__ void __launch_bounds__(64) local_step_kernel(
    const T* __restrict__ dix, const T* __restrict__ u, const T* __restrict__ mu,
    const T* __restrict__ lam, const T* __restrict__ k, T* __restrict__ z,
    T* __restrict__ uo, int n, int n_iters, int sweeps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T v[9], zz[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = dix[(int64_t)i * n + t] + u[(int64_t)i * n + t];
  prox_nh(v, mu[t], lam[t], k[t], n_iters, sweeps, zz);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    z[(int64_t)i * n + t] = zz[i];
    uo[(int64_t)i * n + t] = v[i] - zz[i];
  }
}

template <typename T>
int launch_local_step(const T* dix, const T* u, const T* mu, const T* lam, const T* k, T* z,
                      T* uo, int n, int n_iters, int sweeps, void* stream) {
  if (n <= 0) return 0;
  const int block = 64;
  const int grid = (n + block - 1) / block;
  local_step_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dix, u, mu, lam, k, z, uo, n, n_iters, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kappa (the spline compression stabiliser) is taken for the layout of the
// four parameter rows but the neo-Hookean energy does not read it.
extern "C" int admm_local_step_f32(const float* dix, const float* u, const float* mu,
                                   const float* lam, const float* kappa, const float* k,
                                   float* z, float* uo, int n, int n_iters, int sweeps,
                                   void* stream) {
  (void)kappa;
  return launch_local_step<float>(dix, u, mu, lam, k, z, uo, n, n_iters, sweeps, stream);
}

extern "C" int admm_local_step_f64(const double* dix, const double* u, const double* mu,
                                   const double* lam, const double* kappa, const double* k,
                                   double* z, double* uo, int n, int n_iters, int sweeps,
                                   void* stream) {
  (void)kappa;
  return launch_local_step<double>(dix, u, mu, lam, k, z, uo, n, n_iters, sweeps, stream);
}
