// The per-lane tet prox bodies shared by kernel A (local_step.cu) and kernels
// D and F (prox.cu): the signed 3x3 SVD, the energies of the five
// hyperelastic models with their gradients and Hessians in principal
// stretches, the projected Newton solve, the linear prox, the per-lane
// function that runs the model's prox on a lane's v and stores z (and the
// dual u' = v - z), and the kernel template that loads a lane from SoA rows
// or [T,3,3] and calls it.
//
// It repeats admm_elastic_tpu_torch/ops/soa.py, ops/hyper_soa.py and
// materials.py line for line, in the same order: x ** 2 and x ** 3 are
// products, never pow; every literal is T(...); max / min go through the
// NaN-propagating maxp / minp of common.cuh. Where the plain version runs
// every lane through every Newton trip and every line-search candidate, the
// body leaves each loop as soon as the result is fixed (prox_hyper): the
// operations that reach the result, and so its bits, stay the same. The
// Newton and search loops stay rolled (#pragma unroll 1) so that the many
// instantiations (models x float / double x entries) compile in seconds
// without spills.
#pragma once

#include "common.cuh"

namespace {

// Model ids, in the order of admm_elastic_tpu_torch/ops/cuda_local_step.MODEL_IDS.
enum Model { NH = 0, STVK = 1, SPLINE_NH = 2, SPLINE_STVK = 3, SPLINE_COROT = 4, LINEAR = 5 };

template <typename T> struct Mat { T mu, lam, kappa, k; };

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

// Xu et al. spline curves (materials.py spline_fgh / spline_dfgh /
// spline_d2fgh); KIND 0 neo-Hookean, 1 StVK, 2 corotated.
template <typename T, int KIND> struct Spline {
  __device__ static __forceinline__ T compress(T kappa, T x) {
    const T c = (T(1) - x) / T(6);
    return (kappa / T(12)) * (c * c * c);
  }
  __device__ static __forceinline__ T d_compress(T kappa, T x) {
    const T c = (T(1) - x) / T(6);
    return (-kappa / T(24)) * (c * c);
  }
  __device__ static __forceinline__ T d2_compress(T kappa, T x) {
    return (kappa / T(72)) * ((T(1) - x) / T(6));
  }
  __device__ static __forceinline__ T f(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) {
      return T(0.5) * m.mu * (x * x - T(1));
    } else if constexpr (KIND == 1) {
      const T x2 = x * x, q = x2 - T(1);
      return T(0.125) * m.lam * (x2 * x2 - T(6) * x2 + T(5)) + T(0.25) * m.mu * (q * q);
    } else {
      const T q = x - T(1);
      return T(0.5) * m.lam * (x * x - T(6) * x + T(5)) + m.mu * (q * q);
    }
  }
  __device__ static __forceinline__ T g(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) return T(0);
    else if constexpr (KIND == 1) return T(0.25) * m.lam * (x * x - T(1));
    else return m.lam * (x - T(1));
  }
  __device__ static __forceinline__ T h(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) {
      const T logx = dlog(x);
      return -m.mu * logx + T(0.5) * m.lam * logx * logx + compress(m.kappa, x);
    } else {
      return compress(m.kappa, x);
    }
  }
  __device__ static __forceinline__ T df(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) {
      return m.mu * x;
    } else if constexpr (KIND == 1) {
      const T x2 = x * x;
      return T(0.125) * m.lam * (T(4) * x2 * x - T(12) * x) + m.mu * x * (x2 - T(1));
    } else {
      return T(0.5) * m.lam * (T(2) * x - T(6)) + T(2) * m.mu * (x - T(1));
    }
  }
  __device__ static __forceinline__ T dg(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) return T(0);
    else if constexpr (KIND == 1) return T(0.5) * m.lam * x;
    else return m.lam;
  }
  __device__ static __forceinline__ T dh(T x, const Mat<T>& m) {
    if constexpr (KIND == 0)
      return -m.mu / x + m.lam * dlog(x) / x + d_compress(m.kappa, x);
    else
      return d_compress(m.kappa, x);
  }
  __device__ static __forceinline__ T d2f(T x, const Mat<T>& m) {
    if constexpr (KIND == 0) {
      return m.mu;
    } else if constexpr (KIND == 1) {
      const T x2 = x * x;
      return T(0.125) * m.lam * (T(12) * x2 - T(12)) + m.mu * (T(3) * x2 - T(1));
    } else {
      return m.lam + T(2) * m.mu;
    }
  }
  __device__ static __forceinline__ T d2g(T x, const Mat<T>& m) {
    if constexpr (KIND == 1) return T(0.5) * m.lam;
    else return T(0);
  }
  __device__ static __forceinline__ T d2h(T x, const Mat<T>& m) {
    if constexpr (KIND == 0)
      return (m.mu + m.lam * (T(1) - dlog(x))) / (x * x) + d2_compress(m.kappa, x);
    else
      return d2_compress(m.kappa, x);
  }
};

// psi, its gradient and its Hessian (h11, h22, h33, h12, h13, h23) in the
// principal stretches s, per model (ops/hyper_soa.py _vgh_soa).
template <typename T, int MODEL> struct Energy {
  using Sp = Spline<T, MODEL - SPLINE_NH>;

  __device__ static __forceinline__ T psi(const T* s, const Mat<T>& m) {
    if constexpr (MODEL == NH) {
      const T J = s[0] * s[1] * s[2];
      const T I1 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
      const T logI3 = dlog(J * J);
      return T(0.5) * m.mu * (I1 - logI3 - T(3)) + T(0.125) * m.lam * logI3 * logI3;
    } else if constexpr (MODEL == STVK) {
      const T st0 = T(0.5) * (s[0] * s[0] - T(1));
      const T st1 = T(0.5) * (s[1] * s[1] - T(1));
      const T st2 = T(0.5) * (s[2] * s[2] - T(1));
      const T tr = st0 + st1 + st2;
      return m.mu * (st0 * st0 + st1 * st1 + st2 * st2) + T(0.5) * m.lam * tr * tr;
    } else {
      const T J = maxp(s[0] * s[1] * s[2], T(1e-30));
      T total = Sp::f(s[0], m);
      total = total + Sp::f(s[1], m);
      total = total + Sp::f(s[2], m);
      total = total + Sp::g(s[0] * s[1], m);
      total = total + Sp::g(s[1] * s[2], m);
      total = total + Sp::g(s[2] * s[0], m);
      return total + Sp::h(J, m);
    }
  }

  __device__ static __forceinline__ void grad(const T* s, const Mat<T>& m, T* g) {
    if constexpr (MODEL == NH) {
      const T J = s[0] * s[1] * s[2];
      const T lj = m.lam * dlog(J);
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = m.mu * (s[i] - T(1) / s[i]) + lj / s[i];
    } else if constexpr (MODEL == STVK) {
      const T sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
      const T half = T(0.5) * m.lam * (sum_s2 - T(3));
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = m.mu * s[i] * (s[i] * s[i] - T(1)) + half * s[i];
    } else {
      const T s1 = s[0], s2 = s[1], s3 = s[2];
      const T J = maxp(s1 * s2 * s3, T(1e-30));
      const T df1 = Sp::df(s1, m), dg12 = Sp::dg(s1 * s2, m), dh = Sp::dh(J, m);
      const T df2 = Sp::df(s2, m), dg23 = Sp::dg(s2 * s3, m);
      const T df3 = Sp::df(s3, m), dg31 = Sp::dg(s3 * s1, m);
      g[0] = df1 + dg12 * s2 + dg31 * s3 + dh * s2 * s3;
      g[1] = df2 + dg23 * s3 + dg12 * s1 + dh * s3 * s1;
      g[2] = df3 + dg31 * s1 + dg23 * s2 + dh * s1 * s2;
    }
  }

  __device__ static __forceinline__ void hess(const T* s, const Mat<T>& m, T* h) {
    if constexpr (MODEL == NH) {
      const T J = s[0] * s[1] * s[2];
      const T logJ = dlog(J);
      T inv[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) inv[i] = T(1) / s[i];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        h[i] = m.mu * (T(1) + inv[i] * inv[i]) + m.lam * (T(1) - logJ) * inv[i] * inv[i];
      h[3] = m.lam * inv[0] * inv[1];
      h[4] = m.lam * inv[0] * inv[2];
      h[5] = m.lam * inv[1] * inv[2];
    } else if constexpr (MODEL == STVK) {
      const T sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
      const T half = T(0.5) * m.lam * (sum_s2 - T(3));
#pragma unroll
      for (int i = 0; i < 3; ++i)
        h[i] = m.mu * (T(3) * s[i] * s[i] - T(1)) + half + m.lam * s[i] * s[i];
      h[3] = m.lam * s[0] * s[1];
      h[4] = m.lam * s[0] * s[2];
      h[5] = m.lam * s[1] * s[2];
    } else {
      const T s1 = s[0], s2 = s[1], s3 = s[2];
      const T J = maxp(s1 * s2 * s3, T(1e-30));
      const T dg12 = Sp::dg(s1 * s2, m), dh = Sp::dh(J, m);
      const T dg23 = Sp::dg(s2 * s3, m), dg31 = Sp::dg(s3 * s1, m);
      const T d2f1 = Sp::d2f(s1, m), d2g12 = Sp::d2g(s1 * s2, m), d2h = Sp::d2h(J, m);
      const T d2f2 = Sp::d2f(s2, m), d2g23 = Sp::d2g(s2 * s3, m);
      const T d2f3 = Sp::d2f(s3, m), d2g31 = Sp::d2g(s3 * s1, m);
      const T p23 = s2 * s3, p31 = s3 * s1, p12 = s1 * s2;
      h[0] = d2f1 + d2g12 * s2 * s2 + d2g31 * s3 * s3 + d2h * (p23 * p23);
      h[1] = d2f2 + d2g23 * s3 * s3 + d2g12 * s1 * s1 + d2h * (p31 * p31);
      h[2] = d2f3 + d2g31 * s1 * s1 + d2g23 * s2 * s2 + d2h * (p12 * p12);
      h[3] = dg12 + d2g12 * s1 * s2 + d2h * p23 * p31 + dh * s3;
      h[4] = dg31 + d2g31 * s3 * s1 + d2h * p23 * p12 + dh * s2;
      h[5] = dg23 + d2g23 * s2 * s3 + d2h * p31 * p12 + dh * s1;
    }
  }
};

// psi(s) + k/2 |s - s0|^2, FLT_MAX / DBL_MAX outside s > 0.
template <typename T, int MODEL>
__device__ __forceinline__ T prox_value(const T* s, const T* s0, const Mat<T>& m) {
  const bool infeasible = (s[0] <= T(0)) | (s[1] <= T(0)) | (s[2] <= T(0));
  const T d0 = s[0] - s0[0], d1 = s[1] - s0[1], d2 = s[2] - s0[2];
  const T quad = T(0.5) * m.k * (d0 * d0 + d1 * d1 + d2 * d2);
  const T c[3] = {maxp(s[0], T(1e-30)), maxp(s[1], T(1e-30)), maxp(s[2], T(1e-30))};
  return infeasible ? Lim<T>::max() : Energy<T, MODEL>::psi(c, m) + quad;
}

// ops/hyper_soa.py prox_tet_hyper_tuple on one lane: f (row-major 3x3) -> z.
//
// The plain version runs n_iters trips of 8 candidates on every lane; this
// gives the same result bit for bit in less:
// - a lane leaves the Newton loop after the trip that finds it converged: it
//   keeps s then, so every later trip would recompute the same gradient,
//   Hessian and candidates and find it converged again;
// - with |g|^2 < tol^2 the lane is converged whatever the search finds, so
//   the search is skipped;
// - `take = !accepted & (fc < best_f)` with best_f = f0 until the first
//   accept picks the first candidate j with fc_j < f0 (NaN compares false in
//   both), so the search is left there.
template <typename T, int MODEL>
__device__ void prox_hyper(const T* f, const Mat<T>& m, int n_iters, int sweeps, T* z) {
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
    T g[3], h6[6];
    Energy<T, MODEL>::grad(s, m, g);
    Energy<T, MODEL>::hess(s, m, h6);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = g[i] + m.k * (s[i] - s0[i]);
      h6[i] = h6[i] + m.k;
    }

    // Active set: coordinates pinned at the barrier with inward gradient.
    bool pinned[3];
    T fr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pinned[i] = (s[i] <= pin_at) & (g[i] > T(0));
      fr[i] = pinned[i] ? T(0) : T(1);
      g[i] = g[i] * fr[i];
    }
    const T gnorm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
    if (gnorm2 < tol2) break;  // converged whatever the search would find
    const T h11 = h6[0] * fr[0] * fr[0] + (pinned[0] ? T(1) : T(0));
    const T h22 = h6[1] * fr[1] * fr[1] + (pinned[1] ? T(1) : T(0));
    const T h33 = h6[2] * fr[2] * fr[2] + (pinned[2] ? T(1) : T(0));
    const T h12 = h6[3] * fr[0] * fr[1];
    const T h13 = h6[4] * fr[0] * fr[2];
    const T h23 = h6[5] * fr[1] * fr[2];

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

    // The line search: the first of the 8 candidates below f0, or s.
    const T f0 = prox_value<T, MODEL>(s, s0, m);
    T best[3] = {s[0], s[1], s[2]};
    T t = T(1);
#pragma unroll 1
    for (int bt = 0; bt < 8; ++bt) {
      T cand[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) cand[i] = maxp(s[i] - t * dir[i], floor_);
      const T fc = prox_value<T, MODEL>(cand, s0, m);
      if (fc < f0) {
#pragma unroll
        for (int i = 0; i < 3; ++i) best[i] = cand[i];
        break;
      }
      t = t * T(0.5);
    }
    const T e0 = best[0] - s[0], e1 = best[1] - s[1], e2 = best[2] - s[2];
    const T step2 = e0 * e0 + e1 * e1 + e2 * e2;
    if (step2 < tol2) break;  // converged: s stays
    s[0] = best[0];
    s[1] = best[1];
    s[2] = best[2];
  }

  // z = U diag(s) V^T
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T us0 = s[0] * U[3 * r], us1 = s[1] * U[3 * r + 1], us2 = s[2] * U[3 * r + 2];
#pragma unroll
    for (int c = 0; c < 3; ++c) z[3 * r + c] = us0 * V[3 * c] + us1 * V[3 * c + 1] + us2 * V[3 * c + 2];
  }
}

// ops/soa.py prox_tet_linear_tuple on one lane: z = 1/2 (U V^T + f).
template <typename T>
__device__ void prox_linear(const T* f, int sweeps, T* z) {
  T U[9], S[3], V[9];
  signed_svd3(f, sweeps, U, S, V);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const T p = U[3 * r] * V[3 * c] + U[3 * r + 1] * V[3 * c + 1] + U[3 * r + 2] * V[3 * c + 2];
      z[3 * r + c] = T(0.5) * (p + f[3 * r + c]);
    }
}

// The prox of lane t on v (row-major 3x3, in registers) and its stores. ROWS:
// z and uo are SoA rows [9, n] and the dual u' = v - z is written; otherwise
// z is [n, 3, 3] row-major and uo is not touched. Every entry that has a
// lane's v ends here: the rows and [T,3,3] entries below, and the entry of
// local_step.cu that computes D x itself.
// tet_lane_prox_mat takes the lane's material m (unread by the linear model);
// tet_lane_prox reads it at t.
template <typename T, int MODEL, bool ROWS>
__device__ __forceinline__ void tet_lane_prox_mat(const T* v, const Mat<T>& m,
                                                  T* __restrict__ z, T* __restrict__ uo, int n,
                                                  int t, int n_iters, int sweeps) {
  T zz[9];
  if constexpr (MODEL == LINEAR) {
    prox_linear(v, sweeps, zz);
  } else {
    prox_hyper<T, MODEL>(v, m, n_iters, sweeps, zz);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if constexpr (ROWS) {
      z[(int64_t)i * n + t] = zz[i];
      uo[(int64_t)i * n + t] = v[i] - zz[i];
    } else {
      z[(int64_t)9 * t + i] = zz[i];
    }
  }
}

template <typename T, int MODEL, bool ROWS>
__device__ __forceinline__ void tet_lane_prox(const T* v, const T* __restrict__ mu,
                                              const T* __restrict__ lam,
                                              const T* __restrict__ kappa,
                                              const T* __restrict__ k, T* __restrict__ z,
                                              T* __restrict__ uo, int n, int t, int n_iters,
                                              int sweeps) {
  Mat<T> m = {T(0), T(0), T(0), T(0)};
  if constexpr (MODEL != LINEAR) m = {mu[t], lam[t], kappa[t], k[t]};
  tet_lane_prox_mat<T, MODEL, ROWS>(v, m, z, uo, n, t, n_iters, sweeps);
}

// One thread per lane t < n. ROWS: in, u, z, uo are SoA rows [9, n] (thread t
// reads column t of each row: a warp reads 32 neighbouring values per row,
// coalesced) and the dual u' = v - z is written. Otherwise in and z are
// [n, 3, 3] row-major (lane t owns in[9t .. 9t+8]; a warp's 32 lanes cover
// one contiguous 288-value span), u and uo are not read. The ragged edge is
// the bounds check; nothing is padded on the host.
template <typename T, int MODEL, bool ROWS>
__global__ void __launch_bounds__(64) tet_prox_kernel(
    const T* __restrict__ in, const T* __restrict__ u, const T* __restrict__ mu,
    const T* __restrict__ lam, const T* __restrict__ kappa, const T* __restrict__ k,
    T* __restrict__ z, T* __restrict__ uo, int n, int n_iters, int sweeps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    if constexpr (ROWS) v[i] = in[(int64_t)i * n + t] + u[(int64_t)i * n + t];
    else v[i] = in[(int64_t)9 * t + i];
  }
  tet_lane_prox<T, MODEL, ROWS>(v, mu, lam, kappa, k, z, uo, n, t, n_iters, sweeps);
}

// 64-thread blocks: at the 7,680 lanes of the bench beam that is 120 blocks
// on 120 of the 132 SMs, where 256-thread blocks would fill only 30.
template <typename T, int MODEL, bool ROWS>
int launch_tet_prox(const T* in, const T* u, const T* mu, const T* lam, const T* kappa,
                    const T* k, T* z, T* uo, int n, int n_iters, int sweeps, void* stream) {
  if (n <= 0) return 0;
  const int block = 64;
  const int grid = (n + block - 1) / block;
  tet_prox_kernel<T, MODEL, ROWS><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps);
  return static_cast<int>(cudaGetLastError());
}

// Run-time model id -> compile-time variant; an unknown id is an invalid value.
template <typename T, bool ROWS>
int dispatch_tet_prox(int model, const T* in, const T* u, const T* mu, const T* lam,
                      const T* kappa, const T* k, T* z, T* uo, int n, int n_iters, int sweeps,
                      void* stream) {
  switch (model) {
    case NH: return launch_tet_prox<T, NH, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    case STVK: return launch_tet_prox<T, STVK, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    case SPLINE_NH: return launch_tet_prox<T, SPLINE_NH, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    case SPLINE_STVK: return launch_tet_prox<T, SPLINE_STVK, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    case SPLINE_COROT: return launch_tet_prox<T, SPLINE_COROT, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    case LINEAR: return launch_tet_prox<T, LINEAR, ROWS>(in, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
