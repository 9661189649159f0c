// Scalar helpers shared by the per-lane kernels (local_step.cu, prox.cu,
// tri_local_step.cu). They carry the semantics of the jnp / PyTorch code that
// a plain CUDA translation would silently lose:
// - constants are written T(...), as JAX casts a Python float to the array
//   dtype: 1e-300 in float rounds to 0, so a guard `|det| < 1e-300` never
//   fires in float32, where fabsf(det) < 1e-300 would be evaluated in double;
// - jnp.maximum / torch.maximum propagate NaN, fmaxf / fmax return the other
//   operand: every max / min / clamp goes through maxp / minp;
// - jnp.sign(0) = 0: sgn() returns its argument for 0 and NaN, not copysign.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float max() { return FLT_MAX; }
  __device__ static float svd_eps() { return 1e-8f; }    // ops/soa.py signed_svd3_soa
  __device__ static float polar_eps() { return 1e-7f; }  // ops/soa.py polar_rotation_3x2_tuple
};
template <> struct Lim<double> {
  __device__ static double max() { return DBL_MAX; }
  __device__ static double svd_eps() { return 1e-12; }
  __device__ static double polar_eps() { return 1e-12; }
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

}  // namespace
