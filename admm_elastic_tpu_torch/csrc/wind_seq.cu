// Kernel I: the sequential wind, one launch per WindForce(sequential=True).project.
//
// It has no Pallas original. It replaces the JAX package's lax.scan over the
// triangles (admm_elastic_tpu/forces.py:76-84), the reference's
// single-threaded loop (src/ExplicitForce.cpp:55-104): the triangles are
// walked in file order, and each computes its Wejchert-Haumann force from x
// and from the velocities that the triangles before it have already kicked,
// then adds the force to its three vertices. The serial order is the
// semantics, so the kernel is one chain carried by one thread. As plain
// PyTorch it would be some 35 launches per triangle. The plain version is
// admm_elastic_tpu_torch/ops/cuda_wind.py wind_seq_plain; chip_smoke.py holds
// this kernel to it bit for bit.
//
// Per triangle (t0, t1, t2), with p the positions and w the velocities:
//   curr = ((w0 + w1) + w2) / 3;  v_r = curr - direction
//   a = p1 - p0;  b = p2 - p0;  n = a x b
//   |n| = sqrt((n0^2 + n1^2) + n2^2);  normal = n / max(|n|, 1e-30)
//   area = 0.5 |n|;  v_n = (normal0 v_r0 + normal1 v_r1) + normal2 v_r2
//   force = ((((-alpha_n area) v_n) |v_n|) normal) 0.33 dt
//   w0 += force; w1 += force; w2 += force
// Every operation is an IEEE-rounded intrinsic (no contraction into an fma),
// in the plain version's order, with the constants rounded to the dtype as
// PyTorch rounds a Python scalar; so the two agree bit for bit.
//
// What bounds it: latency. The bytes (x and v once, the triangles once, v
// out once) take microseconds at the card's memory rate; the chain of W
// dependent triangles, each some 60 dependent operations (two divides and a
// square root among them) behind the loads of its three velocities, takes
// milliseconds. The design keeps that chain short where it can:
// - SHARED form, where v fits the block's shared memory (N x 3 values, f32
//   up to some 19,000 vertices, f64 some 9,700): the block loads v once, the
//   chain reads and writes shared memory (a dependent load some 30 cycles,
//   not an L2 round trip) and the block writes v out once;
// - GLOBAL form, for larger N: the block copies v to the output first and
//   the chain runs on it in global memory (the block's own writes, seen after
//   __syncthreads);
// - the next triangle's indices and positions, which no velocity feeds, are
//   loaded while the current one computes (one triangle ahead).
// Thread 0 adds one to a device counter of the kernel's launches at the end
// (the wrapper's, read by chip_smoke.py: torch.profiler misses this kernel's
// records, eager ones always and a window's first replay late in a long
// process). No atomics.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

// The latency floor (chip_smoke.py, FLOOR_DEFINES): with ADMM_I_FLOOR=1 each
// triangle only loads its three velocities, adds a zero that the compiler
// cannot fold (dt * 0) and stores them: the chain of dependent loads and
// stores, with none of the force's arithmetic.
#ifndef ADMM_I_FLOOR
#define ADMM_I_FLOOR 0
#endif

namespace {

constexpr int kThreads = 256;

template <typename T> struct Op;
template <> struct Op<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float abs(float a) { return fabsf(a); }
};
template <> struct Op<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double abs(double a) { return fabs(a); }
};

// torch.clamp(min=): NaN propagates.
template <typename T> __device__ __forceinline__ T clamp_min(T a, T lo) {
  return (a != a) ? a : (a < lo ? lo : a);
}

template <typename T>
struct Args {
  const int64_t* tris;  // [W, 3] vertex ids
  const T* x;           // [N, 3]
  const T* v;           // [N, 3]
  const T* direction;   // [3], in the state's dtype
  T* out;               // [N, 3] v after every triangle's kick
  int* launches;        // [1] the launches so far, on the device
  int n, w;
  T neg_alpha, dt;
};

template <typename T>
__device__ __forceinline__ void load_tri(const Args<T>& a, int t, int64_t (&id)[3], T (&p)[3][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) id[c] = __ldg(a.tris + 3 * t + c);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) p[c][r] = __ldg(a.x + id[c] * 3 + r);
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads) wind_seq_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vs = SHARED ? reinterpret_cast<T*>(smem_raw) : a.out;
  const int len = a.n * 3;
  for (int i = threadIdx.x; i < len; i += kThreads) vs[i] = a.v[i];
  __syncthreads();
  if (threadIdx.x == 0 && a.w > 0) {
#if !ADMM_I_FLOOR
    using O = Op<T>;
    const T d[3] = {a.direction[0], a.direction[1], a.direction[2]};
#endif
    int64_t id[3], id_next[3] = {0, 0, 0};
    T p[3][3], p_next[3][3] = {};
    load_tri(a, 0, id, p);
    for (int t = 0; t < a.w; ++t) {
      if (t + 1 < a.w) load_tri(a, t + 1, id_next, p_next);
#if ADMM_I_FLOOR
      const T zero = Op<T>::mul(a.dt, T(0));
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < 3; ++r) vs[id[c] * 3 + r] = Op<T>::add(vs[id[c] * 3 + r], zero);
#else
      T vr[3], e1[3], e2[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T sum = O::add(O::add(vs[id[0] * 3 + r], vs[id[1] * 3 + r]), vs[id[2] * 3 + r]);
        vr[r] = O::sub(O::div(sum, T(3)), d[r]);
        e1[r] = O::sub(p[1][r], p[0][r]);
        e2[r] = O::sub(p[2][r], p[0][r]);
      }
      const T n[3] = {O::sub(O::mul(e1[1], e2[2]), O::mul(e1[2], e2[1])),
                      O::sub(O::mul(e1[2], e2[0]), O::mul(e1[0], e2[2])),
                      O::sub(O::mul(e1[0], e2[1]), O::mul(e1[1], e2[0]))};
      const T len_n =
          O::sqrt(O::add(O::add(O::mul(n[0], n[0]), O::mul(n[1], n[1])), O::mul(n[2], n[2])));
      const T den = clamp_min(len_n, T(1e-30));
      T normal[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) normal[r] = O::div(n[r], den);
      const T area = O::mul(T(0.5), len_n);
      const T vn = O::add(O::add(O::mul(normal[0], vr[0]), O::mul(normal[1], vr[1])),
                          O::mul(normal[2], vr[2]));
      const T s = O::mul(O::mul(O::mul(a.neg_alpha, area), vn), O::abs(vn));
      T f[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) f[r] = O::mul(O::mul(O::mul(s, normal[r]), T(0.33)), a.dt);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < 3; ++r) vs[id[c] * 3 + r] = O::add(vs[id[c] * 3 + r], f[r]);
#endif
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        id[c] = id_next[c];
#pragma unroll
        for (int r = 0; r < 3; ++r) p[c][r] = p_next[c][r];
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) a.out[i] = vs[i];
  }
  if (threadIdx.x == 0) *a.launches += 1;
}

// ptrs: tris, x, v, direction, out, launches; shared: 1 for the SHARED form.
template <typename T>
int launch(const uint64_t* ptrs, int n, int w, double neg_alpha, double dt, int shared,
           void* stream) {
  Args<T> a;
  a.tris = reinterpret_cast<const int64_t*>(ptrs[0]);
  a.x = reinterpret_cast<const T*>(ptrs[1]);
  a.v = reinterpret_cast<const T*>(ptrs[2]);
  a.direction = reinterpret_cast<const T*>(ptrs[3]);
  a.out = reinterpret_cast<T*>(ptrs[4]);
  a.launches = reinterpret_cast<int*>(ptrs[5]);
  a.n = n;
  a.w = w;
  a.neg_alpha = T(neg_alpha);
  a.dt = T(dt);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    static int granted = 0;  // the dynamic shared memory allowed so far
    const int smem = static_cast<int>(static_cast<size_t>(n) * 3 * sizeof(T));
    if (smem > granted) {
      const cudaError_t rc = cudaFuncSetAttribute(
          wind_seq_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      granted = smem;
    }
    wind_seq_kernel<T, true><<<1, kThreads, smem, s>>>(a);
  } else {
    wind_seq_kernel<T, false><<<1, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admm_wind_seq_f32(const uint64_t* ptrs, int n, int w, double neg_alpha,
                                 double dt, int shared, void* stream) {
  return launch<float>(ptrs, n, w, neg_alpha, dt, shared, stream);
}

extern "C" int admm_wind_seq_f64(const uint64_t* ptrs, int n, int w, double neg_alpha,
                                 double dt, int shared, void* stream) {
  return launch<double>(ptrs, n, w, neg_alpha, dt, shared, stream);
}
