// Kernel I: the sequential wind, one launch per WindForce(sequential=True).project.
//
// It has no Pallas original. It replaces the JAX package's lax.scan over the
// triangles (admm_elastic_tpu/forces.py:76-84), the reference's
// single-threaded loop (src/ExplicitForce.cpp:55-104): the triangles are
// walked in file order, and each computes its Wejchert-Haumann force from x
// and from the velocities that the triangles before it have already kicked,
// then adds the force to its three vertices. The plain version is
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
// out once) take microseconds at the card's memory rate; the scan is a chain
// of W dependent triangles. But a triangle depends only on the last earlier
// triangle that shares one of its vertices, so the chain is as long as the
// triangles' level schedule (ops/cuda_wind.py bake_schedule, baked once per
// sheet on the host): level(t) = 1 + the largest level of an earlier triangle
// sharing a vertex with t. No two triangles of a level share a vertex, each
// vertex sees its triangles' kicks in file order, and each triangle reads the
// v the scan gives it: the scan's bits, in 236 levels for the 40x40 sheet's
// 3,200 triangles and 956 for the 160x160 sheet's 51,200.
// The design:
// - phase 1, every thread: v in, and for each slot (a triangle in level
//   order) its vertex ids and the geometry that no velocity feeds, the normal
//   and -alpha_n area, computed once, off the chain;
// - phase 2, the levels in order, walked by the block's first `walkers`
//   threads (ops/cuda_wind.py walkers: the widest level in warps, 32 to 512):
//   a level's slots over them (a range wider than the walkers loops, with no
//   sync: a level is vertex-disjoint), each the three v loads, the mean, v_r,
//   v_n, the force and the nine adds; a barrier between levels, __syncwarp
//   where one warp walks (the 40x40 sheet: 20 triangles a level at most),
//   else a named barrier of the walkers (the 160x160 sheet: 96). The next
//   level's first slot and end are loaded before the barrier. (The whole
//   block walking with __syncthreads took 105.5 against 95.4 us on the 40x40
//   sheet in float32 on an H100: tools/i_anatomy.py, PERF.md.)
// Forms (ops/cuda_wind.py i_form chooses), each one block:
// - SHARED: v, the geometry and the ids in its shared memory (the 40x40
//   sheet: 110 KB in float32);
// - GLOBAL, where they do not fit: v in the output in global memory (the
//   block's own writes, seen after the barrier), the geometry and ids in a
//   scratch the wrapper allocates; a level wider than the walkers loops.
// Measured and removed (PERF.md): a thread-block cluster holding v in its
// blocks' shared memory through DSMEM (its barrier some 1.2 us a level:
// 1,487.1 against GLOBAL's 1,265.1 us on the 160x160 sheet), and a block
// whose shared memory holds only the live velocities, staged chunk by chunk
// beside the walk (545.0 us there; no path runs a sheet beyond one block).
// Thread 0 adds one to a device counter of the kernel's launches at the end
// (the wrapper's, read by chip_smoke.py). No atomics.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

// The latency floor (chip_smoke.py, FLOOR_DEFINES): with ADMM_I_FLOOR=1 phase
// 1 stages v and the ids only, and each slot only loads its three velocities,
// adds a zero that the compiler cannot fold (dt * 0) and stores them: the
// levels' loads, stores and barriers, with none of the force's arithmetic.
#ifndef ADMM_I_FLOOR
#define ADMM_I_FLOOR 0
#endif

namespace {

constexpr int kThreads = 512;
enum Form { kShared = 0, kGlobal = 1 };

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
  const int* order;     // [W] the triangles by level, file order within a level
  const int* offsets;   // [levels + 1] each level's first slot
  const T* x;           // [N, 3]
  const T* v;           // [N, 3]
  const T* direction;   // [3], in the state's dtype
  T* out;               // [N, 3] v after every triangle's kick
  T* geom;              // [W, 4] scratch (GLOBAL): a slot's normal, -alpha_n area
  int* ids;             // [W, 3] scratch (GLOBAL): a slot's vertex ids
  int* launches;        // [1] the launches so far, on the device
  int n, w, levels;
  int walkers;          // the threads that walk the levels (a multiple of 32)
  T neg_alpha, dt;
};

// The geometry of the triangle on vertices i that no velocity feeds: the
// normal, then -alpha_n area, into g[0..3].
template <typename T>
__device__ __forceinline__ void geometry(const Args<T>& a, const int64_t (&i)[3], T* g) {
  using O = Op<T>;
  T p[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) p[c][r] = __ldg(a.x + i[c] * 3 + r);
  T e1[3], e2[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    e1[r] = O::sub(p[1][r], p[0][r]);
    e2[r] = O::sub(p[2][r], p[0][r]);
  }
  const T n[3] = {O::sub(O::mul(e1[1], e2[2]), O::mul(e1[2], e2[1])),
                  O::sub(O::mul(e1[2], e2[0]), O::mul(e1[0], e2[2])),
                  O::sub(O::mul(e1[0], e2[1]), O::mul(e1[1], e2[0]))};
  const T len_n =
      O::sqrt(O::add(O::add(O::mul(n[0], n[0]), O::mul(n[1], n[1])), O::mul(n[2], n[2])));
  const T den = clamp_min(len_n, T(1e-30));
#pragma unroll
  for (int r = 0; r < 3; ++r) g[r] = O::div(n[r], den);
  g[3] = O::mul(a.neg_alpha, O::mul(T(0.5), len_n));
}

// Phase 1 for the slots rank, rank + nthr, ...: each slot's vertex ids and
// geometry into is / gs. (Loading a few slots at a time, so that their loads
// overlap, was tried and was not faster.)
template <typename T>
__device__ void stage(const Args<T>& a, T* gs, int* is, int rank, int nthr) {
  for (int s = rank; s < a.w; s += nthr) {
    const int64_t t = __ldg(a.order + s);
    int64_t i[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      i[c] = __ldg(a.tris + 3 * t + c);
      is[3 * s + c] = static_cast<int>(i[c]);
    }
    if (!ADMM_I_FLOOR) geometry(a, i, gs + 4 * s);
  }
}

// One slot's kick: w from v, w + force back (a repeated vertex gets w +
// force once per corner, as the plain version's indexed assignment).
template <typename T>
__device__ __forceinline__ void kick(const Args<T>& a, T* vs, const int (&id)[3], const T (&g)[4],
                                     const T (&d)[3]) {
  using O = Op<T>;
  T* pv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) pv[c] = vs + id[c] * 3;
  T w[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) w[c][r] = pv[c][r];
#if ADMM_I_FLOOR
  const T zero = O::mul(a.dt, T(0));
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) pv[c][r] = O::add(w[c][r], zero);
#else
  T vr[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    vr[r] = O::sub(O::div(O::add(O::add(w[0][r], w[1][r]), w[2][r]), T(3)), d[r]);
  const T vn = O::add(O::add(O::mul(g[0], vr[0]), O::mul(g[1], vr[1])), O::mul(g[2], vr[2]));
  const T s = O::mul(O::mul(g[3], vn), O::abs(vn));
  T f[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) f[r] = O::mul(O::mul(O::mul(s, g[r]), T(0.33)), a.dt);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) pv[c][r] = O::add(w[c][r], f[r]);
#endif
}

// The barrier between two levels among the block's `walkers` threads: a
// warp's, the block's, or a named barrier of the first `walkers` threads.
__device__ __forceinline__ void level_barrier(int walkers) {
  if (walkers == 32) {
    __syncwarp();
  } else if (walkers == static_cast<int>(blockDim.x)) {
    __syncthreads();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(walkers) : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void load_slot(const T* gs, const int* is, int s, int (&id)[3],
                                          T (&g)[4]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) id[c] = is[3 * s + c];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = gs[4 * s + k];
}

// Phase 2: the levels in order, the slots of a level over nthr threads of
// rank `rank`, a barrier after each level.
template <typename T>
__device__ void walk(const Args<T>& a, T* vs, const T* gs, const int* is, int rank, int nthr) {
  T d[3];
#if !ADMM_I_FLOOR
#pragma unroll
  for (int r = 0; r < 3; ++r) d[r] = a.direction[r];
#endif
  int hi = a.levels > 0 ? __ldg(a.offsets + 1) : 0;
  int s = rank;  // this thread's first slot of the level
  int id[3];
  T g[4];
  if (s < hi) load_slot(gs, is, s, id, g);
  for (int l = 0; l < a.levels; ++l) {
    const int next = l + 2 <= a.levels ? __ldg(a.offsets + l + 2) : hi;
    if (s < hi) {
      kick<T>(a, vs, id, g, d);
      for (int t = s + nthr; t < hi; t += nthr) {
        int id2[3];
        T g2[4];
        load_slot(gs, is, t, id2, g2);
        kick<T>(a, vs, id2, g2, d);
      }
    }
    s = hi + rank;  // the next level's first slot, loaded before the barrier
    if (s < next) load_slot(gs, is, s, id, g);
    hi = next;
    level_barrier(nthr);
  }
}

template <typename T, int FORM>
__global__ void __launch_bounds__(kThreads) wind_seq_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  T* const vs = FORM == kGlobal ? a.out : smem;
  T* const gs = FORM == kShared ? smem + 3 * a.n : a.geom;
  int* const is = FORM == kShared ? reinterpret_cast<int*>(gs + 4 * a.w) : a.ids;
  // phase 1: v in; every slot's ids and geometry
  for (int i = threadIdx.x; i < 3 * a.n; i += blockDim.x) vs[i] = a.v[i];
  stage(a, gs, is, threadIdx.x, blockDim.x);
  __syncthreads();
  // phase 2: the levels, on the block's first walkers
  if (static_cast<int>(threadIdx.x) < a.walkers) walk<T>(a, vs, gs, is, threadIdx.x, a.walkers);
  // v out
  if constexpr (FORM == kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * a.n; i += blockDim.x) a.out[i] = vs[i];
  }
  if (threadIdx.x == 0) *a.launches += 1;
}

// Raise fn's dynamic shared memory to smem bytes (never lowered, once per
// size).
template <typename F>
cudaError_t allow(F* fn, int smem, int* granted) {
  if (smem > *granted) {
    const cudaError_t rc =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
    *granted = smem;
  }
  return cudaSuccess;
}

template <typename T, int FORM>
cudaError_t launch_form(const Args<T>& a, int smem, cudaStream_t s) {
  static int granted = 0;  // the dynamic shared memory allowed so far, per precision and form
  const cudaError_t rc = allow(wind_seq_kernel<T, FORM>, smem, &granted);
  if (rc != cudaSuccess) return rc;
  wind_seq_kernel<T, FORM><<<1, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// ptrs: tris, order, offsets, x, v, direction, out, geom, ids, launches
// (geom and ids null in the SHARED form); ints: n, w, levels, form (0 SHARED,
// 1 GLOBAL), walkers.
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, double neg_alpha, double dt, void* stream) {
  Args<T> a;
  a.tris = reinterpret_cast<const int64_t*>(ptrs[0]);
  a.order = reinterpret_cast<const int*>(ptrs[1]);
  a.offsets = reinterpret_cast<const int*>(ptrs[2]);
  a.x = reinterpret_cast<const T*>(ptrs[3]);
  a.v = reinterpret_cast<const T*>(ptrs[4]);
  a.direction = reinterpret_cast<const T*>(ptrs[5]);
  a.out = reinterpret_cast<T*>(ptrs[6]);
  a.geom = reinterpret_cast<T*>(ptrs[7]);
  a.ids = reinterpret_cast<int*>(ptrs[8]);
  a.launches = reinterpret_cast<int*>(ptrs[9]);
  a.n = ints[0];
  a.w = ints[1];
  a.levels = ints[2];
  const int form = ints[3];
  a.walkers = ints[4];
  a.neg_alpha = T(neg_alpha);
  a.dt = T(dt);
  if (a.n <= 0) return 0;
  if (a.walkers < 32 || a.walkers > kThreads || a.walkers % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t staged = (static_cast<size_t>(a.n) * 3 + static_cast<size_t>(a.w) * 4) * sizeof(T) +
                        static_cast<size_t>(a.w) * 3 * sizeof(int);
  switch (form) {
    case kShared:
      return static_cast<int>(launch_form<T, kShared>(a, static_cast<int>(staged), s));
    case kGlobal:
      return static_cast<int>(launch_form<T, kGlobal>(a, 0, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int admm_wind_seq_f32(const uint64_t* ptrs, const int* ints, double neg_alpha,
                                 double dt, void* stream) {
  return launch<float>(ptrs, ints, neg_alpha, dt, stream);
}

extern "C" int admm_wind_seq_f64(const uint64_t* ptrs, const int* ints, double neg_alpha,
                                 double dt, void* stream) {
  return launch<double>(ptrs, ints, neg_alpha, dt, stream);
}
