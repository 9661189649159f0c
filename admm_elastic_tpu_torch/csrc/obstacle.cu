// Kernel J: one mesh obstacle's detection at V query lanes, one launch.
//
// It has no Pallas original. It replaces the jnp narrow phases of the JAX
// package's mesh obstacles, PassiveMeshSDF.signed_distance_with_overflow
// (admm_elastic_tpu/collision/passive.py:120-179) and
// PassiveMeshExact.signed_distance_with_overflow / _narrow (:401-546), which
// a contact solver (Uzawa, AL-PCG) runs once per ADMM iteration
// (admm_elastic_tpu/solver.py:291-294). As plain PyTorch the exact phase is
// some 40 launches and keeps several [V, Kf, 3, 3] tensors of the gathered
// candidate corners (tens of MB at 15,616 lanes). The plain versions are
// admm_elastic_tpu_torch/collision/passive.py; chip_smoke.py holds this
// kernel to them on the card (float64 within 1e-12, the same hit masks).
// The lane's arithmetic is obstacle_body.cuh's.
//
// One block of kThreads threads walks the lanes in chunks, so that the
// compactions can rank in lane order with a block-wide prefix count:
// 1. with near_lanes = K (0 < K < V): a lane is near where its SDF cell's
//    least corner is < 0, or its exact cell is in the grid and tet-occupied;
//    the first K near lanes in lane order are listed for the narrow phase,
//    every other lane reports no hit (dx 1e30, point and normal 0); more
//    than K near lanes set the overflow. Else every lane is evaluated;
// 2. the narrow phase of each listed lane, a thread each: the SDF's blend
//    (then done), or the exact candidates; a lane in an occupied cell with no
//    candidate, or whose nearest lies beyond capture_cells * h, needs the
//    deep fallback, and those are ranked in lane order again;
// 3. (exact) the first min(fallback_lanes, listed lanes) of them, a warp
//    each, take the first least over the whole triangle soup;
// 4. (exact) the rest are demoted to no hit and set the overflow; the sign.
// The overflow flag is set in a device int (thread 0, one store; a captured
// step never reads it). No atomics: the result is the same bits every run.
//
// What bounds it: latency. The bytes are a few MB at most (the lanes and the
// outputs once, the tables from L2); the operations a few MFLOP (some 70 a
// candidate triangle). A detection is a chain of block-wide prefix counts
// (one per 1,024 lanes, each two barriers) and each thread's walk of its
// lane's candidate list, two dependent loads a candidate (the table entry,
// then its corners). A simple kernel first: one block, a thread per lane;
// spreading the walk over more blocks is later work (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "obstacle_body.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct JArgs {
  Mesh<T> o;
  const T* x;            // [V, 3] query lanes
  T* dx;                 // [V] out
  T* point;              // [V, 3] out
  T* normal;             // [V, 3] out
  unsigned char* mask;   // [V] out: dx < 0
  int* overflow;         // [1]: set to 1 where a stage dropped a lane
  int* list;             // [V] scratch: the evaluated lanes, in lane order
  int* flags;            // [V] scratch, by list entry: 1 any_face, 2 near_tet, 4 need, 8 served
  int* fb_list;          // [max(k_fb, 1)] scratch: the served entries, in order
  int v;
};

template <typename T>
__device__ __forceinline__ void load3(const T* x, int lane, T p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p[r] = x[static_cast<int64_t>(lane) * 3 + r];
}

template <typename T>
__device__ __forceinline__ void store3(T* x, int lane, const T p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) x[static_cast<int64_t>(lane) * 3 + r] = p[r];
}

template <typename T>
__device__ __forceinline__ void no_hit(const JArgs<T>& a, int lane) {
  const T z[3] = {T(0), T(0), T(0)};
  a.dx[lane] = T(kBig);
  store3(a.point, lane, z);
  store3(a.normal, lane, z);
  a.mask[lane] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mesh_detect_kernel(const __grid_constant__ JArgs<T> a) {
  using O = Op<T>;
  __shared__ int sm[kWarps];
  const Mesh<T>& o = a.o;
  const int tid = threadIdx.x, V = a.v, K = o.near_lanes;
  const bool compact = K > 0 && K < V;
  const bool sdf = o.kind == MESH_SDF;

  // 1. the near lanes, ranked in lane order
  int near_total = 0;
  if (compact) {
    for (int b = 0; b < V; b += kThreads) {
      const int lane = b + tid;
      bool near = false;
      if (lane < V) {
        T p[3];
        load3(a.x, lane, p);
        if (sdf) {
          T f[3];
          near = sdf_near(o, sdf_cell(o, p, f));
        } else {
          bool in_grid;
          const int cid = exact_cell(o, p, in_grid);
          near = in_grid && exact_near_tet(o, cid);
        }
      }
      int total;
      const int r = near_total + block_rank<kThreads>(near, sm, total);
      if (lane < V) {
        if (near && r < K)
          a.list[r] = lane;
        else
          no_hit(a, lane);
      }
      near_total += total;
    }
    __syncthreads();  // the list, for every thread
  }
  const int n_eval = compact ? (near_total < K ? near_total : K) : V;
  const bool near_ovf = compact && near_total > K;

  // 2. the narrow phase
  if (sdf) {
    for (int e = tid; e < n_eval; e += kThreads) {
      const int lane = compact ? a.list[e] : e;
      T p[3], f[3], n[3], pt[3];
      load3(a.x, lane, p);
      const T d = sdf_blend(o, sdf_cell(o, p, f), f, n);
      const bool keep = d < T(1e29);  // a far lane's point is zeroed
#pragma unroll
      for (int r = 0; r < 3; ++r) pt[r] = keep ? O::sub(p[r], O::mul(d, n[r])) : T(0);
      a.dx[lane] = d;
      store3(a.point, lane, pt);
      store3(a.normal, lane, n);
      a.mask[lane] = d < T(0);
    }
    if (tid == 0 && near_ovf) *a.overflow = 1;
    return;
  }
  const int seen = compact ? K : V;  // the lanes the plain _narrow sees
  const int k_fb = o.fallback_lanes < seen ? o.fallback_lanes : seen;
  const T capture = O::mul(T(o.capture_cells), o.h[0]);
  int need_total = 0;
  for (int b = 0; b < n_eval; b += kThreads) {
    const int e = b + tid;
    bool need = false;
    if (e < n_eval) {
      const int lane = compact ? a.list[e] : e;
      T p[3], cl[3], n[3], dist;
      bool in_grid, any_face;
      load3(a.x, lane, p);
      const int cid = exact_cell(o, p, in_grid);
      const bool valid = compact || in_grid;  // a listed lane is near, so in the grid
      candidates(o, p, cid, valid, dist, cl, n, any_face);
      const bool near_tet = exact_near_tet(o, cid);
      need = valid && near_tet && (!any_face || dist > capture);
      a.dx[lane] = dist;
      store3(a.point, lane, cl);
      store3(a.normal, lane, n);
      a.flags[e] = (any_face ? 1 : 0) | (near_tet ? 2 : 0) | (need ? 4 : 0);
    }
    int total;
    const int r = need_total + block_rank<kThreads>(need, sm, total);
    if (need && r < k_fb && o.n_tris > 0) {
      a.fb_list[r] = e;
      a.flags[e] |= 8;
    }
    need_total += total;
  }
  __syncthreads();
  const int served = (k_fb > 0 && o.n_tris > 0) ? (need_total < k_fb ? need_total : k_fb) : 0;

  // 3. the deep fallback, a warp per served lane
  for (int s = tid >> 5; s < served; s += kWarps) {
    const int e = a.fb_list[s];
    const int lane = compact ? a.list[e] : e;
    T p[3], cl[3], n[3], dist;
    load3(a.x, lane, p);
    brute_force_warp(o, p, dist, cl, n);
    if ((tid & 31) == 0) {
      a.dx[lane] = dist;
      store3(a.point, lane, cl);
      store3(a.normal, lane, n);
    }
  }
  __syncthreads();

  // 4. the sign; a lane the fallback could not serve reports no hit
  for (int e = tid; e < n_eval; e += kThreads) {
    const int lane = compact ? a.list[e] : e;
    const int fl = a.flags[e];
    const bool need = fl & 4, srv = fl & 8;
    const bool any_face = ((fl & 1) || srv) && !(need && !srv);
    T p[3], cl[3], n[3];
    load3(a.x, lane, p);
    load3(a.point, lane, cl);
    load3(a.normal, lane, n);
    const T d = exact_signed(p, a.dx[lane], cl, n, any_face, (fl & 2) != 0);
    a.dx[lane] = d;
    a.mask[lane] = d < T(0);
  }
  if (tid == 0 && (near_ovf || need_total > served)) *a.overflow = 1;
}

// ptrs: kMeshPtrs of the obstacle, then x, dx, point, normal, mask, overflow,
// list, flags, fb_list; ints: kMeshInts of the obstacle, then V.
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, double capture_cells, void* stream) {
  JArgs<T> a;
  a.o = mesh_from<T>(ints, ptrs, capture_cells);
  const uint64_t* q = ptrs + kMeshPtrs;
  a.x = reinterpret_cast<const T*>(q[0]);
  a.dx = reinterpret_cast<T*>(q[1]);
  a.point = reinterpret_cast<T*>(q[2]);
  a.normal = reinterpret_cast<T*>(q[3]);
  a.mask = reinterpret_cast<unsigned char*>(q[4]);
  a.overflow = reinterpret_cast<int*>(q[5]);
  a.list = reinterpret_cast<int*>(q[6]);
  a.flags = reinterpret_cast<int*>(q[7]);
  a.fb_list = reinterpret_cast<int*>(q[8]);
  a.v = ints[kMeshInts];
  if (a.v <= 0) return 0;
  if (a.o.kind != MESH_SDF && a.o.kind != MESH_EXACT) return static_cast<int>(cudaErrorInvalidValue);
  mesh_detect_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int admm_mesh_detect_f32(const uint64_t* ptrs, const int* ints, double capture_cells,
                                    void* stream) {
  return launch<float>(ptrs, ints, capture_cells, stream);
}

extern "C" int admm_mesh_detect_f64(const uint64_t* ptrs, const int* ints, double capture_cells,
                                    void* stream) {
  return launch<double>(ptrs, ints, capture_cells, stream);
}
