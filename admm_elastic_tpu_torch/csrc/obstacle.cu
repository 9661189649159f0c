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
// kernel to them on the card, bit for bit in float32 and float64.
// The lane's arithmetic is obstacle_body.cuh's.
//
// Persistent blocks of kThreads threads over the card, one a SM, launched
// cooperatively (cudaLaunchCooperativeKernel: the runtime refuses a grid that
// cannot be resident at once, which the grid barrier needs; a refused launch
// raises), separated by grid_sync (grid_sync.cuh: integer acquire / release,
// no float atomic). Block b owns a contiguous span of lanes, and of list
// entries, so that each compaction ranks in lane order: the block counts its
// own flags with block_rank, writes its count, and after the barrier adds the
// counts of the blocks before it.
// 1. with near_lanes = K (0 < K < V): a lane is near where its SDF cell's
//    least corner is < 0, or its exact cell is in the grid and tet-occupied;
//    the first K near lanes in lane order are listed for the narrow phase,
//    every other lane reports no hit (dx 1e30, point and normal 0); more
//    than K near lanes set the overflow. Else every lane is evaluated;
// 2. the narrow phase of each listed entry: the SDF's blend a thread each
//    (then done); the exact candidates a group of g threads each
//    (group_size: the largest power of two <= 32, and <= a table row, that
//    gives the block's entries a group each; obstacle_body.cuh candidates).
//    A lane in an occupied cell with no candidate, or whose nearest lies
//    beyond capture_cells * h, needs the deep fallback; every other lane is
//    done, sign and all;
// 3. (exact) the deep entries ranked in entry (= lane) order; the first
//    min(fallback_lanes, listed lanes) of them take the first least over the
//    whole triangle soup, a warp each over the grid, and their sign; the
//    rest are demoted to no hit and set the overflow.
// Grid barriers: two after step 1 (counts, list) where it compacts, one
// after step 2's counts (exact), one before the fallback where a lane
// needs it. The overflow flag is set in a device int (one store, by block
// 0's thread 0, after the last barrier; a captured step never reads it). No
// atomic touches a result: it is the same bits every run, on any grid.
//
// The scene form (mesh_detect_scenes_kernel; scenario batching, the JAX
// package's vmap of the narrow phase): S scenes' query lanes in one
// cooperative launch of teams of blocks, each team with a barrier of its own
// (grid_sync.cuh team_barrier) and its own scratch, taking scenes t, t +
// teams, ... in turn by the same detect as the single launch. The near lanes
// and the deep fallback are ranked within a scene and the overflow is a
// scene's, so each scene is bit for bit the single-scene launch on its
// lanes, whatever S; a team barrier ends each scene before its scratch is
// used again.
//
// What bounds it: latency. The bytes are a few MB at most (the lanes and the
// outputs once, the tables from L2); the operations a few MFLOP (some 70 a
// candidate triangle). On one block (one SM, a thread walking its lane's
// whole candidate list: some 129 steps on the 67k slab, each two dependent
// loads, the table entry and then its corners; the ranking 16 chunks in a
// row) a detection took 314 us (PERF.md); here the walk is some 129 / g
// steps a thread over every SM, the ranking one chunk a block and a few grid
// barriers. Staging the soup in each block's shared memory was measured in
// turns and lost: the corners come through the read-only path.

#include <cstdint>
#include <cuda_runtime.h>

#include "grid_sync.cuh"
#include "obstacle_body.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// One detection's lanes, outputs and scratch (a scene's, in the scene form).
template <typename T>
struct JView {
  const T* x;            // [V, 3] query lanes
  T* dx;                 // [V] out
  T* point;              // [V, 3] out
  T* normal;             // [V, 3] out
  unsigned char* mask;   // [V] out: dx < 0
  int* overflow;         // [1]: set to 1 where a stage dropped a lane
  int* list;             // [V] scratch: the evaluated lanes, in lane order
  int* need;             // [V] scratch, by list entry: 1 where it needs the fallback
  int* rank;             // [V] scratch: a lane's rank among its block's near lanes,
                         //   then an entry's among its block's deep entries
  int* counts;           // [2 grid] scratch: each block's near lanes, then its deep entries
  int* fb_list;          // [max(k_fb, 1)] scratch: the served lanes, in order
  Barrier* bar;          // zero before the first launch; every launch leaves it so
  int v;
};

template <typename T>
struct JArgs {
  Mesh<T> o;
  JView<T> a;
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
__device__ __forceinline__ void no_hit(const JView<T>& a, int lane) {
  const T z[3] = {T(0), T(0), T(0)};
  a.dx[lane] = T(kBig);
  store3(a.point, lane, z);
  store3(a.normal, lane, z);
  a.mask[lane] = 0;
}

// The sum of counts over the blocks before b and over all nb blocks, in
// every thread (counts written by other blocks before the last grid barrier:
// read from L2). sm: block_rank's, free between its calls.
__device__ __forceinline__ void blocks_before(const int* counts, int b, int nb, int* sm,
                                              int& before, int& total) {
  if (threadIdx.x < 32) {
    int bf = 0, tt = 0;
    for (int i = threadIdx.x; i < nb; i += 32) {
      const int c = __ldcg(counts + i);
      tt += c;
      bf += i < b ? c : 0;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      bf += __shfl_xor_sync(0xffffffffu, bf, off);
      tt += __shfl_xor_sync(0xffffffffu, tt, off);
    }
    if (threadIdx.x == 0) {
      sm[0] = bf;
      sm[1] = tt;
    }
  }
  __syncthreads();
  before = sm[0];
  total = sm[1];
  __syncthreads();
}

// One detection on the blocks 0..nb-1 of a team (the grid, or in the scene
// form the team that holds the scene), b this block's rank in it; sm: kWarps
// ints of shared memory.
template <typename T>
__device__ __forceinline__ void detect(const Mesh<T>& o, const JView<T>& a, int b, int nb,
                                       int* sm) {
  using O = Op<T>;
  const int tid = threadIdx.x, V = a.v, K = o.near_lanes;
  const bool compact = K > 0 && K < V;
  const bool sdf = o.kind == MESH_SDF;

  // 1. the near lanes, ranked in lane order: this block's, then the blocks' before it
  int near_total = 0;
  if (compact) {
    const int span = (V + nb - 1) / nb;
    const int lo = min(b * span, V), hi = min(lo + span, V);
    int mine = 0;
    for (int c = lo; c < hi; c += kThreads) {
      const int lane = c + tid;
      bool near = false;
      if (lane < hi) {
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
      const int r = mine + block_rank<kThreads>(near, sm, total);
      if (lane < hi) a.rank[lane] = near ? r : -1;
      mine += total;
    }
    if (tid == 0) a.counts[b] = mine;
    grid_sync(a.bar, nb);
    int before;
    blocks_before(a.counts, b, nb, sm, before, near_total);
    for (int lane = lo + tid; lane < hi; lane += kThreads) {
      const int r = a.rank[lane];
      if (r >= 0 && before + r < K)
        a.list[before + r] = lane;
      else
        no_hit(a, lane);
    }
    grid_sync(a.bar, nb);  // the list, for every block
  }
  const int n_eval = compact ? (near_total < K ? near_total : K) : V;
  const bool near_ovf = compact && near_total > K;

  // 2. the narrow phase
  if (sdf) {
    for (int e = b * kThreads + tid; e < n_eval; e += nb * kThreads) {
      const int lane = compact ? __ldcg(a.list + e) : e;
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
    if (b == 0 && tid == 0 && near_ovf) *a.overflow = 1;
    return;
  }
  const int seen = compact ? K : V;  // the lanes the plain _narrow sees
  const int k_fb = o.fallback_lanes < seen ? o.fallback_lanes : seen;
  const T capture = O::mul(T(o.capture_cells), o.h[0]);
  const int per = (n_eval + nb - 1) / nb;  // entries a block
  const int e_lo = min(b * per, n_eval), e_hi = min(e_lo + per, n_eval);
  const int g = group_size(per, kThreads, o.kf);
  for (int e = e_lo + tid / g; e < e_hi; e += kThreads / g) {  // a group an entry
    const int lane = compact ? __ldcg(a.list + e) : e;
    T p[3], cl[3], n[3], dist;
    bool in_grid, any_face;
    load3(a.x, lane, p);
    const int cid = exact_cell(o, p, in_grid);
    const bool valid = compact || in_grid;  // a listed lane is near, so in the grid
    candidates(o, p, cid, valid, g, dist, cl, n, any_face);
    if ((tid & (g - 1)) == 0) {
      const bool near_tet = exact_near_tet(o, cid);
      const bool need = valid && near_tet && (!any_face || dist > capture);
      store3(a.point, lane, cl);
      store3(a.normal, lane, n);
      a.need[e] = need;
      if (!need) {
        const T d = exact_signed(p, dist, cl, n, any_face, near_tet);
        a.dx[lane] = d;
        a.mask[lane] = d < T(0);
      }
    }
  }
  __syncthreads();  // the block's need flags

  // 3. the deep entries, ranked in entry order: this block's, then the blocks' before it
  int mine = 0;
  for (int c = e_lo; c < e_hi; c += kThreads) {
    const int e = c + tid;
    const bool need = e < e_hi && a.need[e];
    int total;
    const int r = mine + block_rank<kThreads>(need, sm, total);
    if (need) a.rank[e] = r;
    mine += total;
  }
  if (tid == 0) a.counts[nb + b] = mine;
  grid_sync(a.bar, nb);
  int before, need_total;
  blocks_before(a.counts + nb, b, nb, sm, before, need_total);
  const int served = (k_fb > 0 && o.n_tris > 0) ? (need_total < k_fb ? need_total : k_fb) : 0;
  if (need_total > 0) {
    for (int e = e_lo + tid; e < e_hi; e += kThreads) {
      if (!a.need[e]) continue;
      const int lane = compact ? __ldcg(a.list + e) : e;
      const int r = before + a.rank[e];
      if (r < served) {
        a.fb_list[r] = lane;
      } else {  // no place in the fallback: no hit (point and normal stay the candidates')
        a.dx[lane] = T(kBig);
        a.mask[lane] = 0;
      }
    }
  }
  if (served > 0) {
    grid_sync(a.bar, nb);  // the served lanes, for every block
    for (int s = b * kWarps + (tid >> 5); s < served; s += nb * kWarps) {  // a warp a lane
      const int lane = __ldcg(a.fb_list + s);
      T p[3], cl[3], n[3], dist;
      load3(a.x, lane, p);
      brute_force_warp(o, p, dist, cl, n);
      if ((tid & 31) == 0) {
        const T d = exact_signed(p, dist, cl, n, true, true);  // a deep lane is near a tet
        a.dx[lane] = d;
        store3(a.point, lane, cl);
        store3(a.normal, lane, n);
        a.mask[lane] = d < T(0);
      }
    }
  }
  if (b == 0 && tid == 0 && (near_ovf || need_total > served)) *a.overflow = 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mesh_detect_kernel(const __grid_constant__ JArgs<T> a) {
  __shared__ int sm[kWarps];
  detect(a.o, a.a, blockIdx.x, gridDim.x, sm);
}

// The scene form: S scenes' detections in one cooperative launch of teams x
// bps blocks. Team t (blocks t bps .. t bps + bps - 1, its barrier
// team_barrier(bar, t)) takes scenes t, t + teams, ... in turn, each as
// detect on its bps blocks: scene s's lanes x [S, V, 3] and outputs (dx,
// mask [S, V], point, normal [S, V, 3], overflow [S]) at scene s's offset,
// the team's scratch (list, need, rank [teams, V], counts [teams, 2 bps],
// fb_list [teams, max(k_fb, 1)]). The near lanes and the fallback's are
// ranked within the scene, and a detection's bits do not depend on the
// blocks that make it, so scene s is bit for bit the single-scene launch on
// its lanes. A barrier ends each scene, before the team's scratch is used
// again. Any S runs on a grid the card holds at once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mesh_detect_scenes_kernel(const __grid_constant__ JArgs<T> a, const int scenes,
                              const int teams, const int bps, const int k_fb) {
  __shared__ int sm[kWarps];
  const int team = blockIdx.x / bps, rank = blockIdx.x % bps;
  const int64_t v = a.a.v;
  JView<T> c = a.a;
  c.bar = team_barrier(a.a.bar, team);
  c.list += team * v;
  c.need += team * v;
  c.rank += team * v;
  c.counts += team * 2 * bps;
  c.fb_list += team * (int64_t)k_fb;
  for (int64_t s = team; s < scenes; s += teams) {
    JView<T> e = c;
    e.x += s * v * 3;
    e.dx += s * v;
    e.point += s * v * 3;
    e.normal += s * v * 3;
    e.mask += s * v;
    e.overflow += s;
    detect(a.o, e, rank, bps, sm);
    grid_sync(c.bar, bps);  // the team's scratch is free again
  }
}

// The most blocks a launch takes: one a SM, where the card holds one (minus
// a CUDA error code on failure). Two an SM, as many as it holds, took 23.1
// against 21.5 us on the 67k path's detection (PERF.md).
template <typename K>
int max_blocks(K fn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  return per_sm > 0 ? sms : 0;
}

// ptrs: kMeshPtrs of the obstacle, then x, dx, point, normal, mask, overflow,
// list, need, rank, counts, fb_list, barrier; ints: kMeshInts of the
// obstacle, then V, the grid (its blocks, at most max_blocks()), the scenes
// S (-1: one detection) and the teams (the scene form: grid = teams x bps,
// every per-scene tensor [S, ...], the scratch a team's, the barrier an
// array of teams barriers).
template <typename T>
int launch(const uint64_t* ptrs, const int* ints, double capture_cells, void* stream) {
  JArgs<T> args;
  args.o = mesh_from<T>(ints, ptrs, capture_cells);
  JView<T>& a = args.a;
  const uint64_t* q = ptrs + kMeshPtrs;
  a.x = reinterpret_cast<const T*>(q[0]);
  a.dx = reinterpret_cast<T*>(q[1]);
  a.point = reinterpret_cast<T*>(q[2]);
  a.normal = reinterpret_cast<T*>(q[3]);
  a.mask = reinterpret_cast<unsigned char*>(q[4]);
  a.overflow = reinterpret_cast<int*>(q[5]);
  a.list = reinterpret_cast<int*>(q[6]);
  a.need = reinterpret_cast<int*>(q[7]);
  a.rank = reinterpret_cast<int*>(q[8]);
  a.counts = reinterpret_cast<int*>(q[9]);
  a.fb_list = reinterpret_cast<int*>(q[10]);
  a.bar = reinterpret_cast<Barrier*>(q[11]);
  a.v = ints[kMeshInts];
  const int grid = ints[kMeshInts + 1];
  const int scenes = ints[kMeshInts + 2], teams = ints[kMeshInts + 3];
  if (a.v <= 0 || scenes == 0) return 0;
  const int kind = args.o.kind;
  if (kind != MESH_SDF && kind != MESH_EXACT) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || a.bar == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scenes < 0) {  // one detection
    void* params[] = {&args};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(mesh_detect_kernel<T>), dim3(grid), dim3(kThreads), params, 0,
        st));
  }
  // the scene form: grid = teams x bps
  if (teams < 1 || grid % teams != 0) return static_cast<int>(cudaErrorInvalidValue);
  int n_scenes = scenes, n_teams = teams, bps = grid / teams;
  int k_fb = args.o.fallback_lanes > 1 ? args.o.fallback_lanes : 1;
  void* params[] = {&args, &n_scenes, &n_teams, &bps, &k_fb};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(mesh_detect_scenes_kernel<T>), dim3(grid), dim3(kThreads), params,
      0, st));
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

// The most blocks kernel J's cooperative grid takes, in float32 (f64 = 0) or
// float64.
extern "C" int admm_mesh_blocks(int f64) {
  return f64 ? max_blocks(mesh_detect_kernel<double>) : max_blocks(mesh_detect_kernel<float>);
}
// The same for the scene form.
extern "C" int admm_mesh_scene_blocks(int f64) {
  return f64 ? max_blocks(mesh_detect_scenes_kernel<double>)
             : max_blocks(mesh_detect_scenes_kernel<float>);
}
