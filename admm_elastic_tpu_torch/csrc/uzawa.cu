// Uzawa's Schur trip on the card: kernel L's full C^T in one launch
// (uzawa_ct_kernel) and kernel M, the trip's update (schur_trip_grid_kernel).
//
// Neither has a Pallas original. A Schur trip of solvers/uzawa.py (the port
// of admm_elastic_tpu/solvers/uzawa.py:41-125, whose body is jnp) is
//     q2 = A^-1 C^T d;  q3 = C q2 on the active rows;  the CG update.
// Around the A^-1 apply (the direct solve or kernel G, unchanged) it was
// some 98 plain PyTorch operations; here it is these two launches.
//
// L: out[v] = C^T [yp; yd] at vertex v, as collision/constraints.Ct_apply
// computes it: the passive row's own term (ck yp_s) n_p, yp masked by the
// passive mask; plus (with dynamic rows) the dynamic row's own term (ck yd_s)
// n_d, yd masked likewise; then the face corners of the active dynamic rows
// in table order (dyn_rows.cuh dyn_corners_ct). s is the vertex's query slot
// (slot_of, or the vertex itself where the query set is every vertex); a
// vertex outside the query set starts from +0. One thread a vertex. Its bound
// is bytes: the rows and the table read once, [N, 3] written once.
//
// M: one trip's update from q2 = A^-1 C^T d and the state x [N, 3], y, r, d
// [2H], k and done, as solvers/uzawa.py schur_trip_plain:
//   q3 = where(active, C q2, 0): a passive row ck (n . q2[v]), a dynamic row
//        dyn_row_value;
//   denom = d.q3, bad = |denom| < tiny, alpha = bad ? 0 : (d.r) / denom;
//   x -= alpha q2, y += alpha d, r -= alpha q3;
//   small = r.r < tol^2, beta = bad ? 0 : (r.q3) / denom, d = r - beta d;
//   k += 1, done = bad | small,
// all of it skipped where done is set on entry (the trips after the exit).
// Each dot sums in one fixed order that no launch shape changes: element i
// goes to partial i mod kParts (1,024), added in index order from +0, then a
// pairwise tree over the partials (partial t plus partial t + 512, then +
// 256, ..., + 1): ops/cuda_uzawa.py fixed_dot, the plain twin. The products
// are rounded to T; the partials and the tree are summed in double and the
// sum rounded to T once (a float32 run's dots nearly exact, as the CG's
// scalars want them; a float64 run's in its own type). M is a cooperative
// grid of blocks of kParts threads (a thread a row or an element of x,
// ops/cuda_uzawa.m_blocks) with one grid barrier (schur_trip_grid_kernel
// below). No float atomic; every
// operation an IEEE-rounded intrinsic (DynOp, __fdiv_rn / __ddiv_rn), no
// contraction into an fma. Its bound is bytes (the rows, the state and q2
// read, the state written); at these sizes it is latency: the launch and the
// barrier are most of it but at floor_uzawa67k. A form in one block of kParts
// threads (the rows t, t + kParts, ... a thread, no grid barrier) took 40.7 us
// there against this form's 13.8, and 8.5-8.7 against 9.0-9.2 on the smaller
// paths; it was measured and dropped (PERF.md §6).
//
// Scene forms (scenario batching, admm_elastic_tpu_torch/parallel/batch.py;
// jax.vmap of the JAX package's Uzawa solve, admm_elastic_tpu/parallel/
// batch.py:191-227): S scenes' passive rows (mask [S, H], normal [S, H, 3])
// on one query set (vidx / slot shared) and their per-scene state. L's
// (uzawa_ct_scenes_kernel) puts the scene on the grid's y and runs ct_vertex
// at the scene's offset. M's (schur_trip_scenes_kernel) is one cooperative
// launch of teams of blocks, each team with a barrier of its own
// (grid_sync.cuh team_barrier) taking scenes t, t + teams, ... in turn by
// trip_body, so any S runs on a grid the card holds at once; each scene's
// scratch is its own, so no team waits between scenes. A trip's sums do not
// depend on the blocks that make them, so each scene of either form is bit
// for bit the single-scene launch on its tensors, and a scene's done freezes
// that scene alone. Dynamic rows in a batch are not ported (ROADMAP Queue 1
// item 12b).
//
// ADMM_M_FLOOR=1 (a measurement's build, chip_smoke.floor_library) is M's
// latency floor: the launch, the done read, the barrier and the block
// reductions, of zeros, with no row and no state read or written (one scratch
// value keeps the reductions).

#include <cstdint>
#include <cuda_runtime.h>

#include "dyn_rows.cuh"
#include "grid_sync.cuh"

#ifndef ADMM_M_FLOOR
#define ADMM_M_FLOOR 0
#endif

namespace {

constexpr int kParts = 1024;  // the dots' partials: ops/cuda_uzawa.py PARTS
constexpr int kCtThreads = 256;

template <typename T> struct Div;
template <> struct Div<float> {
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
};
template <> struct Div<double> {
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
};

// The passive rows of one detection.
template <typename T>
struct PassiveRows {
  const unsigned char* mask;  // [H] bool
  const int64_t* vidx;        // [H] each row's vertex
  const T* normal;            // [H, 3]
};

// --- L: C^T [yp; yd] -------------------------------------------------------------

template <typename T>
struct CtArgs {
  PassiveRows<T> p;
  DynRows<T> d;   // order / start unread without dynamic rows
  const T* y;     // [2H]: yp, then yd
  T* out;         // [N, 3]
  int n, may_dyn;
};

// Vertex v of C^T [yp; yd]: its passive row's term, its dynamic row's, then
// its face corners' in table order.
template <typename T>
__device__ __forceinline__ void ct_vertex(const CtArgs<T>& a, int v) {
  using O = DynOp<T>;
  const T ck = *a.d.ck;
  const int h = a.d.h;
  T acc[3] = {T(0), T(0), T(0)};
  const int s = a.d.slot ? a.d.slot[v] : v;
  if (s >= 0) {
    const T cp = O::mul(ck, a.p.mask[s] ? a.y[s] : T(0));
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = O::mul(cp, a.p.normal[s * 3 + k]);
    if (a.may_dyn) {
      const T cd = O::mul(ck, a.d.mask[s] ? a.y[h + s] : T(0));
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = O::add(acc[k], O::mul(cd, a.d.normal[s * 3 + k]));
    }
  }
  if (a.may_dyn) {
    const T* yd = a.y + h;
    const unsigned char* dm = a.d.mask;
    dyn_corners_ct(a.d, v, ck, [yd, dm](int64_t r) { return dm[r] ? yd[r] : T(0); }, acc);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) a.out[(int64_t)v * 3 + k] = acc[k];
}

template <typename T>
__global__ void __launch_bounds__(kCtThreads) uzawa_ct_kernel(const __grid_constant__ CtArgs<T> a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v < a.n) ct_vertex(a, v);
}

// L's scene form: scene s = blockIdx.y of S, its passive rows (mask [S, H],
// normal [S, H, 3]) on the shared query set (vidx / slot), y [S, 2H] and out
// [S, N, 3] at scene s's offset; the vertex's sum is ct_vertex's, so scene s
// is bit for bit the single-scene launch on its rows. Passive rows only.
template <typename T>
__global__ void __launch_bounds__(kCtThreads)
    uzawa_ct_scenes_kernel(const __grid_constant__ CtArgs<T> a) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= a.n) return;
  const int64_t s = blockIdx.y, h = a.d.h;
  CtArgs<T> c = a;
  c.p.mask += s * h;
  c.p.normal += s * h * 3;
  c.y += s * 2 * h;
  c.out += s * a.n * 3;
  ct_vertex(c, v);
}

// --- M: the trip's update ------------------------------------------------------

template <typename T>
struct TripArgs {
  PassiveRows<T> p;
  DynRows<T> d;
  const T* q2;         // [N, 3]
  T* x;                // [N, 3]
  T* y;                // [2H]
  T* r;                // [2H]
  T* dir;              // [2H] the Schur direction d
  T* q3;               // [2H] scratch
  T* prod;             // [3, 2H] scratch: two products and r
  Barrier* bar;        // the grid barrier
  int* k;              // the trips taken
  unsigned char* done; // bool
  T tiny, tol2;
  int n, may_dyn;
};

// Row i of q3 = where(active, C q2, 0).
template <typename T>
__device__ __forceinline__ T q3_row(const TripArgs<T>& a, int i, T ck) {
  using O = DynOp<T>;
  const int h = a.d.h;
  if (i < h) {
    if (!a.p.mask[i]) return T(0);
    const int64_t v = a.p.vidx[i];
    T n[3], q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = a.p.normal[i * 3 + k];
      q[k] = a.q2[v * 3 + k];
    }
    return O::mul(ck, dyn_dot3(n, q));
  }
  const int r = i - h;
  if (!a.may_dyn || !a.d.mask[r]) return T(0);
  const T* q2 = a.q2;
  return dyn_row_value(a.d, r, ck, [q2](int64_t v, T out[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = q2[v * 3 + k];
  });
}

// The dots' partials and tree are summed in double whatever T (a float32
// run's products are widened exactly, and the sum is rounded to T once).
using Acc = double;

// The sums of the block's partials s0, s1 (thread t holding partial t) by the
// fixed pairwise tree (partial t plus partial t + stride, stride = 512, 256,
// ..., 1: ops/cuda_uzawa.fixed_dot's tree), rounded to T; every thread gets
// both. red: [2][kParts] shared.
template <typename T>
__device__ __forceinline__ void tree2(Acc (*red)[kParts], Acc s0, Acc s1, T& t0, T& t1) {
  const int t = threadIdx.x;
  red[0][t] = s0;
  red[1][t] = s1;
#pragma unroll
  for (int stride = kParts / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (t < stride) {
      red[0][t] = __dadd_rn(red[0][t], red[0][t + stride]);
      red[1][t] = __dadd_rn(red[1][t], red[1][t + stride]);
    }
  }
  __syncthreads();
  t0 = static_cast<T>(red[0][0]);  // round to nearest
  t1 = static_cast<T>(red[1][0]);
  __syncthreads();  // red is free again
}

// Thread t's partials of two stored product rows p0, p1 [m]: the rows t,
// t + kParts, ... added in index order from +0, in Acc.
template <typename T>
__device__ __forceinline__ void partials2(const T* p0, const T* p1, int m, Acc& s0, Acc& s1) {
  s0 = Acc(0);
  s1 = Acc(0);
#pragma unroll 8
  for (int i = threadIdx.x; i < m; i += kParts) {
    s0 = __dadd_rn(s0, static_cast<Acc>(p0[i]));
    s1 = __dadd_rn(s1, static_cast<Acc>(p1[i]));
  }
}

// M: a cooperative grid of blocks of kParts threads, the rows and x spread
// over all of its threads, one grid barrier a trip. Before it each
// thread stores its rows' q3, r and the first two dots' products ([4, 2H]
// scratch: p0 = d q3, p1 = d r, rs = r, q3). After it every block sums the
// products itself in the fixed order (partials2, tree2), and then the other
// two dots from rs and q3, r_n = rs - alpha q3 formed anew for each row in
// the partials' order: the same sums and alpha, beta in every block, with no
// second barrier and no third to hand them out. Then each thread writes its
// own rows of y, r, d and x; no block reads them after the barrier.
//
// trip_body is one trip on the blocks 0..nb-1 of a team (the grid, or in the
// scene form the team that holds the scene), b this block's rank in it, bar
// the team's barrier.
template <typename T>
__device__ __forceinline__ void trip_body(const TripArgs<T>& a, unsigned b, unsigned nb,
                                          Barrier* bar, Acc (*red)[kParts]) {
  using O = DynOp<T>;
  if (*a.done) return;  // read by every block before the barrier, written after it
  const int g = b * kParts + threadIdx.x;
  const int stride = static_cast<int>(nb) * kParts;
  const int m = 2 * a.d.h;
  const T ck = *a.d.ck;
  T* p0 = a.prod;
  T* p1 = a.prod + m;
  T* rs = a.prod + 2 * m;
#if !ADMM_M_FLOOR
  for (int i = g; i < m; i += stride) {
    const T q = q3_row(a, i, ck);
    const T di = a.dir[i], ri = a.r[i];
    a.q3[i] = q;
    rs[i] = ri;
    p0[i] = O::mul(di, q);
    p1[i] = O::mul(di, ri);
  }
#endif
  grid_sync(bar, nb);
  const int mm = ADMM_M_FLOOR ? 0 : m;
  Acc s0, s1;
  T denom, dr;
  partials2(p0, p1, mm, s0, s1);
  tree2(red, s0, s1, denom, dr);
  const bool bad = (denom < T(0) ? -denom : denom) < a.tiny;  // torch.abs, then <
  const T alpha = bad ? T(0) : Div<T>::div(dr, denom);
  s0 = Acc(0);
  s1 = Acc(0);
#pragma unroll 4
  for (int i = threadIdx.x; i < mm; i += kParts) {
    const T q = a.q3[i];
    const T rn = O::sub(rs[i], O::mul(alpha, q));
    s0 = __dadd_rn(s0, static_cast<Acc>(O::mul(rn, rn)));
    s1 = __dadd_rn(s1, static_cast<Acc>(O::mul(rn, q)));
  }
  T rr, rq;
  tree2(red, s0, s1, rr, rq);
  const bool small = rr < a.tol2;
  const T beta = bad ? T(0) : Div<T>::div(rq, denom);
#if !ADMM_M_FLOOR
  for (int i = g; i < m; i += stride) {
    const T rn = O::sub(rs[i], O::mul(alpha, a.q3[i]));
    const T di = a.dir[i];
    a.y[i] = O::add(a.y[i], O::mul(alpha, di));
    a.r[i] = rn;
    a.dir[i] = O::sub(rn, O::mul(beta, di));
  }
  const int nx = 3 * a.n;
  for (int j = g; j < nx; j += stride) a.x[j] = O::sub(a.x[j], O::mul(alpha, a.q2[j]));
  if (g == 0) {
    *a.k += 1;
    *a.done = bad || small;
  }
#else
  if (g == 0 && m > 0) a.q3[0] = O::add(O::add(rr, rq), beta);  // keeps the reductions
#endif
}

template <typename T>
__global__ void __launch_bounds__(kParts)
    schur_trip_grid_kernel(const __grid_constant__ TripArgs<T> a) {
  __shared__ Acc red[2][kParts];
  trip_body(a, blockIdx.x, gridDim.x, a.bar, red);
}

// M's scene form: S scenes' trips in one cooperative launch of teams x bps
// blocks. Team t (blocks t bps .. t bps + bps - 1, its own barrier bar + t)
// takes scenes t, t + teams, ... in turn, each as trip_body on its bps
// blocks: scene s's rows (mask [S, H], normal [S, H, 3]; the query set
// shared), q2 and x [S, N, 3], y, r, d [S, 2H], k and done [S] and its
// scratch (q3 [S, 2H], products [S, 3, 2H]) at scene s's offset. A trip's
// sums do not depend on the blocks that take it, so scene s is bit for bit
// the single-scene launch on its tensors, and its done freezes it alone. Any
// S runs on a grid the card holds at once. Passive rows only.
struct SceneTeams {
  int scenes, teams, bps;
};

template <typename T>
__global__ void __launch_bounds__(kParts)
    schur_trip_scenes_kernel(const __grid_constant__ TripArgs<T> a,
                             const __grid_constant__ SceneTeams st) {
  __shared__ Acc red[2][kParts];
  const int team = blockIdx.x / st.bps, rank = blockIdx.x % st.bps;
  Barrier* bar = team_barrier(a.bar, team);
  const int64_t h2 = 2 * (int64_t)a.d.h, n3 = 3 * (int64_t)a.n;
  for (int64_t s = team; s < st.scenes; s += st.teams) {
    TripArgs<T> c = a;
    c.p.mask += s * a.d.h;
    c.p.normal += s * a.d.h * 3;
    c.q2 += s * n3;
    c.x += s * n3;
    c.y += s * h2;
    c.r += s * h2;
    c.dir += s * h2;
    c.q3 += s * h2;
    c.prod += s * 3 * h2;
    c.k += s;
    c.done += s;
    trip_body(c, rank, st.bps, bar, red);
  }
}

// The blocks of kernel fn (of kParts threads) the card holds at once (minus
// a CUDA error code on failure).
template <typename K>
int grid_blocks(K fn) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kParts, 0);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  return per_sm * sms;
}

// ptrs: p_mask, p_vidx, p_normal, d_mask, d_vidx, d_face, d_barys, d_normal,
// ck, d_order, d_start, slot_of (or null: row = vertex); then the launch's
// own. Null order / start without dynamic rows.
template <typename T>
void rows_of(const uint64_t* p, int h, PassiveRows<T>& pr, DynRows<T>& d) {
  pr.mask = reinterpret_cast<const unsigned char*>(p[0]);
  pr.vidx = reinterpret_cast<const int64_t*>(p[1]);
  pr.normal = reinterpret_cast<const T*>(p[2]);
  d.mask = reinterpret_cast<const unsigned char*>(p[3]);
  d.vidx = reinterpret_cast<const int64_t*>(p[4]);
  d.face = reinterpret_cast<const int64_t*>(p[5]);
  d.barys = reinterpret_cast<const T*>(p[6]);
  d.normal = reinterpret_cast<const T*>(p[7]);
  d.ck = reinterpret_cast<const T*>(p[8]);
  d.order = reinterpret_cast<const int64_t*>(p[9]);
  d.start = reinterpret_cast<const int64_t*>(p[10]);
  d.slot = reinterpret_cast<const int*>(p[11]);
  d.h = h;
}
constexpr int kRowPtrs = 12;

// ptrs: the rows (rows_of), y [2H], out [N, 3]; ints: n, h, may_dyn.
template <typename T>
int ct(const uint64_t* p, const int* ints, void* stream) {
  CtArgs<T> a;
  rows_of(p, ints[1], a.p, a.d);
  a.y = reinterpret_cast<const T*>(p[kRowPtrs]);
  a.out = reinterpret_cast<T*>(p[kRowPtrs + 1]);
  a.n = ints[0];
  a.may_dyn = ints[2];
  if (a.n <= 0) return 0;
  if (a.may_dyn && !(a.d.order && a.d.start)) return static_cast<int>(cudaErrorInvalidValue);
  uzawa_ct_kernel<T><<<(a.n + kCtThreads - 1) / kCtThreads, kCtThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: the rows (rows_of), y [S, 2H], out [S, N, 3]; ints: n, h, S (passive
// rows: mask and normal [S, H]).
template <typename T>
int ct_scenes(const uint64_t* p, const int* ints, void* stream) {
  CtArgs<T> a;
  rows_of(p, ints[1], a.p, a.d);
  a.y = reinterpret_cast<const T*>(p[kRowPtrs]);
  a.out = reinterpret_cast<T*>(p[kRowPtrs + 1]);
  a.n = ints[0];
  a.may_dyn = 0;
  const int scenes = ints[2];
  if (a.n <= 0 || scenes <= 0) return 0;
  if (scenes > 65535) return static_cast<int>(cudaErrorInvalidValue);
  uzawa_ct_scenes_kernel<T><<<dim3((a.n + kCtThreads - 1) / kCtThreads, scenes), kCtThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: the rows (rows_of; slot unread), q2, x, y, r, d, q3, k, done, prod,
// barrier; ints: n, h, may_dyn, blocks (the grid, at most admm_schur_blocks).
template <typename T>
int trip(const uint64_t* p, const int* ints, double tiny, double tol2, void* stream) {
  TripArgs<T> a;
  rows_of(p, ints[1], a.p, a.d);
  a.q2 = reinterpret_cast<const T*>(p[kRowPtrs]);
  a.x = reinterpret_cast<T*>(p[kRowPtrs + 1]);
  a.y = reinterpret_cast<T*>(p[kRowPtrs + 2]);
  a.r = reinterpret_cast<T*>(p[kRowPtrs + 3]);
  a.dir = reinterpret_cast<T*>(p[kRowPtrs + 4]);
  a.q3 = reinterpret_cast<T*>(p[kRowPtrs + 5]);
  a.k = reinterpret_cast<int*>(p[kRowPtrs + 6]);
  a.done = reinterpret_cast<unsigned char*>(p[kRowPtrs + 7]);
  a.prod = reinterpret_cast<T*>(p[kRowPtrs + 8]);
  a.bar = reinterpret_cast<Barrier*>(p[kRowPtrs + 9]);
  a.tiny = static_cast<T>(tiny);
  a.tol2 = static_cast<T>(tol2);
  a.n = ints[0];
  a.may_dyn = ints[2];
  const int blocks = ints[3];
  if (a.n < 0 || a.d.h < 0 || blocks < 1 || a.prod == nullptr || a.bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(schur_trip_grid_kernel<T>), dim3(blocks), dim3(kParts), params, 0,
      static_cast<cudaStream_t>(stream)));
}

// The scene form: ptrs as trip's with every per-scene tensor [S, ...] and
// the barrier an array of teams barriers (kBarrierInts ints each); ints: n,
// h, S, teams, bps (teams x bps blocks, at most admm_schur_blocks). Passive
// rows only.
template <typename T>
int trip_scenes(const uint64_t* p, const int* ints, double tiny, double tol2, void* stream) {
  TripArgs<T> a;
  rows_of(p, ints[1], a.p, a.d);
  a.q2 = reinterpret_cast<const T*>(p[kRowPtrs]);
  a.x = reinterpret_cast<T*>(p[kRowPtrs + 1]);
  a.y = reinterpret_cast<T*>(p[kRowPtrs + 2]);
  a.r = reinterpret_cast<T*>(p[kRowPtrs + 3]);
  a.dir = reinterpret_cast<T*>(p[kRowPtrs + 4]);
  a.q3 = reinterpret_cast<T*>(p[kRowPtrs + 5]);
  a.k = reinterpret_cast<int*>(p[kRowPtrs + 6]);
  a.done = reinterpret_cast<unsigned char*>(p[kRowPtrs + 7]);
  a.prod = reinterpret_cast<T*>(p[kRowPtrs + 8]);
  a.bar = reinterpret_cast<Barrier*>(p[kRowPtrs + 9]);
  a.tiny = static_cast<T>(tiny);
  a.tol2 = static_cast<T>(tol2);
  a.n = ints[0];
  a.may_dyn = 0;
  SceneTeams st{ints[2], ints[3], ints[4]};
  if (st.scenes == 0) return 0;
  if (a.n < 0 || a.d.h < 0 || st.scenes < 0 || st.teams < 1 || st.bps < 1 ||
      a.prod == nullptr || a.bar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a, &st};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(schur_trip_scenes_kernel<T>), dim3(st.teams * st.bps), dim3(kParts),
      params, 0, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int admm_uzawa_ct_scenes_f32(const uint64_t* p, const int* ints, void* stream) {
  return ct_scenes<float>(p, ints, stream);
}
extern "C" int admm_uzawa_ct_scenes_f64(const uint64_t* p, const int* ints, void* stream) {
  return ct_scenes<double>(p, ints, stream);
}
extern "C" int admm_schur_trip_scenes_f32(const uint64_t* p, const int* ints, double tiny,
                                          double tol2, void* stream) {
  return trip_scenes<float>(p, ints, tiny, tol2, stream);
}
extern "C" int admm_schur_trip_scenes_f64(const uint64_t* p, const int* ints, double tiny,
                                          double tol2, void* stream) {
  return trip_scenes<double>(p, ints, tiny, tol2, stream);
}

extern "C" int admm_uzawa_ct_f32(const uint64_t* p, const int* ints, void* stream) {
  return ct<float>(p, ints, stream);
}
extern "C" int admm_uzawa_ct_f64(const uint64_t* p, const int* ints, void* stream) {
  return ct<double>(p, ints, stream);
}
extern "C" int admm_schur_trip_f32(const uint64_t* p, const int* ints, double tiny, double tol2,
                                   void* stream) {
  return trip<float>(p, ints, tiny, tol2, stream);
}
extern "C" int admm_schur_trip_f64(const uint64_t* p, const int* ints, double tiny, double tol2,
                                   void* stream) {
  return trip<double>(p, ints, tiny, tol2, stream);
}
// The most blocks M's grid takes at once, in float32 (f64 = 0) or
// float64 (a negative CUDA error where the query fails).
extern "C" int admm_schur_blocks(int f64) {
  return f64 ? grid_blocks(schur_trip_grid_kernel<double>)
             : grid_blocks(schur_trip_grid_kernel<float>);
}
// The same for M's scene form.
extern "C" int admm_schur_scene_blocks(int f64) {
  return f64 ? grid_blocks(schur_trip_scenes_kernel<double>)
             : grid_blocks(schur_trip_scenes_kernel<float>);
}
