// Kernel H: one nodal-constrained multicolour Gauss-Seidel solve per launch.
//
// It has no Pallas original. It replaces the jnp loop of
// admm_elastic_tpu/solvers/gs.py solve (:147-196), without dynamic rows
// (may_have_dyn=False) and, in its DYN form below, with them: a lax.while_loop of SOR sweeps that stops on a device
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
//     the deepest obstacle at x_new (Floor, Sphere, PassiveMeshSDF,
//     PassiveMeshExact; the first of least distance); where it is hit
//     (distance < 0): delta = x_gs - p,
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
//
// Mesh obstacles (at most 8 obstacles of any kinds) come by pointer to their
// tables, with kernel J's device body (obstacle_body.cuh). A pass with one
// takes phases (mesh_pass): x_gs and x_new of every slot of the colour; each
// obstacle in order, a mesh one's near-lane compaction and deep fallback
// ranking the colour's slots by a block-wide prefix count once every x_new
// is known, as the JAX sweep detects on the colour's padded rows at once;
// then the projection, the pins and x. Its slots' values wait in global
// scratch between the phases; the exact walk takes a group of threads a
// slot (mesh_obstacle). A pass with the analytic obstacles alone is the
// one-go update_row above, unchanged.
//
// DYN: the self-collision rows folded in as a penalty A + C^T C, b + C^T c
// (the JAX package's may_have_dyn sweeps, admm_elastic_tpu/solvers/gs.py:85-106;
// the instantiation for a solver with colliders, with the analytic obstacles;
// with a mesh obstacle the wrapper raises). b is b_eff = b + C^T c and pen the
// penalty diagonal where(n_active > 0, diag(C^T C), 0), both formed by the
// wrapper with kernel L as the plain version forms them. Each colour pass
// first computes the active rows' C x from the x at the pass's start (a thread
// a row, into global scratch, then a barrier), as the plain colour update takes
// C^T C x of the x before it (hit-coupled vertices of one colour update
// Jacobi-style, the JAX package's accepted deviation); then each row of the
// colour gathers its C^T C x through dyn_rows.cuh (its own row's term, then its
// face corners in table order), lux = (lux + C^T C x) - pen x and a_ii = diag +
// pen per component. The residual adds C^T C x of the swept x, its rows
// computed first.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "dyn_rows.cuh"
#include "obstacle_body.cuh"

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
enum Kind { FLOOR = 0, SPHERE = 1 };  // and obstacle_body.cuh's MESH_SDF, MESH_EXACT
constexpr int kSlot = 20;  // a slot's scratch values in a pass with mesh obstacles (mesh_pass)

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
  Mesh<T> mesh[kMaxObstacles];  // the mesh obstacles' tables, by pointer
  T* scratch;                   // [width, kSlot] with mesh obstacles, else null
  int* iscratch;                // [2 width]: a slot's flags, then the fallback's slots
  // after the parent's fields: n_mesh beside n_obs moved omega and tol, which
  // cost floor_gs5k's solve 2 % (tools/h_turns.py, PERF.md)
  int n_mesh;
  int group;  // threads a slot in the exact walk: 0 the rule (group_size), or 1-32
  // DYN: the dynamic rows and their table, the penalty diagonal [N, 3], and
  // the rows' C x [H] (scratch)
  DynRows<T> dyn;
  const T* pen;
  T* rd;
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

// a x b, as the plain _cross forms it
template <typename T>
__device__ __forceinline__ void cross(const T a[3], const T b[3], T out[3]) {
  using O = Op<T>;
  out[0] = O::sub(O::mul(a[1], b[2]), O::mul(a[2], b[1]));
  out[1] = O::sub(O::mul(a[2], b[0]), O::mul(a[0], b[2]));
  out[2] = O::sub(O::mul(a[0], b[1]), O::mul(a[1], b[0]));
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

// The SOR update of colour c's slot i, vertex row: x_gs and x_new.
// DYN: vertex row's C^T C x, the rows' C x in a.rd (dyn_rows.cuh).
template <typename T>
__device__ __forceinline__ void ctc_row(const Args<T>& a, int row, T ck, T ctc[3]) {
  const T* rd = a.rd;
  const auto y = [rd](int64_t r) { return rd[r]; };
  dyn_own_ct(a.dyn, row, ck, y, ctc);
  dyn_corners_ct(a.dyn, row, ck, y, ctc);
}

// DYN: every active row's C x at x, into a.rd; a barrier follows.
template <typename T, bool SH, int THREADS>
__device__ __forceinline__ void rows_phase(const Args<T>& a, const XMem<T, SH>& x, T ck) {
  const auto load = [&x](int64_t q, T o[3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r) o[r] = x[q * 3 + r];
  };
  for (int r = threadIdx.x; r < a.dyn.h; r += THREADS)
    if (a.dyn.mask[r]) a.rd[r] = dyn_row_value(a.dyn, r, ck, load);
}

template <typename T, bool SH, bool WIDE, bool DYN = false>
__device__ __forceinline__ void sor_row(const Args<T>& a, const XMem<T, SH>& x, int c, int i,
                                        int row, T one_m, T xg[3], T xn[3], T ck = T(0)) {
  using O = Op<T>;
  // the row's own values first: their loads overlap the sum's
  const T aii = __ldg(a.diag + row);
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
  T aii3[3] = {aii, aii, aii};
  if constexpr (DYN) {
    T ctc[3];
    ctc_row(a, row, ck, ctc);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const T pen = a.pen[row * 3 + r];
      aii3[r] = O::add(aii, pen);
      lux[r] = O::sub(O::add(lux[r], ctc[r]), O::mul(pen, xi[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    xg[r] = O::div(O::sub(bi[r], lux[r]), aii3[r]);
    xn[r] = O::add(O::mul(one_m, xi[r]), O::mul(a.omega, xg[r]));
  }
}

// The contact's tangent-plane update of a hit vertex: x_new = u (u . delta)
// + v (v . delta) + p, delta = x_gs - p, (u, v) orthoG's basis of nrm.
template <typename T>
__device__ __forceinline__ void project(const T xg[3], const T p[3], const T nrm[3], T xn[3]) {
  using O = Op<T>;
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

// One vertex's update of its colour's pass: colour c's slot i, vertex row
// (the analytic obstacles only).
template <typename T, bool SH, bool WIDE, bool DYN = false>
__device__ __forceinline__ void update_row(const Args<T>& a, const XMem<T, SH>& x, int c, int i,
                                           int row, T one_m, T ck = T(0)) {
  const bool pinned = __ldg(a.pinned + row);
  T xg[3], xn[3];
  sor_row<T, SH, WIDE, DYN>(a, x, c, i, row, one_m, xg, xn, ck);
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
    if (best < T(0)) project(xg, p, nrm, xn);
  }
  if (pinned) {
#pragma unroll
    for (int r = 0; r < 3; ++r) xn[r] = __ldg(a.pin_target + row * 3 + r);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) x.set(row * 3 + r, xn[r]);
}

// --- a colour's pass with mesh obstacles ---------------------------------------
//
// The JAX sweep detects on the colour's padded rows x_new [L, 3] at once
// (admm_elastic_tpu/solvers/gs.py:115-127), so a mesh obstacle's near-lane
// compaction and deep fallback rank the colour's slots, L = its padded
// width, in slot order. A colour is its vertices first and its padding (row
// n, run as row n - 1) at the tail (system/assembly.py color_groups), so a
// padded slot ranks after every real one: it never takes a near-lane place
// or a fallback place from a real vertex, and changes only the overflow
// flag, which Gauss-Seidel discards as the JAX package does (gs.py:120).
// This pass therefore skips the padded slots, as the analytic pass does.
// (tests/test_torch_mesh_obstacle.py holds the plain detection to this: the
// same rows with and without tail duplicates.) A slot's values live in
// a.scratch between the phases, which barriers separate; a slot belongs to
// thread i % threads in every phase but the exact walk, where a group of g
// threads takes each evaluated slot (obstacle_body.cuh candidates; g by
// group_size: the largest power of two <= 32 with g x the evaluated slots
// <= the block's threads and g <= a table row, 8 at some 123 slots and
// 1,024 threads) and its leader writes the slot's values; the need flags
// are then ranked in slot order.
//
// scratch per slot: 0-2 x_gs, 3-5 x_new, 6 the deepest distance, 7-9 its
// point, 10-12 its normal, 13 a mesh obstacle's distance, 14-16 its point,
// 17-19 its normal. iscratch: flags per slot, then the fallback's slots,
// then the evaluated slots in slot order.
constexpr int kEval = 16;  // flag: the slot takes the obstacle's narrow phase

template <typename T>
__device__ __forceinline__ void merge(T* s, bool first, T d, const T p[3], const T n[3]) {
  if (first || d < s[6]) {  // the first of least distance, as argmin
    s[6] = d;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      s[7 + r] = p[r];
      s[10 + r] = n[r];
    }
  }
}

// One mesh obstacle at every real slot of the pass, merged into the slots'
// deepest (first: it is obstacle 0).
template <typename T, bool WIDE>
__device__ void mesh_obstacle(const Args<T>& a, const Mesh<T>& m, bool first, const int* grp,
                              int* smi) {
  using O = Op<T>;
  constexpr int threads = kThreads<WIDE>;
  const int tid = threadIdx.x, L = a.width, K = m.near_lanes;
  const bool compact = K > 0 && K < L, sdf = m.kind == MESH_SDF;
  int* flags = a.iscratch;
  int* fb_list = a.iscratch + L;
  int* list = a.iscratch + 2 * L;
  // 1. the slots that take the narrow phase: the first K near ones (listed
  // in slot order), or all
  int near_total = 0;
  for (int b = 0; b < L; b += threads) {
    const int i = b + tid;
    const bool real = i < L && __ldg(grp + i) < a.n;
    bool near = false;
    if (real && compact) {
      const T* xn = a.scratch + (int64_t)i * kSlot + 3;
      if (sdf) {
        T f[3];
        near = sdf_near(m, sdf_cell(m, xn, f));
      } else {
        bool in_grid;
        const int cid = exact_cell(m, xn, in_grid);
        near = in_grid && exact_near_tet(m, cid);
      }
    }
    bool eval = real;
    if (compact) {
      int total;
      const int r = near_total + block_rank<threads>(near, smi, total);
      near_total += total;
      eval = near && r < K;
      if (eval) list[r] = i;
    }
    if (real) flags[i] = eval ? kEval : 0;
  }
  if (sdf) {  // 2. the SDF's blend, a thread a slot
    for (int i = tid; i < L; i += threads) {
      if (__ldg(grp + i) >= a.n || !(flags[i] & kEval)) continue;
      T* s = a.scratch + (int64_t)i * kSlot;
      const T* p = s + 3;
      T f[3], n[3];
      const T d = sdf_blend(m, sdf_cell(m, p, f), f, n);
      const bool keep = d < T(1e29);
      s[13] = d;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        s[14 + r] = keep ? O::sub(p[r], O::mul(d, n[r])) : T(0);
        s[17 + r] = n[r];
      }
    }
  } else {
    // 2. the exact walk, a group of g threads an evaluated slot; its deep
    // slots ranked in slot order
    __syncthreads();  // every slot's x_new and flags, and the list
    const int n_eval = compact ? (near_total < K ? near_total : K) : L;
    const int g = a.group > 0 ? a.group : group_size(n_eval, threads, m.kf);
    const int seen = compact ? K : L;
    const int k_fb = m.fallback_lanes < seen ? m.fallback_lanes : seen;
    const T capture = O::mul(T(m.capture_cells), m.h[0]);
    for (int e = tid / g; e < n_eval; e += threads / g) {
      const int i = compact ? list[e] : e;
      if (!compact && __ldg(grp + i) >= a.n) continue;  // a padded slot (the whole group)
      T* s = a.scratch + (int64_t)i * kSlot;
      const T p[3] = {s[3], s[4], s[5]};
      T cl[3], n[3], dist;
      bool in_grid, any_face;
      const int cid = exact_cell(m, p, in_grid);
      const bool valid = compact || in_grid;
      candidates(m, p, cid, valid, g, dist, cl, n, any_face);
      if ((tid & (g - 1)) == 0) {
        const bool near_tet = exact_near_tet(m, cid);
        const bool need = valid && near_tet && (!any_face || dist > capture);
        s[13] = dist;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          s[14 + r] = cl[r];
          s[17 + r] = n[r];
        }
        flags[i] |= (any_face ? 1 : 0) | (near_tet ? 2 : 0) | (need ? 4 : 0);
      }
    }
    __syncthreads();  // the need flags
    int need_total = 0;
    for (int b = 0; b < L; b += threads) {
      const int i = b + tid;
      const bool need = i < L && __ldg(grp + i) < a.n && (flags[i] & 4);
      int total;
      const int r = need_total + block_rank<threads>(need, smi, total);
      if (need && r < k_fb && m.n_tris > 0) {
        fb_list[r] = i;
        flags[i] |= 8;
      }
      need_total += total;
    }
    __syncthreads();
    const int served = (k_fb > 0 && m.n_tris > 0) ? (need_total < k_fb ? need_total : k_fb) : 0;
    for (int w = tid >> 5; w < served; w += threads / 32) {  // a warp per deep slot
      const int i = fb_list[w];
      T* s = a.scratch + (int64_t)i * kSlot;
      T p[3], cl[3], n[3], dist;
#pragma unroll
      for (int r = 0; r < 3; ++r) p[r] = s[3 + r];
      brute_force_warp(m, p, dist, cl, n);
      if ((tid & 31) == 0) {
        s[13] = dist;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          s[14 + r] = cl[r];
          s[17 + r] = n[r];
        }
      }
    }
    __syncthreads();
  }
  // 3. each slot's distance (no hit where it took no narrow phase), merged
  for (int i = tid; i < L; i += threads) {
    if (__ldg(grp + i) >= a.n) continue;
    T* s = a.scratch + (int64_t)i * kSlot;
    const int fl = flags[i];
    T d = T(kBig), pt[3] = {T(0), T(0), T(0)}, n[3] = {T(0), T(0), T(0)};
    if (fl & kEval) {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        pt[r] = s[14 + r];
        n[r] = s[17 + r];
      }
      if (sdf) {
        d = s[13];
      } else {
        const bool need = fl & 4, srv = fl & 8;
        const bool any_face = ((fl & 1) || srv) && !(need && !srv);
        d = exact_signed(s + 3, s[13], pt, n, any_face, (fl & 2) != 0);
      }
    }
    merge(s, first, d, pt, n);
  }
}

// Colour c's pass where a mesh obstacle is among the obstacles: x_gs and
// x_new of every real slot; each obstacle in order into the slot's deepest
// (the analytic ones per slot, the mesh ones by mesh_obstacle); then the
// projection, the pins and x, as update_row.
template <typename T, bool SH, bool WIDE>
__device__ void mesh_pass(const Args<T>& a, const XMem<T, SH>& x, int c, T one_m, int* smi) {
  constexpr int threads = kThreads<WIDE>;
  const int tid = threadIdx.x, L = a.width;
  const int* grp = a.groups + (int64_t)c * L;
  for (int i = tid; i < L; i += threads) {
    const int row = __ldg(grp + i);
    if (row >= a.n) continue;
    T xg[3], xn[3];
    sor_row<T, SH, WIDE>(a, x, c, i, row, one_m, xg, xn);
    T* s = a.scratch + (int64_t)i * kSlot;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      s[r] = xg[r];
      s[3 + r] = xn[r];
    }
  }
  for (int o = 0; o < a.n_obs; ++o) {
    if (a.kind[o] >= MESH_SDF) {
      mesh_obstacle<T, WIDE>(a, a.mesh[o], o == 0, grp, smi);
      continue;
    }
    for (int i = tid; i < L; i += threads) {
      if (__ldg(grp + i) >= a.n) continue;
      T* s = a.scratch + (int64_t)i * kSlot;
      T xn[3], p[3], nrm[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) xn[r] = s[3 + r];
      const T d = signed_distance(a, o, xn, p, nrm);
      merge(s, o == 0, d, p, nrm);
    }
  }
  for (int i = tid; i < L; i += threads) {
    const int row = __ldg(grp + i);
    if (row >= a.n) continue;
    const T* s = a.scratch + (int64_t)i * kSlot;
    T xg[3], xn[3], p[3], nrm[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      xg[r] = s[r];
      xn[r] = s[3 + r];
      p[r] = s[7 + r];
      nrm[r] = s[10 + r];
    }
    if (s[6] < T(0)) project(xg, p, nrm, xn);
    if (__ldg(a.pinned + row)) {
#pragma unroll
      for (int r = 0; r < 3; ++r) xn[r] = __ldg(a.pin_target + row * 3 + r);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) x.set(row * 3 + r, xn[r]);
  }
}

// MESH: the instantiation for an obstacle set with a mesh obstacle (its
// passes are mesh_pass); without one the kernel is the analytic one-go update,
// its code untouched by the mesh phases. DYN: the dynamic rows' penalty (with
// the analytic obstacles; never with MESH).
template <typename T, bool SH, bool WIDE, bool MESH, bool DYN>
__global__ void __launch_bounds__(kThreads<WIDE>) gs_kernel(const __grid_constant__ Args<T> a) {
  static_assert(!(MESH && DYN), "the DYN form takes the analytic obstacles only");
  constexpr int threads = kThreads<WIDE>;
  using O = Op<T>;
  __shared__ T sm[kLaneWarps + 1];
  __shared__ int smi[MESH ? threads / 32 : 1];  // block_rank's warp counts
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
  const T ck = DYN ? *a.dyn.ck : T(0);
  int k = 0;
  bool done = false;
  while (!done && k < a.max_iters) {
    for (int c = 0; kAnatomy != 4 && c < a.n_colors; ++c) {
      if constexpr (MESH && kAnatomy == 0) {
        mesh_pass<T, SH, WIDE>(a, x, c, one_m, smi);
        __syncthreads();
        continue;
      }
      if constexpr (DYN) {
        rows_phase<T, SH, threads>(a, x, ck);
        __syncthreads();
      }
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
          update_row<T, SH, WIDE, DYN>(a, x, c, i, row, one_m, ck);
        }
      }
      __syncthreads();
    }
    if (kAnatomy != 0 && kAnatomy != 4) {
      ++k;
      continue;
    }
    if constexpr (DYN) {
      rows_phase<T, SH, threads>(a, x, ck);
      __syncthreads();
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
      T ctc[3] = {T(0), T(0), T(0)};
      if constexpr (DYN) ctc_row(a, i, ck, ctc);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T res = DYN ? bi[r] - ((d * x[i * 3 + r] + lux[r]) + ctc[r])
                          : bi[r] - (d * x[i * 3 + r] + lux[r]);
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

template <typename T, bool WIDE, bool MESH, bool DYN>
cudaError_t launch_form(const Args<T>& a, bool shared, cudaStream_t s) {
  if (shared) {
    static int granted = 0;  // the dynamic shared memory allowed so far
    const int smem = static_cast<int>(a.n * 3 * sizeof(T));
    if (smem > granted) {
      const cudaError_t rc = cudaFuncSetAttribute(
          gs_kernel<T, true, WIDE, MESH, DYN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return rc;
      granted = smem;
    }
    gs_kernel<T, true, WIDE, MESH, DYN><<<1, kThreads<WIDE>, smem, s>>>(a);
  } else {
    gs_kernel<T, false, WIDE, MESH, DYN><<<1, kThreads<WIDE>, 0, s>>>(a);
  }
  return cudaGetLastError();
}

// ptrs: ell_cols, ell_vals, ccols, cvals, tcols, tvals, diag, groups, b, x0,
// x, pinned, pin_target, sweeps, scratch, iscratch, then kMeshPtrs per obstacle
// (a mesh obstacle's tables, obstacle_body.cuh; 0 for an analytic one), then
// DYN's (all null without dynamic rows): mask, vidx, face, barys, normal, ck,
// order, start, slot (null: the query set is every vertex), pen, rd; ints:
// n, k, n_colors, width, max_iters, form (bit 0 SHARED, bit 1 WIDE, bits 2-7
// the exact walk's group: 0 the rule), n_obs,
// kind[kMaxObstacles], then kMeshInts per obstacle, then the dynamic rows' H;
// par: [n_obs, 4] (a mesh obstacle: capture_cells).
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
  a.group = (ints[5] >> 2) & 63;
  a.n_obs = ints[6];
  a.omega = T(omega);
  a.tol = T(tol);
  if (a.n <= 0) return 0;
  if (a.n_obs < 0 || a.n_obs > kMaxObstacles) return static_cast<int>(cudaErrorInvalidValue);
  a.scratch = reinterpret_cast<T*>(ptrs[14]);
  a.iscratch = reinterpret_cast<int*>(ptrs[15]);
  a.n_mesh = 0;
  for (int o = 0; o < kMaxObstacles; ++o) {
    a.kind[o] = o < a.n_obs ? ints[7 + o] : FLOOR;
    for (int q = 0; q < 4; ++q) a.par[o][q] = o < a.n_obs ? T(par[o * 4 + q]) : T(0);
    if (o < a.n_obs && a.kind[o] >= MESH_SDF) {
      a.mesh[o] = mesh_from<T>(ints + 7 + kMaxObstacles + o * kMeshInts,
                               ptrs + 16 + o * kMeshPtrs, par[o * 4]);
      ++a.n_mesh;
    }
  }
  if (a.n_mesh > 0 && (a.scratch == nullptr || a.iscratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a.group & (a.group - 1)) != 0 || a.group > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t* dp = ptrs + 16 + kMaxObstacles * kMeshPtrs;
  a.dyn.mask = reinterpret_cast<const unsigned char*>(dp[0]);
  a.dyn.vidx = reinterpret_cast<const int64_t*>(dp[1]);
  a.dyn.face = reinterpret_cast<const int64_t*>(dp[2]);
  a.dyn.barys = reinterpret_cast<const T*>(dp[3]);
  a.dyn.normal = reinterpret_cast<const T*>(dp[4]);
  a.dyn.ck = reinterpret_cast<const T*>(dp[5]);
  a.dyn.order = reinterpret_cast<const int64_t*>(dp[6]);
  a.dyn.start = reinterpret_cast<const int64_t*>(dp[7]);
  a.dyn.slot = reinterpret_cast<const int*>(dp[8]);
  a.pen = reinterpret_cast<const T*>(dp[9]);
  a.rd = reinterpret_cast<T*>(dp[10]);
  a.dyn.h = ints[7 + kMaxObstacles + kMaxObstacles * kMeshInts];
  const bool dyn = a.dyn.mask != nullptr;
  if (dyn && (a.n_mesh > 0 || a.pen == nullptr || a.rd == nullptr || a.dyn.ck == nullptr ||
              a.dyn.order == nullptr || a.dyn.start == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n_mesh > 0)
    return static_cast<int>(wide ? launch_form<T, true, true, false>(a, shared, s)
                                 : launch_form<T, false, true, false>(a, shared, s));
  if (dyn)
    return static_cast<int>(wide ? launch_form<T, true, false, true>(a, shared, s)
                                 : launch_form<T, false, false, true>(a, shared, s));
  return static_cast<int>(wide ? launch_form<T, true, false, false>(a, shared, s)
                               : launch_form<T, false, false, false>(a, shared, s));
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
