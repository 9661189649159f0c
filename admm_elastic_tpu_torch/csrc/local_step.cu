// Kernel A: the fused tet local step of one ADMM iteration, for each of the
// six tet models.
//
// Replaces the Pallas kernel admm_elastic_tpu/ops/pallas_kernels.py
// _local_hyper_kernel (:172-185), launched by _local_hyper_call (:200-244,
// pallas_call at :220) behind local_step_tet_hyper_pallas, whose static
// `model` argument selects neo-Hookean, StVK or one of the three Xu splines.
// The linear model is a sixth variant here: the JAX package leaves it to
// XLA's fusion of the jnp body (system/elements.py:159-169), and eager
// PyTorch has no such fusion. Per lane t:
//   v  = dix + u
//   U, S, V = signed SVD of v (8 Jacobi sweeps on v^T v, sort, U
//             orthonormalised with fallbacks, det signs; ops/soa.py)
//   hyperelastic: eps-inflation of collapsed elements, |S3|, then
//     S* = 8 projected active-set Newton steps on psi_model(s) + k/2 |s - S|^2,
//     Gershgorin damping, 8-step backtracking (ops/hyper_soa.py);
//     z = U diag(S*) V^T
//   linear: z = 1/2 (U V^T + v)
//   u' = v - z
// The plain version is admm_elastic_tpu_torch/ops/hyper_soa.local_step_plain;
// prox_body.cuh repeats it line for line, in the same order.
//
// Layout: dix, u, z, u' are [9, T] row-major (row = matrix entry), mu, lam,
// kappa, k are [T]. Thread t reads column t of each row, so a warp reads 32
// neighbouring values per row: coalesced. The ragged edge is masked by
// t < T; no host-side padding. Dead stencil lanes arrive as identity F with
// u = 0 and leave as z = I, u' = 0, finite.
//
// What bounds it on Hopper: neither bytes (160 B a lane in float) nor the
// card's arithmetic rate, but the length of one lane's dependent chain. At
// the bench size T = 7,680 the whole kernel is one wave with a warp or two
// per SM, so it takes as long as its slowest warp: the 8-sweep Jacobi SVD
// (24 rotations, each two divisions and two square roots deep), then per
// Newton trip the gradient, Hessian, 3x3 solve and f0, and the line search's
// candidates, each with a log, built without fast math. What the design does
// about it (prox_body.cuh, prox_hyper): a lane leaves the Newton loop on the
// trip that finds it converged, skips the search when the gradient already
// says so, and leaves the search at the first accept; none of these changes
// a bit of the result. What was tried and not kept: a group of 4 or 8
// threads of one warp per lane that try the candidates side by side, a
// ballot picking the first below f0. On the H100 at the bench size 4 threads
// read 3-11 % faster than one on four of the five models (by model and
// input), 12 % slower for StVK, 8 threads no better than 4: most trips
// accept candidate 0, so a trip's length is its serial part, and some lane
// of the beam needs all 8 trips whatever the warps hold. That did not pay for twenty more
// instantiations and up to 148 registers, so a lane is one thread, in
// 64-thread blocks. The SVD stays sequential: its sweep count is the
// reference's. Everything stays in registers; the Newton and search loops
// are kept rolled so the body compiles in seconds and does not spill.
//
// Two entries. The rows entry (admm_local_step_*) takes D x as rows [9, T]:
// the counterpart of the TPU kernel by signature, behind TetBatch.prox(rows)
// and whatever has its D x from elsewhere. The stencil entry
// (admm_local_step_stencil_*) is the one the ADMM step launches for a lattice
// family: it takes x, and lane t = slot * cells + p computes its own nine
// values of D x with tet_dx_lane of stencil_body.cuh (kernel B's body) where
// the rows entry loads them, then runs the same tet_lane_prox. On an H100 a
// D x launch of its own cannot get under the launch floor (0.87 us for an
// empty kernel, four times B's bound); it took 1.9-2.9 us of device time and
// some 20 us of host enqueue in a host-bound step, and wrote rows that the
// very next launch read back. Inside this launch it is one more round of
// independent loads of values that sit in L1 / L2 (x is 17.7 KB at the bench
// size), whose temporaries are dead before the SVD starts: 0.1-0.6 us by
// model on top of the rows entry's 8.5-18.5 us. B's sums are __fmul_rn /
// __fadd_rn, so the nine values are B's bit for bit, and v = D x + u adds two
// values neither of which is a product the compiler could contract: the two
// entries give the same bits.
//
// Scenes (scenario batching, admm_elastic_tpu_torch/parallel/batch.py, where
// the JAX package vmaps the step over a batch and the Pallas kernel with it):
// both entries have a scene form over S scenes of one mesh, with rows
// [S, 9, T] (the stencil entry's x [S, N, 3]), one thread a lane of S * T,
// lane l of scene l / T and element l % T. Each scene has its stiffness scale
// s (scale [S]), and the lane's material is the scene's: mu s, lam s, kappa s
// and k = lam s + (2/3) (mu s), each product and the sum rounded on its own
// (__fmul_rn / __fadd_rn), as parallel/batch._scale_system forms the scaled
// arrays and TetBatch their bulk; nvcc may not contract the bulk into one
// rounding. Scene i's z and u' are then, bit for bit, the single-scene
// entry's on scene i's scaled parameters.
//
// Built once per precision (-DADMM_REAL=float -DADMM_SFX=f32, or double /
// f64), without --use_fast_math (it flushes denormals and approximates log,
// sqrt and division); FMA contraction stays on, which the stated float32
// tolerances allow for.

#include "prox_body.cuh"
#include "stencil_body.cuh"

namespace {

// One thread per lane t < n = 5 * cells of a lattice family; u, z, uo are SoA
// rows [9, n]. A warp's lanes have consecutive cells (and share the slot but
// where the warp straddles two: a ring's cells are no multiple of 128), so
// every load is coalesced.
// The second launch bound says that one block per SM is enough: without it
// ptxas holds every variant to 128 registers for the sake of occupancy, and
// the float64 spline_nh variant then spills 8 bytes; with it the float64
// variants take 114-142 registers, the float32 ones 72-80, and none spills.
// At the bench size the grid is one block or less per SM anyway.
template <typename T, int MODEL>
__global__ void __launch_bounds__(64, 1) tet_local_step_stencil_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ par,
    const T* __restrict__ dead, const T* __restrict__ u, const T* __restrict__ mu,
    const T* __restrict__ lam, const T* __restrict__ kappa, const T* __restrict__ k,
    T* __restrict__ z, T* __restrict__ uo, int base, int n_vblock, int cells, int n,
    int n_iters, int sweeps, const __grid_constant__ Geom g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int s = t / cells, p = t - s * cells;
  T v[9];
  tet_dx_lane(x, dl, par, dead, base, n_vblock, cells, s, p, g, v);
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = v[i] + u[(int64_t)i * n + t];
  tet_lane_prox<T, MODEL, true>(v, mu, lam, kappa, k, z, uo, n, t, n_iters, sweeps);
}

template <typename T, int MODEL>
int launch_stencil(const T* x, const T* dl, const T* par, const T* dead, const T* u,
                   const T* mu, const T* lam, const T* kappa, const T* k, T* z, T* uo, int base,
                   int n_vblock, int cells, int n_iters, int sweeps, const Geom& g,
                   void* stream) {
  const int block = 64;
  const int grid = (5 * cells + block - 1) / block;
  tet_local_step_stencil_kernel<T, MODEL><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dl, par, dead, u, mu, lam, kappa, k, z, uo, base, n_vblock, cells, 5 * cells, n_iters,
      sweeps, g);
  return static_cast<int>(cudaGetLastError());
}

// The lane's material in a scene of scale s (see the header): unread by the
// linear model.
template <typename T, int MODEL>
__device__ __forceinline__ Mat<T> scaled_mat(const T* __restrict__ mu, const T* __restrict__ lam,
                                             const T* __restrict__ kappa, int t, T s) {
  Mat<T> m = {T(0), T(0), T(0), T(0)};
  if constexpr (MODEL != LINEAR) {
    m.mu = mul_rn(mu[t], s);
    m.lam = mul_rn(lam[t], s);
    m.kappa = mul_rn(kappa[t], s);
    m.k = add_rn(m.lam, mul_rn(T(2.0 / 3.0), m.mu));
  }
  return m;
}

// The rows entry over S scenes: dix, u, z, uo [S, 9, n].
template <typename T, int MODEL>
__global__ void __launch_bounds__(64) tet_local_step_scenes_kernel(
    const T* __restrict__ dix, const T* __restrict__ u, const T* __restrict__ mu,
    const T* __restrict__ lam, const T* __restrict__ kappa, const T* __restrict__ scale,
    T* __restrict__ z, T* __restrict__ uo, int n, int scenes, int n_iters, int sweeps) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= (int64_t)scenes * n) return;
  const int sc = static_cast<int>(l / n), t = static_cast<int>(l - (int64_t)sc * n);
  const int64_t off = (int64_t)sc * 9 * n;
  T v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = dix[off + (int64_t)i * n + t] + u[off + (int64_t)i * n + t];
  const Mat<T> m = scaled_mat<T, MODEL>(mu, lam, kappa, t, scale[sc]);
  tet_lane_prox_mat<T, MODEL, true>(v, m, z + off, uo + off, n, t, n_iters, sweeps);
}

// The stencil entry over S scenes: x [S, n_verts, 3], u, z, uo [S, 9, n].
template <typename T, int MODEL>
__global__ void __launch_bounds__(64, 1) tet_local_step_stencil_scenes_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ par,
    const T* __restrict__ dead, const T* __restrict__ u, const T* __restrict__ mu,
    const T* __restrict__ lam, const T* __restrict__ kappa, const T* __restrict__ scale,
    T* __restrict__ z, T* __restrict__ uo, int base, int n_vblock, int cells, int n, int n_verts,
    int scenes, int n_iters, int sweeps, const __grid_constant__ Geom g) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= (int64_t)scenes * n) return;
  const int sc = static_cast<int>(l / n), t = static_cast<int>(l - (int64_t)sc * n);
  const int s = t / cells, p = t - s * cells;
  const int64_t off = (int64_t)sc * 9 * n;
  T v[9];
  tet_dx_lane(x + (int64_t)sc * n_verts * 3, dl, par, dead, base, n_vblock, cells, s, p, g, v);
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = v[i] + u[off + (int64_t)i * n + t];
  const Mat<T> m = scaled_mat<T, MODEL>(mu, lam, kappa, t, scale[sc]);
  tet_lane_prox_mat<T, MODEL, true>(v, m, z + off, uo + off, n, t, n_iters, sweeps);
}

template <typename T, int MODEL>
int launch_scenes(const T* dix, const T* u, const T* mu, const T* lam, const T* kappa,
                  const T* scale, T* z, T* uo, int n, int scenes, int n_iters, int sweeps,
                  void* stream) {
  const int64_t lanes = (int64_t)scenes * n;
  if (lanes <= 0) return 0;
  const int block = 64;
  tet_local_step_scenes_kernel<T, MODEL>
      <<<(unsigned)((lanes + block - 1) / block), block, 0, static_cast<cudaStream_t>(stream)>>>(
          dix, u, mu, lam, kappa, scale, z, uo, n, scenes, n_iters, sweeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODEL>
int launch_stencil_scenes(const T* x, const T* dl, const T* par, const T* dead, const T* u,
                          const T* mu, const T* lam, const T* kappa, const T* scale, T* z, T* uo,
                          int base, int n_vblock, int cells, int n_verts, int scenes, int n_iters,
                          int sweeps, const Geom& g, void* stream) {
  const int n = 5 * cells;
  const int64_t lanes = (int64_t)scenes * n;
  if (lanes <= 0) return 0;
  const int block = 64;
  tet_local_step_stencil_scenes_kernel<T, MODEL>
      <<<(unsigned)((lanes + block - 1) / block), block, 0, static_cast<cudaStream_t>(stream)>>>(
          x, dl, par, dead, u, mu, lam, kappa, scale, z, uo, base, n_vblock, cells, n, n_verts,
          scenes, n_iters, sweeps, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ADMM_CAT2(a, b) a##_##b
#define ADMM_CAT(a, b) ADMM_CAT2(a, b)

// model: the Model id of prox_body.cuh. kappa is read by the spline models
// only, mu / lam / kappa / k not at all by the linear one.
extern "C" int ADMM_CAT(admm_local_step, ADMM_SFX)(
    const ADMM_REAL* dix, const ADMM_REAL* u, const ADMM_REAL* mu, const ADMM_REAL* lam,
    const ADMM_REAL* kappa, const ADMM_REAL* k, ADMM_REAL* z, ADMM_REAL* uo, int n, int model,
    int n_iters, int sweeps, void* stream) {
  return dispatch_tet_prox<ADMM_REAL, true>(model, dix, u, mu, lam, kappa, k, z, uo, n, n_iters,
                                            sweeps, stream);
}

// The stencil entry. geom: host int[49], see make_geom of stencil_body.cuh.
extern "C" int ADMM_CAT(admm_local_step_stencil, ADMM_SFX)(
    const ADMM_REAL* x, const ADMM_REAL* dl, const ADMM_REAL* par, const ADMM_REAL* dead,
    const ADMM_REAL* u, const ADMM_REAL* mu, const ADMM_REAL* lam, const ADMM_REAL* kappa,
    const ADMM_REAL* k, ADMM_REAL* z, ADMM_REAL* uo, int base, int n_vblock, int cells,
    const int* geom, int model, int n_iters, int sweeps, void* stream) {
  if (cells <= 0) return 0;
  const Geom g = make_geom(geom);
#define ADMM_STENCIL_CASE(M)                                                                   \
  case M:                                                                                      \
    return launch_stencil<ADMM_REAL, M>(x, dl, par, dead, u, mu, lam, kappa, k, z, uo, base,   \
                                        n_vblock, cells, n_iters, sweeps, g, stream);
  switch (model) {
    ADMM_STENCIL_CASE(NH)
    ADMM_STENCIL_CASE(STVK)
    ADMM_STENCIL_CASE(SPLINE_NH)
    ADMM_STENCIL_CASE(SPLINE_STVK)
    ADMM_STENCIL_CASE(SPLINE_COROT)
    ADMM_STENCIL_CASE(LINEAR)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ADMM_STENCIL_CASE
}

#define ADMM_MODEL_SWITCH(CALL)              \
  switch (model) {                           \
    case NH: return CALL(NH);                \
    case STVK: return CALL(STVK);            \
    case SPLINE_NH: return CALL(SPLINE_NH);  \
    case SPLINE_STVK: return CALL(SPLINE_STVK);  \
    case SPLINE_COROT: return CALL(SPLINE_COROT);  \
    case LINEAR: return CALL(LINEAR);        \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

// The rows entry over S scenes (see the header): dix, u, z, uo [S, 9, n];
// mu, lam, kappa [n]; scale [S].
extern "C" int ADMM_CAT(admm_local_step_scenes, ADMM_SFX)(
    const ADMM_REAL* dix, const ADMM_REAL* u, const ADMM_REAL* mu, const ADMM_REAL* lam,
    const ADMM_REAL* kappa, const ADMM_REAL* scale, ADMM_REAL* z, ADMM_REAL* uo, int n,
    int scenes, int model, int n_iters, int sweeps, void* stream) {
#define ADMM_ROWS_SCENES(M)                                                                 \
  launch_scenes<ADMM_REAL, M>(dix, u, mu, lam, kappa, scale, z, uo, n, scenes, n_iters, sweeps, \
                              stream)
  ADMM_MODEL_SWITCH(ADMM_ROWS_SCENES)
#undef ADMM_ROWS_SCENES
}

// The stencil entry over S scenes: x [S, n_verts, 3], u, z, uo [S, 9, 5 cells].
extern "C" int ADMM_CAT(admm_local_step_stencil_scenes, ADMM_SFX)(
    const ADMM_REAL* x, const ADMM_REAL* dl, const ADMM_REAL* par, const ADMM_REAL* dead,
    const ADMM_REAL* u, const ADMM_REAL* mu, const ADMM_REAL* lam, const ADMM_REAL* kappa,
    const ADMM_REAL* scale, ADMM_REAL* z, ADMM_REAL* uo, int base, int n_vblock, int cells,
    int n_verts, int scenes, const int* geom, int model, int n_iters, int sweeps, void* stream) {
  if (cells <= 0) return 0;
  const Geom g = make_geom(geom);
#define ADMM_STENCIL_SCENES(M)                                                                 \
  launch_stencil_scenes<ADMM_REAL, M>(x, dl, par, dead, u, mu, lam, kappa, scale, z, uo, base,  \
                                      n_vblock, cells, n_verts, scenes, n_iters, sweeps, g, stream)
  ADMM_MODEL_SWITCH(ADMM_STENCIL_SCENES)
#undef ADMM_STENCIL_SCENES
}
#undef ADMM_MODEL_SWITCH
