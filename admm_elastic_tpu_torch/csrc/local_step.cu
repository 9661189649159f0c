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
// What bounds it on Hopper: arithmetic and registers, not bytes. A lane
// reads 22 values and writes 18 (160 B in float) but runs a few thousand
// flops and ~150 transcendental calls (log, sqrt, div) in the Newton loop.
// Everything stays in registers; the Newton and backtracking loops are kept
// rolled so the body compiles in seconds and does not spill. At the bench
// size T = 7,680, which is only ~58 lanes per SM, the block is 64 threads.
//
// Built once per precision (-DADMM_REAL=float -DADMM_SFX=f32, or double /
// f64), without --use_fast_math (it flushes denormals and approximates log,
// sqrt and division); FMA contraction stays on, which the stated float32
// tolerances allow for.

#include "prox_body.cuh"

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
