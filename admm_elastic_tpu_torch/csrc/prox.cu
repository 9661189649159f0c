// Kernels D and F: the tet prox on [T, 3, 3] with no dual update.
//
// D replaces the Pallas kernel admm_elastic_tpu/ops/pallas_kernels.py
// _hyper_kernel (:112-121; pallas_call at :141, behind prox_tet_hyper_pallas):
// the hyperelastic prox of kernel A (signed SVD, eps-inflation, 8 projected
// Newton steps in principal stretches, recompose) for neo-Hookean, StVK and
// the three Xu splines. F replaces _linear_kernel (:312-313; pallas_call at
// :322, behind prox_tet_linear_pallas): signed SVD, then 1/2 (U V^T + F).
// Both share the per-lane bodies of prox_body.cuh with kernel A; the plain
// version is admm_elastic_tpu_torch/ops/hyper_soa.prox_plain.
//
// Layout: zi and the output are [T, 3, 3] row-major; lane t reads its nine
// values at 9t .. 9t+8 and writes them back there. The TPU wrapper's
// transpose to rows and its identity padding (_to_rows) are TPU layout and
// are not carried over: the bounds check t < T replaces the pad. A warp's 32
// lanes cover one contiguous span of 288 values, so every fetched sector is
// used, though each single load strides by 9 values.
//
// What bounds them on Hopper: D, like A, arithmetic (a few thousand flops
// per lane against 88 B in float); F is lighter (the 8 Jacobi sweeps, ~700
// flops per lane against 72 B) and is still bounded by operations.
//
// Built once per precision, as local_step.cu.

#include "prox_body.cuh"

#define ADMM_CAT2(a, b) a##_##b
#define ADMM_CAT(a, b) ADMM_CAT2(a, b)

// Kernel D. model: a hyperelastic Model id of prox_body.cuh (not LINEAR).
extern "C" int ADMM_CAT(admm_prox_tet_hyper, ADMM_SFX)(
    const ADMM_REAL* zi, const ADMM_REAL* mu, const ADMM_REAL* lam, const ADMM_REAL* kappa,
    const ADMM_REAL* k, ADMM_REAL* out, int n, int model, int n_iters, int sweeps,
    void* stream) {
  if (model == LINEAR) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_tet_prox<ADMM_REAL, false>(model, zi, nullptr, mu, lam, kappa, k, out, nullptr,
                                             n, n_iters, sweeps, stream);
}

// Kernel F.
extern "C" int ADMM_CAT(admm_prox_tet_linear, ADMM_SFX)(const ADMM_REAL* zi, ADMM_REAL* out,
                                                        int n, int sweeps, void* stream) {
  return launch_tet_prox<ADMM_REAL, LINEAR, false>(zi, nullptr, nullptr, nullptr, nullptr, nullptr,
                                                   out, nullptr, n, 0, sweeps, stream);
}
