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
// are not carried over: the bounds check t < T replaces the pad. On the same
// values a lane's z is kernel A's rows entry's with u = 0, bit for bit: the
// body (tet_lane_prox) is the same.
//
// What bounds them on an H100 (float32, the bench beam's D x at its 7,680
// lanes, and the same values tiled 128 times, 983,040 lanes), and why the
// kernel is no more than this:
// - Not the layout. A single load strides 36 bytes, but a warp's 32 lanes
//   cover one contiguous 1,152-byte span, which its first loads bring into
//   L1 for the other eight. A variant that staged each block's span through
//   shared memory (cp.async in, 16-byte stores out) ran 0.5-2.6 % slower at
//   983,040 lanes for all six models, and at 7,680 for four of them
//   (tools/prox_turns.py, the two in turns), and was dropped. Kernel A's
//   rows entry (coalesced rows, twice the bytes) takes the same time as D
//   and F on the same values.
// - One wave or less: one lane's dependent chain, as for kernel A (see
//   local_step.cu): the 8-sweep SVD, for D then the Newton trips; 65-95
//   times the bound, which is below the time of an empty launch.
// - Many waves: the rate at which the SMs issue every lane's instructions,
//   each IEEE division, square root and log a sequence of them (no fast
//   math), and for D the Newton trips that diverge within a warp: 7-10
//   times the bound, which counts each of those as one operation. Moving
//   the bytes once takes 21 us of F's 169. ptxas: 46-58 registers in float,
//   80-122 in double, no spill.
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
