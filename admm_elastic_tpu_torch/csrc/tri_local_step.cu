// Kernel E: the fused cloth (triangle) local step of one ADMM iteration.
//
// Replaces the Pallas kernel admm_elastic_tpu/ops/pallas_kernels.py
// _local_tri_kernel (:254-261), launched by _local_tri_call (:273-301,
// pallas_call at :286) behind local_step_tri_pallas. Per lane t:
//   v  = dix + u                                  (3x2 deformation gradient)
//   P  = closest orthonormal-column 3x2 to v, from the 2x2 eigen-decomposition
//        of v^T v with its fallbacks (ops/soa.py polar_rotation_3x2_tuple)
//   z  = 1/2 (P + v), column norms clamped to [limit_min, limit_max] where the
//        lane has limits (ops/soa.py prox_tri_tuple)
//   u' = v - z
// The plain version is admm_elastic_tpu_torch/ops/soa.local_step_tri_plain;
// this body repeats it line for line, in the same order: every literal is
// T(...), max goes through the NaN-propagating maxp of common.cuh, use_alt is
// a strict <, and eps is 1e-7 in float and 1e-12 in double.
//
// Layout: dix, u, z, u' are [6, T] row-major (rows F00, F01, F10, F11, F20,
// F21), limit_min and limit_max are [T]. Thread t reads column t of each row,
// so a warp reads 32 neighbouring values per row: coalesced. The ragged edge
// is masked by t < T: the TPU wrapper's pad lanes (identity F, limits
// -100 / 100) are not carried over. Dead stencil lanes arrive as the identity
// 3x2 with u = 0, take the (1, 0) eigenvector fallback (a = c, b = 0) and
// leave as z = identity, u' = 0.
//
// What bounds it on Hopper: a lane moves 14 values in and 12 out (104 B in
// float) for about 150 flops and a dozen sqrt / divisions, so at the card's
// byte and flop rates the two bounds are of the same order and bytes win; at
// the cloth size T = 3,362 neither matters beside the launch itself. One
// thread per lane, everything in registers, no shared memory.
//
// Two entries over one per-lane body (tri_lane_step). The rows entry
// (admm_tri_local_step_*) takes D x as rows [6, T], the TPU kernel's
// signature. The stencil entry (admm_tri_local_step_stencil_*) is what the
// ADMM step launches for a regular sheet: it takes x, and lane t = slot *
// cells + p computes its own six values of D x with tri_dx_lane of
// stencil_body.cuh: three corners of x, the lane's six Dlocal values, the
// corner sum ((j0 + j1) + j2) in __fmul_rn / __fadd_rn, so the six values have
// the bits of ops/stencil.tri_Dx_rows and the two entries give the same
// result. Since launches are what this size pays for, that takes the sheet's
// D x (about ten small PyTorch launches an iteration: pad, stack, product,
// adds, a permuting copy) and its rows in global memory out of the step.
//
// Scenes (scenario batching, admm_elastic_tpu_torch/parallel/batch.py): the
// stencil entry has a scene form over S scenes of one sheet, x [S, N, 3] and
// rows [S, 6, T], one thread a lane of S * T, lane l of scene l / T and
// element l % T. No per-scene parameter enters the cloth prox, so scene i's z
// and u' are the single-scene entry's on scene i's x; a batch of gather
// families runs the rows entry as it is, on the S * T lanes.
//
// Built once per precision (-DADMM_REAL=float -DADMM_SFX=f32, or double /
// f64), without --use_fast_math.

#include "common.cuh"
#include "stencil_body.cuh"

namespace {

// ops/soa.py polar_rotation_3x2_tuple on one lane: f (row-major 3x2) -> p.
template <typename T>
__device__ __forceinline__ void polar_rotation_3x2(const T* f, T* p) {
  const T eps = Lim<T>::polar_eps();
  const T f00 = f[0], f01 = f[1], f10 = f[2], f11 = f[3], f20 = f[4], f21 = f[5];

  // G = F^T F (2x2 SPD)
  const T a = f00 * f00 + f10 * f10 + f20 * f20;
  const T b = f00 * f01 + f10 * f11 + f20 * f21;
  const T c = f01 * f01 + f11 * f11 + f21 * f21;

  const T tr = a + c;
  const T disc = dsqrt(maxp((a - c) * (a - c) + T(4) * b * b, T(0)));
  const T l1 = T(0.5) * (tr + disc);
  const T l2 = T(0.5) * (tr - disc);

  T v1x = b, v1y = l1 - a;
  const T ax = l1 - c, ay = b;
  const bool use_alt = v1x * v1x + v1y * v1y < ax * ax + ay * ay;
  v1x = use_alt ? ax : v1x;
  v1y = use_alt ? ay : v1y;
  const T n1 = dsqrt(v1x * v1x + v1y * v1y);
  const bool ok = n1 > eps;
  const T inv = T(1) / maxp(n1, eps);
  v1x = ok ? v1x * inv : T(1);
  v1y = ok ? v1y * inv : T(0);
  const T v2x = -v1y, v2y = v1x;
  const T s1 = dsqrt(maxp(l1, T(0)));
  const T s2 = dsqrt(maxp(l2, T(0)));

  // U columns = F V / s with orthonormalisation fallbacks.
  T u1[3] = {f00 * v1x + f01 * v1y, f10 * v1x + f11 * v1y, f20 * v1x + f21 * v1y};
  T u2[3] = {f00 * v2x + f01 * v2y, f10 * v2x + f11 * v2y, f20 * v2x + f21 * v2y};
  const T inv1 = T(1) / maxp(s1, eps);
  const T inv2 = T(1) / maxp(s2, eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u1[r] = u1[r] * inv1;
    u2[r] = u2[r] * inv2;
  }

  const T nu1 = dsqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]);
  const bool ok1 = nu1 > eps;
  const T iu1 = T(1) / maxp(nu1, eps);
#pragma unroll
  for (int r = 0; r < 3; ++r) u1[r] = ok1 ? u1[r] * iu1 : (r == 0 ? T(1) : T(0));

  const T proj = u2[0] * u1[0] + u2[1] * u1[1] + u2[2] * u1[2];
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] = u2[r] - proj * u1[r];
  const T nu2 = dsqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]);
  const bool ok2 = nu2 > eps;
  const T iu2 = T(1) / maxp(nu2, eps);
  const bool big0 = dabs(u1[0]) > T(0.9);
  const T ref[3] = {big0 ? T(0) : T(1), big0 ? T(1) : T(0), T(0)};
  T alt[3] = {u1[1] * ref[2] - u1[2] * ref[1], u1[2] * ref[0] - u1[0] * ref[2],
              u1[0] * ref[1] - u1[1] * ref[0]};
  const T altn = dsqrt(maxp(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2], eps * eps));
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    alt[r] = alt[r] / altn;
    u2[r] = ok2 ? u2[r] * iu2 : alt[r];
  }

  // P = U V^T (3x2): P_rc = u1_r * v1_c + u2_r * v2_c.
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[2 * r] = u1[r] * v1x + u2[r] * v2x;
    p[2 * r + 1] = u1[r] * v1y + u2[r] * v2y;
  }
}

// The strain-limit scale of one column norm (ops/soa.py prox_tri_tuple clamp).
template <typename T>
__device__ __forceinline__ T limit_scale(T n, T lo, T hi, bool check) {
  const T safe = maxp(n, T(1e-30));
  T s = T(1);
  s = n < lo ? lo / safe : s;
  s = n > hi ? hi / safe : s;
  return check ? s : T(1);
}

// v (3x2 row-major, in registers) of lane t -> z and u' = v - z, stored to
// rows [6, n]. Both entries end here.
template <typename T>
__device__ __forceinline__ void tri_lane_step(const T* v, const T* __restrict__ limit_min,
                                              const T* __restrict__ limit_max,
                                              T* __restrict__ z, T* __restrict__ uo, int n,
                                              int t) {
  T p[6], zz[6];
  polar_rotation_3x2(v, p);
#pragma unroll
  for (int i = 0; i < 6; ++i) zz[i] = T(0.5) * (p[i] + v[i]);

  const T lo = limit_min[t], hi = limit_max[t];
  const bool check = (lo > T(0)) | (hi < T(99));
  const T n0 = dsqrt(zz[0] * zz[0] + zz[2] * zz[2] + zz[4] * zz[4]);
  const T n1 = dsqrt(zz[1] * zz[1] + zz[3] * zz[3] + zz[5] * zz[5]);
  const T s0 = limit_scale(n0, lo, hi, check);
  const T s1 = limit_scale(n1, lo, hi, check);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    zz[2 * r] = zz[2 * r] * s0;
    zz[2 * r + 1] = zz[2 * r + 1] * s1;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    z[(int64_t)i * n + t] = zz[i];
    uo[(int64_t)i * n + t] = v[i] - zz[i];
  }
}

// The rows entry: D x comes as rows [6, n].
template <typename T>
__global__ void __launch_bounds__(64) tri_local_step_kernel(
    const T* __restrict__ dix, const T* __restrict__ u, const T* __restrict__ limit_min,
    const T* __restrict__ limit_max, T* __restrict__ z, T* __restrict__ uo, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  T v[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = dix[(int64_t)i * n + t] + u[(int64_t)i * n + t];
  tri_lane_step(v, limit_min, limit_max, z, uo, n, t);
}

// The stencil entry: lane t = slot * cells + p of a regular sheet computes
// its own D x from x (tri_dx_lane), n = n_slots * cells.
template <typename T>
__global__ void __launch_bounds__(64) tri_local_step_stencil_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ dead,
    const T* __restrict__ u, const T* __restrict__ limit_min, const T* __restrict__ limit_max,
    T* __restrict__ z, T* __restrict__ uo, int base, int cells, int n,
    const __grid_constant__ TriGeom g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int s = t / cells, p = t - s * cells;
  T v[6];
  tri_dx_lane(x, dl, dead, base, cells, s, p, g, v);
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = v[i] + u[(int64_t)i * n + t];
  tri_lane_step(v, limit_min, limit_max, z, uo, n, t);
}

}  // namespace

#define ADMM_CAT2(a, b) a##_##b
#define ADMM_CAT(a, b) ADMM_CAT2(a, b)

namespace {

// The stencil entry over S scenes: x [S, n_verts, 3], u, z, uo [S, 6, n].
template <typename T>
__global__ void __launch_bounds__(64) tri_local_step_stencil_scenes_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ dead,
    const T* __restrict__ u, const T* __restrict__ limit_min, const T* __restrict__ limit_max,
    T* __restrict__ z, T* __restrict__ uo, int base, int cells, int n, int n_verts, int scenes,
    const __grid_constant__ TriGeom g) {
  const int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= (int64_t)scenes * n) return;
  const int sc = static_cast<int>(l / n), t = static_cast<int>(l - (int64_t)sc * n);
  const int s = t / cells, p = t - s * cells;
  const int64_t off = (int64_t)sc * 6 * n;
  T v[6];
  tri_dx_lane(x + (int64_t)sc * n_verts * 3, dl, dead, base, cells, s, p, g, v);
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = v[i] + u[off + (int64_t)i * n + t];
  tri_lane_step(v, limit_min, limit_max, z + off, uo + off, n, t);
}

}  // namespace

extern "C" int ADMM_CAT(admm_tri_local_step_stencil_scenes, ADMM_SFX)(
    const ADMM_REAL* x, const ADMM_REAL* dl, const ADMM_REAL* dead, const ADMM_REAL* u,
    const ADMM_REAL* limit_min, const ADMM_REAL* limit_max, ADMM_REAL* z, ADMM_REAL* uo,
    int base, int cells, int n_slots, int n_verts, int scenes, const int* geom, void* stream) {
  if (cells <= 0 || scenes <= 0) return 0;
  if (n_slots < 1 || n_slots > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n = n_slots * cells;
  const int64_t lanes = (int64_t)scenes * n;
  const int block = 64;
  tri_local_step_stencil_scenes_kernel<ADMM_REAL>
      <<<(unsigned)((lanes + block - 1) / block), block, 0, static_cast<cudaStream_t>(stream)>>>(
          x, dl, dead, u, limit_min, limit_max, z, uo, base, cells, n, n_verts, scenes,
          make_tri_geom(geom));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ADMM_CAT(admm_tri_local_step, ADMM_SFX)(
    const ADMM_REAL* dix, const ADMM_REAL* u, const ADMM_REAL* limit_min,
    const ADMM_REAL* limit_max, ADMM_REAL* z, ADMM_REAL* uo, int n, void* stream) {
  if (n <= 0) return 0;
  const int block = 64;  // 3,362 cloth lanes -> 53 blocks on 53 SMs
  const int grid = (n + block - 1) / block;
  tri_local_step_kernel<ADMM_REAL><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dix, u, limit_min, limit_max, z, uo, n);
  return static_cast<int>(cudaGetLastError());
}

// geom: host int[28], see make_tri_geom of stencil_body.cuh; 1 <= n_slots <= 8.
extern "C" int ADMM_CAT(admm_tri_local_step_stencil, ADMM_SFX)(
    const ADMM_REAL* x, const ADMM_REAL* dl, const ADMM_REAL* dead, const ADMM_REAL* u,
    const ADMM_REAL* limit_min, const ADMM_REAL* limit_max, ADMM_REAL* z, ADMM_REAL* uo,
    int base, int cells, int n_slots, const int* geom, void* stream) {
  if (cells <= 0) return 0;
  if (n_slots < 1 || n_slots > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n = n_slots * cells;
  const int block = 64;
  const int grid = (n + block - 1) / block;
  tri_local_step_stencil_kernel<ADMM_REAL>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          x, dl, dead, u, limit_min, limit_max, z, uo, base, cells, n, make_tri_geom(geom));
  return static_cast<int>(cudaGetLastError());
}
