// Kernels B and C: flat-stencil D x and D^T W^2 (z - u) for one lattice
// tet family: a make_tet_blocks beam, or a ring lattice (make_tet_torus,
// Geom::wrap / Match::wrap), whose cells equal its vertex block and are no
// multiple of 128 or of C's tile.
//
// B replaces admm_elastic_tpu/ops/pallas_stencil.py tet_Dx_rows (:157-168,
// pallas_call at :164, body _dx_blocks :91-112). C replaces tet_rhs_rows
// (:183-201, pallas_call at :193, body _rhs_kernel :175-180 and _dt_total
// :115-145). Their plain versions are tet_Dx_rows_plain and
// tet_rhs_rows_plain in admm_elastic_tpu_torch/ops/stencil.py; both kernels
// repeat those sums term for term, in the same order.
//
// Layout (ops/stencil.py): element t = slot * cells + p over cells p
// embedded at vertex pitch, so corner (di, dj, dk) of cell p is vertex
// base + p + offs[di*4 + dj*2 + dk]. dl is [5 slots][4 corners][3 cols]
// [cells]; par is 1 on even cells; dead is 1 on dead cells. The geometry
// ints come in a struct by value (Geom of stencil_body.cuh): offs[8], pe[20],
// po[20] (per slot s and corner j, the cube-corner id on even and on odd
// cells), wrap.
//
// B: one thread per lane (slot, cell), 64-thread blocks; the lane's nine
// values come from tet_dx_lane of stencil_body.cuh, the same per-lane body
// that the tet local step inlines (local_step.cu), so the rows written here
// and the values that step computes for itself cannot drift apart. The ADMM
// step does not launch B any more: it is the kernel behind system.Dx, which
// A_mv (the refinement pass of an unpinned float32 system) and the
// element-level prox call. At the bench size (7,680 lanes) it moves a few
// hundred KB; what bounds it on Hopper is the latency of one round of loads
// plus the launch, not bandwidth. It reads x at p + d only where
// p + d < n_vblock, 0 elsewhere: the TPU kernel reads rolled-in finite
// padding there, and an unchecked read past the family could bring a NaN
// that survives dl = 0 (NaN * 0 = NaN).
//
// C is a gather: vertex q sums, for each corner id in 0..7, the
// contributions of cell p = q - offs[cid] (when 0 <= p < cells) for the
// (slot, corner) pairs whose parity-selected corner id is cid, in slot-major
// order, and writes its vertex once. On a ring a cell p = q - offs[cid] < 0
// is cell p + cells: the plain version adds those contributions after the
// others (it folds the tail past the last cell onto the head), so the kernels
// sum the wrapped corner ids apart, in their order, and add that sum last.
// No atomics: D^T is deterministic run
// to run, which bitwise checkpoint replay needs. Which pairs feed which
// corner id depends on pe / po alone, so the host builds that match table
// once (ops/cuda_stencil.rhs_match_table) and the kernels walk its entries.
// The sums use the non-contracting __fmul_rn / __fadd_rn (mul_rn, add_rn of
// stencil_body.cuh): both branches then round exactly as the plain version's
// separate PyTorch operations do, whatever the compiler would fuse, and are
// bitwise equal to each other.
//
// What bounds C on Hopper is latency, not bytes (under 1 MB at the bench
// size): a vertex needs ~20-32 (cell, slot, corner) contributions of 31
// loads each. The two branches, chosen by the wrapper from the shapes alone:
// - tiled (tet_rhs_tiled_kernel), where the halo fits: a block owns a tile
//   of `tile` consecutive vertices. Phase 1, a thread per (cell, slot) over
//   the cells [q0 - max(offs), q0 + tile) that can feed the tile: one round
//   of 31 independent, coalesced loads, w^2 (z - u) and the 4 corner
//   contributions once per tet (not once per corner fed), stored to shared
//   memory as [slot][corner][component] rows x cell columns. Phase 2, a
//   thread per (corner id, vertex): that corner id's entries come from
//   shared memory (consecutive threads on consecutive banks) and are added
//   in the table's order. Phase 3, a thread per (vertex, component), adds
//   the 8 corner-id sums in turn. The dependent chain is one round of global
//   loads, then at most a corner id's entries, then 8 adds.
// - wide (tet_rhs_wide_kernel), for cross-sections whose halo
//   max(offs) = Y*Z + Z + 1 leaves no room for a tile in a block's shared
//   memory: a thread per vertex loads each contribution's operands itself,
//   one dependent round per contribution. Slow at the bench size (a chain
//   of tens of round trips on 24 SMs), it streams at sizes where many
//   warps are resident.
// On an H100 at the bench size, f32, the tiled branch takes 2.8 us of device
// time at a tile of 32, the wide branch 17.8, an empty launch 0.9.
//
// C has a scene form (scenario batching, admm_elastic_tpu_torch/parallel/
// batch.py): S scenes of one lattice, z and u [S, 9, T], out [S, N, 3], the
// scenes on the grid's y axis. Scene i's weight is w sqrt(s_i) (sq [S] holds
// the square roots, taken by the wrapper) and its W^2 that weight squared,
// (w sqrt(s_i)) (w sqrt(s_i)), each product rounded on its own, as the plain
// version forms it from parallel/batch._scale_system's weights; so scene i's
// rows are, bit for bit, the single-scene kernel's on its scaled weights.

#include "stencil_body.cuh"

namespace {

// C's match table: corner id cid owns ent[start[cid] .. start[cid + 1]), in
// slot-major order; an entry is (slot * 4 + corner) | kind << 8 with kind
// BOTH (pe == po == cid: the contribution as it is), EVEN (pe == cid only:
// times par) or ODD (po == cid only: times 1 - par). At most 40 entries.
// wrap: 1 on a ring lattice.
enum MatchKind { BOTH = 0, EVEN = 1, ODD = 2 };
struct Match {
  int offs[8];
  int start[9];
  int ent[40];
  int wrap;
};

template <typename T>
__global__ void __launch_bounds__(64) tet_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ par,
    const T* __restrict__ dead, T* __restrict__ out, int base, int n_vblock, int cells,
    const __grid_constant__ Geom g) {
  const int n = 5 * cells;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int s = t / cells, p = t - s * cells;
  T dix[9];
  tet_dx_lane(x, dl, par, dead, base, n_vblock, cells, s, p, g, dix);
#pragma unroll
  for (int i = 0; i < 9; ++i) out[(int64_t)i * n + t] = dix[i];
}

// g = w^2 (z - u) of tet (slot s, cell p), 19 independent loads.
template <typename T, bool SCN>
__device__ __forceinline__ void rhs_g(const T* __restrict__ z, const T* __restrict__ u,
                                      const T* __restrict__ w, const T* __restrict__ sq,
                                      int cells, int s, int p, T g[9]) {
  const int64_t row = (int64_t)5 * cells;
  const int64_t t = (int64_t)s * cells + p;
  T wt = w[t];
  if constexpr (SCN) wt = mul_rn(wt, *sq);
  T zz[9], uu[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    zz[k] = z[k * row + t];
    uu[k] = u[k * row + t];
  }
  const T w2 = mul_rn(wt, wt);
#pragma unroll
  for (int k = 0; k < 9; ++k) g[k] = mul_rn(w2, zz[k] - uu[k]);
}

// One corner's contribution to D^T W^2 (z - u): out[r] = sum_c g[3r + c] *
// d[c], c = 0, 1, 2 in turn.
template <typename T>
__device__ __forceinline__ void rhs_corner(const T g[9], T d0, T d1, T d2, T out[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T cr = mul_rn(g[3 * r], d0);
    cr = add_rn(cr, mul_rn(g[3 * r + 1], d1));
    out[r] = add_rn(cr, mul_rn(g[3 * r + 2], d2));
  }
}

// acc (+)= the entry's share of one contribution, for one component.
template <typename T>
__device__ __forceinline__ T rhs_add(bool first, T acc, int kind, T pr, T inv, T c) {
  const T v = kind == BOTH ? c : mul_rn(kind == EVEN ? pr : inv, c);
  return first ? v : add_rn(acc, v);
}

// Threads of a tiled block: one per (slot, cell column) of phase 1 where that
// is at most this many (375 at the bench shape with a tile of 32: phase 1 is
// then a single round of loads), else this many looping over the columns.
constexpr int kRhsMaxBlock = 640;

// Tiled branch. Block b owns output vertices [b * tile, (b + 1) * tile);
// q0 = b * tile - base is the first of them in the family's block. Shared
// memory, width = tile + halo cell columns, halo = max(offs), col = p -
// (q0 - halo): 60 rows of contributions sm[(sj * 3 + r) * width + col], one
// row of parities par[p], then the tile's 8 corner-id sums acc[(cid * tile +
// vertex) * 3 + r].
// SCN: the scene form (see the header), an instantiation of its own.
template <typename T, bool SCN>
__global__ void __launch_bounds__(kRhsMaxBlock) tet_rhs_tiled_kernel(
    const T* __restrict__ z, const T* __restrict__ u, const T* __restrict__ w,
    const T* __restrict__ sq, const T* __restrict__ dl, const T* __restrict__ par,
    T* __restrict__ out, int n_verts, int base, int n_vblock, int cells, int tile, int halo,
    Match m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (SCN) {  // scene blockIdx.y
    const int64_t rows = (int64_t)blockIdx.y * 45 * cells;
    z += rows;
    u += rows;
    out += (int64_t)blockIdx.y * n_verts * 3;
    sq += blockIdx.y;
  }
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int width = tile + halo;
  T* sm_par = sm + 60 * width;
  T* sm_acc = sm_par + width;
  const int q0 = blockIdx.x * tile - base;
  const int p0 = q0 - halo;

  // Phase 1: a thread per (slot, cell column); one round of loads where the
  // block has a thread for each. A ring's column p < 0 holds cell p + cells.
  for (int idx = threadIdx.x; idx < 5 * width; idx += blockDim.x) {
    const int s = idx / width, col = idx - s * width;
    int p = p0 + col;
    if (m.wrap && p < 0) p += cells;
    if (p < 0 || p >= cells) continue;
    T d[12], g[9];
#pragma unroll
    for (int k = 0; k < 12; ++k) d[k] = dl[((int64_t)s * 12 + k) * cells + p];
    if (s == 0) sm_par[col] = par[p];
    rhs_g<T, SCN>(z, u, w, sq, cells, s, p, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T c[3];
      rhs_corner(g, d[3 * j], d[3 * j + 1], d[3 * j + 2], c);
#pragma unroll
      for (int r = 0; r < 3; ++r) sm[((s * 4 + j) * 3 + r) * width + col] = c[r];
    }
  }
  __syncthreads();

  // Phase 2: a thread per (corner id, vertex) sums that corner id's entries
  // in the table's order; with tile a multiple of 32 a warp shares its cid.
  for (int idx = threadIdx.x; idx < 8 * tile; idx += blockDim.x) {
    const int cid = idx / tile, v = idx - cid * tile;
    const int p = q0 + v - m.offs[cid];
    const int e0 = m.start[cid], e1 = m.start[cid + 1];
    if ((p < 0 && !m.wrap) || p >= cells) continue;
    const int col = p - p0;
    const T pr = sm_par[col];
    const T inv = T(1) - pr;
    T acc[3] = {T(0), T(0), T(0)};
#pragma unroll 2
    for (int e = e0; e < e1; ++e) {
      const int sj = m.ent[e] & 0xff, kind = m.ent[e] >> 8;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        acc[r] = rhs_add(e == e0, acc[r], kind, pr, inv, sm[(sj * 3 + r) * width + col]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) sm_acc[idx * 3 + r] = acc[r];
  }
  __syncthreads();

  // Phase 3: a thread per (vertex, component) adds the corner ids' sums in
  // turn (a ring's wrapped ones apart, then the two) and writes its value
  // once; consecutive threads, consecutive addresses.
  for (int idx = threadIdx.x; idx < 3 * tile; idx += blockDim.x) {
    const int v = idx / 3;
    const int q = q0 + v;
    if (q + base >= n_verts) break;
    T total = T(0), tail = T(0);
    if (q >= 0 && q < n_vblock) {
#pragma unroll
      for (int cid = 0; cid < 8; ++cid) {
        const int p = q - m.offs[cid];
        if (p >= cells || m.start[cid] == m.start[cid + 1]) continue;
        if (p >= 0)
          total = add_rn(total, sm_acc[cid * tile * 3 + idx]);
        else if (m.wrap)
          tail = add_rn(tail, sm_acc[cid * tile * 3 + idx]);
      }
    }
    out[(int64_t)(blockIdx.x * tile) * 3 + idx] = m.wrap ? add_rn(total, tail) : total;
  }
}

// Wide branch: a thread per output vertex, every operand from global memory.
template <typename T, bool SCN>
__global__ void __launch_bounds__(64) tet_rhs_wide_kernel(
    const T* __restrict__ z, const T* __restrict__ u, const T* __restrict__ w,
    const T* __restrict__ sq, const T* __restrict__ dl, const T* __restrict__ par,
    T* __restrict__ out, int n_verts, int base, int n_vblock, int cells, Match m) {
  if constexpr (SCN) {  // scene blockIdx.y
    const int64_t rows = (int64_t)blockIdx.y * 45 * cells;
    z += rows;
    u += rows;
    out += (int64_t)blockIdx.y * n_verts * 3;
    sq += blockIdx.y;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_verts) return;
  const int q = i - base;
  T total[3] = {T(0), T(0), T(0)}, tail[3] = {T(0), T(0), T(0)};
  if (q >= 0 && q < n_vblock) {
#pragma unroll 1
    for (int cid = 0; cid < 8; ++cid) {
      int p = q - m.offs[cid];
      const int e0 = m.start[cid], e1 = m.start[cid + 1];
      const bool wrapped = m.wrap && p < 0;
      if (wrapped) p += cells;
      if (p < 0 || p >= cells || e0 == e1) continue;
      const T pr = par[p];
      const T inv = T(1) - pr;
      T acc[3] = {T(0), T(0), T(0)};
#pragma unroll 1
      for (int e = e0; e < e1; ++e) {
        const int sj = m.ent[e] & 0xff, kind = m.ent[e] >> 8;
        const T* d = dl + (int64_t)sj * 3 * cells + p;
        const T d0 = d[0], d1 = d[cells], d2 = d[(int64_t)2 * cells];
        T g[9], c[3];
        rhs_g<T, SCN>(z, u, w, sq, cells, sj >> 2, p, g);
        rhs_corner(g, d0, d1, d2, c);
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[r] = rhs_add(e == e0, acc[r], kind, pr, inv, c[r]);
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (wrapped)
          tail[r] = add_rn(tail[r], acc[r]);
        else
          total[r] = add_rn(total[r], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    out[(int64_t)i * 3 + r] = m.wrap ? add_rn(total[r], tail[r]) : total[r];
}

Match make_match(const int* match) {
  Match m;
  for (int i = 0; i < 8; ++i) m.offs[i] = match[i];
  for (int i = 0; i < 9; ++i) m.start[i] = match[8 + i];
  for (int i = 0; i < 40; ++i) m.ent[i] = match[17 + i];
  m.wrap = match[57];
  return m;
}

template <typename T>
int launch_dx(const T* x, const T* dl, const T* par, const T* dead, T* out, int base,
              int n_vblock, int cells, const int* geom, void* stream) {
  if (cells <= 0) return 0;
  const int block = 64;
  tet_dx_kernel<T><<<(5 * cells + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dl, par, dead, out, base, n_vblock, cells, make_geom(geom));
  return static_cast<int>(cudaGetLastError());
}

// tile > 0: the tiled branch with that tile (at most 256 vertices) and halo
// = max(offs); tile == 0: the wide branch. Above 48 KB the tile's shared
// memory has to be granted to the kernel first: once per precision and
// size, so that a launch captured into a CUDA graph (after an uncaptured
// one of the same size) sets no attribute.
// SCN: the scene form, sq the scenes' [S] square roots of their scales
template <typename T, bool SCN = false>
int launch_rhs(const T* z, const T* u, const T* w, const T* dl, const T* par, T* out,
               int n_verts, int base, int n_vblock, int cells, const int* match, int tile,
               int halo, void* stream, const T* sq = nullptr, int scenes = 1) {
  if (n_verts <= 0 || scenes <= 0) return 0;
  if (scenes > 65535 || (SCN && sq == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Match m = make_match(match);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    const int block = 64;
    tet_rhs_wide_kernel<T, SCN><<<dim3((n_verts + block - 1) / block, scenes), block, 0, st>>>(
        z, u, w, sq, dl, par, out, n_verts, base, n_vblock, cells, m);
    return static_cast<int>(cudaGetLastError());
  }
  if (tile < 0 || tile > 256 || halo < 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = ((size_t)61 * (tile + halo) + 24 * tile) * sizeof(T);
  static size_t granted = 48 * 1024;  // one per precision and form
  if (bytes > granted) {
    const cudaError_t rc = cudaFuncSetAttribute(
        tet_rhs_tiled_kernel<T, SCN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    granted = bytes;
  }
  const int items = 5 * (tile + halo);
  const int block = items < kRhsMaxBlock ? (items + 31) / 32 * 32 : kRhsMaxBlock;
  tet_rhs_tiled_kernel<T, SCN><<<dim3((n_verts + tile - 1) / tile, scenes), block, bytes, st>>>(
      z, u, w, sq, dl, par, out, n_verts, base, n_vblock, cells, tile, halo, m);
  return static_cast<int>(cudaGetLastError());
}

// A kernel that does nothing: its device time is the floor under every
// launch on this card (chip_smoke.py prints it beside the kernels' times).
__global__ void empty_kernel() {}

}  // namespace

// geom: host int[49], see make_geom of stencil_body.cuh.
extern "C" int admm_tet_dx_f32(const float* x, const float* dl, const float* par,
                               const float* dead, float* out, int base, int n_vblock,
                               int cells, const int* geom, void* stream) {
  return launch_dx<float>(x, dl, par, dead, out, base, n_vblock, cells, geom, stream);
}

extern "C" int admm_tet_dx_f64(const double* x, const double* dl, const double* par,
                               const double* dead, double* out, int base, int n_vblock,
                               int cells, const int* geom, void* stream) {
  return launch_dx<double>(x, dl, par, dead, out, base, n_vblock, cells, geom, stream);
}

// match: host int[58] = offs[8], start[9], ent[40], wrap (struct Match).
extern "C" int admm_tet_rhs_f32(const float* z, const float* u, const float* w,
                                const float* dl, const float* par, float* out, int n_verts,
                                int base, int n_vblock, int cells, const int* match, int tile,
                                int halo, void* stream) {
  return launch_rhs<float>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, match, tile,
                           halo, stream);
}

extern "C" int admm_tet_rhs_f64(const double* z, const double* u, const double* w,
                                const double* dl, const double* par, double* out,
                                int n_verts, int base, int n_vblock, int cells,
                                const int* match, int tile, int halo, void* stream) {
  return launch_rhs<double>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, match, tile,
                            halo, stream);
}

// The scene form: z, u [scenes, 9, 5 cells], out [scenes, n_verts, 3], sq [scenes].
extern "C" int admm_tet_rhs_scenes_f32(const float* z, const float* u, const float* w,
                                       const float* sq, const float* dl, const float* par,
                                       float* out, int n_verts, int base, int n_vblock,
                                       int cells, int scenes, const int* match, int tile,
                                       int halo, void* stream) {
  return launch_rhs<float, true>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, match,
                                 tile, halo, stream, sq, scenes);
}

extern "C" int admm_tet_rhs_scenes_f64(const double* z, const double* u, const double* w,
                                       const double* sq, const double* dl, const double* par,
                                       double* out, int n_verts, int base, int n_vblock,
                                       int cells, int scenes, const int* match, int tile,
                                       int halo, void* stream) {
  return launch_rhs<double, true>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, match,
                                  tile, halo, stream, sq, scenes);
}

extern "C" int admm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
