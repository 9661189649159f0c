// Flat-stencil D x of ONE lane, in registers: the arithmetic of kernel B
// (admm_elastic_tpu/ops/pallas_stencil.py tet_Dx_rows, body _dx_blocks
// :91-112) for a tet lattice, and of the sheet's D x
// (admm_elastic_tpu/ops/stencil.py, the triangle-sheet part) for a cloth
// grid. The plain versions are tet_Dx_rows_plain and tri_Dx_rows in
// admm_elastic_tpu_torch/ops/stencil.py.
//
// Who calls it: the standalone kernel B (stencil.cu, a thread per lane, rows
// written to global memory: what system.Dx and A_mv need), and the local
// steps that read x themselves (local_step.cu, tri_local_step.cu): there the
// lane that consumes D x computes it, so a step launches no D x kernel and
// no D x rows exist in global memory. A separate D x launch cannot get under
// the launch floor of the card, which alone is several times the bound of
// these few hundred KB; inside the consumer's launch it costs one more round
// of independent loads of values that sit in L1 / L2 (x is 17.7 KB at the
// bench size).
//
// Layout (ops/stencil.py): lane t = slot * cells + p over cells p embedded
// at vertex pitch, so a corner of cell p is vertex base + p + offs[corner
// id]. Lanes of a warp have consecutive p and share the slot but where a
// warp straddles two slots (cells is a multiple of 128 for a plain tet
// lattice, not for a ring): the reads of dl, par, dead and of each corner of
// x are coalesced, and all of them are independent.
//
// A corner past the family's vertex block reads 0 (the plain version's zero
// pad): an unchecked read could bring a NaN that survives dl = 0. On a ring
// lattice (Geom::wrap; cells = n_vblock) it reads vertex (p + offs) mod cells
// instead, one compare and subtract: every offset is below cells.
//
// Every product and sum is __fmul_rn / __fadd_rn (mul_rn, add_rn): the
// compiler can contract none of them into an FMA, so a lane's 9 (or 6)
// values have the same bits in every kernel that inlines this body, and the
// bits of the plain version's separate PyTorch operations, whose order they
// follow term for term.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// A tet lattice family: offs[8] the flat vertex offset of each cube corner;
// pe / po [slot * 4 + corner] the cube-corner id on even and on odd cells;
// wrap 1 on a ring lattice.
struct Geom {
  int offs[8];
  int pe[20];
  int po[20];
  int wrap;
};

// A sheet: offs[4] the flat vertex offset of each cell corner; pats
// [slot * 3 + corner] the cell-corner id, for at most 8 slots.
struct TriGeom {
  int offs[4];
  int pats[24];
};

// geom: host int[49] = offs[8], pe[20], po[20] (row-major [slot][corner]),
// wrap.
inline Geom make_geom(const int* geom) {
  Geom g;
  for (int i = 0; i < 8; ++i) g.offs[i] = geom[i];
  for (int i = 0; i < 20; ++i) g.pe[i] = geom[8 + i];
  for (int i = 0; i < 20; ++i) g.po[i] = geom[28 + i];
  g.wrap = geom[48];
  return g;
}

// geom: host int[28] = offs[4], pats[24] (row-major [slot][corner], 0 past
// the family's slots).
inline TriGeom make_tri_geom(const int* geom) {
  TriGeom g;
  for (int i = 0; i < 4; ++i) g.offs[i] = geom[i];
  for (int i = 0; i < 24; ++i) g.pats[i] = geom[4 + i];
  return g;
}

// Vertex base + q of x [N, 3], 0 where q lies past the family's block, or
// on a ring (wrap) vertex base + q - n_vblock there.
template <typename T>
__device__ __forceinline__ void stencil_corner(const T* __restrict__ x, int base, int n_vblock,
                                               int q, bool wrap, T out[3]) {
  if (wrap && q >= n_vblock) q -= n_vblock;
  const bool in = q < n_vblock;
  const int64_t v = (int64_t)(base + (in ? q : 0)) * 3;
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = in ? x[v + r] : T(0);
}

// D x of tet lane (slot s, cell p) -> out[3 r + c], row-major 3x3.
// tet_Dx_rows_plain: corner j is the even cell's cube corner where both
// parities name the same one, else par * even + (1 - par) * odd; then
// sum_j xs[j][r] * dl[s][j][c] with j = 0..3 in turn, + dead on the diagonal.
template <typename T>
__device__ __forceinline__ void tet_dx_lane(const T* __restrict__ x, const T* __restrict__ dl,
                                            const T* __restrict__ par,
                                            const T* __restrict__ dead, int base, int n_vblock,
                                            int cells, int s, int p, const Geom& g, T out[9]) {
  const T pr = par[p];
  const T inv = T(1) - pr;
  const T dd = dead[p];
  T xs[4][3], d[4][3];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = g.pe[s * 4 + j], o = g.po[s * 4 + j];
    T xe[3], xo[3];
    stencil_corner(x, base, n_vblock, p + g.offs[e], g.wrap != 0, xe);
    stencil_corner(x, base, n_vblock, p + g.offs[o], g.wrap != 0, xo);
#pragma unroll
    for (int r = 0; r < 3; ++r)
      xs[j][r] = (e == o) ? xe[r] : add_rn(mul_rn(pr, xe[r]), mul_rn(inv, xo[r]));
#pragma unroll
    for (int c = 0; c < 3; ++c) d[j][c] = dl[((int64_t)(s * 4 + j) * 3 + c) * cells + p];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T acc = mul_rn(xs[0][r], d[0][c]);
#pragma unroll
      for (int j = 1; j < 4; ++j) acc = add_rn(acc, mul_rn(xs[j][r], d[j][c]));
      out[3 * r + c] = (r == c) ? add_rn(acc, dd) : acc;
    }
  }
}

// D x of sheet lane (slot s, cell p) -> out[2 r + c], row-major 3x2.
// tri_Dx_rows: the corner sum as ((j0 + j1) + j2), + dead on rows F00 and F11
// (the identity 3x2 on dead lanes). The sheet's vertex block has one vertex
// per cell.
template <typename T>
__device__ __forceinline__ void tri_dx_lane(const T* __restrict__ x, const T* __restrict__ dl,
                                            const T* __restrict__ dead, int base, int cells,
                                            int s, int p, const TriGeom& g, T out[6]) {
  const T dd = dead[p];
  T xs[3][3], d[3][2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    stencil_corner(x, base, cells, p + g.offs[g.pats[s * 3 + j]], false, xs[j]);
#pragma unroll
    for (int c = 0; c < 2; ++c) d[j][c] = dl[((int64_t)(s * 3 + j) * 2 + c) * cells + p];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const T acc = add_rn(add_rn(mul_rn(xs[0][r], d[0][c]), mul_rn(xs[1][r], d[1][c])),
                           mul_rn(xs[2][r], d[2][c]));
      out[2 * r + c] = (r == c) ? add_rn(acc, dd) : acc;
    }
  }
}

}  // namespace
