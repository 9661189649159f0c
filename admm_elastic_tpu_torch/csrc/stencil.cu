// Kernels B and C: flat-stencil D x and D^T W^2 (z - u) for one lattice
// tet family (make_tet_blocks beams), non-wrap.
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
// ints come in a struct by value: offs[8], pe[20], po[20] (per slot s and
// corner j, the cube-corner id on even and on odd cells).
//
// What bounds them on Hopper: at the bench size (1,536 cells, 1,476
// vertices) each is a few hundred KB of traffic and runs in a few
// microseconds, so launch latency, not bandwidth, bounds them. They are
// written simple: one thread per cell (B) or per vertex (C), 64-thread
// blocks so that the 24 blocks spread over 24 SMs. At larger lattices both
// stream at memory bandwidth: B reads x through L1/L2 at 8 shifts of the
// same stream; C re-reads each cell's z and u once per corner it feeds,
// which an SMEM-tiled version could cut (later work).
//
// B reads x at p + d only where p + d < n_vblock, 0 elsewhere: the TPU
// kernel reads rolled-in finite padding there, and an unchecked read past
// the family could bring a NaN that survives dl = 0 (NaN * 0 = NaN).
//
// C is written in gather form: thread q sums, for each corner id in 0..7,
// the contributions of cell p = q - offs[cid] (when 0 <= p < cells) for the
// (slot, corner) pairs whose parity-selected corner id is cid, in slot-major
// order, and writes its vertex once. No atomics: D^T is deterministic run
// to run, which bitwise checkpoint replay needs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Geom {
  int offs[8];
  int pe[20];
  int po[20];
};

template <typename T>
__global__ void __launch_bounds__(64) tet_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ dl, const T* __restrict__ par,
    const T* __restrict__ dead, T* __restrict__ out, int base, int n_vblock, int cells,
    Geom g) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cells) return;
  // The 8 corner positions of this cell (0 past the vertex block).
  T xc[8][3];
#pragma unroll
  for (int cid = 0; cid < 8; ++cid) {
    const int q = p + g.offs[cid];
    const bool in = q < n_vblock;
    const int64_t v = (int64_t)(base + (in ? q : 0)) * 3;
#pragma unroll
    for (int r = 0; r < 3; ++r) xc[cid][r] = in ? x[v + r] : T(0);
  }
  const T pr = par[p];
  const T inv = T(1) - pr;
  const T dd = dead[p];
  const int64_t row = (int64_t)5 * cells;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    T xs[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = g.pe[s * 4 + j], o = g.po[s * 4 + j];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        xs[j][r] = (e == o) ? xc[e][r] : pr * xc[e][r] + inv * xc[o][r];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T acc = xs[0][r] * dl[((int64_t)(s * 4 + 0) * 3 + c) * cells + p];
#pragma unroll
        for (int j = 1; j < 4; ++j) acc = acc + xs[j][r] * dl[((int64_t)(s * 4 + j) * 3 + c) * cells + p];
        if (r == c) acc = acc + dd;
        out[(r * 3 + c) * row + (int64_t)s * cells + p] = acc;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(64) tet_rhs_kernel(
    const T* __restrict__ z, const T* __restrict__ u, const T* __restrict__ w,
    const T* __restrict__ dl, const T* __restrict__ par, T* __restrict__ out, int n_verts,
    int base, int n_vblock, int cells, Geom g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_verts) return;
  const int q = i - base;
  T total[3] = {T(0), T(0), T(0)};
  if (q >= 0 && q < n_vblock) {
    const int64_t row = (int64_t)5 * cells;
#pragma unroll 1
    for (int cid = 0; cid < 8; ++cid) {
      const int p = q - g.offs[cid];
      if (p < 0 || p >= cells) continue;
      const T pr = par[p];
      const T inv = T(1) - pr;
      T acc[3];
      bool any = false;
#pragma unroll 1
      for (int s = 0; s < 5; ++s) {
        const int64_t t = (int64_t)s * cells + p;
        const T w2 = w[t] * w[t];
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          const int he = g.pe[s * 4 + j], ho = g.po[s * 4 + j];
          if (he != cid && ho != cid) continue;
          T contrib[3];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            T cr = T(0);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const int64_t k = (r * 3 + c) * row + t;
              const T gv = w2 * (z[k] - u[k]);
              const T term = gv * dl[((int64_t)(s * 4 + j) * 3 + c) * cells + p];
              cr = (c == 0) ? term : cr + term;
            }
            contrib[r] = cr;
          }
          const T f = (he == ho) ? T(1) : (he == cid ? pr : inv);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const T v = (he == ho) ? contrib[r] : f * contrib[r];
            acc[r] = any ? acc[r] + v : v;
          }
          any = true;
        }
      }
      if (any) {
#pragma unroll
        for (int r = 0; r < 3; ++r) total[r] = total[r] + acc[r];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) out[(int64_t)i * 3 + r] = total[r];
}

Geom make_geom(const int* geom) {
  Geom g;
  for (int i = 0; i < 8; ++i) g.offs[i] = geom[i];
  for (int i = 0; i < 20; ++i) g.pe[i] = geom[8 + i];
  for (int i = 0; i < 20; ++i) g.po[i] = geom[28 + i];
  return g;
}

template <typename T>
int launch_dx(const T* x, const T* dl, const T* par, const T* dead, T* out, int base,
              int n_vblock, int cells, const int* geom, void* stream) {
  if (cells <= 0) return 0;
  const int block = 64;
  tet_dx_kernel<T><<<(cells + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dl, par, dead, out, base, n_vblock, cells, make_geom(geom));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rhs(const T* z, const T* u, const T* w, const T* dl, const T* par, T* out,
               int n_verts, int base, int n_vblock, int cells, const int* geom, void* stream) {
  if (n_verts <= 0) return 0;
  const int block = 64;
  tet_rhs_kernel<T><<<(n_verts + block - 1) / block, block, 0, static_cast<cudaStream_t>(stream)>>>(
      z, u, w, dl, par, out, n_verts, base, n_vblock, cells, make_geom(geom));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// geom: host int[48] = offs[8], pe[20], po[20] (row-major [slot][corner]).
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

extern "C" int admm_tet_rhs_f32(const float* z, const float* u, const float* w,
                                const float* dl, const float* par, float* out, int n_verts,
                                int base, int n_vblock, int cells, const int* geom,
                                void* stream) {
  return launch_rhs<float>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, geom, stream);
}

extern "C" int admm_tet_rhs_f64(const double* z, const double* u, const double* w,
                                const double* dl, const double* par, double* out,
                                int n_verts, int base, int n_vblock, int cells,
                                const int* geom, void* stream) {
  return launch_rhs<double>(z, u, w, dl, par, out, n_verts, base, n_vblock, cells, geom, stream);
}
