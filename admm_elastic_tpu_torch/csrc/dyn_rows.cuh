// The dynamic (self-collision) constraint rows as a gather: the device body of
// kernel L (self_collision.cu's standalone launch) and of the DYN forms of
// kernels H (gs.cu) and G (pcg.cu).
//
// It has no Pallas original. It replaces the scatters with duplicates of the
// JAX package's constraints.py (Ct_apply and CtC_diag, :146-147, 167-172:
// .at[d_face].add, which on the card would need float atomics). A dynamic row
// r adds into its own vertex and into its face's three vertices, which the
// faces of other rows share. Per detection, ops/cuda_dynamic.py and
// collision/constraints.with_table list the active rows' face corners by
// vertex in CSR form: order, the corner ids r * 3 + c sorted stably by their
// vertex, and start, each vertex's first entry. A vertex then sums its entries
// one at a time in that order (row, then corner: the order in which
// .at[].add and index_add apply them) onto its own row's term, with no atomic.
// Every operation is an IEEE-rounded intrinsic in the plain version's order
// (collision/constraints.py corner_values, gather_plain), so a sum is its
// plain twin's bit for bit.
//
// The terms of row r's corner c, component k:
//   C^T y:        (-(ck y_r) b_rc) n_rk
//   diag(C^T C):  (ck ck) (b_rc n_rk)^2
// and a row's value, C x:  ck n_r . (x_v - ((b_r0 x_f0 + b_r1 x_f1) + b_r2 x_f2)).
//
// Its bound is bytes (the rows and the table read once, [N, 3] written once),
// but at these sizes a launch is latency: one thread a vertex, each walking
// a handful of entries (a vertex lies in the faces of a few hit rows).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// IEEE-rounded operations (no contraction into an fma).
template <typename T> struct DynOp;
template <> struct DynOp<float> {
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
};
template <> struct DynOp<double> {
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
};

enum DynMode { DYN_CT = 0, DYN_DIAG = 1 };  // collision/constraints.py CT, DIAG

// The dynamic rows of one detection and their table by vertex.
template <typename T>
struct DynRows {
  const unsigned char* mask;  // [H] bool: the active rows
  const int64_t* vidx;        // [H] each row's own (query) vertex
  const int64_t* face;        // [H, 3] its face's vertices
  const T* barys;             // [H, 3]
  const T* normal;            // [H, 3]
  const T* ck;                // the constraint weight's square root, on the device
  const int64_t* order;       // [3H] corner ids by vertex (the table)
  const int64_t* start;       // [N + 1] each vertex's first entry
  const int* slot;            // [N] each vertex's row (-1: none), or null: row = vertex
  int h;                      // rows
};

template <typename T>
__device__ __forceinline__ T dyn_dot3(const T a[3], const T b[3]) {
  using O = DynOp<T>;
  return O::add(O::add(O::mul(a[0], b[0]), O::mul(a[1], b[1])), O::mul(a[2], b[2]));
}

// Row r's C x (r active): x read by load(vertex, out[3]).
template <typename T, typename Load>
__device__ __forceinline__ T dyn_row_value(const DynRows<T>& d, int r, T ck, const Load& load) {
  using O = DynOp<T>;
  T xv[3], xf[3][3], diff[3], nr[3];
  load(d.vidx[r], xv);
#pragma unroll
  for (int c = 0; c < 3; ++c) load(d.face[r * 3 + c], xf[c]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T fp = O::add(O::add(O::mul(d.barys[r * 3], xf[0][k]), O::mul(d.barys[r * 3 + 1], xf[1][k])),
                        O::mul(d.barys[r * 3 + 2], xf[2][k]));
    diff[k] = O::sub(xv[k], fp);
    nr[k] = d.normal[r * 3 + k];
  }
  return O::mul(ck, dyn_dot3(nr, diff));
}

// The C^T terms of vertex v's table entries, added to acc in table order;
// y(r) is row r's value.
template <typename T, typename Y>
__device__ __forceinline__ void dyn_corners_ct(const DynRows<T>& d, int64_t v, T ck, const Y& y,
                                               T acc[3]) {
  using O = DynOp<T>;
  const int64_t e1 = d.start[v + 1];
  for (int64_t e = d.start[v]; e < e1; ++e) {
    const int64_t id = d.order[e];
    const int64_t r = id / 3;
    const T t = O::mul(-O::mul(ck, y(r)), d.barys[id]);
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] = O::add(acc[k], O::mul(t, d.normal[r * 3 + k]));
  }
}

// The diag(C^T C) terms of vertex v's table entries, added to acc in order.
template <typename T>
__device__ __forceinline__ void dyn_corners_diag(const DynRows<T>& d, int64_t v, T ck, T acc[3]) {
  using O = DynOp<T>;
  const T ck2 = O::mul(ck, ck);
  const int64_t e1 = d.start[v + 1];
  for (int64_t e = d.start[v]; e < e1; ++e) {
    const int64_t id = d.order[e];
    const int64_t r = id / 3;
    const T b = d.barys[id];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T bn = O::mul(b, d.normal[r * 3 + k]);
      acc[k] = O::add(acc[k], O::mul(ck2, O::mul(bn, bn)));
    }
  }
}

// Vertex v's own row term of C^T y, (ck y_s) n_s, added to a +0 (the passive
// rows' term where no passive row is active): the dynamic-only C^T's start
// (kernels H and G); 0 where v is no query vertex.
template <typename T, typename Y>
__device__ __forceinline__ void dyn_own_ct(const DynRows<T>& d, int64_t v, T ck, const Y& y,
                                           T acc[3]) {
  using O = DynOp<T>;
  const int s = d.slot ? d.slot[v] : static_cast<int>(v);
  acc[0] = acc[1] = acc[2] = T(0);
  if (s < 0) return;
  const T yd = d.mask[s] ? y(s) : T(0);
  const T cy = O::mul(ck, yd);
#pragma unroll
  for (int k = 0; k < 3; ++k) acc[k] = O::add(T(0), O::mul(cy, d.normal[s * 3 + k]));
}

}  // namespace
