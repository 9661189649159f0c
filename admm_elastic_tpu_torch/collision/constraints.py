"""Fixed-capacity masked constraint buffers and matrix-free C applies.

A port of ``admm_elastic_tpu/collision/constraints.py`` (:26-185). The hit
buffers have one slot per surface vertex and a boolean mask, and C and C^T
are applied matrix-free from them (the reference builds a sparse C every
solve, src/ConstraintSet.hpp:59-116). Row conventions:

- passive row r:  ck n_r . x_{v_r}  =  ck n_r . p_r
- dynamic row r:  ck n_r . (x_{v_r} - sum_j barys_j x_{f_rj})  =  0

``dense`` (the surface is every vertex in order) makes every hit-row gather
and scatter the identity; otherwise the surface indices are unique, and each
scatter of a row's own vertex is a permutation (``index_copy``). A dynamic
row also adds into its face's three vertices, which other rows' faces share:
the JAX package's ``.at[d_face].add``, a scatter with duplicates. Here that sum
is a gather with no float atomics: ``with_table`` lists, per detection, the
active rows' face corners by vertex (CSR: a stable sort of the corners'
vertex ids, then ``searchsorted`` for each vertex's start, no host
synchronisation), and each vertex sums its entries in (row, corner) order, the
order in which ``.at[].add`` and ``index_add`` apply them, onto its own rows'
terms. ``dyn_gather`` does that sum: on CPU tensors the plain ordered loop
(``dyn_gather_plain``), on CUDA tensors kernel L (``ops/cuda_dynamic.py``,
``csrc/dyn_rows.cuh``), bit for bit the same. The applies below take the sum to
use as ``gather``: ``dyn_gather_plain`` gives their plain twins on any device,
which the card's checks hold the kernels to. Every dot and face point sums its
three terms in component order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Hits:
    """Per-surface-vertex hit slots. H = number of surface vertices."""

    p_mask: torch.Tensor  # bool [H]
    p_vidx: torch.Tensor  # i64 [H] global vertex index
    p_normal: torch.Tensor  # [H, 3]
    p_point: torch.Tensor  # [H, 3]
    d_mask: torch.Tensor  # bool [H]
    d_vidx: torch.Tensor  # i64 [H]
    d_face: torch.Tensor  # i64 [H, 3]
    d_barys: torch.Tensor  # [H, 3]
    d_normal: torch.Tensor  # [H, 3]
    overflow: torch.Tensor  # bool scalar: a fixed-capacity stage dropped a contact
    dense: bool = False  # static: the surface is every vertex in order
    may_dyn: bool = True  # static: dynamic colliders are registered
    # the active dynamic rows' face corners by vertex (with_table): the
    # corners' ids row * 3 + corner sorted by vertex [3H], and each vertex's
    # first entry [N + 1]; None until with_table, and after dedup
    d_order: Optional[torch.Tensor] = None
    d_start: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.p_mask.shape[0]

    def n_active(self):
        return (self.p_mask.sum() + self.d_mask.sum()).to(torch.int32)

    def dedup(self) -> "Hits":
        """Drop dynamic rows on vertices that already have a passive row (the
        table, if any, goes: with_table makes it anew)."""
        return dataclasses.replace(self, d_mask=self.d_mask & ~self.p_mask, d_order=None,
                                   d_start=None)


def empty_hits(surf_inds, dtype, dense: bool = False, may_dyn: bool = True) -> Hits:
    h = surf_inds.shape[0]
    dev = surf_inds.device
    z3 = torch.zeros((h, 3), dtype=dtype, device=dev)
    no = torch.zeros((h,), dtype=torch.bool, device=dev)
    return Hits(p_mask=no, p_vidx=surf_inds, p_normal=z3, p_point=z3, d_mask=no,
                d_vidx=surf_inds, d_face=torch.zeros((h, 3), dtype=torch.int64, device=dev),
                d_barys=z3, d_normal=z3,
                overflow=torch.zeros((), dtype=torch.bool, device=dev),
                dense=dense, may_dyn=may_dyn)


def _scatter(rows: torch.Tensor, vidx: torch.Tensor, n_verts: int) -> torch.Tensor:
    """rows [H, 3] placed at the unique vertex ids vidx of a zero [N, 3]."""
    out = torch.zeros((n_verts, 3), dtype=rows.dtype, device=rows.device)
    return out.index_copy(0, vidx, rows)


# --- the dynamic rows' face corners as a gather ---------------------------------

CT, DIAG = 0, 1  # what dyn_gather sums: C^T y, or diag(C^T C)


def with_table(hits: Hits, n_verts: int) -> Hits:
    """hits with the table of its active dynamic rows' face corners by
    vertex: d_order, the corner ids (row * 3 + corner) sorted stably by
    their vertex, an inactive row's after every vertex (key N); d_start [N +
    1], each vertex's first entry (searchsorted), d_start[N] the active
    corners' count. Device work only (no host synchronisation): a captured
    step builds it per detection. Without dynamic rows, hits unchanged."""
    if not hits.may_dyn:
        return hits
    keys = torch.where(hits.d_mask[:, None], hits.d_face, n_verts).reshape(-1)
    order = torch.argsort(keys, stable=True)
    start = torch.searchsorted(keys[order], torch.arange(n_verts + 1, device=keys.device))
    return dataclasses.replace(hits, d_order=order, d_start=start)


def corner_values(hits: Hits, mode: int, ck, yd=None):
    """Each row's three corners' terms [H, 3, 3]: C^T y's, -(ck yd_r)
    barys_rc n_r, or diag(C^T C)'s, ck^2 (barys_rc n_r)^2."""
    if mode == CT:
        return -(ck * yd)[..., None, None] * hits.d_barys[..., None] * hits.d_normal[..., None, :]
    return (ck * ck) * (hits.d_barys[..., None] * hits.d_normal[..., None, :]) ** 2


def gather_plain(order, start, vals, base):
    """base [N, 3] plus, per vertex, its entries of vals [3H, 3] (listed by
    order from start) added one at a time in table order: the plain version
    of kernel L's ordered sum."""
    counts = start[1:] - start[:-1]
    if vals.shape[0] == 0 or counts.numel() == 0:
        return base
    v = vals[order]
    first = start[:-1]
    acc = base
    for j in range(int(counts.max())):  # a host read: the plain version only
        idx = torch.clamp_max(first + j, v.shape[0] - 1)
        acc = torch.where((counts > j)[:, None], acc + v[idx], acc)
    return acc


def dyn_gather_plain(hits: Hits, base, mode: int, ck, yd=None):
    """base [N, 3] plus the dynamic rows' face-corner terms of mode (CT with
    the row values yd, or DIAG), each vertex's in table order (with_table,
    made here where hits have none), by the plain loop on any device: kernel
    L's twin."""
    if hits.d_order is None:
        hits = with_table(hits, base.shape[0])
    vals = corner_values(hits, mode, ck, yd).reshape(-1, 3)
    return gather_plain(hits.d_order, hits.d_start, vals, base)


def dyn_gather(hits: Hits, base, mode: int, ck, yd=None):
    """dyn_gather_plain's sum through kernel L's wrapper (its plain loop on
    CPU tensors)."""
    from admm_elastic_tpu_torch.ops import cuda_dynamic

    if hits.d_order is None:
        hits = with_table(hits, base.shape[0])
    return cuda_dynamic.dyn_gather(hits, base, mode, ck, yd)


def _dot3(a, b):
    """sum over the last axis of length 3, in component order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def C_apply(hits: Hits, ck, x):
    """C x -> ([H] passive rows, [H] dynamic rows); masked rows are 0."""
    xp = x if hits.dense else x[hits.p_vidx]
    rp = ck * _dot3(hits.p_normal, xp)
    rp = torch.where(hits.p_mask, rp, 0.0)
    if not hits.may_dyn:
        return rp, torch.zeros_like(rp)
    xv = x if hits.dense else x[hits.d_vidx]
    xf = x[hits.d_face]  # [H, 3, 3]
    b = hits.d_barys
    face_pt = ((b[:, 0, None] * xf[:, 0] + b[:, 1, None] * xf[:, 1])
               + b[:, 2, None] * xf[:, 2])
    rd = ck * _dot3(hits.d_normal, xv - face_pt)
    rd = torch.where(hits.d_mask, rd, 0.0)
    return rp, rd


def C_rhs(hits: Hits, ck):
    """c: passive rows ck n.p, dynamic rows 0 (src/ConstraintSet.hpp:84,96)."""
    cp = ck * _dot3(hits.p_normal, hits.p_point)
    cp = torch.where(hits.p_mask, cp, 0.0)
    return cp, torch.zeros_like(cp)


def Ct_apply(hits: Hits, ck, yp, yd, n_verts: int, gather=dyn_gather):
    """C^T [yp; yd] -> [N, 3]; gather sums the dynamic rows' face corners
    (dyn_gather, or dyn_gather_plain for the plain twin on any device)."""
    yp = torch.where(hits.p_mask, yp, 0.0)
    p_part = (ck * yp)[..., None] * hits.p_normal
    if not hits.may_dyn:
        return p_part if hits.dense else _scatter(p_part, hits.p_vidx, n_verts)
    yd = torch.where(hits.d_mask, yd, 0.0)
    own = p_part + (ck * yd)[..., None] * hits.d_normal
    base = own if hits.dense else _scatter(own, hits.p_vidx, n_verts)
    return gather(hits, base, CT, ck, yd)


def CtC_diag(hits: Hits, ck, n_verts: int, dtype, gather=dyn_gather):
    """diag(C^T C) per dof -> [N, 3] (the penalty diagonal); gather as in
    Ct_apply."""
    ck2 = ck * ck
    coef_p = torch.where(hits.p_mask[..., None], ck2 * hits.p_normal ** 2, 0.0).to(dtype)
    if not hits.may_dyn:
        return coef_p if hits.dense else _scatter(coef_p, hits.p_vidx, n_verts)
    own = coef_p + torch.where(hits.d_mask[..., None], ck2 * hits.d_normal ** 2, 0.0)
    base = own if hits.dense else _scatter(own, hits.p_vidx, n_verts)
    return gather(hits, base, DIAG, ck)


def Ct_dyn(hits: Hits, ck, yd, n_verts: int, gather=dyn_gather):
    """The dynamic rows' C^T yd -> [N, 3]: each row's own vertex term
    (ck yd) n, then its face corners' in table order (kernel G's DYN apply);
    gather as in Ct_apply."""
    yd = torch.where(hits.d_mask, yd, 0.0)
    own = (ck * yd)[..., None] * hits.d_normal
    base = own if hits.dense else _scatter(own, hits.d_vidx, n_verts)
    return gather(hits, base, CT, ck, yd)


def CtC_apply(hits: Hits, ck, x, gather=dyn_gather):
    """(C^T C) x -> [N, 3] (the matrix-free penalty apply)."""
    rp, rd = C_apply(hits, ck, x)
    return Ct_apply(hits, ck, rp, rd, x.shape[0], gather)


def Ct_c(hits: Hits, ck, n_verts: int, gather=dyn_gather):
    """C^T c -> [N, 3] (the rhs shift of the penalty fold)."""
    cp, cd = C_rhs(hits, ck)
    return Ct_apply(hits, ck, cp, cd, n_verts, gather)
