"""Fixed-capacity masked constraint buffers and matrix-free C applies.

A port of ``admm_elastic_tpu/collision/constraints.py`` (:26-185). The hit
buffers have one slot per surface vertex and a boolean mask, and C and C^T
are applied matrix-free from them (the reference builds a sparse C every
solve, src/ConstraintSet.hpp:59-116). Row conventions:

- passive row r:  ck n_r . x_{v_r}  =  ck n_r . p_r
- dynamic row r:  ck n_r . (x_{v_r} - sum_j barys_j x_{f_rj})  =  0

``dense`` (the surface is every vertex in order) makes every hit-row gather
and scatter the identity. Without dynamic rows (``may_dyn`` False, the only
case a solver runs here: colliders are not ported yet) the surface indices
are unique, so each scatter is a permutation and is written as
``index_copy``. The dynamic-row terms are plain PyTorch for the CPU: their
``d_face`` scatter adds duplicates with ``index_add_``, which on the card
would need float atomics; a tensor on the card raises there (ROADMAP Queue 1
item 10 turns it into a gather first).
"""

from __future__ import annotations

import dataclasses

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

    @property
    def capacity(self) -> int:
        return self.p_mask.shape[0]

    def n_active(self):
        return (self.p_mask.sum() + self.d_mask.sum()).to(torch.int32)

    def dedup(self) -> "Hits":
        """Drop dynamic rows on vertices that already have a passive row."""
        return dataclasses.replace(self, d_mask=self.d_mask & ~self.p_mask)


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


def _dyn_on_cpu(hits: Hits) -> None:
    if hits.p_normal.device.type != "cpu":
        raise NotImplementedError(
            "dynamic constraint rows run on the CPU only: their d_face scatter needs a "
            "gather form first (ROADMAP Queue 1 item 10)")


def _scatter(rows: torch.Tensor, vidx: torch.Tensor, n_verts: int) -> torch.Tensor:
    """rows [H, 3] placed at the unique vertex ids vidx of a zero [N, 3]."""
    out = torch.zeros((n_verts, 3), dtype=rows.dtype, device=rows.device)
    return out.index_copy(0, vidx, rows)


def _dot3(a, b):
    """sum over the last axis of length 3, in component order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def C_apply(hits: Hits, ck, x):
    """C x -> ([H] passive rows, [H] dynamic rows); masked rows are 0."""
    if hits.may_dyn:
        _dyn_on_cpu(hits)
    xp = x if hits.dense else x[hits.p_vidx]
    rp = ck * _dot3(hits.p_normal, xp)
    rp = torch.where(hits.p_mask, rp, 0.0)
    if not hits.may_dyn:
        return rp, torch.zeros_like(rp)
    xv = x if hits.dense else x[hits.d_vidx]
    xf = x[hits.d_face]  # [H, 3, 3]
    face_pt = torch.sum(hits.d_barys[..., None] * xf, dim=-2)
    rd = ck * _dot3(hits.d_normal, xv - face_pt)
    rd = torch.where(hits.d_mask, rd, 0.0)
    return rp, rd


def C_rhs(hits: Hits, ck):
    """c: passive rows ck n.p, dynamic rows 0 (src/ConstraintSet.hpp:84,96)."""
    cp = ck * _dot3(hits.p_normal, hits.p_point)
    cp = torch.where(hits.p_mask, cp, 0.0)
    return cp, torch.zeros_like(cp)


def Ct_apply(hits: Hits, ck, yp, yd, n_verts: int):
    """C^T [yp; yd] -> [N, 3]."""
    if hits.may_dyn:
        _dyn_on_cpu(hits)
    yp = torch.where(hits.p_mask, yp, 0.0)
    p_part = (ck * yp)[..., None] * hits.p_normal
    if not hits.may_dyn:
        return p_part if hits.dense else _scatter(p_part, hits.p_vidx, n_verts)
    yd = torch.where(hits.d_mask, yd, 0.0)
    d_part = (ck * yd)[..., None] * hits.d_normal
    if hits.dense:
        out = p_part + d_part
    else:
        out = torch.zeros((n_verts, 3), dtype=hits.p_normal.dtype)
        out = out.index_add(0, hits.p_vidx, p_part).index_add(0, hits.d_vidx, d_part)
    contrib_f = -(ck * yd)[..., None, None] * hits.d_barys[..., None] * hits.d_normal[..., None, :]
    return out.index_add(0, hits.d_face.reshape(-1), contrib_f.reshape(-1, 3))


def CtC_diag(hits: Hits, ck, n_verts: int, dtype):
    """diag(C^T C) per dof -> [N, 3] (the penalty diagonal)."""
    if hits.may_dyn:
        _dyn_on_cpu(hits)
    ck2 = ck * ck
    coef_p = torch.where(hits.p_mask[..., None], ck2 * hits.p_normal ** 2, 0.0)
    out = coef_p.to(dtype) if hits.dense else _scatter(coef_p.to(dtype), hits.p_vidx, n_verts)
    if not hits.may_dyn:
        return out
    coef_v = torch.where(hits.d_mask[..., None], ck2 * hits.d_normal ** 2, 0.0)
    out = out + coef_v if hits.dense else out.index_add(0, hits.d_vidx, coef_v)
    coef_f = torch.where(hits.d_mask[..., None, None],
                         ck2 * (hits.d_barys[..., None] * hits.d_normal[..., None, :]) ** 2, 0.0)
    return out.index_add(0, hits.d_face.reshape(-1), coef_f.reshape(-1, 3))


def CtC_apply(hits: Hits, ck, x):
    """(C^T C) x -> [N, 3] (the matrix-free penalty apply)."""
    rp, rd = C_apply(hits, ck, x)
    return Ct_apply(hits, ck, rp, rd, x.shape[0])


def Ct_c(hits: Hits, ck, n_verts: int):
    """C^T c -> [N, 3] (the rhs shift of the penalty fold)."""
    cp, cd = C_rhs(hits, ck)
    return Ct_apply(hits, ck, cp, cd, n_verts)
