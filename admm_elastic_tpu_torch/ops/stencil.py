"""Flat-stencil D / D^T for make_tet_blocks lattices: host plan and the
plain PyTorch versions of kernels B and C.

A port of the non-wrap tet part of ``admm_elastic_tpu/ops/stencil.py``
(:87-321). Elements of a lattice family are reordered slot-major over a
cell grid embedded at vertex pitch: element t = slot * cells + p, with
p = ci*Y*Z + cj*Z + ck. A cell's cube corner (di, dj, dk) is then the
vertex at the constant flat offset di*Y*Z + dj*Z + dk, so D x reads the
vertex stream at 8 fixed shifts, and D^T adds 8 shifted blocks.
Cells that do not exist (cj = ny, ck = nz, and the 128-cell pad kept so
that lanes compare one for one with the JAX package) are dead lanes:
weight, volume and Dlocal 0; D x injects an identity F there.

``tet_Dx_rows_plain`` and ``tet_rhs_rows_plain`` are the plain versions
that ``ops/cuda_stencil.py`` uses for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels to them.
"""

from __future__ import annotations

import dataclasses
from itertools import product
from typing import Optional, Tuple

import numpy as np
import torch

# meta: (base, X, Y, Z, pat_even, pat_odd, wrap), as in the JAX package.
StencilMeta = Tuple[int, int, int, int, tuple, tuple, bool]

_CORNERS = tuple(product((0, 1), (0, 1), (0, 1)))  # id = di*4 + dj*2 + dk


def _extract_pats(corner: np.ndarray, parity: np.ndarray, slot: np.ndarray):
    pats = []
    for p in (0, 1):
        sel = parity == p
        if not sel.any():
            return None
        pat = np.zeros((5, 4), np.int64)
        for s in range(5):
            rows = corner[sel & (slot == s)]
            if rows.shape[0] == 0:
                return None
            pat[s] = rows[0]
            if not (rows == rows[0]).all():
                return None
        pats.append(tuple(tuple(int(v) for v in r) for r in pat))
    return pats


def verify_lattice(inds: np.ndarray, dims: Tuple[int, int, int],
                   base: int = 0) -> Optional[StencilMeta]:
    """Check LOCAL inds [T,4] against a non-wrap (nx,ny,nz)-cell lattice and
    return its stencil meta, or None. Ring lattices (the JAX package's
    wrap=True) are not ported yet."""
    nx, ny, nz = dims
    X, Y, Z = nx + 1, ny + 1, nz + 1
    inds = np.asarray(inds)
    t = inds.shape[0]
    if t != nx * ny * nz * 5 or inds.shape[1] != 4:
        return None
    cell = np.arange(t) // 5
    slot = np.arange(t) % 5
    ci = cell // (ny * nz)
    cj = (cell // nz) % ny
    ck = cell % nz
    ii = inds // (Y * Z)
    jj = (inds // Z) % Y
    kk = inds % Z
    di = ii - ci[:, None]
    dj = jj - cj[:, None]
    dk = kk - ck[:, None]
    if not ((di >= 0) & (di <= 1) & (dj >= 0) & (dj <= 1)
            & (dk >= 0) & (dk <= 1)).all():
        return None
    corner = di * 4 + dj * 2 + dk  # [T, 4]
    parity = (ci + cj + ck) % 2
    pats = _extract_pats(corner, parity, slot)
    if pats is None:
        return None
    return (int(base), X, Y, Z, pats[0], pats[1], False)


@dataclasses.dataclass
class FlatPlan:
    """Host plan mapping a stencil family to its flat layout.

    src: i64 [T_cap], original element per flat lane, -1 on dead lanes.
    dead: bool [cells]; par: f64 [cells], 1.0 on even-parity cells.
    """

    src: np.ndarray
    dead: np.ndarray
    par: np.ndarray
    n_slots: int
    arity: int
    cols: int

    @property
    def t_cap(self) -> int:
        return self.src.shape[0]

    def take(self, a: np.ndarray, fill=0.0) -> np.ndarray:
        """Permute a per-element array into flat order, filling dead lanes."""
        a = np.asarray(a)
        out = np.full((self.t_cap,) + a.shape[1:], fill, dtype=a.dtype)
        live = self.src >= 0
        out[live] = a[self.src[live]]
        return out

    def dl_rows(self, Dlocal: np.ndarray) -> np.ndarray:
        """[T, arity, cols] -> [S, arity, cols, cells] lane-major fields."""
        d = self.take(np.asarray(Dlocal, np.float64))
        cells = self.t_cap // self.n_slots
        return np.ascontiguousarray(
            d.reshape(self.n_slots, cells, self.arity, self.cols)
            .transpose(0, 2, 3, 1))

    def spread_inds(self, inds: np.ndarray, n_local: int, base: int) -> np.ndarray:
        """Flat-order global inds; dead lanes cycle over the family's vertices."""
        arity = inds.shape[1]
        out = self.take(np.asarray(inds, np.int64) + base, fill=0)
        dead_rows = np.nonzero(self.src < 0)[0]
        if dead_rows.size:
            spread = (dead_rows[:, None] * arity
                      + np.arange(arity)[None, :]) % n_local + base
            out[dead_rows] = spread
        return out


def _pad128(n: int) -> int:
    """Round up to 128 cells: the JAX package's TPU lane width, kept so
    that z and u compare lane for lane between the two packages."""
    return -(-n // 128) * 128


def tet_flat_plan(meta: StencilMeta) -> FlatPlan:
    base, X, Y, Z, pe, po, wrap = meta
    if wrap:
        raise NotImplementedError(
            "wrap (ring) lattices are not ported yet (ROADMAP Queue 1 item 6)")
    nx = X - 1
    ny, nz = Y - 1, Z - 1
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(Y), np.arange(Z),
                             indexing="ij")
    live = (cj < ny) & (ck < nz)
    cells = nx * Y * Z
    cell_id = (ci * ny + cj) * nz + ck
    src_cell = np.where(live, cell_id, -1).reshape(-1)  # [cells]
    par = ((ci + cj + ck) % 2 == 0).astype(np.float64).reshape(-1)
    dead = ~live.reshape(-1)
    pad = _pad128(cells) - cells
    if pad:
        src_cell = np.concatenate([src_cell, np.full((pad,), -1, np.int64)])
        par = np.concatenate([par, np.zeros((pad,))])
        dead = np.concatenate([dead, np.ones((pad,), bool)])
        cells += pad
    src = np.empty((5 * cells,), np.int64)
    for s in range(5):
        src[s * cells:(s + 1) * cells] = np.where(src_cell >= 0, src_cell * 5 + s, -1)
    return FlatPlan(src=src, dead=dead, par=par, n_slots=5, arity=4, cols=3)


def _tet_geom(meta: StencilMeta):
    """(base, cells, n_vblock, offs, pe, po) of a non-wrap family."""
    base, X, Y, Z, pe, po, wrap = meta
    if wrap:
        raise NotImplementedError(
            "wrap (ring) lattices are not ported yet (ROADMAP Queue 1 item 6)")
    YZ = Y * Z
    cells = _pad128((X - 1) * YZ)
    n_vblock = X * YZ  # the family's vertex block
    offs = tuple(di * YZ + dj * Z + dk for (di, dj, dk) in _CORNERS)
    return base, cells, n_vblock, offs, pe, po


def tet_Dx_rows_plain(x: torch.Tensor, b) -> torch.Tensor:
    """Flat-stencil D x -> SoA rows [9, 5*cells] (plain version of kernel B).

    Corner reads past the family's vertex block read 0, like the JAX
    package's zero-padded stream; dead lanes get +1 on the diagonal rows.
    """
    base, cells, n_vblock, offs, pe, po = _tet_geom(b.stencil)
    maxd = max(offs)
    xT = x[base:base + n_vblock].T  # [3, verts]
    xp = torch.nn.functional.pad(xT, (0, cells + maxd - n_vblock))
    xc = [xp[:, d:d + cells] for d in offs]
    par = b.st_par
    inv = 1.0 - par
    dl = b.st_dl  # [5, 4, 3, cells]
    dead = b.st_dead
    xsel = [[(xc[pe[s][j]] if pe[s][j] == po[s][j]
              else par * xc[pe[s][j]] + inv * xc[po[s][j]])
             for j in range(4)] for s in range(5)]
    rows = []
    for r in range(3):
        for c in range(3):
            per_slot = [
                sum(xsel[s][j][r] * dl[s, j, c] for j in range(4))
                for s in range(5)
            ]
            if r == c:
                per_slot = [ps + dead for ps in per_slot]
            rows.append(torch.stack(per_slot, dim=0))  # [5, cells]
    return torch.stack(rows, dim=0).reshape(9, -1)


def tet_Dt_rows_plain(G_rows: torch.Tensor, b, n_verts: int) -> torch.Tensor:
    """Flat-stencil D^T G from SoA rows [9, 5*cells] -> [N, 3]."""
    base, cells, n_vblock, offs, pe, po = _tet_geom(b.stencil)
    maxd = max(offs)
    g = G_rows.reshape(3, 3, 5, cells)
    dl = b.st_dl
    par = b.st_par
    inv = 1.0 - par
    acc = [None] * 8
    for s in range(5):
        for j in range(4):
            contrib = torch.stack([
                sum(g[r, c, s] * dl[s, j, c] for c in range(3))
                for r in range(3)
            ], dim=0)  # [3, cells]
            he, ho = pe[s][j], po[s][j]
            if he == ho:
                acc[he] = contrib if acc[he] is None else acc[he] + contrib
            else:
                e = par * contrib
                o = inv * contrib
                acc[he] = e if acc[he] is None else acc[he] + e
                acc[ho] = o if acc[ho] is None else acc[ho] + o
    out = G_rows.new_zeros((3, cells + maxd))
    for cid, d in enumerate(offs):
        if acc[cid] is None:
            continue
        out = out + torch.nn.functional.pad(acc[cid], (d, maxd - d))
    outT = out[:, :n_vblock].T
    return torch.nn.functional.pad(outT, (0, 0, base, n_verts - base - n_vblock))


def tet_rhs_rows_plain(z: torch.Tensor, u: torch.Tensor, b, n_verts: int) -> torch.Tensor:
    """D^T W^2 (z - u) -> [N, 3] (plain version of kernel C)."""
    w2 = (b.weight * b.weight)[None, :]
    return tet_Dt_rows_plain(w2 * (z - u), b, n_verts)
