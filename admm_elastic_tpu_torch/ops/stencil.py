"""Flat-stencil D / D^T for make_tet_blocks lattices and regular cloth
sheets: host plans, the plain PyTorch versions of kernels B and C, and the
sheet's D x / D^T.

A port of the tet part (:87-321) and the triangle-sheet part (:324-487)
of ``admm_elastic_tpu/ops/stencil.py``. Elements of a lattice family are
reordered slot-major over a cell grid embedded at vertex pitch: element
t = slot * cells + p, with p = ci*Y*Z + cj*Z + ck. A cell's cube corner
(di, dj, dk) is then the vertex at the constant flat offset
di*Y*Z + dj*Z + dk, so D x reads the vertex stream at 8 fixed shifts, and
D^T adds 8 shifted blocks. Cells that do not exist (cj = ny, ck = nz, and
the 128-cell pad kept so that lanes compare one for one with the JAX
package) are dead lanes: weight, volume and Dlocal 0; D x injects an
identity F there.

A ring lattice (``make_tet_torus``, the meta's ``wrap``) has a periodic
first axis: X counts ring segments, cells and vertices alike, so cells =
n_vblock = X*Y*Z with no +1 slab and no 128-cell pad, and corner d of cell
p is vertex (p + d) mod cells. D x reads a wrap-extended stream; D^T folds
the tail past the last cell back onto the head.

``tet_Dx_rows_plain`` and ``tet_rhs_rows_plain`` are the plain versions
that ``ops/cuda_stencil.py`` uses for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels to them.

A sheet triangulates a vertex grid with a constant corner pattern per slot
(no parity). The JAX package computes its D x and D^T in jnp, outside any
Pallas kernel, so ``tri_Dx_rows`` and ``tri_Dt_rows`` are plain PyTorch on
every device: stacked slices, pads and adds in the jnp code's summation
order, no ``index_add_`` and no atomics, so D^T is bitwise repeatable.
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
                   base: int = 0, wrap: bool = False) -> Optional[StencilMeta]:
    """Check LOCAL inds [T,4] against an (nx,ny,nz)-cell lattice and return
    its stencil meta, or None. wrap=True verifies a ring lattice instead: the
    first axis is periodic, nx ring segments of cells and vertices, first-axis
    corner deltas taken modulo nx (nx must be even so that the parity
    pattern closes around the seam)."""
    nx, ny, nz = dims
    if wrap and nx % 2 != 0:
        return None
    X = nx if wrap else nx + 1
    Y, Z = ny + 1, nz + 1
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
    di = (ii - ci[:, None]) % nx if wrap else ii - ci[:, None]
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
    return (int(base), X, Y, Z, pats[0], pats[1], bool(wrap))


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
    nx = X if wrap else X - 1  # a ring lattice has no +1 slab on its wrap axis
    ny, nz = Y - 1, Z - 1
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(Y), np.arange(Z),
                             indexing="ij")
    live = (cj < ny) & (ck < nz)
    cells = nx * Y * Z
    cell_id = (ci * ny + cj) * nz + ck
    src_cell = np.where(live, cell_id, -1).reshape(-1)  # [cells]
    par = ((ci + cj + ck) % 2 == 0).astype(np.float64).reshape(-1)
    dead = ~live.reshape(-1)
    # A ring keeps its exact cell count: its (p + d) mod cells addressing
    # holds only there.
    pad = 0 if wrap else _pad128(cells) - cells
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
    """(base, cells, n_vblock, offs, pe, po) of a family; a ring's (meta[6])
    cells equal its n_vblock."""
    base, X, Y, Z, pe, po, wrap = meta
    YZ = Y * Z
    cells = X * YZ if wrap else _pad128((X - 1) * YZ)
    n_vblock = X * YZ  # the family's vertex block
    offs = tuple(di * YZ + dj * Z + dk for (di, dj, dk) in _CORNERS)
    return base, cells, n_vblock, offs, pe, po


def tet_Dx_rows_plain(x: torch.Tensor, b) -> torch.Tensor:
    """Flat-stencil D x -> SoA rows [9, 5*cells] (plain version of kernel B).

    Corner reads past the family's vertex block read 0, like the JAX
    package's zero-padded stream (a ring's wrap to the block's head); dead
    lanes get +1 on the diagonal rows.
    """
    base, cells, n_vblock, offs, pe, po = _tet_geom(b.stencil)
    maxd = max(offs)
    xT = x[base:base + n_vblock].T  # [3, verts]
    if b.stencil[6]:
        xp = torch.cat([xT, xT[:, :maxd]], dim=1)
    else:
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
    if b.stencil[6]:
        # out[(p + d) mod cells] += acc[p]: fold the tail back onto the head.
        head = out[:, :maxd] + out[:, cells:cells + maxd]
        outT = torch.cat([head, out[:, maxd:cells]], dim=1).T
    else:
        outT = out[:, :n_vblock].T
    return torch.nn.functional.pad(outT, (0, 0, base, n_verts - base - n_vblock))


def tet_rhs_rows_plain(z: torch.Tensor, u: torch.Tensor, b, n_verts: int) -> torch.Tensor:
    """D^T W^2 (z - u) -> [N, 3] (plain version of kernel C)."""
    w2 = (b.weight * b.weight)[None, :]
    return tet_Dt_rows_plain(w2 * (z - u), b, n_verts)


# ---------------------------------------------------------------------------
# Triangle sheet stencil (cloth grids)
# ---------------------------------------------------------------------------
#
# The grid is detected with no factory hint: the fast-axis pitch G1 is
# inferred from the first triangles' index differences and every candidate is
# verified against all T index rows, so a false positive is impossible (the
# checks are the addressing equivalence).

# meta: (base, G0, G1, pats): vertex grid [G0, G1] with vid = slow * G1 + fast;
# pats an S x 3 tuple of corner ids ds * 2 + df in (slow, fast) axes. The flat
# layout embeds cells at vertex pitch p = cs * G1 + cf whatever the original
# enumeration order.
TriStencilMeta = Tuple[int, int, int, tuple]

_CORNERS2 = ((0, 0), (0, 1), (1, 0), (1, 1))  # (ds, df), id = ds*2 + df


def _check_tri_grid(inds: np.ndarray, v: int, g1: int, base: int):
    g0 = v // g1
    if g0 < 2 or g1 < 2:
        return None
    slow, fast = inds // g1, inds % g1
    cs, cf = slow.min(axis=1), fast.min(axis=1)
    ds, df = slow - cs[:, None], fast - cf[:, None]
    if not ((ds >= 0) & (ds <= 1) & (df >= 0) & (df <= 1)).all():
        return None
    n_s, n_f = g0 - 1, g1 - 1
    t = inds.shape[0]
    if t % (n_s * n_f):
        return None
    s_cnt = t // (n_s * n_f)
    if not 1 <= s_cnt <= 8:
        return None
    cell = np.arange(t) // s_cnt
    slot = np.arange(t) % s_cnt
    if (cs == cell // n_f).all() and (cf == cell % n_f).all():
        pass  # slow-major enumeration
    elif (cf == cell // n_s).all() and (cs == cell % n_s).all():
        pass  # fast-major enumeration
    else:
        return None
    corner = ds * 2 + df  # [T, 3] in (slow, fast) axes
    pats = []
    for s in range(s_cnt):
        rows = corner[slot == s]
        if rows.shape[0] == 0 or not (rows == rows[0]).all():
            return None
        pats.append(tuple(int(x) for x in rows[0]))
    return (int(base), g0, g1, tuple(pats))


def verify_tri_grid(inds: np.ndarray, base: int = 0,
                    n_local_verts: Optional[int] = None) -> Optional[TriStencilMeta]:
    """Detect a regular-sheet triangulation from LOCAL inds [T, 3] alone.

    Tries the fast-axis pitches implied by the first triangles' index
    differences (the grid pitch or its +-1 neighbours show up there in every
    standard sheet triangulation) and fully verifies each candidate; returns
    the meta or None."""
    inds = np.asarray(inds)
    if inds.ndim != 2 or inds.shape[1] != 3 or inds.shape[0] < 2:
        return None
    v = int(n_local_verts if n_local_verts is not None else inds.max() + 1)
    head = inds[: min(4, inds.shape[0])]
    diffs = np.abs(head[:, :, None] - head[:, None, :]).reshape(-1)
    cands = set()
    for d in diffs[diffs > 0]:
        for g in (int(d) - 1, int(d), int(d) + 1):
            if 2 <= g <= v // 2 and v % g == 0:
                cands.add(g)
    for g1 in sorted(cands):
        meta = _check_tri_grid(inds, v, g1, base)
        if meta is not None:
            return meta
    return None


def tri_flat_plan(inds: np.ndarray, meta: TriStencilMeta) -> FlatPlan:
    """Flat plan for a sheet: slot-major over cells at vertex pitch G1.

    The original element order (slow- or fast-major cell enumeration) is
    recovered from the index array itself, so src is exact either way.
    """
    base, g0, g1, pats = meta
    s_cnt = len(pats)
    n_s, n_f = g0 - 1, g1 - 1
    inds = np.asarray(inds)
    slow, fast = inds // g1, inds % g1
    cs, cf = slow.min(axis=1), fast.min(axis=1)
    # Original element t sits at embedded cell p and slot t % s_cnt.
    p_orig = cs * g1 + cf  # [T]
    slot_orig = np.arange(inds.shape[0]) % s_cnt
    cells = g0 * g1
    src = np.full((s_cnt * cells,), -1, np.int64)
    src[slot_orig * cells + p_orig] = np.arange(inds.shape[0])
    a, bb = np.meshgrid(np.arange(g0), np.arange(g1), indexing="ij")
    live = (a < n_s) & (bb < n_f)
    return FlatPlan(src=src, dead=~live.reshape(-1),
                    par=np.ones((cells,), np.float64),
                    n_slots=s_cnt, arity=3, cols=2)


def _tri_geom(meta: TriStencilMeta):
    base, g0, g1, pats = meta
    cells = g0 * g1
    offs = tuple(ds * g1 + df for (ds, df) in _CORNERS2)
    return base, cells, offs, pats


def tri_Dx_rows(x: torch.Tensor, b) -> torch.Tensor:
    """Flat-stencil D x for a sheet -> SoA rows [6, T_cap].

    Dead lanes receive the identity 3x2 F (rows 0 and 3 = 1). One stacked
    product over (slot, corner, row, column), then the corner sum in the jnp
    code's order ((j0 + j1) + j2)."""
    base, cells, offs, pats = _tri_geom(b.stencil)
    s_cnt = len(pats)
    maxd = max(offs)
    xT = x[base:base + cells].T  # [3, cells]
    xp = torch.nn.functional.pad(xT, (0, maxd))
    xc = [xp[:, d:d + cells] for d in offs]
    xsel = torch.stack([xc[pats[s][j]] for s in range(s_cnt) for j in range(3)],
                       dim=0).reshape(s_cnt, 3, 3, 1, cells)  # [S, j, r, 1, cells]
    terms = xsel * b.st_dl[:, :, None, :, :]  # [S, j, r, c, cells]
    per_slot = terms[:, 0] + terms[:, 1] + terms[:, 2]  # [S, r, c, cells]
    rows = per_slot.permute(1, 2, 0, 3).contiguous()  # [r, c, S, cells]
    rows[0, 0] += b.st_dead
    rows[1, 1] += b.st_dead
    return rows.reshape(6, -1)


def tri_Dt_rows(G_rows: torch.Tensor, b, n_verts: int) -> torch.Tensor:
    """Flat-stencil D^T G from SoA rows [6, T_cap] -> [N, 3], or over a
    leading scene axis [S, 6, T_cap] -> [S, N, 3] (scenario batches: the
    same ops on every scene at once, so each scene's sum is the one it has
    alone).

    The jnp code's order: per (slot, corner) the column sum (c0 + c1), the
    corner accumulators filled slot by slot and corner by corner, then the
    four shifted blocks added in `offs` order. Pads and adds only."""
    base, cells, offs, pats = _tri_geom(b.stencil)
    n_slots = len(pats)
    maxd = max(offs)
    lead = G_rows.shape[:-2]
    # [..., slot, r, c, cells]
    g = G_rows.reshape(lead + (3, 2, n_slots, cells)).movedim(-2, -4)
    terms = g.unsqueeze(-4) * b.st_dl[:, :, None, :, :]  # [..., slot, j, r, c, cells]
    contrib = terms[..., 0, :] + terms[..., 1, :]  # [..., slot, j, r, cells]
    acc = [None] * 4
    for s in range(n_slots):
        for j in range(3):
            cid = pats[s][j]
            c = contrib[..., s, j, :, :]
            acc[cid] = c if acc[cid] is None else acc[cid] + c
    out = None
    for cid, d in enumerate(offs):
        if acc[cid] is None:
            continue
        blk = torch.nn.functional.pad(acc[cid], (d, maxd - d))
        out = blk if out is None else out + blk
    outT = out[..., :cells].transpose(-1, -2)
    if base == 0 and cells == n_verts:
        return outT
    return torch.nn.functional.pad(outT, (0, 0, base, n_verts - base - cells))
