"""Wrappers of kernels B and C (``csrc/stencil.cu``): flat-stencil D x and
D^T W^2 (z - u), replacing ``pallas_stencil.tet_Dx_rows`` and
``pallas_stencil.tet_rhs_rows``.

Dispatch is by the tensors' device: CPU tensors take the plain versions in
``ops/stencil.py``; CUDA tensors launch the kernels, and a build or launch
failure raises. ``tet_Dx_rows.launches`` and ``tet_rhs_rows.launches``
count kernel launches.

Kernel C has two branches (see the header of ``csrc/stencil.cu``): "tiled",
a block per tile of ``RHS_TILE`` vertices with the contributions of the cells
that feed it staged in shared memory, and "wide", a thread per vertex reading
global memory, for cross-sections whose halo does not fit. ``rhs_plan``
chooses between them from the shapes alone.

``tet_rhs_rows_scenes`` is C's scene form (scenario batching,
``parallel/batch.py``): S scenes of one lattice in one launch, z and u
[S, 9, T], each scene's weight w sqrt(s) (sq [S] the square roots of the
scales), bit for bit the single-scene kernel on that scene's scaled weights.
Its plain version runs ``tet_rhs_rows_plain`` scene by scene.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops import stencil as stencil_mod

RHS_TILE = 32  # vertices per block of the tiled branch (at most 256; a multiple of 32)
# Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
MAX_SHARED_BYTES = 232448
BOTH, EVEN, ODD = 0, 1, 2  # enum MatchKind of csrc/stencil.cu


def rhs_match_table(pe, po):
    """Per corner id 0..7, the (slot * 4 + corner, kind) pairs that feed it,
    in slot-major order: BOTH where the pair's corner id is the same on even
    and odd cells, else EVEN under its even-cell id and ODD under its
    odd-cell id."""
    table = [[] for _ in range(8)]
    for s in range(5):
        for j in range(4):
            he, ho = pe[s][j], po[s][j]
            if he == ho:
                table[he].append((s * 4 + j, BOTH))
            else:
                table[he].append((s * 4 + j, EVEN))
                table[ho].append((s * 4 + j, ODD))
    return table


def rhs_plan(halo: int, itemsize: int, branch: str | None = None, tile: int | None = None):
    """(branch, tile, shared bytes) of kernel C for a family whose largest
    corner offset is ``halo``: "tiled" where 61 rows (60 of contributions, one
    of parities) of tile + halo cell columns and the tile's 8 x 3 partial sums
    fit in a block's shared memory, else "wide" (tile 0, no shared memory).
    ``branch`` forces one of them; "tiled" raises where it does not fit."""
    tile = RHS_TILE if tile is None else int(tile)
    if not 1 <= tile <= 256:
        raise ValueError(f"tet_rhs_rows: tile {tile} outside 1..256")
    if branch not in (None, "tiled", "wide"):
        raise ValueError(f"tet_rhs_rows: unknown branch {branch!r}")
    n_bytes = (61 * (tile + halo) + 24 * tile) * itemsize
    fits = n_bytes <= MAX_SHARED_BYTES
    if branch == "tiled" and not fits:
        raise ValueError(f"tet_rhs_rows: the tiled branch needs {n_bytes} B of shared memory "
                         f"(tile {tile}, halo {halo}), a block has {MAX_SHARED_BYTES}")
    if branch == "wide" or not fits:
        return "wide", 0, 0
    return "tiled", tile, n_bytes


def rhs_plan_of(b, itemsize: int, branch: str | None = None, tile: int | None = None):
    """rhs_plan for the stencil tet family ``b``."""
    return rhs_plan(geom_of(b.stencil)[3], itemsize, branch, tile)


@functools.lru_cache(maxsize=64)
def geom_of(meta):
    """(base, cells, n_vblock, halo, int[49] offs/pe/po/wrap for B and A's
    stencil entry, int[58] offs/start/ent/wrap for C) of a stencil meta."""
    base, cells, n_vblock, offs, pe, po = stencil_mod._tet_geom(meta)
    wrap = int(bool(meta[6]))
    flat = (list(offs) + [v for row in pe for v in row] + [v for row in po for v in row]
            + [wrap])
    table = rhs_match_table(pe, po)
    start = [0]
    for row in table:
        start.append(start[-1] + len(row))
    ent = [sj | kind << 8 for row in table for sj, kind in row]
    match = list(offs) + start + ent + [0] * (40 - len(ent)) + [wrap]
    return (base, cells, n_vblock, max(offs), (ctypes.c_int * 49)(*flat),
            (ctypes.c_int * 58)(*match))


def tet_Dx_rows(x: torch.Tensor, b) -> torch.Tensor:
    """D x for one stencil tet family: x [N, 3] -> rows [9, 5*cells]."""
    if x.device.type == "cpu":
        return stencil_mod.tet_Dx_rows_plain(x, b)
    base, cells, n_vblock, _, geom, _ = geom_of(b.stencil)
    sfx = _build.cuda_args("tet_Dx_rows", x, (
        ("x", x, (x.shape[0], 3)), ("st_dl", b.st_dl, (5, 4, 3, cells)),
        ("st_par", b.st_par, (cells,)), ("st_dead", b.st_dead, (cells,))))
    if base + n_vblock > x.shape[0]:
        raise ValueError("tet_Dx_rows: family vertex block lies outside x")
    out = x.new_empty((9, 5 * cells))
    fn = getattr(_build.library(), f"admm_tet_dx_{sfx}")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), b.st_dl.data_ptr(), b.st_par.data_ptr(), b.st_dead.data_ptr(),
                out.data_ptr(), base, n_vblock, cells, geom,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "tet_Dx_rows")
    tet_Dx_rows.launches += 1
    return out


def tet_rhs_rows(z: torch.Tensor, u: torch.Tensor, b, n_verts: int,
                 branch: str | None = None, tile: int | None = None) -> torch.Tensor:
    """D^T W^2 (z - u) for one stencil tet family -> [N, 3], zero outside
    the family's vertex block. ``branch`` ("tiled" or "wide") and ``tile``
    override ``rhs_plan``'s choice, for tests and timing; the two branches
    give bitwise the same result."""
    base, cells, n_vblock, halo, _, match = geom_of(b.stencil)
    _, tile, _ = rhs_plan_of(b, z.element_size(), branch, tile)
    if z.device.type == "cpu":
        return stencil_mod.tet_rhs_rows_plain(z, u, b, n_verts)
    t = 5 * cells
    sfx = _build.cuda_args("tet_rhs_rows", z, (
        ("z", z, (9, t)), ("u", u, (9, t)), ("weight", b.weight, (t,)),
        ("st_dl", b.st_dl, (5, 4, 3, cells)), ("st_par", b.st_par, (cells,))))
    if base + n_vblock > n_verts:
        raise ValueError("tet_rhs_rows: family vertex block lies outside n_verts")
    out = z.new_empty((n_verts, 3))
    fn = getattr(_build.library(), f"admm_tet_rhs_{sfx}")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), u.data_ptr(), b.weight.data_ptr(), b.st_dl.data_ptr(),
                b.st_par.data_ptr(), out.data_ptr(), n_verts, base, n_vblock, cells, match,
                tile, halo, torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "tet_rhs_rows")
    tet_rhs_rows.launches += 1
    return out


def tet_rhs_rows_scenes(z: torch.Tensor, u: torch.Tensor, b, n_verts: int, sq: torch.Tensor,
                        branch: str | None = None, tile: int | None = None) -> torch.Tensor:
    """D^T W^2 (z - u) of S scenes, W = w sqrt(s): z, u [S, 9, 5*cells], sq
    [S] -> [S, N, 3]."""
    import dataclasses

    base, cells, n_vblock, halo, _, match = geom_of(b.stencil)
    _, tile, _ = rhs_plan_of(b, z.element_size(), branch, tile)
    s_cnt = z.shape[0]
    if z.device.type == "cpu":
        return torch.stack([
            stencil_mod.tet_rhs_rows_plain(z[i], u[i], dataclasses.replace(
                b, weight=b.weight * sq[i]), n_verts) for i in range(s_cnt)])
    t = 5 * cells
    sfx = _build.cuda_args("tet_rhs_rows_scenes", z, (
        ("z", z, (s_cnt, 9, t)), ("u", u, (s_cnt, 9, t)), ("weight", b.weight, (t,)),
        ("sq", sq, (s_cnt,)), ("st_dl", b.st_dl, (5, 4, 3, cells)),
        ("st_par", b.st_par, (cells,))))
    if base + n_vblock > n_verts:
        raise ValueError("tet_rhs_rows_scenes: family vertex block lies outside n_verts")
    out = z.new_empty((s_cnt, n_verts, 3))
    fn = getattr(_build.library(), f"admm_tet_rhs_scenes_{sfx}")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), u.data_ptr(), b.weight.data_ptr(), sq.data_ptr(),
                b.st_dl.data_ptr(), b.st_par.data_ptr(), out.data_ptr(), n_verts, base, n_vblock,
                cells, s_cnt, match, tile, halo, torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "tet_rhs_rows_scenes")
    tet_rhs_rows_scenes.launches += 1
    return out


def empty_launch(device) -> None:
    """Launch the kernel that does nothing, through the same route as the
    others: its device time is the floor under any launch on the card."""
    with torch.cuda.device(device):
        rc = _build.library().admm_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    _build.check(rc, "empty_launch")


tet_Dx_rows.launches = 0
tet_rhs_rows.launches = 0
tet_rhs_rows_scenes.launches = 0
