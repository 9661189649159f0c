"""Wrappers of kernels B and C (``csrc/stencil.cu``): flat-stencil D x and
D^T W^2 (z - u), replacing ``pallas_stencil.tet_Dx_rows`` and
``pallas_stencil.tet_rhs_rows``.

Dispatch is by the tensors' device: CPU tensors take the plain versions in
``ops/stencil.py``; CUDA tensors launch the kernels, and a build or launch
failure raises. ``tet_Dx_rows.launches`` and ``tet_rhs_rows.launches``
count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops import stencil as stencil_mod


@functools.lru_cache(maxsize=64)
def _geom(meta):
    """(base, cells, n_vblock, int[48] offs/pe/po) of a stencil meta."""
    base, cells, n_vblock, offs, pe, po = stencil_mod._tet_geom(meta)
    flat = list(offs) + [v for row in pe for v in row] + [v for row in po for v in row]
    return base, cells, n_vblock, (ctypes.c_int * 48)(*flat)


def _cuda_args(name, lead, fields):
    if lead.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lead.device}")
    if lead.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {lead.dtype}")
    for fname, t, shape in fields:
        if t.device != lead.device or t.dtype != lead.dtype:
            raise ValueError(f"{name}: {fname} is {t.device}/{t.dtype}, "
                             f"expected {lead.device}/{lead.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {fname} has shape {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()}), expected {shape}")
    return "f32" if lead.dtype == torch.float32 else "f64"


def tet_Dx_rows(x: torch.Tensor, b) -> torch.Tensor:
    """D x for one stencil tet family: x [N, 3] -> rows [9, 5*cells]."""
    if x.device.type == "cpu":
        return stencil_mod.tet_Dx_rows_plain(x, b)
    base, cells, n_vblock, geom = _geom(b.stencil)
    sfx = _cuda_args("tet_Dx_rows", x, (
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


def tet_rhs_rows(z: torch.Tensor, u: torch.Tensor, b, n_verts: int) -> torch.Tensor:
    """D^T W^2 (z - u) for one stencil tet family -> [N, 3], zero outside
    the family's vertex block."""
    if z.device.type == "cpu":
        return stencil_mod.tet_rhs_rows_plain(z, u, b, n_verts)
    base, cells, n_vblock, geom = _geom(b.stencil)
    t = 5 * cells
    sfx = _cuda_args("tet_rhs_rows", z, (
        ("z", z, (9, t)), ("u", u, (9, t)), ("weight", b.weight, (t,)),
        ("st_dl", b.st_dl, (5, 4, 3, cells)), ("st_par", b.st_par, (cells,))))
    if base + n_vblock > n_verts:
        raise ValueError("tet_rhs_rows: family vertex block lies outside n_verts")
    out = z.new_empty((n_verts, 3))
    fn = getattr(_build.library(), f"admm_tet_rhs_{sfx}")
    with torch.cuda.device(z.device):
        rc = fn(z.data_ptr(), u.data_ptr(), b.weight.data_ptr(), b.st_dl.data_ptr(),
                b.st_par.data_ptr(), out.data_ptr(), n_verts, base, n_vblock, cells, geom,
                torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "tet_rhs_rows")
    tet_rhs_rows.launches += 1
    return out


tet_Dx_rows.launches = 0
tet_rhs_rows.launches = 0
