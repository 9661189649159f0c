"""Wrappers of kernel E (``csrc/tri_local_step.cu``): the fused cloth local
step, replacing ``pallas_kernels.local_step_tri_pallas``.

Two entries. ``local_step_tri`` takes D x as rows [6, T], as the TPU kernel
does. ``local_step_tri_stencil`` takes x and a regular sheet: each lane
computes its own D x (``csrc/stencil_body.cuh``) inside the local step's
launch, so the ADMM step runs no ``ops/stencil.tri_Dx_rows`` and keeps no D x
rows; it gives bit for bit what ``tri_Dx_rows`` followed by ``local_step_tri``
gives.

Dispatch is by the tensors' device: CPU tensors take the plain versions
(``ops/soa.local_step_tri_plain``, after ``tri_Dx_rows`` for the stencil
entry); CUDA tensors launch the kernel, and a build or launch failure raises.
``local_step_tri.launches`` and ``local_step_tri_stencil.launches`` count
kernel launches.

Scenes (scenario batching, ``parallel/batch.py``): no per-scene parameter
enters the cloth prox, so ``local_step_tri_over_scenes`` runs the rows entry
as it is on S scenes' rows [S, 6, T] laid out as S * T lanes, and
``local_step_tri_stencil_scenes`` is the stencil entry's scene form: S scenes
of one sheet in one launch, x [S, N, 3].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain


def local_step_tri(dix, u, limit_min, limit_max):
    """v = dix + u, z = prox_tri(v), u' = v - z on rows [6, T] -> (z, u')."""
    if dix.device.type == "cpu":
        return local_step_tri_plain(dix, u, limit_min, limit_max)
    n = dix.shape[1]
    sfx = _build.cuda_args("local_step_tri", dix, (
        ("dix", dix, (6, n)), ("u", u, (6, n)), ("limit_min", limit_min, (n,)),
        ("limit_max", limit_max, (n,))))
    fn = getattr(_build.library(), f"admm_tri_local_step_{sfx}")
    z = torch.empty_like(dix)
    uo = torch.empty_like(dix)
    with torch.cuda.device(dix.device):
        rc = fn(dix.data_ptr(), u.data_ptr(), limit_min.data_ptr(), limit_max.data_ptr(),
                z.data_ptr(), uo.data_ptr(), n,
                torch.cuda.current_stream(dix.device).cuda_stream)
    _build.check(rc, "local_step_tri")
    local_step_tri.launches += 1
    return z, uo


@functools.lru_cache(maxsize=64)
def tri_geom_of(meta):
    """(base, cells, slots, int[28] offs / pats for the kernel) of a sheet's
    stencil meta."""
    base, cells, offs, pats = stencil_mod._tri_geom(meta)
    flat = list(offs) + [v for row in pats for v in row]
    return base, cells, len(pats), (ctypes.c_int * 28)(*(flat + [0] * (28 - len(flat))))


def local_step_tri_stencil(x, u, b):
    """v = D x + u, z = prox_tri(v), u' = v - z for the regular sheet ``b``:
    x [N, 3], u rows [6, slots*cells] -> (z, u')."""
    base, cells, slots, geom = tri_geom_of(b.stencil)
    if base + cells > x.shape[0]:
        raise ValueError("local_step_tri_stencil: family vertex block lies outside x")
    if x.device.type == "cpu":
        return local_step_tri_plain(stencil_mod.tri_Dx_rows(x, b), u, b.limit_min, b.limit_max)
    n = slots * cells
    sfx = _build.cuda_args("local_step_tri_stencil", x, (
        ("x", x, (x.shape[0], 3)), ("st_dl", b.st_dl, (slots, 3, 2, cells)),
        ("st_dead", b.st_dead, (cells,)), ("u", u, (6, n)),
        ("limit_min", b.limit_min, (n,)), ("limit_max", b.limit_max, (n,))))
    fn = getattr(_build.library(), f"admm_tri_local_step_stencil_{sfx}")
    z = torch.empty_like(u)
    uo = torch.empty_like(u)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), b.st_dl.data_ptr(), b.st_dead.data_ptr(), u.data_ptr(),
                b.limit_min.data_ptr(), b.limit_max.data_ptr(), z.data_ptr(), uo.data_ptr(),
                base, cells, slots, geom, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "local_step_tri_stencil")
    local_step_tri_stencil.launches += 1
    return z, uo


def local_step_tri_over_scenes(dix, u, limit_min, limit_max, step=local_step_tri):
    """``step`` (the rows entry, or its plain version) on S scenes' rows
    dix, u [S, 6, T] with limits [T], as one call on the S * T lanes
    [6, S * T]. Returns (z, u') [S, 6, T]."""
    s_cnt, _, t = dix.shape

    def lanes(a):  # [S, 6, T] -> [6, S * T]
        return a.permute(1, 0, 2).reshape(6, s_cnt * t)

    z, uo = step(lanes(dix), lanes(u), limit_min.repeat(s_cnt), limit_max.repeat(s_cnt))
    return tuple(a.reshape(6, s_cnt, t).permute(1, 0, 2).contiguous() for a in (z, uo))


def local_step_tri_stencil_scenes(x, u, b):
    """The stencil entry over S scenes: x [S, N, 3], u [S, 6, slots*cells]."""
    base, cells, slots, geom = tri_geom_of(b.stencil)
    s_cnt, n_verts = x.shape[0], x.shape[1]
    if base + cells > n_verts:
        raise ValueError("local_step_tri_stencil_scenes: family vertex block lies outside x")
    if x.device.type == "cpu":
        dix = torch.stack([stencil_mod.tri_Dx_rows(xs, b) for xs in x])
        return local_step_tri_over_scenes(dix, u, b.limit_min, b.limit_max)
    n = slots * cells
    sfx = _build.cuda_args("local_step_tri_stencil_scenes", x, (
        ("x", x, (s_cnt, n_verts, 3)), ("st_dl", b.st_dl, (slots, 3, 2, cells)),
        ("st_dead", b.st_dead, (cells,)), ("u", u, (s_cnt, 6, n)),
        ("limit_min", b.limit_min, (n,)), ("limit_max", b.limit_max, (n,))))
    fn = getattr(_build.library(), f"admm_tri_local_step_stencil_scenes_{sfx}")
    z = torch.empty_like(u)
    uo = torch.empty_like(u)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), b.st_dl.data_ptr(), b.st_dead.data_ptr(), u.data_ptr(),
                b.limit_min.data_ptr(), b.limit_max.data_ptr(), z.data_ptr(), uo.data_ptr(),
                base, cells, slots, n_verts, s_cnt, geom,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "local_step_tri_stencil_scenes")
    local_step_tri_stencil_scenes.launches += 1
    return z, uo


local_step_tri.launches = 0
local_step_tri_stencil.launches = 0
local_step_tri_stencil_scenes.launches = 0
