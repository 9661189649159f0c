"""Wrappers of kernel A (``csrc/local_step.cu``): the fused tet local step for
each of the six tet models, replacing
``pallas_kernels.local_step_tet_hyper_pallas`` (and, for the linear model,
the fused jnp path the JAX package leaves to XLA).

Two entries. ``local_step_tet_hyper`` takes D x as rows [9, T], as the TPU
kernel does. ``local_step_tet_stencil`` takes x and a lattice family: each
lane computes its own D x (kernel B's per-lane body, ``csrc/stencil_body.cuh``)
inside the local step's launch, so the ADMM step launches no D x kernel and
keeps no D x rows; it gives bit for bit what ``cuda_stencil.tet_Dx_rows``
followed by ``local_step_tet_hyper`` gives.

Dispatch is by the tensors' device: CPU tensors take the plain versions
(``ops/hyper_soa.local_step_plain``, after ``ops/stencil.tet_Dx_rows_plain``
for the stencil entry); CUDA tensors launch the kernel, and a build or launch
failure raises. ``local_step_tet_hyper.launches`` and
``local_step_tet_stencil.launches`` count kernel launches.

Scene forms (scenario batching, ``parallel/batch.py``):
``local_step_tet_hyper_scenes`` and ``local_step_tet_stencil_scenes`` run S
scenes of one family in one launch, rows [S, 9, T] (x [S, N, 3]), each scene on
its material scaled by its stiffness scale (scale [S], formed in the kernel as
``hyper_soa.scaled_params`` forms it), bit for bit the single-scene entry on
that scene's scaled parameters. Their plain versions are
``hyper_soa.local_step_scenes_plain`` (after ``tet_Dx_rows_plain`` per scene
for the stencil entry); their counts ``.launches``.

A hyperelastic lane is solved by one thread, which leaves the Newton loop
and the line search as soon as the result is fixed (``csrc/prox_body.cuh``):
bit for bit the plain version's result, in fewer trips.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import _build, cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, local_step_scenes_plain
from admm_elastic_tpu_torch.ops.prox import (TET_LINEAR, TET_NEOHOOKEAN, TET_SPLINE_COROT,
                                             TET_SPLINE_NH, TET_SPLINE_STVK, TET_STVK,
                                             check_model)

SWEEPS = 8  # Jacobi sweeps of the signed SVD (pallas_kernels.py:238-239)

# The Model enum of csrc/prox_body.cuh.
MODEL_IDS = {TET_NEOHOOKEAN: 0, TET_STVK: 1, TET_SPLINE_NH: 2, TET_SPLINE_STVK: 3,
             TET_SPLINE_COROT: 4, TET_LINEAR: 5}


def local_step_tet_hyper(dix, u, mu, lam, kappa, k, n_iters: int = 8,
                         model: str = TET_NEOHOOKEAN):
    """v = dix + u, z = prox_model(v), u' = v - z on rows [9, T] -> (z, u')."""
    check_model(model)
    if dix.device.type == "cpu":
        return local_step_plain(dix, u, mu, lam, kappa, k, n_iters=n_iters, model=model)
    n = dix.shape[1]
    sfx = _build.cuda_args("local_step_tet_hyper", dix, (
        ("dix", dix, (9, n)), ("u", u, (9, n)), ("mu", mu, (n,)), ("lam", lam, (n,)),
        ("kappa", kappa, (n,)), ("k", k, (n,))))
    fn = getattr(_build.library(), f"admm_local_step_{sfx}")
    z = torch.empty_like(dix)
    uo = torch.empty_like(dix)
    with torch.cuda.device(dix.device):
        rc = fn(dix.data_ptr(), u.data_ptr(), mu.data_ptr(), lam.data_ptr(),
                kappa.data_ptr(), k.data_ptr(), z.data_ptr(), uo.data_ptr(),
                n, MODEL_IDS[model], int(n_iters), SWEEPS,
                torch.cuda.current_stream(dix.device).cuda_stream)
    _build.check(rc, "local_step_tet_hyper")
    local_step_tet_hyper.launches += 1
    return z, uo


def local_step_tet_stencil(x, u, b, n_iters: int = 8):
    """v = D x + u, z = prox_model(v), u' = v - z for the stencil tet family
    ``b``: x [N, 3], u rows [9, 5*cells] -> (z, u')."""
    check_model(b.model)
    base, cells, n_vblock, _, geom, _ = cuda_stencil.geom_of(b.stencil)
    if base + n_vblock > x.shape[0]:
        raise ValueError("local_step_tet_stencil: family vertex block lies outside x")
    if x.device.type == "cpu":
        return local_step_plain(stencil_mod.tet_Dx_rows_plain(x, b), u, b.mu, b.lam, b.kappa,
                                b.bulk, n_iters=n_iters, model=b.model)
    n = 5 * cells
    sfx = _build.cuda_args("local_step_tet_stencil", x, (
        ("x", x, (x.shape[0], 3)), ("st_dl", b.st_dl, (5, 4, 3, cells)),
        ("st_par", b.st_par, (cells,)), ("st_dead", b.st_dead, (cells,)), ("u", u, (9, n)),
        ("mu", b.mu, (n,)), ("lam", b.lam, (n,)), ("kappa", b.kappa, (n,)),
        ("bulk", b.bulk, (n,))))
    fn = getattr(_build.library(), f"admm_local_step_stencil_{sfx}")
    z = torch.empty_like(u)
    uo = torch.empty_like(u)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), b.st_dl.data_ptr(), b.st_par.data_ptr(), b.st_dead.data_ptr(),
                u.data_ptr(), b.mu.data_ptr(), b.lam.data_ptr(), b.kappa.data_ptr(),
                b.bulk.data_ptr(), z.data_ptr(), uo.data_ptr(), base, n_vblock, cells, geom,
                MODEL_IDS[b.model], int(n_iters), SWEEPS,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "local_step_tet_stencil")
    local_step_tet_stencil.launches += 1
    return z, uo


def local_step_tet_hyper_scenes(dix, u, mu, lam, kappa, scale, n_iters: int = 8,
                                model: str = TET_NEOHOOKEAN):
    """The rows entry over S scenes: dix, u [S, 9, T], mu / lam / kappa [T],
    scale [S] -> (z, u') [S, 9, T]."""
    check_model(model)
    if dix.device.type == "cpu":
        return local_step_scenes_plain(dix, u, mu, lam, kappa, scale, n_iters=n_iters,
                                       model=model)
    s_cnt, _, n = dix.shape
    sfx = _build.cuda_args("local_step_tet_hyper_scenes", dix, (
        ("dix", dix, (s_cnt, 9, n)), ("u", u, (s_cnt, 9, n)), ("mu", mu, (n,)),
        ("lam", lam, (n,)), ("kappa", kappa, (n,)), ("scale", scale, (s_cnt,))))
    fn = getattr(_build.library(), f"admm_local_step_scenes_{sfx}")
    z = torch.empty_like(dix)
    uo = torch.empty_like(dix)
    with torch.cuda.device(dix.device):
        rc = fn(dix.data_ptr(), u.data_ptr(), mu.data_ptr(), lam.data_ptr(), kappa.data_ptr(),
                scale.data_ptr(), z.data_ptr(), uo.data_ptr(), n, s_cnt, MODEL_IDS[model],
                int(n_iters), SWEEPS, torch.cuda.current_stream(dix.device).cuda_stream)
    _build.check(rc, "local_step_tet_hyper_scenes")
    local_step_tet_hyper_scenes.launches += 1
    return z, uo


def local_step_tet_stencil_scenes(x, u, b, scale, n_iters: int = 8):
    """The stencil entry over S scenes: x [S, N, 3], u [S, 9, 5*cells],
    scale [S] -> (z, u')."""
    check_model(b.model)
    base, cells, n_vblock, _, geom, _ = cuda_stencil.geom_of(b.stencil)
    s_cnt, n_verts = x.shape[0], x.shape[1]
    if base + n_vblock > n_verts:
        raise ValueError("local_step_tet_stencil_scenes: family vertex block lies outside x")
    if x.device.type == "cpu":
        dix = torch.stack([stencil_mod.tet_Dx_rows_plain(xs, b) for xs in x])
        return local_step_scenes_plain(dix, u, b.mu, b.lam, b.kappa, scale, n_iters=n_iters,
                                       model=b.model)
    n = 5 * cells
    sfx = _build.cuda_args("local_step_tet_stencil_scenes", x, (
        ("x", x, (s_cnt, n_verts, 3)), ("st_dl", b.st_dl, (5, 4, 3, cells)),
        ("st_par", b.st_par, (cells,)), ("st_dead", b.st_dead, (cells,)),
        ("u", u, (s_cnt, 9, n)), ("mu", b.mu, (n,)), ("lam", b.lam, (n,)),
        ("kappa", b.kappa, (n,)), ("scale", scale, (s_cnt,))))
    fn = getattr(_build.library(), f"admm_local_step_stencil_scenes_{sfx}")
    z = torch.empty_like(u)
    uo = torch.empty_like(u)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), b.st_dl.data_ptr(), b.st_par.data_ptr(), b.st_dead.data_ptr(),
                u.data_ptr(), b.mu.data_ptr(), b.lam.data_ptr(), b.kappa.data_ptr(),
                scale.data_ptr(), z.data_ptr(), uo.data_ptr(), base, n_vblock, cells, n_verts,
                s_cnt, geom, MODEL_IDS[b.model], int(n_iters), SWEEPS,
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "local_step_tet_stencil_scenes")
    local_step_tet_stencil_scenes.launches += 1
    return z, uo


local_step_tet_hyper.launches = 0
local_step_tet_stencil.launches = 0
local_step_tet_hyper_scenes.launches = 0
local_step_tet_stencil_scenes.launches = 0
