"""Wrapper of kernel A (``csrc/local_step.cu``): the fused neo-Hookean tet
local step, replacing ``pallas_kernels.local_step_tet_hyper_pallas``.

Dispatch is by the tensors' device: CPU tensors take the plain version
(``ops/hyper_soa.local_step_plain``); CUDA tensors launch the kernel, and
a build or launch failure raises. ``local_step_tet_hyper.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
from admm_elastic_tpu_torch.ops.prox import TET_NEOHOOKEAN, check_model

SWEEPS = 8  # Jacobi sweeps of the signed SVD (pallas_kernels.py:238-239)


def _check(name, t, like, shape):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: {t.device}/{t.dtype}, expected {like.device}/{like.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: shape {tuple(t.shape)} (contiguous={t.is_contiguous()}), "
                         f"expected contiguous {shape}")


def local_step_tet_hyper(dix, u, mu, lam, kappa, k, n_iters: int = 8,
                         model: str = TET_NEOHOOKEAN):
    """v = dix + u, z = prox_NH(v), u' = v - z on rows [9, T] -> (z, u')."""
    check_model(model)
    if dix.device.type == "cpu":
        return local_step_plain(dix, u, mu, lam, kappa, k, n_iters=n_iters, model=model)
    if dix.device.type != "cuda":
        raise ValueError(f"local_step_tet_hyper: unsupported device {dix.device}")
    if dix.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"local_step_tet_hyper: unsupported dtype {dix.dtype}")
    n = dix.shape[1]
    _check("dix", dix, dix, (9, n))
    _check("u", u, dix, (9, n))
    for name, p in (("mu", mu), ("lam", lam), ("kappa", kappa), ("k", k)):
        _check(name, p, dix, (n,))
    lib = _build.library()
    fn = lib.admm_local_step_f32 if dix.dtype == torch.float32 else lib.admm_local_step_f64
    z = torch.empty_like(dix)
    uo = torch.empty_like(dix)
    stream = torch.cuda.current_stream(dix.device).cuda_stream
    with torch.cuda.device(dix.device):
        rc = fn(dix.data_ptr(), u.data_ptr(), mu.data_ptr(), lam.data_ptr(),
                kappa.data_ptr(), k.data_ptr(), z.data_ptr(), uo.data_ptr(),
                n, int(n_iters), SWEEPS, stream)
    _build.check(rc, "local_step_tet_hyper")
    local_step_tet_hyper.launches += 1
    return z, uo


local_step_tet_hyper.launches = 0
