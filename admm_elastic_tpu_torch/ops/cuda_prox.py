"""Wrappers of kernels D and F (``csrc/prox.cu``): the tet prox on
``[T, 3, 3]`` with no dual update, replacing
``pallas_kernels.prox_tet_hyper_pallas`` and
``pallas_kernels.prox_tet_linear_pallas``.

Dispatch is by the tensors' device: CPU tensors take the plain version
(``ops/hyper_soa.prox_plain``); CUDA tensors launch the kernel, and a build
or launch failure raises. ``prox_tet_hyper.launches`` and
``prox_tet_linear.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops.cuda_local_step import MODEL_IDS, SWEEPS
from admm_elastic_tpu_torch.ops.hyper_soa import prox_plain
from admm_elastic_tpu_torch.ops.prox import TET_LINEAR, check_model


def prox_tet_hyper(zi, model: str, mu, lam, kappa, k, n_iters: int = 8):
    """Hyperelastic prox of [T, 3, 3] -> [T, 3, 3] (kernel D); k is [T] or a
    scalar tensor broadcast over the lanes."""
    check_model(model)
    if model == TET_LINEAR:
        raise ValueError("prox_tet_hyper: the linear model goes through prox_tet_linear")
    t = zi.shape[0]
    k = torch.broadcast_to(k, (t,)).contiguous()
    if zi.device.type == "cpu":
        return prox_plain(zi, model, mu, lam, kappa, k, n_iters=n_iters)
    sfx = _build.cuda_args("prox_tet_hyper", zi, (
        ("zi", zi, (t, 3, 3)), ("mu", mu, (t,)), ("lam", lam, (t,)),
        ("kappa", kappa, (t,)), ("k", k, (t,))))
    fn = getattr(_build.library(), f"admm_prox_tet_hyper_{sfx}")
    out = torch.empty_like(zi)
    with torch.cuda.device(zi.device):
        rc = fn(zi.data_ptr(), mu.data_ptr(), lam.data_ptr(), kappa.data_ptr(), k.data_ptr(),
                out.data_ptr(), t, MODEL_IDS[model], int(n_iters), SWEEPS,
                torch.cuda.current_stream(zi.device).cuda_stream)
    _build.check(rc, "prox_tet_hyper")
    prox_tet_hyper.launches += 1
    return out


def prox_tet_linear(zi):
    """Linear-tet prox 1/2 (U V^T + F) of [T, 3, 3] -> [T, 3, 3] (kernel F)."""
    if zi.device.type == "cpu":
        return prox_plain(zi, TET_LINEAR, None, None, None, None)
    t = zi.shape[0]
    sfx = _build.cuda_args("prox_tet_linear", zi, (("zi", zi, (t, 3, 3)),))
    fn = getattr(_build.library(), f"admm_prox_tet_linear_{sfx}")
    out = torch.empty_like(zi)
    with torch.cuda.device(zi.device):
        rc = fn(zi.data_ptr(), out.data_ptr(), t, SWEEPS,
                torch.cuda.current_stream(zi.device).cuda_stream)
    _build.check(rc, "prox_tet_linear")
    prox_tet_linear.launches += 1
    return out


prox_tet_hyper.launches = 0
prox_tet_linear.launches = 0
