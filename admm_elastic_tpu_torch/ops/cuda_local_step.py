"""Wrapper of kernel A (``csrc/local_step.cu``): the fused tet local step for
each of the six tet models, replacing
``pallas_kernels.local_step_tet_hyper_pallas`` (and, for the linear model,
the fused jnp path the JAX package leaves to XLA).

Dispatch is by the tensors' device: CPU tensors take the plain version
(``ops/hyper_soa.local_step_plain``); CUDA tensors launch the kernel, and
a build or launch failure raises. ``local_step_tet_hyper.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
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


local_step_tet_hyper.launches = 0
