"""Wrapper of kernel E (``csrc/tri_local_step.cu``): the fused cloth local
step, replacing ``pallas_kernels.local_step_tri_pallas``.

Dispatch is by the tensors' device: CPU tensors take the plain version
(``ops/soa.local_step_tri_plain``); CUDA tensors launch the kernel, and a
build or launch failure raises. ``local_step_tri.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import _build
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


local_step_tri.launches = 0
