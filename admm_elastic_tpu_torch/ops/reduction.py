"""D and D^T of the pin family (``admm_elastic_tpu/ops/reduction.py:191-200``).

Pin indices are unique, so D^T is an indexed copy into zeros: no
accumulation, deterministic on every device.
"""

from __future__ import annotations

import torch


def pin_Dx(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, 3] positions of the pinned vertices."""
    return x[idx]


def pin_Dt(G: torch.Tensor, idx: torch.Tensor, n_verts: int) -> torch.Tensor:
    """[P, 3] -> [N, 3], each row written once at its pinned vertex."""
    out = G.new_zeros((n_verts, 3))
    return out.index_copy_(0, idx, G)
