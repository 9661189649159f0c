"""admm_elastic_tpu_torch: the PyTorch / CUDA port of admm_elastic_tpu.

The JAX package beside it is the reference. This package imports torch
and numpy only, never jax. Its first slice runs the pinned neo-Hookean
beam step: make_tet_blocks lattices, ``linsolver=0`` with
``direct_mode="inv"``, float32 or float64, on ``device="cpu"`` (plain
PyTorch) or ``device="cuda"`` (hand-written Hopper kernels in ``csrc/``
for D x, the local step and the rhs). Everything else raises
NotImplementedError naming the ROADMAP item that ports it.
"""

from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.solver import Solver

__version__ = "0.1.0"

__all__ = ["Settings", "Lame", "Solver"]
