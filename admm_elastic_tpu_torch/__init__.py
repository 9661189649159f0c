"""admm_elastic_tpu_torch: the PyTorch / CUDA port of admm_elastic_tpu.

The JAX package beside it is the reference. This package imports torch
and numpy only, never jax. It runs the prefactored direct path
(``linsolver=0`` with ``direct_mode="inv"``, float32 or float64) for
make_tet_blocks lattices of any of the six tet models and for regular
cloth sheets with strain limits and wind, on ``device="cuda"`` (the
default: hand-written Hopper kernels in ``csrc/`` for D x, the local steps,
the rhs and the element-level prox) or ``device="cpu"`` (the kernels' plain
PyTorch versions). Everything else raises NotImplementedError naming the
ROADMAP item that ports it.
"""

from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.solver import Solver

__version__ = "0.1.0"

__all__ = ["Settings", "Lame", "Solver"]
