"""admm_elastic_tpu_torch: the PyTorch / CUDA port of admm_elastic_tpu.

The JAX package beside it is the reference. This package imports torch
and numpy only (and scipy for the RCM ordering of the PCG operator), never
jax. It runs the prefactored direct path (``linsolver=0`` with
``direct_mode`` "inv" or "cho"), PCG (``linsolver=3``, Jacobi or
two-grid; also ``linsolver=0`` above ``direct_max_verts``), and contact with
the obstacles ``Floor``, ``Sphere``, ``PassiveMeshSDF`` and
``PassiveMeshExact`` and self-collision (``collision/dynamic``: a collider
for each tet mesh without NOSELFCOLLISION) through multicolour Gauss-Seidel
(``linsolver=1``), Uzawa (``2``) and AL-PCG (``4``), float32 or float64, for tet meshes of any
of the six tet models (make_tet_blocks lattices and make_tet_torus rings as a
flat stencil, any other mesh, such as one from ``geometry/io.load_elenode``,
by gather) and for triangle (cloth) meshes with strain limits and wind
(batched, colored or sequential), with Anderson acceleration
(``aa_window``), the logged and profiled steps (``log_inner``,
``verbose >= 2``) and checkpoints (``utils/checkpoint.py``), on
``device="cuda"`` (the default: hand-written Hopper kernels in ``csrc/`` for
D x, the local steps, the rhs, the element-level prox, the whole PCG solve
(also with AL-PCG's penalty and the self-collision rows), the whole
Gauss-Seidel solve (also with the self-collision rows), a mesh obstacle's
detection, a collider's detection, the self-collision rows' sums and the
sequential wind, and each timestep replayed as
one captured CUDA graph) or ``device="cpu"`` (the kernels' plain PyTorch
versions, stepped eagerly). Everything else raises NotImplementedError
naming the ROADMAP item that ports it.
"""

from admm_elastic_tpu_torch.collision.passive import (Floor, PassiveMeshExact, PassiveMeshSDF,
                                                       Sphere)
from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.solver import Solver

__version__ = "0.1.0"

__all__ = ["Settings", "Lame", "Solver", "Floor", "Sphere", "PassiveMeshSDF", "PassiveMeshExact"]
