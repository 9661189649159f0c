"""Write tests/data/torch_port_golden_beam.npz: the JAX CPU trajectory of
the bench scene, against which chip_smoke.py and the port's tests check
admm_elastic_tpu_torch where no JAX is installed.

Scene (bench.py:23-24,78-94): 40x5x5 make_tet_blocks neo-Hookean beam,
soft rubber, -x face pinned, float32, linsolver=0, direct_mode="inv",
10 ADMM iterations per step, dt = 1/24, gravity -9.8. The SVD runs the
Jacobi SoA path (set_svd_impl("jacobi")), the same body as the port's
local-step kernel. Positions are stored after steps 1 and 8.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from admm_elastic_tpu import Lame, Settings, Solver, binding  # noqa: E402
from admm_elastic_tpu.geometry.factory import make_tet_blocks  # noqa: E402
from admm_elastic_tpu.ops import prox  # noqa: E402

DIMS = (40, 5, 5)
ADMM_ITERS = 10
DT = 1.0 / 24.0
GRAVITY = -9.8
STEPS = (1, 8)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "torch_port_golden_beam.npz")


def main():
    prox.set_svd_impl("jacobi")
    mesh = make_tet_blocks(*DIMS)
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    solver = Solver()
    lame = Lame.soft_rubber()
    binding.add_tetmesh(solver, mesh, lame, verbose=False)
    pins = np.where(mesh.vertices[:, 0] < 1e-9)[0]
    solver.set_pins([int(i) for i in pins])
    assert solver.initialize(Settings(
        verbose=0, admm_iters=ADMM_ITERS, linsolver=0, gravity=GRAVITY,
        timestep_s=DT, dtype=np.float32, direct_mode="inv"))
    traj = {}
    for step in range(1, max(STEPS) + 1):
        solver.step()
        if step in STEPS:
            traj[f"x{step}"] = np.asarray(solver.x, np.float32)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, dims=np.asarray(DIMS), admm_iters=ADMM_ITERS, dt=DT, gravity=GRAVITY,
        mu=lame.mu, lam=lame.lam, pins=pins, x0=mesh.vertices.astype(np.float32),
        steps=np.asarray(STEPS), **traj)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
