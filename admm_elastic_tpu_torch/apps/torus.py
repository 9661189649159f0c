"""A torus dropped on a floor, Uzawa CG contact with self-collision on (a
port of the JAX package's ``apps/torus.py``, samples/tvcg2017/torus.cpp).

    python -m admm_elastic_tpu_torch.apps.torus [--cpu] [--frames N] [-it N ...]

Prints the least y over the run (the floor at -1).
"""

import sys

from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.demo_data import load_demo_mesh
from admm_elastic_tpu_torch.geometry.factory import make_xform

FLOOR_Y = -1.0


def settings() -> Settings:
    return Settings(linsolver=2, admm_iters=10)


def build(s: Settings, device: str):
    mesh = load_demo_mesh("torus")
    mesh.flags = binding.LINEAR  # self-collision on (no NOSELFCOLLISION)
    mesh.apply_xform(
        make_xform(trans=(0, 2, 0)) @ make_xform(rot_deg=-3.0, rot_axis=(1, 0, 0)))

    solver = Solver(device=device)
    squishy = Lame.from_youngs_poisson(1000000, 0.1)
    binding.add_tetmesh(solver, mesh, squishy, verbose=s.verbose > 0)
    solver.add_obstacle(Floor(y=FLOOR_Y))
    if not solver.initialize(s):
        return None
    return Scene(solver, [(0, len(mesh.vertices), mesh.faces)], floor_y=FLOOR_Y)


def main(argv):
    s = settings()
    args = parse_cli(s, argv)
    traj = run_scene(build(s, device_of(args)), args)
    if traj is None:
        return 1
    print(f"min y over run: {traj[:, :, 1].min():.4f} (floor at -1)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
