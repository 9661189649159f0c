"""A soft sphere settling on a floor, constrained Gauss-Seidel (a port of
the JAX package's ``apps/signorini.py``, samples/tvcg2017/signorini.cpp).

    python -m admm_elastic_tpu_torch.apps.signorini [--obstacle floor|sdf|exact] [--cpu]
        [--frames N] [-it N ...]

``--obstacle sdf|exact`` swaps the analytic floor for a tet-slab mesh
obstacle through either narrow phase (``collision/passive.py``). Prints the
least y over the run (the floor, or the slab's top, at -1).
"""

import sys

from admm_elastic_tpu_torch import (Floor, Lame, PassiveMeshExact, PassiveMeshSDF, Settings,
                                    Solver, binding)
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.demo_data import load_demo_mesh
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks, make_xform

OBSTACLES = ("floor", "sdf", "exact")
FLOOR_Y = -1.0


def settings() -> Settings:
    return Settings(linsolver=1)


def split_argv(argv):
    """(obstacle, the rest of argv): the app's own --obstacle flag, taken
    out before the shared parser."""
    argv = list(argv)
    obstacle = "floor"
    if "--obstacle" in argv:
        i = argv.index("--obstacle")
        obstacle = argv[i + 1]
        del argv[i: i + 2]
    return obstacle, argv


def build(s: Settings, device: str, obstacle: str = "floor"):
    mesh = load_demo_mesh("sphere")
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR

    solver = Solver(device=device)
    very_soft = Lame.from_youngs_poisson(1000000, 0.299)
    binding.add_tetmesh(solver, mesh, very_soft, verbose=s.verbose > 0)
    if obstacle == "floor":
        solver.add_obstacle(Floor(y=FLOOR_Y))
    else:
        ext = mesh.vertices.max(0) - mesh.vertices.min(0)
        slab = make_tet_blocks(12, 2, 12, cell=float(ext.max()) / 3.0)
        sext = slab.vertices.max(0) - slab.vertices.min(0)
        ctr = mesh.vertices.mean(0)
        slab.apply_xform(make_xform(trans=(
            ctr[0] - sext[0] / 2, FLOOR_Y - sext[1], ctr[2] - sext[2] / 2)))
        if obstacle == "sdf":
            solver.add_obstacle(PassiveMeshSDF.from_tet_mesh(
                slab.vertices, slab.tets, resolution=48))
        elif obstacle == "exact":
            solver.add_obstacle(PassiveMeshExact.from_tet_mesh(
                slab.vertices, slab.tets, cells=32))
        else:
            raise SystemExit(f"unknown --obstacle {obstacle!r}")
    if not solver.initialize(s):
        return None
    return Scene(solver, [(0, len(mesh.vertices), mesh.faces)], floor_y=FLOOR_Y)


def main(argv):
    obstacle, argv = split_argv(argv)
    s = settings()
    args = parse_cli(s, argv)
    traj = run_scene(build(s, device_of(args), obstacle), args)
    if traj is None:
        return 1
    print(f"min y over run: {traj[:, :, 1].min():.4f} (floor at -1)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
