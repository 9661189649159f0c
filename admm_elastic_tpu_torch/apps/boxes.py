"""Two stacked boxes on a floor, constrained Gauss-Seidel with dynamic
(inter-mesh) collision (a port of the JAX package's ``apps/boxes.py``,
samples/tvcg2017/boxes.cpp).

    python -m admm_elastic_tpu_torch.apps.boxes [--cpu] [--frames N] [-it N ...]

Each box is ``$ADMM_DATA_DIR/box768`` where that file exists (the
reference's data), else an 8x8x8 block of 1 m. Prints the least y over the
run (the floor at -1).
"""

import os
import sys

from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks, make_xform
from admm_elastic_tpu_torch.geometry.io import load_elenode

FLOOR_Y = -1.0


def settings() -> Settings:
    return Settings(linsolver=1)


def box():
    """box768 from ADMM_DATA_DIR where it is there, else the 8^3 block."""
    data = os.environ.get("ADMM_DATA_DIR")
    if data and os.path.exists(os.path.join(data, "box768.node")):
        return load_elenode(os.path.join(data, "box768"))
    m = make_tet_blocks(8, 8, 8, cell=1.0 / 8)
    m.apply_xform(make_xform(trans=(-0.5, -0.5, -0.5)))
    return m


def build(s: Settings, device: str):
    solver = Solver(device=device)
    surfaces = []
    for i in range(2):
        mesh = box()
        mesh.flags = binding.LINEAR
        mesh.apply_xform(make_xform(trans=(0.0, i * 2.0, 0.0)))
        off = binding.add_tetmesh(solver, mesh, Lame.rubber(), verbose=s.verbose > 0)
        surfaces.append((off, len(mesh.vertices), mesh.faces))

    solver.add_obstacle(Floor(y=FLOOR_Y))
    if not solver.initialize(s):
        return None
    return Scene(solver, surfaces, floor_y=FLOOR_Y)


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
