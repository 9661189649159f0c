"""Inversion recovery: the bunny collapsed to a point or scrambled at
random, then recovering (a port of the JAX package's ``apps/bunnyexpand.py``,
samples/sca2016/bunnyexpand.cpp); neo-Hookean, no gravity.

    python -m admm_elastic_tpu_torch.apps.bunnyexpand [point|rand] [--cpu] [--frames N] ...

Prints the inverted tets of the last frame (a non-finite volume counts as
inverted) and whether the state is finite.
"""

import sys

import numpy as np

from admm_elastic_tpu_torch import Settings, Solver, binding
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.demo_data import load_demo_mesh
from admm_elastic_tpu_torch.geometry.factory import make_xform
from admm_elastic_tpu_torch.geometry.mesh import tet_volumes

SCRAMBLE_SEED = 100


def settings() -> Settings:
    return Settings(linsolver=0, gravity=0.0)


def split_argv(argv):
    """(single_point, the rest of argv): a leading "point" or "rand"."""
    argv = list(argv)
    if argv and argv[0] in ("point", "rand"):
        return argv[0] == "point", argv[1:]
    return False, argv


def build(s: Settings, device: str, single_point: bool = False):
    """The scene, its vertices collapsed to the origin or scrambled; extra:
    "tets" (the mesh's)."""
    # bunny_1124 from data/ (ADMM_DATA_DIR first: the reference's own data
    # runs the original bunny)
    mesh = load_demo_mesh("bunny_1124")
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    mesh.apply_xform(make_xform(rot_deg=20.0, rot_axis=(1, 0, 0)) @ make_xform(scale=(10,) * 3))

    solver = Solver(device=device)
    binding.add_tetmesh(solver, mesh, verbose=s.verbose > 0)
    if not solver.initialize(s):
        return None

    # Scramble the vertices (bunnyexpand.cpp set_vertices).
    rng = np.random.default_rng(SCRAMBLE_SEED)
    x = solver.x
    if single_point:
        x[:] = 0.0
    else:
        lo, hi = x.min(0), x.max(0)
        x = rng.uniform(lo, hi, size=x.shape)
    solver.x = x
    return Scene(solver, [(0, len(mesh.vertices), mesh.faces)], extra=dict(tets=mesh.tets))


def inverted(x, tets) -> int:
    """Inverted tets at x; a non-finite volume counts as inverted."""
    vols = tet_volumes(x, tets)
    return int(((vols <= 0) | ~np.isfinite(vols)).sum())


def main(argv):
    single_point, argv = split_argv(argv)
    s = settings()
    args = parse_cli(s, argv)
    scene = build(s, device_of(args), single_point)
    traj = run_scene(scene, args)
    if traj is None:
        return 1
    tets = scene.extra["tets"]
    finite = bool(np.isfinite(traj[-1]).all())
    print(f"final inverted tets: {inverted(traj[-1], tets)} / {len(tets)} "
          f"(state finite: {finite})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
