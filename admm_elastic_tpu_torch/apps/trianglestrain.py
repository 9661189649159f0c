"""Two pinned cloth sheets, one strain-limited to [0.95, 1.05] (a port of
the JAX package's ``apps/trianglestrain.py``, samples/sca2016/trianglestrain.cpp).

    python -m admm_elastic_tpu_torch.apps.trianglestrain [--cpu] [--frames N] [-it N ...]

Prints the least y of each sheet in the last frame.
"""

import sys

import numpy as np

from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.factory import make_plane, make_xform


def settings() -> Settings:
    return Settings()


def build(s: Settings, device: str):
    """The scene; extra: "limited" and "free", each sheet's (vertex offset,
    vertex count)."""
    meshes = [make_plane(10, 10), make_plane(10, 10)]
    for m in meshes:
        m.flags = binding.NOSELFCOLLISION | binding.LINEAR
    meshes[0].apply_xform(make_xform(trans=(-2, 0, 0)))
    meshes[1].apply_xform(make_xform(trans=(2, 0, 0)))

    solver = Solver(device=device)
    soft = Lame.from_youngs_poisson(100, 0.1)
    off1 = binding.add_trimesh(solver, meshes[1], soft, verbose=s.verbose > 0)
    limited = Lame.from_youngs_poisson(100, 0.1)
    limited.limit_min, limited.limit_max = 0.95, 1.05
    off0 = binding.add_trimesh(solver, meshes[0], limited, verbose=s.verbose > 0)

    # Pin the top corners of each sheet.
    pins = []
    for m, off in ((meshes[1], off1), (meshes[0], off0)):
        v = m.vertices
        top = np.where(v[:, 1] > v[:, 1].max() - 1e-6)[0]
        pins.append(int(top[np.argmin(v[top, 0])]) + off)
        pins.append(int(top[np.argmax(v[top, 0])]) + off)
    solver.set_pins(pins)

    if not solver.initialize(s):
        return None
    surfaces = [(off1, len(meshes[1].vertices), meshes[1].faces),
                (off0, len(meshes[0].vertices), meshes[0].faces)]
    return Scene(solver, surfaces, extra=dict(limited=(off0, len(meshes[0].vertices)),
                                              free=(off1, len(meshes[1].vertices))))


def main(argv):
    s = settings()
    args = parse_cli(s, argv)
    scene = build(s, device_of(args))
    traj = run_scene(scene, args)
    if traj is None:
        return 1
    off0, off1 = scene.extra["limited"][0], scene.extra["free"][0]
    print(f"limited sheet min y: {traj[-1][off0:off0+121, 1].min():.4f}, "
          f"free sheet min y: {traj[-1][off1:off1+121, 1].min():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
