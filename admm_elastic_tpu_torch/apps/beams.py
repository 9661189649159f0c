"""Three material beams stretched by animated pins (a port of the JAX
package's ``apps/beams.py``, samples/sca2016/beams.cpp): LINEAR, NEOHOOKEAN
and STVK beams, their leftmost and rightmost vertices pinned and pulled apart
at 1 m/s through set_pins every frame.

    python -m admm_elastic_tpu_torch.apps.beams [--cpu] [--frames N] [-it N ...]
"""

import sys

import numpy as np

from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.apps._app import Scene, device_of, parse_cli, run_scene
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks, make_xform

FLAGS = (binding.NOSELFCOLLISION | binding.LINEAR,
         binding.NOSELFCOLLISION | binding.NEOHOOKEAN,
         binding.NOSELFCOLLISION | binding.STVK)


def settings() -> Settings:
    return Settings(admm_iters=20)


def build(s: Settings, device: str):
    """The scene; extra: "pins" (vertex ids), "points" (their targets at
    rest), "sides" (-1 left, +1 right: each frame moves a target by side * dt
    in x)."""
    dim = 3
    meshes = []
    for i, fl in enumerate(FLAGS):
        m = make_tet_blocks(dim * 4, dim, dim)
        lo, hi = m.bounds()
        m.apply_xform(make_xform(trans=-(lo + hi) / 2.0))
        y = (hi - lo)[1]
        m.apply_xform(make_xform(scale=(1.0 / y,) * 3))  # 1 m tall
        m.apply_xform(make_xform(trans=(0.0, 1.75 - 1.75 * i, 0.0)))
        m.flags = fl
        meshes.append(m)

    solver = Solver(device=device)
    soft_rubber = Lame.from_youngs_poisson(10000000, 0.399)
    offsets = [binding.add_tetmesh(solver, m, soft_rubber, verbose=s.verbose > 0)
               for m in meshes]

    # The left and right pins (beams.cpp:137-163).
    pins, points, sides = [], [], []
    for m, off in zip(meshes, offsets):
        lo, hi = m.bounds()
        for j, v in enumerate(m.vertices):
            if v[0] < lo[0] + 1e-2:
                pins.append(j + off), points.append(v.copy()), sides.append(-1)
            elif v[0] > hi[0] - 1e-2:
                pins.append(j + off), points.append(v.copy()), sides.append(+1)
    points = np.asarray(points)
    sides = np.asarray(sides, dtype=np.float64)

    solver.set_pins(pins, list(points))
    if not solver.initialize(s):
        return None

    state = {"points": points}

    def stretch(frame):
        move = np.array([1.0, 0.0, 0.0]) * solver.m_settings.timestep_s
        state["points"] = state["points"] + sides[:, None] * move[None, :]
        solver.set_pins(pins, list(state["points"]))

    surfaces = [(off, len(m.vertices), m.faces) for m, off in zip(meshes, offsets)]
    return Scene(solver, surfaces, sim_cb=stretch,
                 extra=dict(pins=pins, points=points, sides=sides))


def pin_targets(extra, dt, frames):
    """The pins' targets after `frames` frames of the stretch, the move taken
    at once (the app adds one frame's move at a time, as the JAX package's
    does: the two agree to rounding)."""
    return extra["points"] + extra["sides"][:, None] * np.array([1.0, 0.0, 0.0]) * dt * frames


def main(argv):
    s = settings()
    args = parse_cli(s, argv)
    return 1 if run_scene(build(s, device_of(args)), args) is None else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
