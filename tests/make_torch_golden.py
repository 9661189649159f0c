"""Write the golden trajectories tests/data/torch_port_golden_*.npz: JAX CPU
runs of the port's full-size scenes, against which chip_smoke.py and the
port's tests check admm_elastic_tpu_torch where no JAX is installed.

All scenes: float32, linsolver=0, direct_mode="inv", 10 ADMM iterations per
step, dt = 1/24; positions after steps 1 and 8. The SVD runs the Jacobi SoA
path (set_svd_impl("jacobi")), the same body as the port's kernels.

- beam (bench.py:23-24,78-94): the 40x5x5 make_tet_blocks beam, soft rubber,
  -x face pinned, gravity -9.8; neo-Hookean in torch_port_golden_beam.npz and
  linear, stvk, spline_nh (mesh flags of binding.add_tetmesh), spline_stvk and
  spline_corot (Solver.add_tet_energies with kappa = the bulk modulus) in
  torch_port_golden_beam_<model>.npz;
- cloth (benchmarks/matrix.py:76-119,279-281, geometry from
  chip_smoke.cloth_sheet): the 40x40 sheet, Lame.from_youngs_poisson(1e7,
  0.399), -x edge pinned; strain limits (0.95, 1.05) under gravity in
  torch_port_golden_cloth_limit40.npz, colored wind (0.05, 0.1, 0.02) without
  gravity in torch_port_golden_cloth_wind40.npz.

Run from the repository root (all files, or only the named ones):

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py [beam beam_stvk cloth_wind40 ...]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from admm_elastic_tpu import Lame, Settings, Solver, binding  # noqa: E402
from admm_elastic_tpu.forces import make_wind_force  # noqa: E402
from admm_elastic_tpu.geometry.factory import make_tet_blocks  # noqa: E402
from admm_elastic_tpu.ops import prox  # noqa: E402
from chip_smoke import BEAM_FLAGS, BEAM_MODELS, CLOTH_SCENES, cloth_sheet  # noqa: E402

DIMS = (40, 5, 5)
ADMM_ITERS = 10
DT = 1.0 / 24.0
GRAVITY = -9.8
STEPS = (1, 8)
DATA = os.path.join(ROOT, "tests", "data")


def _settings(gravity):
    return Settings(verbose=0, admm_iters=ADMM_ITERS, linsolver=0, gravity=gravity,
                    timestep_s=DT, dtype=np.float32, direct_mode="inv")


def _rollout(solver):
    traj = {}
    for step in range(1, max(STEPS) + 1):
        solver.step()
        if step in STEPS:
            traj[f"x{step}"] = np.asarray(solver.x, np.float32)
    return traj


def _save(name, **arrays):
    os.makedirs(DATA, exist_ok=True)
    out = os.path.join(DATA, f"torch_port_golden_{name}.npz")
    np.savez_compressed(out, admm_iters=ADMM_ITERS, dt=DT, steps=np.asarray(STEPS), **arrays)
    print(f"wrote {out}")


def beam(model):
    mesh = make_tet_blocks(*DIMS)
    solver = Solver()
    lame = Lame.soft_rubber()
    if model in BEAM_FLAGS:
        mesh.flags = binding.NOSELFCOLLISION | getattr(binding, BEAM_FLAGS[model])
        binding.add_tetmesh(solver, mesh, lame, verbose=False)
    else:
        solver.add_nodes(mesh.vertices, mesh.weighted_masses(binding.RUBBER_DENSITY))
        solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model,
                                kappa=lame.bulk_modulus(), lattice_dims=mesh.lattice_dims)
    pins = np.where(mesh.vertices[:, 0] < 1e-9)[0]
    solver.set_pins([int(i) for i in pins])
    assert solver.initialize(_settings(GRAVITY))
    assert solver.system.tets[0].model == model
    name = "beam" if model == "neohookean" else f"beam_{model}"
    _save(name, dims=np.asarray(DIMS), gravity=GRAVITY, mu=lame.mu, lam=lame.lam, pins=pins,
          model=model, x0=mesh.vertices.astype(np.float32), **_rollout(solver))


def cloth(name):
    p = CLOTH_SCENES[name]
    verts, tris, masses, pins = cloth_sheet(p["nx"], p["ny"])
    solver = Solver()
    solver.add_nodes(verts, masses)
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if p["limits"] is not None:
        lame.limit_min, lame.limit_max = p["limits"]
    solver.add_tri_energies(verts, tris, lame)
    solver.set_pins([int(i) for i in pins])
    if p["wind"] is not None:
        solver.add_explicit_force(make_wind_force(tris, direction=p["wind"], colored=True))
    assert solver.initialize(_settings(p["gravity"]))
    assert solver.system.tris[0].stencil is not None
    _save(name, nx=p["nx"], ny=p["ny"], gravity=p["gravity"], pins=pins,
          limits=np.asarray(p["limits"] if p["limits"] is not None else (-100.0, 100.0)),
          wind=np.asarray(p["wind"] if p["wind"] is not None else (0.0, 0.0, 0.0)),
          x0=verts.astype(np.float32), **_rollout(solver))


def main(argv):
    prox.set_svd_impl("jacobi")
    writers = {"beam": lambda: beam("neohookean")}
    writers.update({f"beam_{m}": (lambda m=m: beam(m)) for m in BEAM_MODELS})
    writers.update({n: (lambda n=n: cloth(n)) for n in CLOTH_SCENES})
    names = argv or list(writers)
    for n in names:
        if n not in writers:
            raise SystemExit(f"unknown golden {n!r}; one of {sorted(writers)}")
        writers[n]()


if __name__ == "__main__":
    main(sys.argv[1:])
