"""The golden trajectories that chip_smoke.py checks the card against, held to
the port's CPU path at full size (tests/make_torch_golden.py rewrites them
from the JAX package; tests/test_torch_bench_scene.py holds the neo-Hookean
beam's):

- torch_port_golden_cloth_limit40.npz, torch_port_golden_cloth_wind40.npz:
  the 40x40 sheets of benchmarks/matrix.py:76-119,279-281 with linsolver=0
  (1,681 vertices, 3,200 triangles, 3,362 lanes);
- torch_port_golden_beam_{linear,stvk,spline_nh,spline_stvk,spline_corot}.npz:
  the 40x5x5 beam of bench.py with each of the other tet models (mesh flags of
  binding.add_tetmesh, or Solver.add_tet_energies for the last two).

The scenes come from chip_smoke.py's own make_solver and make_cloth_solver,
on the CPU. Bounds relative to max |x|: 1e-4 after one step, 2e-3 after
eight (benchmarks/crossval.py:299-302).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_solver import _rel

torch.set_num_threads(1)


def _check(solver, g):
    assert int(g["admm_iters"]) == 10 and tuple(g["steps"]) == (1, 8)
    solver.step()
    x1 = solver.x
    solver.run(7)
    x8 = solver.x
    assert np.isfinite(x8).all()
    assert _rel(x1, g["x1"]) < chip_smoke.STEP1_TOL, _rel(x1, g["x1"])
    assert _rel(x8, g["x8"]) < chip_smoke.STEP8_TOL, _rel(x8, g["x8"])
    pins = g["pins"]
    assert np.abs(x8[pins] - g["x0"][pins]).max() < 1e-3
    assert _rel(x8, g["x0"]) > 1e-3  # the scene moved


@pytest.mark.parametrize("name", sorted(chip_smoke.CLOTH_SCENES))
def test_cloth_golden(name):
    solver, g, _ = chip_smoke.make_cloth_solver(name, device="cpu")
    assert solver.system.n_verts == 1681 and solver.system.tris[0].n == 3362
    assert solver.system.tris[0].n_real == 3200
    _check(solver, g)


@pytest.mark.parametrize("model", chip_smoke.BEAM_MODELS)
def test_beam_golden(model):
    solver, _, g, _ = chip_smoke.make_solver(model, device="cpu")
    assert solver.system.tets[0].model == model and solver.system.tets[0].n == 7680
    _check(solver, g)
