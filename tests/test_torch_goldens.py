"""The golden trajectories that chip_smoke.py checks the card against, held to
the port's CPU path at full size (tests/make_torch_golden.py rewrites them
from the JAX package; tests/test_torch_bench_scene.py holds the neo-Hookean
beam's):

- torch_port_golden_cloth_limit40.npz, torch_port_golden_cloth_wind40.npz:
  the 40x40 sheets of benchmarks/matrix.py:76-119,279-281 with linsolver=0
  (1,681 vertices, 3,200 triangles, 3,362 lanes);
- torch_port_golden_beam_{linear,stvk,spline_nh,spline_stvk,spline_corot}.npz:
  the 40x5x5 beam of bench.py with each of the other tet models (mesh flags of
  binding.add_tetmesh, or Solver.add_tet_energies for the last two);
- torch_port_golden_beam_free.npz: the neo-Hookean beam without pins, two
  steps of free fall; the float32 system takes one refinement pass per ADMM
  iteration, which applies A through system.A_mv (kernels B and C);
- torch_port_golden_{beam_gather,bunny_nh,bunny_linear,bunny_nh_f64,
  bunny_linear_f64,cloth_gather_limit40,cloth_gather_wind40,beam_cho}.npz
  (chip_smoke.GATHER_SCENES): the bench beam as a gather family, the
  reference's bunny (600 vertices, 3,460 tets) in two models and two
  precisions, the two renumbered 40x40 sheets (each also held, mapped back,
  to its grid sheet's golden, cloth_limit40's or cloth_wind40's), and the
  lattice beam through the Cholesky solve.

The scenes come from chip_smoke.py's own make_solver, make_cloth_solver and
make_gather_solver, on the CPU. Bounds relative to max |x|: 1e-4 after one step, 2e-3 after
eight (benchmarks/crossval.py:299-302); the displacement after each within
chip_smoke.DISP_TOL, which tests/bunny_disp_control.py holds against a
planted fault.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from bunny_disp_control import run as run_with_fault
from test_torch_solver import _rel

torch.set_num_threads(1)


def _check(solver, g, moved=1e-3):
    assert int(g["admm_iters"]) == 10 and tuple(g["steps"]) == (1, 8)
    solver.step()
    x1 = solver.x
    solver.run(7)
    x8 = solver.x
    assert np.isfinite(x8).all()
    assert _rel(x1, g["x1"]) < chip_smoke.STEP1_TOL, _rel(x1, g["x1"])
    assert _rel(x8, g["x8"]) < chip_smoke.STEP8_TOL, _rel(x8, g["x8"])
    for step, x in ((1, x1), (8, x8)):
        disp, tol = chip_smoke.disp_err(x, g, step)
        assert disp < tol, (step, disp)
    pins = g["pins"]
    assert np.abs(x8[pins] - g["x0"][pins]).max() < 1e-3
    assert _rel(x8, g["x0"]) > moved  # the scene moved


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


def test_free_beam_golden():
    solver, _, g, pins = chip_smoke.make_solver(device="cpu", pinned=False)
    assert pins == [] and solver.system.pins is None and solver._refine_eff == 1
    assert int(g["admm_iters"]) == 10 and tuple(g["steps"]) == (1, 2)
    solver.step()
    x1 = solver.x
    solver.step()
    x2 = solver.x
    assert np.isfinite(x2).all()
    assert _rel(x1, g["x1"]) < chip_smoke.STEP1_TOL, _rel(x1, g["x1"])
    assert _rel(x2, g["x2"]) < chip_smoke.STEP8_TOL, _rel(x2, g["x2"])
    # free fall by symplectic Euler: g dt^2 n (n + 1) / 2 after n steps
    drop = (x2 - g["x0"])[:, 1]
    assert np.abs(drop - float(g["gravity"]) * float(g["dt"]) ** 2 * 3).max() < 1e-4


GATHER_SIZES = {"beam_gather": (1476, 5000), "bunny_nh": (600, 3460),
                "bunny_linear": (600, 3460), "bunny_nh_f64": (600, 3460),
                "bunny_linear_f64": (600, 3460), "cloth_gather_limit40": (1681, 3200),
                "cloth_gather_wind40": (1681, 3200), "beam_cho": (1476, 7680)}


@pytest.mark.parametrize("name", sorted(chip_smoke.GATHER_SCENES))
def test_gather_golden(name):
    solver, g, _ = chip_smoke.make_gather_solver(name, device="cpu")
    fam = (solver.system.tets + solver.system.tris)[0]
    assert (solver.system.n_verts, fam.n) == GATHER_SIZES[name]
    assert solver._solve_data.mode == chip_smoke.GATHER_SCENES[name]["direct_mode"]
    # the bunny moves 1.5e-5 m (max |x| 0.06 m) in 8 steps: disp_err holds it
    _check(solver, g, moved=0.0 if name.startswith("bunny") else 1e-3)
    assert solver.x.dtype == chip_smoke.GATHER_SCENES[name].get("dtype", np.float32)
    if chip_smoke.GATHER_SCENES[name]["mesh"] == "sheet":
        # mapped back to the grid's numbering, it is the grid sheet's trajectory
        grid = chip_smoke.golden(chip_smoke.GATHER_SCENES[name]["sheet"])
        perm = g["perm"]
        assert _rel(g["x1"][perm], grid["x1"]) < chip_smoke.STEP1_TOL
        assert _rel(solver.x[perm], grid["x8"]) < chip_smoke.STEP8_TOL


# A fault planted in kernel A's rows entry (its correction z - v off by eps)
# that the displacement bound must catch: float32 cannot resolve the bunny's
# displacement closer than a tenth, float64 a hundredth and far below.
PLANTED = {"bunny_nh": 0.1, "bunny_linear": 0.1, "bunny_nh_f64": 0.01, "bunny_linear_f64": 0.01}


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_displacement_bound_catches_a_planted_fault(name):
    r = run_with_fault(name, PLANTED[name])
    assert r["step1"] < chip_smoke.STEP1_TOL and r["step8"] < chip_smoke.STEP8_TOL
    assert max(r["disp1"], r["disp8"]) > r["disp_tol"], r
