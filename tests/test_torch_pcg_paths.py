"""PCG through the port's Solver on the CPU against the JAX package:

- crossval's PCG scenes (chip_smoke.PCG_SCENES: the 6x3x3 beam, the 12x4
  torus, the bunny; benchmarks/crossval.py:28-37,60-69) against the JAX
  package's goldens (tests/make_torch_golden.py): float32 at crossval's bounds
  (beam 1e-4 after one step, torus 1e-3, both 1e-2 after eight) and the
  displacement bound chip_smoke.DISP_TOL; float64 at 1e-9 in the JAX
  package's CG trips, step by step;
- the linsolver=0 switch to two-grid PCG above direct_max_verts, in both
  packages on one small sheet: the caller's Settings unchanged, the same
  effective settings, the same trajectory;
- convert.pcg_from_numpy: the JAX package's PCG operator arrays stepped by
  both packages;
- runtime_data().inner_iters after step() (the step's CG trips, read from the
  step's device counter) and after run(n) (0), as in the JAX package;
- the traced solves of the contact linsolvers still raise, naming their
  ROADMAP item.

The bunny leaves crossval's float32 bound: its float32 PCG solve is only as
accurate as the clamped tolerance allows (chip_smoke.PCG_STEP_TOL), and its
float64 trips follow the sum order; both are held to measured bounds here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import Lame, Settings, Solver, convert
from admm_elastic_tpu_torch import config as cfg
from admm_elastic_tpu_torch.solvers import pcg as tpcg

torch.set_num_threads(1)

# float32 bounds (step 1, step 8) on x relative to max |x|, and on the
# displacement. Port against the goldens on the CPU: beam 1.2e-5 / 5.1e-6
# (displacement 4.6e-3), torus 1.6e-4 / 3.9e-3 (1.2e-2), bunny 2.2e-2 /
# 1.7e-2 (0.12); see chip_smoke.PCG_STEP_TOL for the bunny.
F32_BOUNDS = {"beam_pcg": (1e-4, 1e-2, chip_smoke.DISP_TOL["float32"]),
              "torus_pcg": (1e-3, 1e-2, chip_smoke.DISP_TOL["float32"]),
              "bunny_pcg": (0.1, 0.1, chip_smoke.PCG_DISP_TOL["bunny_pcg"])}
# float64: beam and torus at most 3.1e-13 in the golden's trips at every step;
# the bunny 6.4e-8 / 8.4e-6, its trips within 8 % (353 against 360 at step 4):
# the trips of a 400-trip float64 solve on its operator follow the sum order.
F64_BOUNDS = {"beam_pcg_f64": (1e-9, 1e-9, 0), "torus_pcg_f64": (1e-9, 1e-9, 0),
              "bunny_pcg_f64": (1e-6, 1e-4, 0.1)}


def _rollout(name):
    chip_smoke.DEVICE = "cpu"
    solver, pins = chip_smoke.pcg_scene(name, chip_smoke.torch_api("cpu"))
    g = chip_smoke.golden(name)
    assert np.array_equal(pins, g["pins"])
    xs, trips = {}, []
    for step in range(1, 9):
        solver.step()
        trips.append(solver.runtime_data().inner_iters)
        if step in (1, 8):
            xs[step] = solver.x
    return solver, g, xs, trips


@pytest.mark.parametrize("name", sorted(F32_BOUNDS))
def test_float32_pcg_scene_holds_its_bounds_against_the_golden(name):
    solver, g, xs, trips = _rollout(name)
    b1, b8, bd = F32_BOUNDS[name]
    assert chip_smoke.rel_err(xs[1], g["x1"]) < b1
    assert chip_smoke.rel_err(xs[8], g["x8"]) < b8
    for step in (1, 8):
        assert np.isfinite(xs[step]).all()
        assert chip_smoke.disp_err(xs[step], g, step)[0] < bd
    assert all(t > 0 for t in trips)
    assert solver.m_settings.linsolver == cfg.PCG


@pytest.mark.parametrize("name", sorted(F64_BOUNDS))
def test_float64_pcg_scene_matches_the_golden_trip_for_trip(name):
    _, g, xs, trips = _rollout(name)
    b1, b8, trip_margin = F64_BOUNDS[name]
    assert chip_smoke.rel_err(xs[1], g["x1"]) < b1
    assert chip_smoke.rel_err(xs[8], g["x8"]) < b8
    want = g["trips"].tolist()
    if trip_margin:
        assert all(abs(t - w) <= trip_margin * w for t, w in zip(trips, want))
    else:
        assert trips == want


@pytest.fixture(scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


SHEET = (12, 12)  # 169 vertices; direct_max_verts set below that


def _sheet(pkg, settings, device=None):
    verts, tris, masses, pins = chip_smoke.cloth_sheet(*SHEET)
    solver = pkg["Solver"]()
    solver.add_nodes(verts, masses)
    lame = pkg["Lame"].from_youngs_poisson(10000000, 0.399)
    lame.limit_min, lame.limit_max = 0.95, 1.05
    solver.add_tri_energies(verts, tris, lame)
    solver.set_pins([int(i) for i in pins])
    assert solver.initialize(settings)
    return solver


def _switch_settings(cls):
    return cls(verbose=0, admm_iters=10, linsolver=0, dtype=np.float64, direct_max_verts=100,
               gravity=-9.8)


JAX = dict(Solver=JSolver, Lame=JLame)
PORT = dict(Solver=lambda: Solver(device="cpu"), Lame=Lame)


@pytest.fixture(scope="module")
def switched(_jacobi_svd):
    """The sheet in both packages, switched to two-grid PCG, with the JAX
    package's three steps (step() then run(2)) and what it reported."""
    js = _switch_settings(JSettings)
    j = _sheet(JAX, js)
    x0, v0 = np.asarray(j.state.x), np.asarray(j.state.v)
    arrays = {f: (None if getattr(j._solve_data, f) is None
                  else np.asarray(getattr(j._solve_data, f)))
              for f in ("ell_cols", "ell_vals", "diag_mass", "diag_stiff", "diag_pin", "agg",
                        "agg_gather", "coarse_inv", "bands", "perm", "iperm")}
    arrays.update(band_offsets=j._solve_data.band_offsets,
                  band_circular=j._solve_data.band_circular)
    j.step()
    inner = j.runtime_data().inner_iters
    x1 = np.asarray(j.x)
    j.run(2)
    return dict(jax=j, settings=js, x0=x0, v0=v0, arrays=arrays, x1=x1, inner=inner,
                run_inner=j.runtime_data().inner_iters, x3=np.asarray(j.x))


def test_linsolver0_switches_to_twogrid_pcg_above_direct_max_verts(switched):
    ps = _switch_settings(Settings)
    p = _sheet(PORT, ps)
    j = switched["jax"]
    assert ps.linsolver == cfg.LDLT and switched["settings"].linsolver == cfg.LDLT
    assert ps.pcg_precond == "jacobi" and ps.pcg_tol == 1e-10  # the caller's object, untouched
    assert p.requested_linsolver == j.requested_linsolver == cfg.LDLT
    for s in (p.m_settings, j.m_settings):
        assert (s.linsolver, s.pcg_precond, s.pcg_tol) == (cfg.PCG, "twogrid", 1e-10)
    assert p.m_settings is not ps
    assert isinstance(p._solve_data, tpcg.PCGData) and p._solve_data.agg is not None


def test_switched_sheet_steps_like_the_jax_package(switched):
    p = _sheet(PORT, _switch_settings(Settings))
    p.step()
    assert chip_smoke.rel_err(p.x, switched["x1"]) < 1e-9
    assert p.runtime_data().inner_iters == switched["inner"] > 0
    p.run(2)
    assert chip_smoke.rel_err(p.x, switched["x3"]) < 1e-9
    assert p.runtime_data().inner_iters == switched["run_inner"] == 0


def test_switch_prints_what_it_does(capsys):
    s = _switch_settings(Settings)
    s.verbose = 1
    _sheet(PORT, s)
    assert "serving linsolver=0 via ELL-PCG (two-grid, tol 1e-10)" in capsys.readouterr().out


def test_pcg_from_numpy_steps_the_jax_package_s_operator(switched):
    """The JAX package's PCGData arrays through convert.pcg_from_numpy into a
    port solver (its own system and state): the first step is the JAX
    package's, and the port's own operator is the same bit for bit."""
    own = _sheet(PORT, _switch_settings(Settings))
    data = convert.pcg_from_numpy(switched["arrays"], device="cpu", dtype=torch.float64)
    for f in ("ell_cols", "ell_vals", "diag_mass", "diag_stiff", "diag_pin", "agg",
              "agg_gather", "coarse_inv", "bands"):
        assert torch.equal(getattr(data, f), getattr(own._solve_data, f)), f
    assert data.band_offsets == own._solve_data.band_offsets
    conv = Solver(own.m_settings, device="cpu")
    conv.load_arrays(own.system, data, convert.state_from_numpy(
        switched["x0"], switched["v0"], device="cpu", dtype=torch.float64))
    conv.step()
    assert chip_smoke.rel_err(conv.x, switched["x1"]) < 1e-9
    assert conv.runtime_data().inner_iters == switched["inner"]


def test_load_arrays_refuses_data_of_the_other_solver():
    p = _sheet(PORT, _switch_settings(Settings))
    direct = Solver(Settings(verbose=0, linsolver=0), device="cpu")
    with pytest.raises(ValueError, match="PCGData for linsolver=0"):
        direct.load_arrays(p.system, p._solve_data, p.state)


def test_inner_iters_on_the_direct_path_are_admm_iters():
    s = Settings(verbose=0, admm_iters=7, linsolver=0, dtype=np.float64)
    p = _sheet(PORT, s)
    p.step()
    assert p.runtime_data().inner_iters == 7
    p.run(3)
    assert p.runtime_data().inner_iters == 0


def test_the_step_counter_holds_one_step_s_trips():
    chip_smoke.DEVICE = "cpu"
    p, _ = chip_smoke.pcg_scene("beam_pcg_f64", chip_smoke.torch_api("cpu"))
    g = chip_smoke.golden("beam_pcg_f64")
    p.run(1)
    assert int(p._inner.item()) == g["trips"][0]  # written by the step, read by step() alone
    p.step()
    assert p.runtime_data().inner_iters == g["trips"][1] == int(p._inner.item())


def test_graph_key_names_the_pcg_settings():
    p = _sheet(PORT, _switch_settings(Settings))
    key = p._graph_key()
    s = p.m_settings
    for change in (dict(pcg_tol=1e-8), dict(pcg_max_iters=10), dict(pcg_precond="jacobi")):
        p.m_settings = dataclasses.replace(s, **change)
        assert p._graph_key() != key
    p.m_settings = s
    assert p._graph_key() == key
