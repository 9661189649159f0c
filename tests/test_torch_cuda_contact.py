"""Kernel H (the whole Gauss-Seidel solve in one launch), kernel G's penalty
form and the contact steps on a CUDA card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_contact.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the contact paths' full size). On the card, on crossval's small contact
scenes (chip_smoke.CONTACT_SCENES) at the golden's landed state:

- H against the plain gs.solve with the pins and the obstacles (a Floor, a
  Sphere, both), float64 in the same sweeps within chip_smoke.H_F64_TOL,
  float32 within H_F32_TOL, twice bitwise;
- each form of H (SHARED, GLOBAL) bitwise the other and the plain gs.solve
  on a Floor, float32 and float64, captured and replayed: on the landed
  floor_gs5k (x fits shared memory) and on the landed floor_uzawa67k beam
  under Gauss-Seidel (15,616 vertices: in float64 beyond the SHARED form);
- G's penalty form against alcg.solve_plain (the dense Jacobi form and the
  two-grid form), float64 in the same trips within PCG_F64_TOL, float32
  within PCG_F32_TOL;
- G as Uzawa's two-grid inner solve at floor_uzawa67k (chip_smoke's
  uzawa_inner_checks): the first solve and a Schur direction's against the
  plain solve_T, and the predicated trip (done set: x0 and no trip);
- each contact linsolver's graph rollout bitwise equal to its eager loop (x,
  v, the multipliers y and the active rows), step() reporting the step's
  inner iterations from the device counter, equal through the graph and the
  eager loop (Uzawa's predicated Schur trips count only where they run).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch import Floor, Sphere

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


OBSTACLES = {"floor": [Floor(y=-1.0)],
             "sphere_floor": [Sphere(center=[3.0, -11.0, 1.5], rad=10.0), Floor(y=-1.0)]}


@pytest.mark.parametrize("which", sorted(OBSTACLES))
def test_h_against_plain_gs_solve(cuda_device, which):
    solver = chip_smoke.landed_solver(torch, "contact_gs")
    b, x0 = chip_smoke.first_solve(torch, solver)
    n = x0.shape[0]
    pin_mask = torch.zeros((n,), dtype=torch.bool, device=cuda_device)
    pin_mask[:9] = True
    pin_target = x0 + 0.003
    d64 = chip_smoke.gs_data64(torch, solver)
    s = solver.m_settings
    r32 = chip_smoke.h_against_plain(torch, which, solver._solve_data, b, x0, pin_mask,
                                     pin_target, OBSTACLES[which], s, "f32", graph=True)
    r64 = chip_smoke.h_against_plain(torch, which, d64, b.double(), x0.double(), pin_mask,
                                     pin_target.double(), OBSTACLES[which], s, "f64")
    assert r32["graph_replay_bitwise"] and r64["sweeps"] > 0
    if which == "floor":  # every operation of a Floor's update in the plain order
        assert r32["bitwise"] and r64["bitwise"]


def test_h_on_the_sphere_scene(cuda_device):
    solver = chip_smoke.landed_solver(torch, "sphere_gs")
    b, x0 = chip_smoke.first_solve(torch, solver)
    no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=cuda_device)
    s = solver.m_settings
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        data = solver._solve_data if tag == "f32" else chip_smoke.gs_data64(torch, solver)
        chip_smoke.h_against_plain(torch, "sphere_gs", data, b.to(dtype), x0.to(dtype), no_pin,
                                   x0.to(dtype), list(solver.obstacles), s, tag)


@pytest.mark.parametrize("name", ["floor_gs5k", "floor_uzawa67k"])
def test_h_forms_inside_and_beyond_shared_memory(cuda_device, name):
    solver = chip_smoke.landed_solver(torch, name)
    b, x0 = chip_smoke.first_solve(torch, solver)
    no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=cuda_device)
    for dtype, np_dtype, tag in ((torch.float32, np.float32, "f32"),
                                 (torch.float64, np.float64, "f64")):
        data = chip_smoke.gs_data_of(torch, solver.system, np_dtype)
        r = chip_smoke.h_against_plain(torch, name, data, b.to(dtype), x0.to(dtype), no_pin,
                                       x0.to(dtype), list(solver.obstacles), solver.m_settings,
                                       tag, graph=True)
        assert r["bitwise"] and r["graph_replay_bitwise"]
        beyond = name == "floor_uzawa67k" and tag == "f64"
        assert list(r["forms"]) == (["global"] if beyond else ["global", "shared"])


@pytest.mark.parametrize("name", ["contact_alpcg", "contact_alpcg_twogrid"])
def test_g_penalty_against_alcg_solve_plain(cuda_device, name):
    from admm_elastic_tpu_torch.solvers import pcg

    solver = chip_smoke.landed_solver(torch, name)
    s = solver.m_settings
    for dtype, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        data = (solver._solve_data if tag == "f32"
                else pcg.prepare(solver.system, dtype, precond=s.pcg_precond))
        hits, ck, b, x0, y = chip_smoke.gpen_inputs(torch, solver, dtype)
        y = y + 0.01  # a warm multiplier
        r = chip_smoke.gpen_against_plain(torch, name, data, hits, ck, b, x0, y, s, tag,
                                          graph=tag == "f32")
        assert r["hits"] > 0 and r["trips"] > 0


def test_g_as_uzawa_inner_against_plain(cuda_device):
    res, timing = chip_smoke.uzawa_inner_checks(torch)
    first = res["floor_uzawa67k"]
    assert first["f32"]["graph_replay_bitwise"] and first["f64"]["done_set_returns_x0"]
    assert first["active_rows"] > 0 and sorted(timing) == sorted(res)


# x after step 12 (just landed) against the golden, relative to max |x|: as
# the CPU tests hold the same scenes (tests/test_torch_contact_paths.py,
# test_torch_contact_inner.py), Uzawa's unconverged Schur CG at 3e-2.
LANDED_TOL = {"contact_gs": 1e-3, "contact_uzawa": 3e-2, "contact_uzawa_pcg": 3e-2,
              "contact_alpcg": 1e-3}


@pytest.mark.parametrize("name", sorted(LANDED_TOL))
def test_contact_graph_equals_eager_and_counts_inner_iterations(cuda_device, name):
    solver = chip_smoke.contact_scene(name, chip_smoke.torch_api("cuda"))
    g = chip_smoke.golden(name)
    state0 = solver.state.clone()
    graph_inner = []
    for _ in range(12):
        solver.step()
        graph_inner.append(solver.runtime_data().inner_iters)
    graph = solver.state.clone()
    assert int(graph.prev_active.sum()) > 0 or name == "contact_gs"
    solver.state = state0.clone()
    eager_inner = []
    for _ in range(12):
        solver._inner.zero_()
        solver._run_eager(1)
        eager_inner.append(int(solver._inner.item()))
    for f in ("x", "v", "y", "prev_active"):
        assert torch.equal(getattr(solver.state, f), getattr(graph, f)), f
    assert graph_inner == eager_inner
    assert all(k > 0 for k in graph_inner[10:])  # the landing steps
    x = graph.x.cpu().numpy()
    assert np.isfinite(x).all() and x[:, 1].min() > -1.1
    assert chip_smoke.rel_err(x, g["x12"]) < LANDED_TOL[name]
    assert chip_smoke.contacts(name, x) > 0
    solver.run(2)
    assert solver.runtime_data().inner_iters == 0
