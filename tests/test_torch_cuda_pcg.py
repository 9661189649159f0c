"""Kernel G (the whole PCG solve in one launch) and the ring stencil kernels
on a CUDA card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_pcg.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the PCG paths' full size). On the card:

- G against the plain solve_T on crossval's small scenes (chip_smoke's
  beam_pcg, torus_pcg, bunny_pcg) in every operator form and both
  preconditioners: float64 in the same trips within chip_smoke.PCG_F64_TOL
  (the bunny within PCG_F64_TOL_BUNNY), float32 within PCG_F32_TOL; twice
  bitwise; the trips added to the counter it is handed;
- G captured into a CUDA graph replays its eager launch bit for bit;
- each form of G (CLUSTER, GRID) bitwise equal to the other in as many
  trips, and against the plain solve_T, on a beam at the CLUSTER form's
  largest N (8,192 vertices: 16 blocks of 512) and on one just beyond it
  (8,704, the GRID form alone), float64 and float32, captured and replayed;
- a PCG solver's graph rollout bitwise equal to its eager loop, and step()
  reporting the step's trips from the device counter, 0 after run(n);
- kernels B and C on a ring lattice exactly equal to their plain versions,
  and A's ring stencil entry bitwise equal to B followed by the rows entry.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_pcg, cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.solvers import pcg

pytestmark = pytest.mark.cuda

SMALL = ("beam_pcg", "torus_pcg", "bunny_pcg")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


def _scene(name):
    solver, _ = chip_smoke.pcg_scene(name, chip_smoke.torch_api("cuda"))
    return solver


@pytest.mark.parametrize("fmt", ["auto", "ell", "bands"])
@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("name", SMALL)
def test_g_against_plain_solve_T(cuda_device, name, precond, fmt):
    solver = _scene(name)
    s = solver.m_settings
    b, x0 = chip_smoke.first_solve(torch, solver)
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        data = pcg.prepare(solver.system, dtype, precond=precond, spmv_format=fmt)
        chip_smoke.g_against_plain(torch, f"{name} {precond} {fmt}", data, b.to(dtype),
                                   x0.to(dtype), s.pcg_tol, s.pcg_max_iters, label)


def test_g_adds_its_trips_and_replays_in_a_graph(cuda_device):
    solver = _scene("torus_pcg")
    s = solver.m_settings
    b, x0 = chip_smoke.first_solve(torch, solver)
    trips = torch.full((1,), 7, dtype=torch.int32, device=cuda_device)
    cuda_pcg.pcg_solve(solver._solve_data, b, x0, s.pcg_tol, s.pcg_max_iters, trips)
    _, k = pcg.solve_T(solver._solve_data.apply_T, solver._solve_data.precondition_T(), b, x0,
                       s.pcg_tol, s.pcg_max_iters)
    assert abs(int(trips.item()) - 7 - k) <= max(2, 0.1 * k)
    _, out = chip_smoke.g_against_plain(torch, "torus_pcg", solver._solve_data, b, x0,
                                        s.pcg_tol, s.pcg_max_iters, "f32", graph=True)
    assert out["graph_replay_bitwise"]


# make_tet_blocks dims at and beyond the CLUSTER form's largest N: 16 x 16 x
# 32 = 8,192 vertices (one vertex a thread, 16 blocks of 512), 17 x 16 x 32
EDGE = {"inside": (15, 15, 31), "beyond": (16, 15, 31)}


@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("where", sorted(EDGE))
def test_g_forms_inside_and_beyond_the_cluster(cuda_device, monkeypatch, where, precond):
    name = f"beam_pcg_{where}"
    monkeypatch.setitem(chip_smoke.PCG_SCENES, name, dict(
        mesh="beam", dims=EDGE[where], settings=dict(linsolver=3, pcg_precond=precond)))
    solver = _scene(name)
    s = solver.m_settings
    b, x0 = chip_smoke.first_solve(torch, solver)
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        data = (solver._solve_data if dtype == torch.float32
                else pcg.prepare(solver.system, dtype, precond=precond))
        _, out = chip_smoke.g_against_plain(torch, name, data, b.to(dtype), x0.to(dtype),
                                            s.pcg_tol, s.pcg_max_iters, label,
                                            graph=label == "f32")
        assert list(out["forms"]) == (["grid", "cluster"] if where == "inside" else ["grid"])
        # 16 blocks: the CLUSTER form takes the shape but lost there, so it is
        # not chosen (cuda_pcg.CLUSTER_CHOSEN)
        assert out["form"] == "grid"
    if where == "inside":
        assert cuda_pcg.blocks_of(solver._solve_data, torch.float32, "cluster") == (
            "cluster", 16, 512)
    else:
        with pytest.raises(ValueError):
            cuda_pcg.form_of(solver._solve_data, torch.float32, "cluster")


@pytest.mark.parametrize("name", ["beam_pcg_f64", "torus_pcg"])
def test_pcg_solver_graph_equals_eager_and_counts_trips(cuda_device, name):
    solver = _scene(name)
    state0 = solver.state.clone()
    trips = []
    for _ in range(3):
        solver.step()
        trips.append(solver.runtime_data().inner_iters)
    assert all(t > 0 for t in trips)
    x_graph = solver.state.x.clone()
    solver.state = state0.clone()
    solver._run_eager(3)
    assert torch.equal(solver.state.x, x_graph)
    solver.run(2)
    assert solver.runtime_data().inner_iters == 0
    if name.endswith("f64"):  # the golden's trips, float64
        assert trips == chip_smoke.golden(name)["trips"][:3].tolist()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ring,off", [((12, 4), 0), ((6, 2), 5)])
def test_ring_kernels_against_plain(cuda_device, ring, off, dtype):
    mesh, b = chip_smoke.ring_batch(torch, dtype, ring, off)
    n = off + len(mesh.vertices) + 2
    rng = np.random.default_rng(11)
    verts = np.concatenate([np.zeros((off, 3)), mesh.vertices, np.zeros((2, 3))])
    x = torch.as_tensor(verts + 0.002 * rng.standard_normal(verts.shape), device=cuda_device,
                        dtype=dtype)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), device=cuda_device, dtype=dtype)
            for _ in range(2))
    dx = cuda_stencil.tet_Dx_rows(x, b)
    assert torch.equal(dx, st.tet_Dx_rows_plain(x, b))
    want = st.tet_rhs_rows_plain(z, u, b, n)
    for branch in ("tiled", "wide"):
        assert torch.equal(cuda_stencil.tet_rhs_rows(z, u, b, n, branch=branch), want)
    u_small = 0.05 * u
    fused = cuda_local_step.local_step_tet_stencil(x, u_small, b)
    two = cuda_local_step.local_step_tet_hyper(dx, u_small, b.mu, b.lam, b.kappa, b.bulk,
                                               model=b.model)
    for a, c in zip(fused, two):
        assert torch.isfinite(a).all() and torch.equal(a, c)
