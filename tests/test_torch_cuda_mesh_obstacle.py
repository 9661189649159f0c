"""Kernel J (a mesh obstacle's detection in one launch) and kernel H's sweeps
against the mesh obstacles on a CUDA card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_mesh_obstacle.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the paths' full size). On the card, on crossval's small mesh scenes
(chip_smoke.CONTACT_SCENES):

- J against the plain signed_distance_with_overflow (chip_smoke.j_case:
  bitwise in float64 and float32, the overflow flags equal, twice the same
  bits) at the golden's states, dense, compacted and overflowing, and on
  the deep scene's first x_bar with the fallback and with its overflow; on
  grids capped at 1-4 blocks, with near_lanes at a block boundary's near
  count and one below it, and with the deep lanes one a block (the ranking
  across blocks);
- H with each mesh kind against the plain gs.solve (chip_smoke.
  h_against_plain: bitwise in float64 and float32, in the same sweeps,
  every form bitwise the chosen one, captured and replayed; the exact walk
  at every group size, bitwise the chosen run);
- the captured rollout of a GS and an AL-PCG mesh scene bitwise equal to
  its eager loop, with each step's overflow flag read outside the graph.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


J_SCENES = ("sdf_obstacle_gs", "exactmesh_obstacle_gs")


@pytest.mark.parametrize("near_lanes", [0, 30, 2])  # dense, compacted, overflowing
@pytest.mark.parametrize("name", J_SCENES)
def test_kernel_j_against_its_plain_version(cuda_device, name, near_lanes):
    obs = chip_smoke.mesh_obstacle(chip_smoke.CONTACT_SCENES[name]["obstacle"],
                                   chip_smoke.torch_api())
    obs = dataclasses.replace(obs, near_lanes=near_lanes)
    g = chip_smoke.golden(name)
    for step in g["steps"].tolist():
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            x = torch.as_tensor(np.asarray(g[f"x{step}"], np.float64)).to(cuda_device, dtype)
            res = chip_smoke.j_case(torch, f"{name}@{step}", obs, x, tag)
            assert res["overflow"] == (near_lanes == 2 and step == 8)


@pytest.mark.parametrize("fallback_lanes", [256, 2])
def test_kernel_j_deep_fallback(cuda_device, fallback_lanes):
    solver = chip_smoke.contact_scene("exactmesh_deep_gs", chip_smoke.torch_api())
    _, x_bar = chip_smoke.first_solve(torch, solver)
    obs = dataclasses.replace(solver._contact.obstacles[0], fallback_lanes=fallback_lanes)
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        res = chip_smoke.j_case(torch, "deep", obs, x_bar.to(dtype), tag)
        assert res["hits"] > 0 and res["overflow"] == (fallback_lanes == 2)


@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
@pytest.mark.parametrize("name", J_SCENES)
def test_kernel_j_ranks_across_blocks(cuda_device, name, blocks):
    obs = chip_smoke.mesh_obstacle(chip_smoke.CONTACT_SCENES[name]["obstacle"],
                                   chip_smoke.torch_api())
    g = chip_smoke.golden(name)
    x = np.asarray(g[f"x{g['steps'].tolist()[-1]}"], np.float64)
    grid = min(blocks, -(-len(x) // 16))  # cuda_obstacle.j_grid: 16 lanes a block at least
    span = -(-len(x) // grid)
    if name == "exactmesh_obstacle_gs":
        near = chip_smoke.j_near_mask(torch, obs, x)
        edge = int(near[:span].sum())  # the near lanes before block 1
        ks = [0, 30, edge, max(edge - 1, 1)]
    else:
        ks = [0, 30, 2]
    for k in ks:
        o = dataclasses.replace(obs, near_lanes=k)
        for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
            res = chip_smoke.j_case(torch, f"{name} blocks{blocks} near{k}", o,
                                    torch.as_tensor(x).to(cuda_device, dtype), tag,
                                    blocks=blocks)
            assert res["bitwise"] and res["blocks"] == grid


@pytest.mark.parametrize("fallback_lanes", [256, 2])
def test_kernel_j_serves_deep_lanes_in_several_blocks(cuda_device, fallback_lanes):
    solver = chip_smoke.contact_scene("exactmesh_deep_gs", chip_smoke.torch_api())
    _, x_bar = chip_smoke.first_solve(torch, solver)
    deep = solver._contact.obstacles[0]
    x, nb = chip_smoke.j_spread_deep(torch, deep, x_bar.double().cpu().numpy())
    obs = dataclasses.replace(deep, near_lanes=0, fallback_lanes=fallback_lanes)
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        res = chip_smoke.j_case(torch, "deep spread", obs, torch.as_tensor(x).to(cuda_device, dtype),
                                tag, blocks=nb)
        assert res["bitwise"] and res["overflow"] == (fallback_lanes == 2)
        assert res["hits"] == (nb if fallback_lanes > nb else fallback_lanes)


@pytest.mark.parametrize("name", ["sdf_obstacle_gs4", "exactmesh_gs4", "exactmesh_deep_gs"])
def test_h_with_a_mesh_obstacle_against_plain_gs_solve(cuda_device, name):
    solver = (chip_smoke.contact_scene(name, chip_smoke.torch_api())
              if name == "exactmesh_deep_gs" else chip_smoke.landed_solver(torch, name))
    b, x0 = chip_smoke.first_solve(torch, solver)
    no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=cuda_device)
    s = solver.m_settings
    obstacles = list(solver.obstacles)
    r32 = chip_smoke.h_against_plain(torch, name, solver._solve_data, b, x0, no_pin, x0,
                                     obstacles, s, "f32", graph=True, bitwise=True)
    r64 = chip_smoke.h_against_plain(torch, name, chip_smoke.gs_data64(torch, solver),
                                     b.double(), x0.double(), no_pin, x0.double(), obstacles, s,
                                     "f64", bitwise=True)
    assert r32["graph_replay_bitwise"] and r64["sweeps"] == r64["plain_sweeps"]
    exact = name != "sdf_obstacle_gs4"
    assert ("group 8" in r32.get("variants", {})) == exact  # every group size, bitwise


@pytest.mark.parametrize("name", ["exactmesh_compact_gs", "exactmesh_compact_alpcg"])
def test_mesh_graph_rollout_is_the_eager_loop(cuda_device, name):
    solver = chip_smoke.contact_scene(name, chip_smoke.torch_api())
    state0 = solver.state.clone()
    solver.run(8)
    graph = solver.state.clone()
    ovf_graph = solver.runtime_data().collision_overflow
    solver.state = state0.clone()
    solver._run_eager(8)
    for f in ("x", "v", "y", "prev_active"):
        assert torch.equal(getattr(graph, f), getattr(solver.state, f)), f
    assert ovf_graph == bool(solver._overflow.item())
    g = chip_smoke.golden(name)
    assert chip_smoke.rel_err(graph.x.cpu().numpy(), g["x8"]) < 2e-3
