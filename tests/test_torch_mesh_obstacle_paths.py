"""Mesh obstacles through the port's Solver on the CPU against the JAX
package's goldens (tests/make_torch_golden.py, chip_smoke.MESH_CPU_SCENES):
crossval's five mesh scenes (benchmarks/crossval.py:47-61: the 3x2x2 linear
body launched onto a slab, Gauss-Seidel), two of them with near_lanes=4 (the
colour passes' compaction engages and overflows), two compacted exact
obstacles under AL-PCG (the solver's own detection; one overflows) and one
scene in float64; 8 steps,
held at steps 1 and 8 to crossval's bounds (benchmarks/crossval.py:256-302:
1e-4 and 2e-3 of max |x|; float64 F64_BOUND), each step's inner iterations
and runtime_data().collision_overflow equal to the JAX package's, the
vertices in contact and no tunnelling. Then run(n)'s overflow over its
steps, and a mesh obstacle added after initialize: on the
device in the run dtype, the graph key changed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import PassiveMeshExact, PassiveMeshSDF

torch.set_num_threads(1)

STEP1_BOUND, STEP8_BOUND = 1e-4, 2e-3  # benchmarks/crossval.py
# float64: the port on the CPU against the JAX golden, measured at 3.6e-15 /
# 8.9e-15 (exactmesh_compact_gs_f64, steps 1 / 8); held at a hundred times that
F64_BOUND = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """chip_smoke's scenes need no Jacobi SVD here, but a file that shares
    the worker may have set it: the JAX package's default goes back after."""
    yield
    jprox.set_svd_impl("auto")


_RUNS = {}


def rollout(name):
    """The port's rollout of a mesh scene (once per module): x at the
    compared steps, each step's inner iterations and overflow flag."""
    if name not in _RUNS:
        chip_smoke.DEVICE = "cpu"
        solver = chip_smoke.contact_scene(name, chip_smoke.torch_api("cpu"))
        steps, compare = chip_smoke.contact_steps(name)
        xs, inner, overflow = {}, [], []
        for step in range(1, steps + 1):
            solver.step()
            inner.append(solver.runtime_data().inner_iters)
            overflow.append(solver.runtime_data().collision_overflow)
            if step in compare:
                xs[step] = solver.x
        _RUNS[name] = (solver, xs, inner, overflow)
    return _RUNS[name]


@pytest.mark.parametrize("name", chip_smoke.MESH_CPU_SCENES)
def test_mesh_scene_holds_crossval_s_bounds_against_the_golden(name):
    solver, xs, inner, overflow = rollout(name)
    g = chip_smoke.golden(name)
    compare = g["steps"].tolist()
    f64 = chip_smoke.CONTACT_SCENES[name].get("dtype") == np.float64
    for k, step in enumerate(compare):
        x = xs[step]
        assert np.isfinite(x).all()
        bound = F64_BOUND if f64 else (STEP1_BOUND if k == 0 else STEP8_BOUND)
        assert chip_smoke.rel_err(x, g[f"x{step}"]) < bound, (name, step)
        # no tunnelling: 10 cm under the slab's top, or the JAX package's own
        # deepest less a centimetre (the deep scene's launch)
        top = chip_smoke.obstacle_top(name)
        assert x[:, 1].min() > min(top - 0.1, float(g[f"x{step}"][:, 1].min()) - 0.01)
    assert chip_smoke.contacts(name, xs[compare[-1]]) == int(g["contacts"][-1]) > 0
    assert inner == g["inner"].tolist()
    assert overflow == g["overflow"].tolist()
    obs = solver._contact.obstacles[0]
    assert isinstance(obs, (PassiveMeshSDF, PassiveMeshExact))
    assert obs.near_lanes == chip_smoke.CONTACT_SCENES[name]["obstacle"]["bake"].get(
        "near_lanes", 0)


def test_a_detection_s_overflow_reaches_runtime_data():
    """AL-PCG detects once per ADMM iteration; with near_lanes=4 the exact
    slab's compaction drops lanes once the body lands: step() reports it per
    step as the JAX package does (its golden), run(n) once over its steps (the
    JAX package's run ORs its steps' flags)."""
    name = "exactmesh_alpcg4"
    g = chip_smoke.golden(name)
    assert not g["overflow"][0] and g["overflow"][-1]
    solver = chip_smoke.contact_scene(name, chip_smoke.torch_api("cpu"))
    state0 = solver.state.clone()
    solver.run(8)
    assert solver.runtime_data().collision_overflow
    solver.state = state0.clone()
    solver.run(1)
    assert not solver.runtime_data().collision_overflow
    last = int(np.flatnonzero(~g["overflow"])[-1]) + 1  # the last step with no overflow
    solver.state = state0.clone()
    solver.run(last)
    assert not solver.runtime_data().collision_overflow


def test_a_mesh_obstacle_added_after_initialize_is_placed_and_recaptures():
    chip_smoke.DEVICE = "cpu"
    api = chip_smoke.torch_api("cpu")
    solver = chip_smoke.contact_scene("exactmesh_compact_gs", api)
    key = solver._graph_key()
    assert solver._graph_key() == key  # the tables' ids, not copies: no capture per call
    extra = chip_smoke.mesh_obstacle(chip_smoke.CONTACT_SCENES["sdf_obstacle_gs"]["obstacle"], api)
    solver.add_obstacle(extra)
    placed = solver._contact.obstacles[-1]
    assert isinstance(placed, PassiveMeshSDF) and placed.vals4.dtype == torch.float32
    assert placed.minv.dtype == torch.float64  # its sign is what is read
    assert solver._graph_key() != key
    assert solver._graph_key() == solver._graph_key()
    assert solver._contact.gs_params is None  # kernel H's parameters: the card's only
    x = solver.x
    solver.step()
    assert np.isfinite(solver.x).all() and not np.array_equal(solver.x, x)
