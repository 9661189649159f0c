"""Solver.run(n) and step() as one captured CUDA graph, and the gather and
Cholesky paths, on a CUDA card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_graph.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the bench shapes). On the card:

- graph against eager: run(n) (graph replays) and Solver._run_eager(n) from
  one state, on the lattice beam, the gather beam, a sheet with wind and a
  renumbered sheet, float64 and float32: bitwise equal, or within
  chip_smoke.GRAPH_EAGER_TOL of max |x|;
- two graph rollouts from one state are bitwise equal;
- nothing goes stale: set_pins copies in place, the x and v setters and a
  new state take effect at the next run, a field assignment to the state,
  the wind or a batch raises (the classes are frozen), initialize() and a
  change of admm_iters, prox_newton_iters, refine_passes, timestep_s or
  gravity capture anew (the wrapper called by the warm-up step and the capture, the
  replays' launches counted on the device, chip_smoke.counted_window);
- a capture that fails raises, and nothing runs eagerly in its place;
- each path of chip_smoke.GATHER_SCENES against its golden;
- the one-tet goldens of tests/test_lineartet.py through the graph.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.forces import ExplicitForce, make_wind_force
from admm_elastic_tpu_torch.geometry.factory import make_plane, make_tet_blocks
from admm_elastic_tpu_torch.ops import cuda_local_step
from admm_elastic_tpu_torch.system.system import SimState

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _beam(device, dtype, lattice=True):
    mesh = make_tet_blocks(4, 2, 2)
    if not lattice:
        mesh.lattice_dims = None
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    s = Solver(device=device)
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, dtype=dtype))
    assert (s.system.tets[0].stencil is None) == (not lattice)
    return s


def _sheet(device, dtype, renumbered):
    """test_torch_cuda.py's 6x6 sheet under wind (colored and batched, no
    gravity), strain-limited, -x edge pinned; renumbered, its vertex ids
    permuted as chip_smoke.renumbered_sheet does, so that it is no grid."""
    mesh = make_plane(6, 6, size=2.0)
    verts, tris = mesh.vertices, mesh.faces
    masses = mesh.weighted_masses(1.0)
    pins = np.where(verts[:, 0] < -2.0 + 1e-9)[0]
    if renumbered:
        perm = np.random.default_rng(chip_smoke.RENUMBER_SEED).permutation(len(verts))
        v2, m2 = np.empty_like(verts), np.empty_like(masses)
        v2[perm], m2[perm] = verts, masses
        verts, tris, masses, pins = v2, perm[tris], m2, np.sort(perm[pins])
    s = Solver(device=device)
    s.add_nodes(verts, masses)
    lame = Lame.soft_rubber()
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s.add_tri_energies(verts, tris, lame)
    s.set_pins([int(i) for i in pins])
    t_dtype = torch.float32 if dtype == np.float32 else torch.float64
    s.add_explicit_force(make_wind_force(tris, (0.05, 0.1, 0.02), colored=True, device=device,
                                         dtype=t_dtype))
    s.add_explicit_force(make_wind_force(tris, (0.02, 0.05, 0.01), device=device, dtype=t_dtype))
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, dtype=dtype, gravity=0.0))
    assert (s.system.tris[0].stencil is None) == renumbered
    return s


SCENES = {
    "beam": lambda d, dt: _beam(d, dt),
    "beam_gather": lambda d, dt: _beam(d, dt, lattice=False),
    "sheet_wind": lambda d, dt: _sheet(d, dt, renumbered=False),
    "renumbered_sheet_wind": lambda d, dt: _sheet(d, dt, renumbered=True),
}


def _state(s):
    return s.state.clone()


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_graph_matches_eager_and_repeats(cuda_device, scene, dtype):
    s = SCENES[scene](cuda_device, dtype)
    state0 = _state(s)
    s.run(8)
    x_graph = s.state.x.clone()
    assert s._graph is not None and torch.isfinite(x_graph).all()
    s.state = state0.clone()
    s.run(8)
    assert torch.equal(s.state.x, x_graph)
    res = chip_smoke.graph_vs_eager(torch, scene, s, state0, 8, x_graph)
    assert res["bitwise"] or res["rel_err"] <= chip_smoke.GRAPH_EAGER_TOL


def test_step_and_run_share_the_graph(cuda_device):
    a, b = (_beam(cuda_device, np.float32) for _ in range(2))
    for _ in range(3):
        a.step()
    b.run(3)
    assert a._graph is not None and torch.equal(a.state.x, b.state.x)


def test_set_pins_copies_in_place(cuda_device):
    s = _beam(cuda_device, np.float64)
    s.run(1)
    graph, pins = s._graph, s.system.pins
    target_ptr = pins.target.data_ptr()
    idx = [int(i) for i in pins.idx.cpu().numpy()]
    tgt = s.x[idx] + np.array([0.1, 0.05, 0.0])
    s.set_pins(idx, tgt)
    assert s.system.pins is pins and pins.target.data_ptr() == target_ptr
    s.run(3)
    assert s._graph is graph
    assert np.abs(s.x[idx] - tgt).max() < 1e-3
    s.set_pins(idx[:2])  # the others let go
    s.run(1)
    assert s._graph is graph and not bool(pins.active[2:].any())


def test_setters_and_new_state_take_effect(cuda_device):
    s = _beam(cuda_device, np.float64)
    s.run(2)
    graph = s._graph
    rng = np.random.default_rng(9)
    xs = s.x + 0.02 * rng.standard_normal(s.x.shape)
    vs = 0.1 * rng.standard_normal(xs.shape)
    s.x, s.v = xs, vs
    s.run(1)
    x_graph = s.state.x.clone()
    assert s._graph is graph
    s.x, s.v = xs, vs
    s._run_eager(1)
    assert torch.allclose(s.state.x, x_graph, rtol=0, atol=1e-12)
    s.state = s.state.clone()  # a new state
    s.run(1)
    # the state after a run is a snapshot, never the graph's own buffers
    assert s._graph is graph and s.state.x is not graph.state.x
    kept = s.state
    x_kept = kept.x.clone()
    s.run(1)
    assert torch.equal(kept.x, x_kept)  # no replay wrote the kept state
    x_next = s.state.x.clone()
    s.state = kept
    s.run(1)
    assert s._graph is graph and torch.equal(s.state.x, x_next)  # restored bitwise


def test_frozen_state_and_the_setter_after_a_graph_run(cuda_device):
    """After a graph run the state is a snapshot, not the graph's buffers:
    assigning one of its fields (or a field of the wind or of a batch)
    raises, as in the JAX package, where before it went unseen by the
    replays; the x setter is honored by the next run(n), which then matches
    the eager loop from the same x and v."""
    s = _sheet(cuda_device, np.float64, renumbered=True)
    s.run(2)
    graph = s._graph
    assert s.state is not graph.state
    assert all(torch.equal(getattr(s.state, f), getattr(graph.state, f))
               for f in ("x", "v", "y", "prev_active"))
    wind, b = s.ext_forces[0], s.system.tris[0]
    for target, field, value in ((s.state, "x", s.state.x.clone()), (wind, "direction",
                                 wind.direction * 2), (wind, "alpha_n", 1.0),
                                 (b, "limit_min", b.limit_min.clone())):
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(target, field, value)
    x, v = s.x + 0.01, s.v
    s.x = x
    s.run(3)
    assert s._graph is graph
    x_graph = s.state.x.clone()
    state0 = SimState(x=torch.as_tensor(x, device=cuda_device),
                      v=torch.as_tensor(v, device=cuda_device), y=s.state.y.clone(),
                      prev_active=s.state.prev_active.clone())
    res = chip_smoke.graph_vs_eager(torch, "setter", s, state0, 3, x_graph)
    assert res["bitwise"] or res["rel_err"] <= chip_smoke.GRAPH_EAGER_TOL


@pytest.mark.parametrize("change", ["admm_iters", "prox_newton_iters", "refine_passes",
                                    "timestep_s", "gravity", "initialize", "explicit_force"])
def test_changes_capture_anew(cuda_device, change):
    s = _beam(cuda_device, np.float32)
    s.run(1)
    graph = s._graph
    if change == "initialize":
        assert s.initialize()
    elif change == "explicit_force":
        s.add_explicit_force(make_wind_force(np.array([[0, 1, 2]]), (0.1, 0.0, 0.0),
                                             device=cuda_device, dtype=torch.float32))
    else:
        value = dict(admm_iters=5, prox_newton_iters=4, refine_passes=1,
                     timestep_s=1.0 / 48.0, gravity=-4.9)[change]
        setattr(s.m_settings, change, value)
    before = cuda_local_step.local_step_tet_stencil.launches
    s.run(0)
    assert s._graph is not None and s._graph is not graph
    # the new capture's warm-up step and the capture call the wrapper; the
    # replays launch the captured kernel without it
    iters = s.m_settings.admm_iters
    assert cuda_local_step.local_step_tet_stencil.launches - before == 2 * iters
    key = "local_step_tet_stencil[neohookean]"
    chip_smoke.counted_window(torch, change, lambda: s.run(2), {key: 2 * iters})
    assert cuda_local_step.local_step_tet_stencil.launches - before == 2 * iters


class _SyncingForce(ExplicitForce):
    """A force that reads a value back to the host: no graph can hold it."""

    def project(self, dt, x, v, m):
        return v * float(v.abs().max().item() >= 0.0)


def test_failed_capture_raises(cuda_device):
    s = _beam(cuda_device, np.float32)
    s.add_explicit_force(_SyncingForce())
    x_before = s.x
    before = cuda_local_step.local_step_tet_stencil.launches
    with pytest.raises(RuntimeError, match="CUDA graph"):
        s.run(3)
    assert s._graph is None
    # the warm-up step ran (and counted), no step was taken eagerly instead
    assert cuda_local_step.local_step_tet_stencil.launches - before == 10
    np.testing.assert_array_equal(s.x, x_before)


@pytest.mark.parametrize("name", sorted(chip_smoke.GATHER_SCENES))
def test_gather_golden_on_card(cuda_device, name):
    s, g, pins = chip_smoke.make_gather_solver(name, device=cuda_device)
    s.step()
    x1 = s.x
    s.run(7)
    x8 = s.x
    assert chip_smoke.rel_err(x1, g["x1"]) < chip_smoke.STEP1_TOL
    assert chip_smoke.rel_err(x8, g["x8"]) < chip_smoke.STEP8_TOL
    for step, x in ((1, x1), (8, x8)):
        disp, tol = chip_smoke.disp_err(x, g, step)
        assert disp < tol, (step, disp)
    assert np.abs(x8[pins] - g["x0"][pins]).max() < 1e-3


def test_one_tet_goldens_through_the_graph(cuda_device):
    got = chip_smoke.one_tet_convergence(device=cuda_device)
    assert abs(got[93] - chip_smoke.ONE_TET_PULLED_X) < 1e-4
    chip_smoke.one_tet_inversion(device=cuda_device)
