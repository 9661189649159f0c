"""Faults of the port repaired, against the JAX package on the CPU.

- The state, system, batch, solve-data and wind dataclasses are frozen, as
  the JAX package's are: an assignment to a field of one of them (which a
  captured step would not see: it reads the buffers it was captured with)
  raises dataclasses.FrozenInstanceError in both packages, and the supported
  ways to change them (the x / v setters, set_pins, dataclasses.replace)
  still work.
- Solver.x set before initialize replaces the staged positions in both
  packages; the first step from them agrees (float64, 1e-9 relative).
- cloth_gather_wind40 (chip_smoke.GATHER_SCENES): the 40x40 sheet under
  colored wind, renumbered so that it is no grid, 8 steps in float32 and
  float64 in both packages: finite, within 1e-4 after one step and 2e-3
  after eight of each other (float64: 1e-9), and the port's, mapped back,
  within the same bounds of the grid sheet's golden (cloth_wind40).

The JAX side takes the Jacobi SoA prox (set_svd_impl("jacobi")), the same
body as the port's kernels.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_solver import _rel

from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.forces import make_wind_force as j_wind
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_blocks
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.forces import make_wind_force
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

torch.set_num_threads(1)

WIND = (0.05, 0.1, 0.02)
BOUNDS = {np.float32: (chip_smoke.STEP1_TOL, chip_smoke.STEP8_TOL), np.float64: (1e-9, 1e-9)}


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _scene(jax_side):
    """A 2x1x1 neo-Hookean beam with its -x face pinned, and a 2x2 sheet
    beside it (vertex offset 12) under colored wind, float64, initialized:
    every frozen class has an instance."""
    pkg = dict(L=JLame, S=JSolver, Settings=JSettings, bind=jbind, blocks=j_blocks) if jax_side \
        else dict(L=Lame, S=lambda: Solver(device="cpu"), Settings=Settings, bind=binding,
                  blocks=make_tet_blocks)
    mesh = pkg["blocks"](2, 1, 1)
    mesh.flags = pkg["bind"].NOSELFCOLLISION | pkg["bind"].NEOHOOKEAN
    s = pkg["S"]()
    pkg["bind"].add_tetmesh(s, mesh, pkg["L"].soft_rubber(), verbose=False)
    verts, tris, masses, _ = chip_smoke.cloth_sheet(2, 2)
    verts = verts + np.array([5.0, 0.0, 0.0])
    off = len(mesh.vertices)
    s.add_nodes(verts, masses)
    s.add_tri_energies(verts, tris, pkg["L"].from_youngs_poisson(10000000, 0.399),
                       vertex_offset=off)
    wind = (j_wind(tris + off, WIND, colored=True) if jax_side else
            make_wind_force(tris + off, WIND, colored=True, device="cpu", dtype=torch.float64))
    s.add_explicit_force(wind)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize(pkg["Settings"](verbose=0, admm_iters=10, linsolver=0,
                                        dtype=np.float64, gravity=-9.8))
    return s, wind


ASSIGNMENTS = {
    "state.x": lambda s, w: setattr(s.state, "x", s.state.x),
    "state.v": lambda s, w: setattr(s.state, "v", s.state.v),
    "wind.direction": lambda s, w: setattr(w, "direction", w.direction),
    "wind.alpha_n": lambda s, w: setattr(w, "alpha_n", 1.0),
    "TetBatch.mu": lambda s, w: setattr(s.system.tets[0], "mu", s.system.tets[0].mu),
    "TriBatch.limit_min": lambda s, w: setattr(s.system.tris[0], "limit_min",
                                               s.system.tris[0].limit_min),
    "PinBatch.target": lambda s, w: setattr(s.system.pins, "target", s.system.pins.target),
    "System.dt": lambda s, w: setattr(s.system, "dt", 0.5),
    "DirectData.mat": lambda s, w: setattr(s._solve_data, "mat", s._solve_data.mat),
}


@pytest.fixture(scope="module")
def scenes():
    return {"port": _scene(False), "jax": _scene(True)}


@pytest.mark.parametrize("what", sorted(ASSIGNMENTS))
@pytest.mark.parametrize("side", ["port", "jax"])
def test_field_assignment_raises(scenes, side, what):
    s, wind = scenes[side]
    with pytest.raises(dataclasses.FrozenInstanceError):
        ASSIGNMENTS[what](s, wind)


def test_supported_changes_still_work():
    s, _ = _scene(False)
    s.run(1)
    x = s.x + 0.01
    s.x, s.v = x, np.zeros_like(x)
    np.testing.assert_array_equal(s.x, x)
    pins = s.system.pins
    idx = [int(i) for i in pins.idx.numpy()]
    s.set_pins(idx, s.x[idx] + 0.1)
    assert s.system.pins is pins
    np.testing.assert_array_equal(pins.target.numpy(), s.x[idx] + 0.1)
    b = s.system.tets[0]
    assert dataclasses.replace(b, mu=b.mu * 2).mu[0] == 2 * b.mu[0]
    s.run(1)
    assert np.isfinite(s.x).all()


def _staged(side):
    """The 4x2x2 beam with x set before initialize to a perturbed rest pose
    (pins then take their targets from it), float64."""
    mesh = (j_blocks if side == "jax" else make_tet_blocks)(4, 2, 2)
    bind = jbind if side == "jax" else binding
    mesh.flags = bind.NOSELFCOLLISION | bind.NEOHOOKEAN
    s = JSolver() if side == "jax" else Solver(device="cpu")
    bind.add_tetmesh(s, mesh, (JLame if side == "jax" else Lame).soft_rubber(), verbose=False)
    x = mesh.vertices + 0.01 * np.random.default_rng(7).standard_normal(mesh.vertices.shape)
    s.x = x
    np.testing.assert_array_equal(np.asarray(s.x), x)
    assert len(s.masses) == len(x)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize((JSettings if side == "jax" else Settings)(
        verbose=0, admm_iters=10, linsolver=0, dtype=np.float64))
    np.testing.assert_array_equal(np.asarray(s.x), x)
    s.step()
    return np.asarray(s.x), x


def test_x_before_initialize_replaces_the_staged_positions():
    port, x0 = _staged("port")
    jax_x, _ = _staged("jax")
    assert _rel(port, jax_x) < 1e-9
    assert _rel(port, x0) > 1e-4  # the step moved it


def _wind_sheet(side, dtype):
    """cloth_gather_wind40 (chip_smoke.make_gather_solver's scene) in either
    package and precision; returns (solver, perm)."""
    c = chip_smoke.CLOTH_SCENES["cloth_wind40"]
    verts, tris, masses, pins, perm = chip_smoke.renumbered_sheet(c["nx"], c["ny"])
    jax_side = side == "jax"
    s = JSolver() if jax_side else Solver(device="cpu")
    s.add_nodes(verts, masses)
    s.add_tri_energies(verts, tris, (JLame if jax_side else Lame).from_youngs_poisson(
        10000000, 0.399))
    s.add_explicit_force(
        j_wind(tris, c["wind"], dtype=dtype, colored=True) if jax_side else make_wind_force(
            tris, c["wind"], colored=True, device="cpu",
            dtype=torch.float64 if dtype == np.float64 else torch.float32))
    s.set_pins([int(i) for i in pins])
    assert s.initialize((JSettings if jax_side else Settings)(
        verbose=0, admm_iters=10, linsolver=0, dtype=dtype, gravity=c["gravity"]))
    return s, perm


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_wind_sheet_matches_jax(dtype):
    runs = {}
    for side in ("port", "jax"):
        s, perm = _wind_sheet(side, dtype)
        assert s.system.tris[0].stencil is None and len(s.ext_forces) == 1
        xs = []
        for _ in range(8):
            s.step()
            xs.append(np.asarray(s.x))
        runs[side] = xs
    port, jax_x = runs["port"], runs["jax"]
    assert np.isfinite(port[-1]).all() and np.isfinite(jax_x[-1]).all()
    b1, b8 = BOUNDS[dtype]
    e1, e8 = _rel(port[0], jax_x[0]), _rel(port[-1], jax_x[-1])
    assert e1 < b1 and e8 < b8, (e1, e8)
    grid = chip_smoke.golden("cloth_wind40")
    assert _rel(port[0][perm], grid["x1"]) < chip_smoke.STEP1_TOL
    assert _rel(port[-1][perm], grid["x8"]) < chip_smoke.STEP8_TOL
    assert _rel(port[-1][perm], grid["x0"]) > 1e-3  # the sheet moved
