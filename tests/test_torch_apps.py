"""The port's demo apps (admm_elastic_tpu_torch/apps/) against the JAX
package's apps/ on the CPU.

- each run of chip_smoke.APP_RUNS (beams, trianglestrain, bunnyexpand point
  and rand, signorini on a floor, an SDF slab and an exact slab, torus,
  boxes): the port's scene, built by the app's builder in float64, equals the
  JAX app's, taken from its main() with run() replaced (nothing stepped, no
  step compiled): settings, positions (bunnyexpand's collapse and scramble
  included), velocities, masses, pins, every batch's tables, the obstacles,
  the colliders and the query set, bit for bit;
- without --cpu on a machine with no card every app raises RuntimeError;
- set_pins reads x only where the targets are taken from it, and a beams run
  with per-frame set_pins keeps its bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import make_torch_golden

from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch.apps.beams import pin_targets
from admm_elastic_tpu_torch.solver import Solver

torch.set_num_threads(1)

SETTINGS = ("timestep_s", "verbose", "admm_iters", "gravity", "linsolver", "constraint_w",
            "gs_max_iters", "gs_tol", "gs_omega", "uzawa_max_iters", "uzawa_tol", "uzawa_inner",
            "pcg_max_iters", "pcg_tol", "pcg_precond", "direct_mode", "prox_newton_iters")


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """Nothing here steps the JAX package; its SVD setting is handed back as
    it was found all the same."""
    yield
    jprox.set_svd_impl("auto")


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _eq(got, want, what):
    if got is None or want is None or isinstance(got, (str, int, float, bool, tuple)):
        assert got == want or (got is None and want is None), what
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), what


def _fields_eq(port, jax_obj, what, skip=()):
    """Every dataclass field of the port's object against the JAX object's
    attribute of the same name."""
    assert type(port).__name__ == type(jax_obj).__name__, what
    for f in dataclasses.fields(port):
        if f.name in skip or not f.compare:
            continue
        _eq(getattr(port, f.name), getattr(jax_obj, f.name, None), f"{what}.{f.name}")


def jax_scene(name):
    """The JAX app's initialized solver (float64: tests/conftest.py turns
    jax_enable_x64 on), its run() replaced by one that steps nothing."""
    got = make_torch_golden.jax_app(name, lambda s, cb, f: np.asarray(s.x)[None], frames=1)
    return got


@pytest.mark.parametrize("name", list(chip_smoke.APP_RUNS))
def test_scene_equals_the_jax_apps(name):
    js = jax_scene(name)
    scene = chip_smoke.app_scene(name, device="cpu", dtype=np.float64)
    p, j = scene.solver, js["solver"]
    for f in SETTINGS:
        if f != "verbose":
            assert getattr(p.m_settings, f) == getattr(j.m_settings, f), f
    assert p.requested_linsolver == j.requested_linsolver
    assert type(p._solve_data).__name__ == type(j._solve_data).__name__
    for f in ("x", "v", "y", "prev_active"):
        _eq(getattr(p.state, f), getattr(j.state, f), f"state.{f}")
    _eq(p.system.masses, j.system.masses, "masses")
    assert p.system.dt == j.system.dt
    assert len(p.system.tets) == len(j.system.tets) and len(p.system.tris) == len(j.system.tris)
    for k, (pb, jb) in enumerate(zip(p.system.tets + p.system.tris,
                                     j.system.tets + j.system.tris)):
        _fields_eq(pb, jb, f"batch {k}")
    if j.system.pins is None:
        assert p.system.pins is None
    else:
        _fields_eq(p.system.pins, j.system.pins, "pins", skip=("gather_idx",))
    _eq(p._contact.pin_mask, j._pin_mask, "pin_mask")
    _eq(p._contact.pin_target, j._pin_target, "pin_target")
    assert sorted(p.surface_inds) == sorted(j.surface_inds)
    _eq(p._contact.surf, j._surf_inds_dev, "query set")
    assert len(p.obstacles) == len(j.obstacles)
    for k, (po, jo) in enumerate(zip(p._contact.obstacles, j.obstacles)):
        _fields_eq(po, jo, f"obstacle {k}")
    assert len(p.colliders) == len(j.colliders)
    for k, (pc, jc) in enumerate(zip(p.colliders, j.colliders)):
        _fields_eq(pc, jc, f"collider {k}")
    assert scene.floor_y == js["floor_y"]
    assert (scene.sim_cb is None) == (js["sim_cb"] is None)
    assert len(scene.surfaces) == len(js["surfaces"])
    for (po, pn, pf), (jo, jn, jf) in zip(scene.surfaces, js["surfaces"]):
        assert (po, pn) == (jo, jn) and np.array_equal(pf, jf)


@pytest.mark.parametrize("module", sorted({m for m, _ in chip_smoke.APP_RUNS.values()}))
def test_app_without_cpu_raises_where_there_is_no_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the app would run on it")
    mod = chip_smoke.app_module(next(n for n, (m, _) in chip_smoke.APP_RUNS.items()
                                     if m == module))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--frames", "1", "-v", "0"])


def _beams(dtype=np.float32):
    return chip_smoke.app_scene("beams", device="cpu", dtype=dtype)


def test_set_pins_reads_x_only_for_targets_taken_from_it(monkeypatch):
    scene = _beams()
    s, pins, points = scene.solver, scene.extra["pins"], scene.extra["points"]
    reads = []
    x_prop = Solver.x

    def counted(self):
        reads.append(1)
        return x_prop.fget(self)

    monkeypatch.setattr(Solver, "x", property(counted, x_prop.fset))
    s.set_pins(pins, list(points + 0.01))
    assert reads == []
    assert np.array_equal(s.system.pins.target[np.argsort(np.argsort(pins))].numpy(),
                          (points + 0.01).astype(np.float32))
    s.set_pins(pins)
    assert reads == [1]


def test_beams_with_per_frame_set_pins_keeps_its_bits():
    """Three frames of the beams app as it runs against the same frames with
    x read before every set_pins, as set_pins itself did before it read x only
    for targets taken from it: the same bits."""
    runs = []
    for read_first in (False, True):
        scene = _beams()
        xs = []
        for f in range(3):
            if read_first:
                scene.solver.x
            scene.sim_cb(f)
            scene.solver.step()
            xs.append(scene.solver.x)
        runs.append(np.stack(xs))
    assert np.array_equal(runs[0], runs[1])
    e = _beams().extra
    want = pin_targets(e, 1.0 / 24.0, 3)
    assert np.abs(runs[0][-1][e["pins"]] - want).max() < chip_smoke.APP_PIN_TOL
