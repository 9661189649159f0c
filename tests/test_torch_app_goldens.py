"""The port's demo apps in float32 on the CPU against their goldens
(tests/data/torch_port_golden_app_<name>.npz: the JAX package's apps/ in
float32 on its Jacobi SVD, written by tests/make_torch_golden.py), as
chip_smoke.py holds them on the card:

- beams and trianglestrain: x after steps 1 and 8 within crossval's 1e-4 and
  2e-3 of max |x| (chip_smoke.APP_STEPS_TOL), beams' pins on their moving
  targets (chip_smoke.app_trajectory_holds);
- the contact apps (signorini on each obstacle, torus, boxes): x after step 1
  within chip_smoke.APP_FIRST_TOL, and each later held step (the first
  contact, the first dynamic hit, the last) one step from the golden's state
  before it within chip_smoke.APP_ONESTEP, the golden's last step above the
  floor's bound;
- bunnyexpand (the point collapse) and bunnyexpand_rand (the scramble): each
  held step one step from the golden's state within chip_smoke.APP_ONESTEP,
  finite (their float64 holds: tests/test_torch_bunnyexpand_f64.py);
- the goldens' own bookkeeping: the held steps are those app_held_steps
  finds in the golden's trajectory, and bunnyexpand's one-step bounds lie
  below the golden's own steps, so that a step that left x where it was
  fails them.
"""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

TRAJECTORY = ("beams", "trianglestrain")
# the mesh obstacles' bakes and boxes' self-collision sweeps take the most CPU
# time: tests/test_torch_app_contact_goldens.py holds them
SLOW = ("signorini_sdf", "signorini_exact", "boxes")
ONE_STEP = [n for n in chip_smoke.APP_RUNS if n not in TRAJECTORY + SLOW]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


@pytest.mark.parametrize("name", TRAJECTORY)
def test_trajectory_holds_its_golden(name):
    g = chip_smoke.golden(f"app_{name}")
    scene = chip_smoke.app_scene(name)
    assert np.array_equal(scene.solver.x.astype(np.float32), g["x0"])
    xs = []
    for f in range(max(chip_smoke.APP_STEPS)):
        if scene.sim_cb is not None:
            scene.sim_cb(f)
        scene.solver.step()
        xs.append(scene.solver.x)
    gaps, off = chip_smoke.app_trajectory_holds(name, xs, g, scene.extra,
                                                scene.solver.m_settings.timestep_s)
    assert all(gap <= tol for gap, tol in zip(gaps.values(), chip_smoke.APP_STEPS_TOL)), gaps
    assert (off is not None) == (name == "beams")


def one_step_holds(name):
    g = chip_smoke.golden(f"app_{name}")
    held = [int(k) for k in g["steps"]]
    assert sorted(chip_smoke.APP_ONESTEP[name]) == (held[1:] if name in chip_smoke.APP_CONTACT
                                                   else held)
    scene = chip_smoke.app_scene(name)
    assert np.array_equal(scene.solver.x.astype(np.float32), g["x0"])
    if name in chip_smoke.APP_CONTACT:
        scene.solver.step()
        assert chip_smoke.rel_err(scene.solver.x, g["x1"]) <= chip_smoke.APP_FIRST_TOL
        held = held[1:]
        assert float(g[f"x{held[-1]}"][:, 1].min()) > chip_smoke.APP_FLOOR_BOUND
    got = chip_smoke.app_one_steps(torch, name, g, held, scene)
    assert all(r["finite"] and r["rel_err"] <= r["bound"] for r in got.values()), got


@pytest.mark.parametrize("name", ONE_STEP)
def test_one_step_holds_its_golden(name):
    one_step_holds(name)


@pytest.mark.parametrize("name", list(chip_smoke.APP_RUNS))
def test_golden_held_steps(name):
    """The held steps of each golden are app_held_steps of its own
    trajectory: 1, 8 without contact; 1, the first step with a vertex on the
    floor, the first dynamic hit and the last with contact."""
    g = chip_smoke.golden(f"app_{name}")
    assert int(g["n_steps"]) == chip_smoke.APP_FRAMES
    held = [int(k) for k in g["steps"]]
    assert held[0] == 1 and held == sorted(set(held))
    if name in chip_smoke.APP_CONTACT:
        assert held[-1] == chip_smoke.APP_FRAMES
        touch = float(g[f"x{held[1]}"][:, 1].min())
        hits = [int(h) for h in g["hits"]]
        first_hit = next((k + 1 for k, h in enumerate(hits) if h > 0), None)
        assert touch <= chip_smoke.APP_FLOOR + chip_smoke.CONTACT_EPS or held[1] == first_hit
    else:
        assert held == list(chip_smoke.APP_STEPS)
    if name in chip_smoke.APP_F64:  # bunnyexpand's bounds lie below its golden's own steps
        for k, bound in chip_smoke.APP_ONESTEP[name].items():
            assert bound < chip_smoke.rel_err(g[f"s{k}_x"], g[f"x{k}"]), (name, k)
