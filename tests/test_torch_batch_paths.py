"""Scenario batches through the port's make_batched_step on the CPU against
the JAX package: crossval's batched_contact_alpcg (benchmarks/crossval.py:
183-203, 4 scenes, AL-PCG on the floor) over 8 steps, float64 tight against
the live JAX run and float32 at crossval's bounds; the batch goldens of the
card's paths (chip_smoke.BATCH_SCENES: the beam sweep, crossval's scene in
both precisions, the cloth sheet; the exact slab of tests/test_parallel.py
under AL-PCG to step 8) at chip_smoke.BATCH_STEP_TOL, each scene's overflow
the golden's; the full-width Uzawa and exact-slab batches
(chip_smoke.BATCH_WIDE) at step 1 and one step from the golden's stored batch
before step 12; a planted fault that the sheet's bound catches;
_debloat_for_throughput's choice in both packages on the four golden meshes.
(crossval's batched scene under Uzawa is held to its goldens beside the live
JAX run in tests/test_torch_batch_contact.py.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.parallel import batch as jb
from admm_elastic_tpu_torch.parallel import batch as tb
from make_torch_golden import jax_api
from test_torch_batch import _carry

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _port_rollout(name, steps=chip_smoke.BATCH_STEPS, step_fn=None):
    """The port's batch of a golden's scene and sweep on the CPU: x at the
    held steps and the last batch."""
    solver, scales, gravity = chip_smoke.batch_scene(name, chip_smoke.torch_api("cpu"))
    step = tb.make_batched_step(solver, mesh=None, donate=False)
    if step_fn is not None:
        step_fn(step)
    batch = tb.make_scenario_batch(solver, len(scales), stiffness_scale=scales, gravity=gravity)
    xs = {}
    for k in range(1, max(steps) + 1):
        batch = step(batch)
        if k in steps:
            xs[k] = batch.x.double().numpy()
    return xs, batch


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


# crossval's batched scene, port against the live JAX run from the same batch,
# relative to max |x| after steps 1..8: float64 measured 0 / 1.6e-15 (held as
# the single-scene AL-PCG float64 tests hold contact_alpcg_f64: 1e-12, 1e-11),
# float32 0 / 7.0e-8 (crossval's 1e-4, 2e-3).
CROSSVAL_BOUNDS = {np.float64: (1e-12, 1e-11), np.float32: (1e-4, 2e-3)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_crossval_batched_contact_alpcg_against_the_live_jax_run(dtype):
    name = "batched_contact_alpcg"
    js, scales, gravity = chip_smoke.batch_scene(name, jax_api(), dtype)
    ts, _, _ = chip_smoke.batch_scene(name, chip_smoke.torch_api("cpu"), dtype)
    jbatch = jb.make_scenario_batch(js, 4, stiffness_scale=scales, gravity=gravity)
    tbatch = _carry(jbatch, torch.float32 if dtype == np.float32 else torch.float64)
    jstep = jb.make_batched_step(js, mesh=None, donate=False)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    first, last = CROSSVAL_BOUNDS[dtype]
    for k in range(1, 9):
        jbatch, tbatch = jstep(jbatch), tstep(tbatch)
        err = _rel(tbatch.x.double().numpy(), np.asarray(jbatch.x, np.float64))
        assert err <= (first if k == 1 else last), (k, err)
    x = tbatch.x.double().numpy()
    assert x[..., 1].min() > chip_smoke.BATCH_FLOOR_BOUND
    assert not bool(tbatch.overflow.any())
    np.testing.assert_array_equal(tbatch.prev_active.numpy(), np.asarray(jbatch.prev_active))


@pytest.mark.parametrize("name", ["batch_beam_sweep8", "batched_contact_alpcg",
                                  "batched_contact_alpcg_f64", "batch_cloth_sweep4",
                                  "batch_exactmesh_alpcg"])
def test_batch_golden(name):
    """The port's CPU batch against the golden the card's path is held to,
    at the card's bounds (chip_smoke.BATCH_STEP_TOL), up to step 8 (the card
    holds batch_exactmesh_alpcg's step 30 too)."""
    g = chip_smoke.golden(name)
    steps = [k for k in chip_smoke.batch_steps(name) if k <= max(chip_smoke.BATCH_STEPS)]
    xs, batch = _port_rollout(name, steps)
    for k, bound in zip(steps, chip_smoke.BATCH_STEP_TOL[name]):
        assert np.isfinite(xs[k]).all()
        err = _rel(xs[k], g[f"x{k}"].astype(np.float64))
        assert err <= bound, (k, err, bound)
    assert not bool(batch.overflow.any()) and not g["overflow"].any()
    np.testing.assert_array_equal(g["scales"], chip_smoke.BATCH_SCENES[name]["scales"])


# The full-width batches on the CPU (one thread): step 1 from the start and one
# step from the golden's batch before step 12, against the golden; measured
# batch_floor_uzawa5k 1.8e-5 and 1.647e-3 (its one-ulp control 1.647e-3: the
# landing is a discrete event), batch_slab_exact_alpcg5k 3.2e-6 and 2.5e-6.
@pytest.mark.parametrize("name", chip_smoke.BATCH_WIDE)
def test_wide_batch_golden_step_1_and_one_step_at_12(name):
    g = chip_smoke.golden(name)
    tol = dict(zip(chip_smoke.batch_steps(name), chip_smoke.BATCH_STEP_TOL[name]))
    xs, batch = _port_rollout(name, (1,))
    assert _rel(xs[1], g["x1"].astype(np.float64)) <= tol[1]
    np.testing.assert_array_equal(batch.overflow.numpy(), g["ovf1"])
    solver, scales, gravity = chip_smoke.batch_scene(name, chip_smoke.torch_api("cpu"))
    step = tb.make_batched_step(solver, mesh=None, donate=False)
    dtype = batch.x.dtype
    start = tb.ScenarioBatch(
        **{f: torch.as_tensor(g[f"s12_{f}"]) for f in ("x", "v", "y", "prev_active", "overflow")},
        stiffness_scale=torch.as_tensor(scales, dtype=dtype),
        gravity=torch.as_tensor(gravity, dtype=dtype))
    out = step(start)
    err = _rel(out.x.double().numpy(), g["x12"].astype(np.float64))
    assert err <= tol[12], (err, float(g["ctl12_gap"]))
    np.testing.assert_array_equal(out.overflow.numpy(), g["ovf12"])
    if solver.m_settings.linsolver == 2:  # a Schur trip at least an ADMM iteration
        assert (step.trips.numpy() >= solver.m_settings.admm_iters).all()


def test_the_sheet_bound_catches_a_planted_fault():
    """The sheet's loosened step-8 bound (1e-2) still catches a planted
    fault: the rhs with the unscaled weights (W^2 = w^2, the sweep dropped
    from D^T W^2) leaves every bound."""
    name = "batch_cloth_sweep4"
    g = chip_smoke.golden(name)

    def plant(step):
        rhs = step._rhs
        step._rhs = lambda M_xbar, z, u, sq: rhs(M_xbar, z, u, torch.ones_like(sq))

    xs, _ = _port_rollout(name, step_fn=plant)
    for k, bound in zip(chip_smoke.BATCH_STEPS, chip_smoke.BATCH_STEP_TOL[name]):
        assert _rel(xs[k], g[f"x{k}"].astype(np.float64)) > bound


@pytest.mark.parametrize("name", ["batch_beam_sweep8", "batched_contact_alpcg",
                                  "batch_cloth_sweep4", "batch_lattice_stencil"])
def test_debloat_choice_is_the_jax_package_s(name):
    """_debloat_for_throughput rebuilds the same meshes in both packages
    (over 15 % stencil padding: the beam 34.9 %, crossval's 6x3x3 57.8 %;
    the sheet 4.8 % and the 20x20x20 lattice 9.4 % keep their stencils), the
    rebuilt families gather families with the JAX package's gather tables."""
    js, _, _ = chip_smoke.batch_scene(name, jax_api())
    ts, _, _ = chip_smoke.batch_scene(name, chip_smoke.torch_api("cpu"))
    jsys, tsys = jb._debloat_for_throughput(js, js.system), tb._debloat_for_throughput(
        ts, ts.system)
    assert (jsys is js.system) == (tsys is ts.system)
    rebuilt = tsys is not ts.system
    assert rebuilt == (name in ("batch_beam_sweep8", "batched_contact_alpcg"))
    padding = {"batch_beam_sweep8": 0.349, "batched_contact_alpcg": 0.578,
               "batch_cloth_sweep4": 0.048, "batch_lattice_stencil": 0.094}[name]
    assert tb._padding(ts.system) == tb._padding(js.system)
    assert abs(tb._padding(ts.system) - padding) < 5e-4
    for jf, tf in zip(jsys.tets + jsys.tris, tsys.tets + tsys.tris):
        assert (jf.stencil is None) == (tf.stencil is None) == rebuilt
        if rebuilt:
            np.testing.assert_array_equal(tf.gather_idx.numpy(), np.asarray(jf.gather_idx))
            np.testing.assert_array_equal(tf.inds.numpy(), np.asarray(jf.inds))
