"""Scenario batching (parallel/batch.py) on the CPU against the JAX package:
each batched test of tests/test_parallel.py ported at its own sizes and
tolerances, the JAX package's batch carried across
(convert.scenario_batch_from_numpy) and stepped by both packages (Uzawa and a
compacted exact mesh obstacle among them); a mesh of several devices raises
NotImplementedError naming ROADMAP Queue 1 item 12b, and make_sim_mesh
without devices raises where there is no CUDA device;
the scaled PCG operator against the JAX package's diag(scale) and
apply(scale); the plain G twin's per-scene exit against jax.vmap of the JAX
solve_T, trips per scene; the uses_sweep switch; the batch's round trip.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.parallel import batch as jb
from admm_elastic_tpu.solvers import pcg as jpcg
from admm_elastic_tpu_torch import convert
from admm_elastic_tpu_torch.parallel import batch as tb
from admm_elastic_tpu_torch.solvers import pcg as tpcg

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _jax_api():
    from admm_elastic_tpu import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry import mesh as jmesh
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_tet_bunny_like, make_xform

    return types.SimpleNamespace(Solver=Solver, Settings=Settings, Lame=Lame, binding=binding,
                                 make_tet_blocks=make_tet_blocks, Floor=Floor,
                                 make_tet_bunny_like=make_tet_bunny_like, make_xform=make_xform,
                                 lumped_masses_tet=jmesh.lumped_masses_tet, asarray=jnp.asarray,
                                 batch=jb)


def _torch_api():
    from admm_elastic_tpu_torch.geometry import mesh as tmesh
    from admm_elastic_tpu_torch.geometry.factory import make_tet_bunny_like

    return types.SimpleNamespace(**vars(chip_smoke.torch_api("cpu")),
                                 make_tet_bunny_like=make_tet_bunny_like,
                                 lumped_masses_tet=tmesh.lumped_masses_tet, batch=tb)


def _small_solver(api):
    """tests/test_parallel.py:8-19 (float64: the JAX package's default under
    tests/conftest.py's x64)."""
    mesh = api.make_tet_blocks(2, 1, 1)
    mesh.flags = api.binding.NOSELFCOLLISION | api.binding.LINEAR
    solver = api.Solver()
    api.binding.add_tetmesh(solver, mesh, api.Lame.from_youngs_poisson(1e6, 0.3), verbose=False)
    solver.set_pins([0])
    assert solver.initialize(api.Settings(verbose=0, admm_iters=5, linsolver=3,
                                          dtype=np.float64))
    return solver


def _drop_box_solver(api, linsolver, floor_y=-0.75):
    """tests/test_contact.py:29-45."""
    mesh = api.make_tet_blocks(1, 1, 1)
    solver = api.Solver()
    solver.add_nodes(mesh.vertices, api.lumped_masses_tet(mesh.vertices, mesh.tets, 1522.0))
    solver.add_tet_energies(mesh.vertices, mesh.tets, api.Lame.from_youngs_poisson(10000000, 0.399))
    solver.add_obstacle(api.Floor(y=api.asarray(floor_y)))
    assert solver.initialize(api.Settings(verbose=0, admm_iters=10, linsolver=linsolver,
                                          dtype=np.float64))
    return solver


def _numpy(batch):
    return {f.name: np.asarray(getattr(batch, f.name)) for f in dataclasses.fields(batch)}


def _carry(jbatch, dtype=F64):
    """The JAX batch as the port's (on the CPU)."""
    return convert.scenario_batch_from_numpy(_numpy(jbatch), device="cpu", dtype=dtype)


def _both(build, n_steps, s, **sweep):
    """Both packages' batched steps from one batch (the JAX package's,
    carried across): (the port's solver, the JAX x [S, N, 3], the port's
    batch)."""
    js, ts = build(_jax_api()), build(_torch_api())
    jbatch = jb.make_scenario_batch(js, s, **sweep)
    tbatch = _carry(jbatch)
    jstep = jb.make_batched_step(js, mesh=None, donate=False)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    for _ in range(n_steps):
        jbatch, tbatch = jstep(jbatch), tstep(tbatch)
    return ts, np.asarray(jbatch.x), tbatch


def test_batched_step_matches_single():
    solver, xj, out = _both(_small_solver, 1, 3)
    solver.step()
    for s in range(3):
        np.testing.assert_allclose(out.x[s].numpy(), solver.x, atol=1e-9)
    np.testing.assert_allclose(out.x.numpy(), xj, atol=1e-9)


def test_batched_step_parameter_sweep():
    _, xj, out = _both(_small_solver, 1, 4, stiffness_scale=np.array([0.25, 1.0, 4.0, 1.0]),
                       gravity=np.array([-9.8, -9.8, -9.8, -1.0]))
    x = out.x.numpy()
    assert np.isfinite(x).all()
    assert np.abs(x[0] - x[1]).max() > 1e-9
    assert np.abs(x[1] - x[3]).max() > 1e-9
    assert x[3][:, 1].min() > x[1][:, 1].min()
    np.testing.assert_allclose(x, xj, atol=1e-9)


def test_stiffness_sweep_keeps_pins_hard():
    """tests/test_parallel.py:139-155: the sweep scales the material only,
    so pinned vertices stay on their targets in every scene."""
    solver = _small_solver(_torch_api())
    target = solver.x[0].copy()
    batch = tb.make_scenario_batch(solver, 3, stiffness_scale=np.array([0.25, 1.0, 4.0]))
    step = tb.make_batched_step(solver, mesh=None, donate=False)
    for _ in range(10):
        batch = step(batch)
    x = batch.x.numpy()
    for s in range(3):
        np.testing.assert_allclose(x[s, 0], target, atol=1e-6)


def test_sharded_step_on_device_mesh():
    """tests/test_parallel.py:158-176: a (scene, shard) mesh of several
    devices is item 12b (one card here); a mesh of the solver's one device
    runs as mesh=None."""
    solver = _small_solver(_torch_api())
    mesh = tb.make_sim_mesh(n_scene=4, n_shard=2, devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"scene": 4, "shard": 2}
    with pytest.raises(NotImplementedError, match="item 12b"):
        tb.make_batched_step(solver, mesh=mesh, donate=False)
    one = tb.make_batched_step(solver, mesh=tb.make_sim_mesh(devices=[torch.device("cpu")]),
                               donate=False)
    out = one(tb.make_scenario_batch(solver, 4))
    out1 = tb.make_batched_step(solver, mesh=None, donate=False)(
        tb.make_scenario_batch(solver, 4))
    assert torch.equal(out.x, out1.x)


# The drop box resting on its floor after 40 steps, port against the JAX
# package, relative to max |x|: AL-PCG's scenes of scale 0.5 and 1 agree to
# 1e-14; the scale-2 scene parts by 4.7e-7 at first contact (step 9: sqrt(2),
# an ulp apart on this host's CPU, through the penalty rows' conditioning) and
# that sliding difference persists, 2.1e-5 at step 40 (the JAX package's own
# batch against its single-scene solver: 3.2e-5). Uzawa's landing is chaotic:
# the port's fixed-order dots (cuda_uzawa.fixed_dot) part from the JAX
# package's by rounding, 0 before contact and 7.9e-4 at step 11, 4.2e-2 at step
# 40, while the JAX package's own batch from x one ulp up parts from itself by
# 2.4e-2 at step 11 and 0.75 at step 40 (UZAWA_CONTROL_STEPS: the port is held
# under that control's gap, or under CONTACT_40_TOL where that is larger).
CONTACT_40_TOL = 1e-4
UZAWA_CONTROL_STEPS = (11, 40)


def _uzawa_drop_box(api):
    """tests/test_parallel.py:188-191: the drop box under Uzawa with the PCG
    inner (which the batch takes whatever uzawa_inner says)."""
    solver = _drop_box_solver(api, 2)
    solver.m_settings.uzawa_inner = "pcg"
    assert solver.initialize(solver.m_settings)
    return solver


def test_batched_step_contact_modes():
    """tests/test_parallel.py:179-201: AL-PCG (ls=4) and Uzawa with the sparse
    inner (ls=2) hold the floor in every scene of a sweep over 40 steps,
    overflow clear, against the JAX package's batch (Uzawa's within the JAX
    package's own one-ulp control after first contact)."""
    floor_tol = 0.05  # tests/test_contact.py FLOOR_TOL
    sweep = dict(stiffness_scale=np.array([0.5, 1.0, 2.0]))
    _, xj, out = _both(lambda api: _drop_box_solver(api, 4), 40, 3, **sweep)
    x = out.x.numpy()
    assert np.isfinite(x).all()
    assert x[..., 1].min() > -0.75 - floor_tol, x[..., 1].min()
    assert not bool(out.overflow.any())
    assert np.abs(x - xj).max() <= CONTACT_40_TOL * np.abs(xj).max()

    js, ts = _uzawa_drop_box(_jax_api()), _uzawa_drop_box(_torch_api())
    jbatch = jb.make_scenario_batch(js, 3, **sweep)
    tbatch = _carry(jbatch)
    ctl = dataclasses.replace(jbatch, x=jnp.asarray(np.nextafter(np.asarray(jbatch.x), np.inf)))
    jstep = jb.make_batched_step(js, mesh=None, donate=False)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    for k in range(1, 41):
        jbatch, tbatch, ctl = jstep(jbatch), tstep(tbatch), jstep(ctl)
        xj = np.asarray(jbatch.x)
        gap = np.abs(tbatch.x.numpy() - xj).max() / np.abs(xj).max()
        if k == 1:
            assert gap <= 1e-12, gap
        if k in UZAWA_CONTROL_STEPS:
            control = np.abs(np.asarray(ctl.x) - xj).max() / np.abs(xj).max()
            assert gap <= max(CONTACT_40_TOL, control), (k, gap, control)
    x = tbatch.x.numpy()
    assert np.isfinite(x).all()
    assert x[..., 1].min() > -0.75 - floor_tol, x[..., 1].min()
    assert not bool(tbatch.overflow.any())
    assert (tstep.trips.numpy() >= 10).all()  # at least a Schur trip an ADMM iteration


def test_solver_exposes_what_the_batch_reads():
    """The solver's query set, its density and ck, as the JAX package's
    solver exposes them to its batched step."""
    for build in (lambda api: _drop_box_solver(api, 4), _small_solver):
        js, ts = build(_jax_api()), build(_torch_api())
        assert ts._surf_dense == js._surf_dense
        np.testing.assert_array_equal(ts._surf_inds_dev.numpy(), np.asarray(js._surf_inds_dev))
        np.testing.assert_array_equal(ts._ck.numpy(), np.asarray(js._ck, ts._ck.numpy().dtype))


def test_batched_step_rejects_dense_modes():
    solver = _small_solver(_torch_api())
    with pytest.raises(ValueError, match="linsolver"):
        tb.make_batched_step(solver, linsolver=0)
    with pytest.raises(ValueError, match="linsolver"):
        tb.make_batched_step(solver, linsolver=1)


def _exact_slab_solver(api, exact_cls):
    """tests/test_parallel.py:238-252 (float64: the JAX test's dtype under
    tests/conftest.py's x64)."""
    obs = api.make_tet_blocks(4, 2, 4, cell=0.5)
    obs.apply_xform(api.make_xform(trans=(0.0, -1.0, 0.0)))
    exact = exact_cls.from_tet_mesh(obs.vertices, obs.tets, cells=24, near_lanes=24)
    mesh = api.make_tet_blocks(3, 2, 2, cell=0.4)
    mesh.flags = api.binding.NOSELFCOLLISION | api.binding.LINEAR
    mesh.apply_xform(api.make_xform(trans=(0.4, 0.6, 0.4)))
    solver = api.Solver()
    api.binding.add_tetmesh(solver, mesh, api.Lame.soft_rubber(), verbose=False)
    solver.add_obstacle(exact)
    assert solver.initialize(api.Settings(verbose=0, admm_iters=10, linsolver=4, gravity=-9.8,
                                          dtype=np.float64))
    return solver


def test_batched_step_compacted_mesh_obstacle():
    """tests/test_parallel.py:224-270: a near-lane-compacted exact mesh
    obstacle in a batch (kernel J's scene form; its plain twin here): every
    scene of a stiffness sweep rests on the slab top after 30 steps, overflow
    clear, and scene 1 (scale 1) is the port's single-scene solver's run at
    the JAX test's atol=1e-9; the port's batch against the JAX package's."""
    from admm_elastic_tpu.collision.passive import PassiveMeshExact as JExact
    from admm_elastic_tpu_torch.collision.passive import PassiveMeshExact

    ts, xj, out = _both(lambda api: _exact_slab_solver(
        api, JExact if api.batch is jb else PassiveMeshExact), 30, 3,
        stiffness_scale=np.array([0.5, 1.0, 2.0]))
    x = out.x.numpy()
    assert np.isfinite(x).all()
    assert x[..., 1].min() > -0.05, x[..., 1].min()
    assert x[..., 1].min() < 0.05
    assert not bool(out.overflow.any())
    ts.run(30)
    np.testing.assert_allclose(x[1], ts.x, atol=1e-9)
    assert np.abs(x - xj).max() <= CONTACT_40_TOL * np.abs(xj).max()


def test_uses_sweep_switches_twogrid_to_jacobi():
    """With uses_sweep a two-grid solver's batch takes Jacobi and warns, as
    the JAX package's does; uses_sweep=False keeps two-grid, which is item
    12b."""
    def build(api):
        solver = _small_solver(api)
        solver.m_settings.pcg_precond = "twogrid"
        assert solver.initialize(solver.m_settings)
        return solver

    js, ts = build(_jax_api()), build(_torch_api())
    with pytest.warns(UserWarning, match="Jacobi"):
        jstep = jb.make_batched_step(js, donate=False)
    with pytest.warns(UserWarning, match="Jacobi"):
        tstep = tb.make_batched_step(ts, donate=False)
    assert tstep.pcg.agg is None
    jbatch = jb.make_scenario_batch(js, 2, stiffness_scale=np.array([0.5, 2.0]))
    np.testing.assert_allclose(tstep(_carry(jbatch)).x.numpy(), np.asarray(jstep(jbatch).x),
                               atol=1e-9)
    with pytest.raises(NotImplementedError, match="item 12b"):
        tb.make_batched_step(ts, donate=False, uses_sweep=False)


@pytest.fixture(scope="module")
def beam_pcg():
    """crossval's beam_pcg (6x3x3, pinned) in both packages, float64."""
    return {k: chip_smoke.pcg_scene("beam_pcg_f64", api)[0]
            for k, api in (("jax", _jax_api()), ("torch", chip_smoke.torch_api("cpu")))}


SCALES = np.array([0.25, 1.0, 2.5, 4.0])


def test_scaled_operator_is_the_jax_package_s(beam_pcg):
    """diag / apply / apply_T / precondition_T with a number scale, and with a
    per-scene scale over a scene axis against jax.vmap of the JAX package's."""
    dt = tpcg.prepare(beam_pcg["torch"].system, F64)
    dj = jpcg.prepare(beam_pcg["jax"].system, jnp.float64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((len(SCALES), dt.n, 3))
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    tol = 1e-12
    for s in (2.0, 0.25):
        assert np.abs(dt.diag(s).numpy() - np.asarray(dj.diag(s))).max() <= tol * np.abs(
            np.asarray(dj.diag(s))).max()
        want = np.asarray(dj.apply(xj[0], s))
        assert np.abs(dt.apply(xt[0], s).numpy() - want).max() <= tol * np.abs(want).max()
    st, sj = torch.as_tensor(SCALES), jnp.asarray(SCALES)
    pairs = [(dt.diag(st), jax.vmap(dj.diag)(sj)),
             (dt.apply(xt, st), jax.vmap(dj.apply)(xj, sj)),
             (dt.apply_T(xt.transpose(1, 2), st),
              jax.vmap(lambda v, s: dj.apply_T(v.T, s))(xj, sj)),
             (dt.precondition_T(st)(xt.transpose(1, 2)),
              jax.vmap(lambda v, s: dj.precondition_T(s)(v.T))(xj, sj))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    # the pins' diagonal is not scaled: at a pinned vertex diag(s) - diag(1)
    # is (s - 1) times the stiffness diagonal alone
    pins = dt.diag_pin.numpy() > 0
    assert pins.any()
    grow = (dt.diag(st) - dt.diag(1.0)[None]).numpy()[:, pins]
    want = ((st - 1.0)[:, None] * dt.diag_stiff[None]).numpy()[:, pins]
    np.testing.assert_allclose(grow, want, rtol=1e-10, atol=1e-12 * np.abs(want).max())


def test_solve_T_scenes_exits_per_scene_as_jax_vmap(beam_pcg):
    """The plain twin of G's scene form against jax.vmap of the JAX
    package's solve_T on each scene's scaled operator: x and each scene's
    trips (a finished scene frozen while the others go on)."""
    data = tpcg.prepare(beam_pcg["torch"].system, F64)
    dj = jpcg.prepare(beam_pcg["jax"].system, jnp.float64)
    rng = np.random.default_rng(11)
    b = rng.standard_normal((len(SCALES), data.n, 3))
    x0 = np.zeros_like(b)
    st = torch.as_tensor(SCALES)
    x, trips = tpcg.solve_T_scenes(lambda vT: data.apply_T(vT, st), data.precondition_T(st),
                                   torch.as_tensor(b), torch.as_tensor(x0), 1e-10, 200)

    def one(bb, xx, s):
        dd = dataclasses.replace(dj, ell_vals=dj.ell_vals * s, diag_stiff=dj.diag_stiff * s,
                                 bands=None if dj.bands is None else dj.bands * s)
        return jpcg.solve_T(dd.apply_T, dd.precondition_T(), bb, xx, 1e-10, 200)

    xj, kj = jax.vmap(one)(jnp.asarray(b), jnp.asarray(x0), jnp.asarray(SCALES))
    assert trips.tolist() == np.asarray(kj).tolist()
    assert len(set(trips.tolist())) > 1  # the scenes leave at different trips
    xj = np.asarray(xj)
    assert np.abs(x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()


def test_scenario_batch_round_trip():
    """A jittered JAX batch carried across keeps every field; the port's own
    jitter comes from torch.Generator(seed), the same draw for the same seed."""
    js, ts = _small_solver(_jax_api()), _small_solver(_torch_api())
    jbatch = jb.make_scenario_batch(js, 3, stiffness_scale=np.array([0.5, 1.0, 2.0]),
                                    gravity=np.array([-9.8, -5.0, -1.0]), jitter=0.01, seed=4)
    tbatch = _carry(jbatch)
    for f, a in _numpy(jbatch).items():
        got = getattr(tbatch, f)
        assert got.shape == a.shape and np.array_equal(got.numpy(), a), f
    assert tbatch.prev_active.dtype == torch.bool and tbatch.overflow.dtype == torch.bool
    mine = [tb.make_scenario_batch(ts, 3, jitter=0.01, seed=4) for _ in range(2)]
    assert torch.equal(mine[0].x, mine[1].x)
    assert not torch.equal(mine[0].x, tb.make_scenario_batch(ts, 3, jitter=0.01, seed=5).x)
    assert float((mine[0].x - ts.state.x).abs().max()) > 0.0
    out_j = np.asarray(jb.make_batched_step(js, donate=False)(jbatch).x)
    out_t = tb.make_batched_step(ts, donate=False)(tbatch).x.numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-9)


def _wind_sheet_solver(api, colored):
    """A 4x4 cloth sheet (chip_smoke.cloth_sheet; 36 % of its stencil lanes
    are padding, so the batch rebuilds it as a gather family) in the wind of
    chip_smoke's cloth_wind40, no gravity, PCG, float64."""
    verts, tris, masses, pins = chip_smoke.cloth_sheet(4, 4)
    wind = (0.05, 0.1, 0.02)
    solver = api.Solver()
    solver.add_nodes(verts, masses)
    solver.add_tri_energies(verts, tris, api.Lame.from_youngs_poisson(10000000, 0.399))
    solver.set_pins([int(i) for i in pins])
    if api.batch is jb:
        from admm_elastic_tpu.forces import make_wind_force

        force = make_wind_force(tris, direction=wind, colored=colored)
    else:
        from admm_elastic_tpu_torch.forces import make_wind_force

        force = make_wind_force(tris, wind, device="cpu", dtype=F64, colored=colored)
    solver.add_explicit_force(force)
    assert solver.initialize(api.Settings(verbose=0, admm_iters=10, linsolver=3, gravity=0.0,
                                          timestep_s=1.0 / 24.0, dtype=np.float64))
    return solver


@pytest.mark.parametrize("colored,n_steps", [(False, 2), (True, 8)])
def test_cloth_gather_batch_in_the_wind(colored, n_steps):
    """A cloth gather family in a batch (kernel E's rows entry on the S * T
    lanes) under the batched or coloured wind, every scene at once, against
    the JAX package's batch: f64, to 1e-12 of max |x|. The batched order
    kicks this coarse sheet unstable after two steps in both packages, so it
    is held there; the coloured order over 8 steps."""
    ts, xj, out = _both(lambda api: _wind_sheet_solver(api, colored), n_steps, 3,
                        stiffness_scale=np.array([0.5, 1.0, 2.0]))
    step = tb.make_batched_step(ts, mesh=None, donate=False)
    assert all(b.stencil is None for b in step.system.tris)
    x = out.x.numpy()
    assert np.isfinite(x).all()
    assert np.abs(x[0] - x[2]).max() > 1e-9  # the scales part the scenes
    assert np.abs(x - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_scene_axis_of_the_cloth_plain_ops(dtype):
    """The ops a cloth batch runs in plain PyTorch over a leading scene axis,
    each scene bitwise what it gives alone: the flat stencil's D^T
    (ops/stencil.tri_Dt_rows) and the batched and coloured wind."""
    from admm_elastic_tpu_torch.forces import make_wind_force
    from admm_elastic_tpu_torch.ops import stencil as tstencil

    api = _torch_api()
    verts, tris, masses, pins = chip_smoke.cloth_sheet(8, 6)
    solver = api.Solver()
    solver.add_nodes(verts, masses)
    solver.add_tri_energies(verts, tris, api.Lame.from_youngs_poisson(10000000, 0.399))
    solver.set_pins([int(i) for i in pins])
    assert solver.initialize(api.Settings(verbose=0, linsolver=3, dtype=np.dtype(
        str(dtype).rpartition(".")[2])))
    b, n = solver.system.tris[0], solver.system.n_verts
    assert b.stencil is not None
    rng = np.random.default_rng(3)
    g = torch.as_tensor(rng.standard_normal((4, 6, b.n)), dtype=dtype)
    out = tstencil.tri_Dt_rows(g, b, n)
    assert out.shape == (4, n, 3)
    for i in range(4):
        assert torch.equal(out[i], tstencil.tri_Dt_rows(g[i], b, n))
    x = torch.as_tensor(verts, dtype=dtype) + torch.as_tensor(
        0.1 * rng.standard_normal((4, n, 3)), dtype=dtype)
    v = torch.as_tensor(0.01 * rng.standard_normal((4, n, 3)), dtype=dtype)
    for colored in (False, True):
        wind = make_wind_force(tris, (0.05, 0.1, 0.02), device="cpu", dtype=dtype,
                               colored=colored)
        got = wind.project(1.0 / 24.0, x, v, None)
        assert torch.isfinite(got).all() and not torch.equal(got, v)
        for i in range(4):
            assert torch.equal(got[i], wind.project(1.0 / 24.0, x[i], v[i], None)), (colored, i)


def test_make_sim_mesh_raises_without_a_card():
    """With devices=None the mesh is the CUDA devices; on a box with none it
    raises, as Solver() does, rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.make_sim_mesh()
    assert tb.make_sim_mesh(devices=[torch.device("cpu")]).shape == {"scene": 1, "shard": 1}
