"""Uzawa in a batch (parallel/batch.py) on the CPU: the scene twins of
kernels L, M and G's per-scene done, each scene bit for bit the
single-scene twin on its own tensors (cuda_uzawa.fixed_dot_scenes,
ct_plain_scenes, schur_trip_plain_scenes, pcg.solve_T_scenes with done);
crossval's batched scene under Uzawa against the live JAX batch and its
golden (float32 and float64). The mesh obstacles in a batch are
tests/test_torch_batch_mesh.py's.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.parallel import batch as jb
from admm_elastic_tpu_torch.ops import cuda_pcg, cuda_uzawa
from admm_elastic_tpu_torch.parallel import batch as tb
from admm_elastic_tpu_torch.solvers import alcg, pcg as tpcg
from make_torch_golden import jax_api
from test_torch_batch import _carry

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _random_hits(rng, s_cnt, n, dense, dtype):
    """Scene hits (alcg.scene_hits) of s_cnt scenes on n vertices: every
    vertex (dense) or every other one, about half the rows active."""
    surf = torch.arange(n) if dense else torch.arange(0, n, 2)
    h = surf.shape[0]
    mask = torch.as_tensor(rng.random((s_cnt, h)) < 0.5)
    normal = torch.as_tensor(rng.standard_normal((s_cnt, h, 3)), dtype=dtype)
    point = torch.as_tensor(rng.standard_normal((s_cnt, h, 3)), dtype=dtype)
    return alcg.scene_hits(mask, normal, point, surf, dense)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("dense", [True, False])
def test_uzawa_scene_twins_are_the_single_scene_twins(dtype, dense):
    """fixed_dot_scenes, ct_plain_scenes and schur_trip_plain_scenes, scene
    by scene bitwise fixed_dot, ct_plain and schur_trip_plain on that scene's
    tensors (cuda_uzawa.scene_of), a done scene frozen; the scene twins over
    a length that pads the last row of partials."""
    rng = np.random.default_rng(5)
    s_cnt, n = 5, 1500
    hits = _random_hits(rng, s_cnt, n, dense, dtype)
    h = hits.p_mask.shape[1]
    ck = torch.tensor(1.7, dtype=dtype)
    vec = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=dtype)  # noqa: E731
    y = vec(s_cnt, 2 * h)
    got = cuda_uzawa.ct_plain_scenes(hits, ck, y, n)
    a, b = vec(s_cnt, 3 * n), vec(s_cnt, 3 * n)
    dots = cuda_uzawa.fixed_dot_scenes(a, b)
    act = torch.cat([hits.p_mask, hits.d_mask], dim=1)
    r = torch.where(act, vec(s_cnt, 2 * h), 0.0)
    state = (vec(s_cnt, n, 3), vec(s_cnt, n, 3), y, r, r.clone(),
             torch.as_tensor(rng.integers(0, 4, s_cnt), dtype=torch.int32),
             torch.tensor([False, True, False, False, True]))
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    out = cuda_uzawa.schur_trip_plain_scenes(hits, ck, *state, float(fi.tiny), 1e-12)
    for i in range(s_cnt):
        one = cuda_uzawa.scene_of(hits, i)
        assert torch.equal(got[i], cuda_uzawa.ct_plain(one, ck, y[i], n))
        assert torch.equal(dots[i], cuda_uzawa.fixed_dot(a[i], b[i]))
        want = cuda_uzawa.schur_trip_plain(one, ck, *(t[i] for t in state), float(fi.tiny),
                                           1e-12)
        assert all(torch.equal(g[i], w) for g, w in zip(out, want)), i
    for t, o in zip(state[1:5], out[:4]):  # x, y, r, d: the done scenes frozen, the others moved
        assert torch.equal(o[state[6]], t[state[6]]) and not torch.equal(o[~state[6]],
                                                                         t[~state[6]])


def test_solve_T_scenes_done_is_the_single_scene_solve():
    """pcg.solve_T_scenes with done: a set scene returns its x0 with no trip,
    every other scene bitwise the single-scene solve_T on its scaled operator
    (what cuda_pcg.pcg_solve does on the CPU with that scene's done)."""
    solver = chip_smoke.pcg_scene("beam_pcg_f64", chip_smoke.torch_api("cpu"))[0]
    data = tpcg.prepare(solver.system, F64)
    rng = np.random.default_rng(1)
    s_cnt = 4
    b = torch.as_tensor(rng.standard_normal((s_cnt, data.n, 3)))
    x0 = torch.as_tensor(0.1 * rng.standard_normal((s_cnt, data.n, 3)))
    scale = torch.tensor([0.5, 1.0, 2.0, 4.0], dtype=F64)
    done = torch.tensor([False, True, False, True])
    trips = torch.zeros((s_cnt,), dtype=torch.int32)
    x = cuda_pcg.pcg_solve_scenes(data, b, x0, 1e-8, 200, trips, scale, done=done)
    for i in range(s_cnt):
        ti = torch.zeros((1,), dtype=torch.int32)
        want = cuda_pcg.pcg_solve(cuda_pcg.scaled(data, scale[i]), b[i], x0[i], 1e-8, 200, ti,
                                  done=done[i:i + 1])
        assert torch.equal(x[i], want) and int(trips[i]) == int(ti), i
    assert torch.equal(x[done], x0[done]) and trips[done].tolist() == [0, 0]
    assert (trips[~done] > 0).all()


CROSSVAL_UZAWA_BOUNDS = {np.float64: (1e-12, 1e-11), np.float32: (1e-4, 2e-3)}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_crossval_batched_contact_uzawa(dtype):
    """crossval's batched scene under Uzawa (batched_contact_uzawa, 4 scenes)
    against the live JAX batch from the same batch after each of steps 1..8
    (float64: the port's fixed-order dots part from the JAX package's by
    rounding, 1.6e-15 at step 8; float32 at crossval's bounds), and against
    its golden at chip_smoke.BATCH_STEP_TOL; the floor held, overflow clear,
    the active rows the JAX package's."""
    name = "batched_contact_uzawa" + ("_f64" if dtype == np.float64 else "")
    js, scales, gravity = chip_smoke.batch_scene(name, jax_api(), dtype)
    ts, _, _ = chip_smoke.batch_scene(name, chip_smoke.torch_api("cpu"), dtype)
    jbatch = jb.make_scenario_batch(js, 4, stiffness_scale=scales, gravity=gravity)
    tbatch = _carry(jbatch, torch.float32 if dtype == np.float32 else F64)
    jstep = jb.make_batched_step(js, mesh=None, donate=False)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    first, last = CROSSVAL_UZAWA_BOUNDS[dtype]
    g = chip_smoke.golden(name)
    for k in range(1, 9):
        jbatch, tbatch = jstep(jbatch), tstep(tbatch)
        x = tbatch.x.double().numpy()
        err = _rel(x, np.asarray(jbatch.x, np.float64))
        assert err <= (first if k == 1 else last), (k, err)
        if k in chip_smoke.batch_steps(name):
            bound = chip_smoke.BATCH_STEP_TOL[name][chip_smoke.batch_steps(name).index(k)]
            assert _rel(x, g[f"x{k}"].astype(np.float64)) <= bound, k
    assert x[..., 1].min() > chip_smoke.BATCH_FLOOR_BOUND
    assert not bool(tbatch.overflow.any())
    np.testing.assert_array_equal(tbatch.prev_active.numpy(), np.asarray(jbatch.prev_active))
    assert (tstep.trips.numpy() >= 10).all()


