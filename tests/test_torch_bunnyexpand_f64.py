"""bunnyexpand in float64 on the port's CPU solver against the JAX package's
apps/bunnyexpand.py in float64 on its Jacobi SVD, as chip_smoke.APP_F64
holds it on the card:

- the point collapse: x after steps 1 and 8 of the app's run;
- the scramble: x after one step with 1, 2 and 3 ADMM iterations (the app's
  -it), a float64 rounding growing 30-100 times an iteration in the tangle;
- the same holds against the golden app_bunnyexpand_f64 (chip_smoke.
  app_f64_holds, the card's check);
- tests/test_inversion_recovery.py's point collapse (its 250-point bunny)
  against the JAX package's run of it, steps 1 and 10;
- the cause of the float32 collapse's gap (chip_smoke.APP_ONESTEP, ROADMAP
  Queue 3 item 17): in float32 both packages' neo-Hookean prox leaves a tet
  collapsed to a point at its inflation eps = 1e-6, because the Newton
  Hessian's determinant overflows there.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import make_torch_golden
import test_inversion_recovery
import test_torch_inversion_recovery

from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch.ops import hyper_soa, soa

torch.set_num_threads(1)

EPS = 1e-6  # the prox's collapse inflation (admm_elastic_tpu/ops/prox.py:240)


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")


def _jax_steps(name, steps, argv=()):
    """x after each of `steps` steps of the JAX app (float64: tests/conftest.py
    turns jax_enable_x64 on), and the state it started from."""
    xs = []

    def drive(solver, sim_cb, frames):
        xs.append(np.asarray(solver.x))
        for _ in range(frames):
            solver.step()
            xs.append(np.asarray(solver.x))
        return np.stack(xs[1:])

    make_torch_golden.jax_app(name, drive, frames=steps, argv=argv)
    assert all(x.dtype == np.float64 for x in xs)
    return xs


def test_collapse_holds_the_jax_app():
    want = _jax_steps("bunnyexpand", 8)
    solver = chip_smoke.app_scene("bunnyexpand", dtype=np.float64).solver
    assert np.array_equal(solver.x, want[0]) and not np.any(want[0])
    got = []
    for _ in range(8):
        solver.step()
        got.append(solver.x)
    for k in (1, 8):
        gap = chip_smoke.rel_err(got[k - 1], want[k])
        assert gap <= chip_smoke.APP_F64_TOL[f"x{k}"], (k, gap)


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_scramble_holds_the_jax_app(iters):
    want = _jax_steps("bunnyexpand_rand", 1, argv=("-it", str(iters)))
    solver = chip_smoke.app_scene("bunnyexpand_rand", dtype=np.float64,
                                  admm_iters=iters).solver
    assert np.array_equal(solver.x, want[0])
    solver.step()
    gap = chip_smoke.rel_err(solver.x, want[1])
    assert gap <= chip_smoke.APP_F64_TOL[f"it{iters}"], gap


@pytest.mark.parametrize("name", list(chip_smoke.APP_F64))
def test_f64_holds_its_golden(name):
    got = chip_smoke.app_f64_holds(torch, name)
    assert sorted(got) == sorted(chip_smoke.APP_F64[name])
    assert all(r["rel_err"] <= r["bound"] for r in got.values()), got


def test_inversion_recovery_collapse_holds_the_jax_run():
    jax_solver, _ = test_inversion_recovery._bunny_solver()
    solver, _ = test_torch_inversion_recovery._bunny_solver()
    assert np.array_equal(solver.x, np.asarray(jax_solver.x))
    jax_solver.x = np.zeros_like(solver.x)
    solver.x = np.zeros_like(solver.x)
    bound = chip_smoke.APP_F64_TOL["x8"]  # the app's collapse bound (3.6e-11 read at step 10)
    for k in range(1, 11):
        jax_solver.step()
        solver.step()
        if k in (1, 10):
            gap = chip_smoke.rel_err(solver.x, np.asarray(jax_solver.x))
            assert gap <= bound, (k, gap)


def test_f32_prox_leaves_a_collapsed_tet_at_eps():
    """F = 0 on the app's own tets: in float32 the prox of both packages
    returns singular values of eps (every Newton candidate is NaN, since the
    Hessian's determinant at s = eps overflows); in float64 the Newton moves
    them off eps."""
    tb = chip_smoke.app_scene("bunnyexpand", dtype=np.float64).solver.system.tets[0]
    lanes = 64
    par = {f: getattr(tb, f).reshape(-1)[:lanes] for f in ("mu", "lam", "kappa", "bulk")}
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        p = {f: v.to(dtype) for f, v in par.items()}
        z = hyper_soa.prox_plain(torch.zeros((lanes, 3, 3), dtype=dtype), tb.model, p["mu"],
                                 p["lam"], p["kappa"], p["bulk"])
        zj = jprox.prox_tet_hyper(np.zeros((lanes, 3, 3), np_dtype), tb.model,
                                  *(v.numpy() for v in p.values()))
        zj = np.asarray(zj)
        assert zj.dtype == np_dtype
        for out in (z.numpy(), zj):
            s = np.linalg.svd(out.astype(np.float64), compute_uv=False)
            if dtype == torch.float32:
                assert np.abs(s - EPS).max() <= 4 * np.spacing(np.float32(EPS)), s[:2]
            else:
                assert s.min() > 100 * EPS, s[:2]
        s = tuple(torch.full((lanes,), EPS, dtype=dtype) for _ in range(3))
        _, _, hess = hyper_soa._vgh_soa(tb.model, p["mu"], p["lam"], p["kappa"], p["bulk"], s)
        _, det = soa.solve3x3_sym_soa(hess(s), s)
        assert bool(torch.isfinite(det).all()) == (dtype == torch.float64)
