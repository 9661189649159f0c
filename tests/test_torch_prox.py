"""The plain versions of kernels D and F (tet prox on [T,3,3]) and of kernel
A's other models (StVK, the three Xu splines, linear) against the JAX package.

Same inputs, made with numpy from a seed (tests/test_torch_cuda.py's
recipes: tests/test_pallas.py's _random_f, near-identity with every 5th F
inverted and every 7th stretched x3; the spline models with kappa = k/1000),
go through admm_elastic_tpu_torch.ops.hyper_soa and through the SoA bodies
that the JAX package's Pallas kernels share (tests/test_torch_prox_pallas.py
runs the Pallas kernels themselves, in interpret mode).

Bounds as tests/test_torch_local_step.py: float64 rtol = atol = 1e-10;
float32 in the flip-tolerant form (absolute on |z| up to ~5: median 1e-6,
99th percentile 2e-4, max 5e-2), since a last-ulp difference of libm log /
sqrt / division flips the backtracking accept test on the few lanes whose
Newton objective is flat to float32 precision. The linear prox has no Newton
loop: float32 within 2e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_cuda import A_F32_MAX as F32_MAX
from test_torch_cuda import A_F32_P99 as F32_P99
from test_torch_cuda import local_step_inputs, prox_inputs

from admm_elastic_tpu.ops import hyper_soa as jhyper
from admm_elastic_tpu.ops import soa as jsoa
from admm_elastic_tpu_torch.ops import cuda_prox
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, prox_plain
from admm_elastic_tpu_torch.ops.prox import TET_MODELS, check_model

torch.set_num_threads(1)

F32_MEDIAN = 1e-6
LINEAR_F32 = 2e-5
OTHER = [m for m in TET_MODELS if m != "neohookean"]


def _check(got, want, dtype, model):
    want = np.asarray(want)
    assert got.dtype == dtype and got.shape == want.shape and np.isfinite(got).all()
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
        return
    err = np.abs(got - want)
    if model == "linear":
        assert err.max() < LINEAR_F32, err.max()
        return
    assert err.max() < F32_MAX, err.max()
    assert np.quantile(err, 0.99) < F32_P99, np.quantile(err, 0.99)
    assert np.median(err) < F32_MEDIAN, np.median(err)


def _port_prox(arrs, model):
    zi, mu, lam, kappa, k = (torch.as_tensor(a) for a in arrs)
    return prox_plain(zi, model, mu, lam, kappa, k).numpy()


def _jax_prox_soa(arrs, model):
    zi, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    if model == "linear":
        return jsoa.prox_tet_linear_soa(zi)
    return jhyper.prox_tet_hyper_soa(zi, model, mu, lam, kappa, k)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("t,dtype", [(1, np.float64), (7, np.float64), (130, np.float64),
                                     (130, np.float32)])
def test_prox_matches_jax_soa(model, t, dtype):
    """D's and F's plain version against the SoA body the Pallas kernels share."""
    arrs = prox_inputs(t, t, dtype, model)
    _check(_port_prox(arrs, model), _jax_prox_soa(arrs, model), dtype, model)


@pytest.mark.parametrize("model", OTHER)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_local_step_other_models_match_jax_soa(model, dtype):
    """Kernel A's plain version for every model but neo-Hookean (which
    tests/test_torch_local_step.py holds), with a dual: z and u' = v - z."""
    arrs = local_step_inputs(129, 129, dtype, model)
    z, uo = (a.numpy() for a in local_step_plain(*(torch.as_tensor(a) for a in arrs),
                                                 model=model))
    dix, u, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    v = dix + u
    f = tuple(v[i] for i in range(9))
    if model == "linear":
        want = jnp.stack(jsoa.prox_tet_linear_tuple(f), axis=0)
    else:
        want = jnp.stack(jhyper.prox_tet_hyper_tuple(f, model, mu, lam, kappa, k), axis=0)
    _check(z, want, dtype, model)
    _check(uo, v - want, dtype, model)


def test_equal_diagonal_jacobi_stall_is_the_jax_package_s():
    """A symmetric shear F = I + s (e0 e1^T + e1 e0^T) gives F^T F two bitwise
    equal diagonal entries with a cross term between them. The Jacobi rotation
    takes t = sign(theta) / (...) with theta = 0 there, and sign(0) = 0 skips
    it in every sweep: the signed SVD stays unconverged and the linear prox is
    not 1/2 (R + F). The port repeats the JAX package's arithmetic, so it must
    give the JAX package's (wrong) answer to 1e-12, not the true polar one."""
    s = 0.3
    f = np.array([[[1.0, s, 0.0], [s, 1.0, 0.0], [0.0, 0.0, 1.0]]])
    got = prox_plain(torch.as_tensor(f), "linear", None, None, None, None).numpy()
    np.testing.assert_allclose(got, np.asarray(jsoa.prox_tet_linear_soa(jnp.asarray(f))),
                               rtol=0, atol=1e-12)
    true = 0.5 * (np.eye(3) + f[0])  # F is symmetric positive definite: R = I
    assert np.abs(got[0] - true).max() > 0.1


@pytest.mark.parametrize("model", TET_MODELS)
def test_prox_equals_rows_entry_with_zero_dual(model):
    """[T,3,3] in, [T,3,3] out is the rows entry with u = 0, transposed."""
    zi, mu, lam, kappa, k = (torch.as_tensor(a) for a in prox_inputs(33, 5, np.float64, model))
    rows = zi.reshape(-1, 9).T.contiguous()
    z, uo = local_step_plain(rows, torch.zeros_like(rows), mu, lam, kappa, k, model=model)
    got = prox_plain(zi, model, mu, lam, kappa, k)
    assert torch.equal(got.reshape(-1, 9).T, z)
    assert torch.equal(uo, rows - z)


def test_prox_wrappers_take_plain_version_on_cpu():
    zi, mu, lam, kappa, k = (torch.as_tensor(a)
                             for a in prox_inputs(33, 5, np.float64, "spline_nh"))
    before = (cuda_prox.prox_tet_hyper.launches, cuda_prox.prox_tet_linear.launches)
    got = cuda_prox.prox_tet_hyper(zi, "spline_nh", mu, lam, kappa, k)
    assert torch.equal(got, prox_plain(zi, "spline_nh", mu, lam, kappa, k))
    # k may be one scalar for the whole family, as the Pallas wrapper broadcasts it
    one = cuda_prox.prox_tet_hyper(zi, "stvk", mu, lam, kappa, torch.tensor(3e5).double())
    assert torch.equal(one, prox_plain(zi, "stvk", mu, lam, kappa, torch.full_like(mu, 3e5)))
    assert torch.equal(cuda_prox.prox_tet_linear(zi), prox_plain(zi, "linear", mu, lam, kappa, k))
    assert (cuda_prox.prox_tet_hyper.launches, cuda_prox.prox_tet_linear.launches) == before
    with pytest.raises(ValueError, match="prox_tet_linear"):
        cuda_prox.prox_tet_hyper(zi, "linear", mu, lam, kappa, k)


def test_check_model_admits_the_six_models_only():
    for m in TET_MODELS:
        check_model(m)
    assert len(TET_MODELS) == 6
    with pytest.raises(ValueError, match="unknown"):
        check_model("mooney")


@pytest.mark.parametrize("model", [m for m in TET_MODELS if m != "linear"])
def test_newton_trips_count_what_the_data_needs(model):
    """newton_soa(trips=) leaves the result bitwise as it is and counts, per
    lane, the gradients up to convergence, the line searches among them and
    their candidates up to the first accepted one."""
    from admm_elastic_tpu_torch.ops.hyper_soa import prox_tet_hyper_tuple

    t, n_iters = 64, 8
    zi, *params = (torch.as_tensor(a) for a in prox_inputs(t, 3, np.float64, model))
    f = tuple(zi.reshape(t, 9).T)
    trips = {}
    got = prox_tet_hyper_tuple(f, model, *params, n_iters=n_iters, trips=trips)
    want = prox_tet_hyper_tuple(f, model, *params, n_iters=n_iters)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert t <= trips["gradients"] <= n_iters * t  # every lane takes the first
    assert trips["searches"] <= trips["gradients"]
    assert trips["searches"] <= trips["candidates"] <= 8 * trips["searches"]
    # a lane at its minimum converges on the gradient, with no line search
    one = tuple(torch.full((1,), v, dtype=torch.float64) for v in np.eye(3).reshape(9))
    rest = {}
    prox_tet_hyper_tuple(one, model, *(p[:1] for p in params), trips=rest)
    assert rest == dict(gradients=1, searches=0, candidates=0)
