"""The port's local step (kernel A's plain version) against the JAX package.

Same inputs, made with numpy from a seed, go through
admm_elastic_tpu_torch.ops.hyper_soa.local_step_plain and through the JAX
package's Pallas kernel local_step_tet_hyper_pallas (interpret mode) and
its SoA body hyper_soa.prox_tet_hyper_tuple. The recipe is
tests/test_pallas.py's _random_f: near-identity, inverted every 5th,
x3 stretch every 7th.

Bounds: float64 1e-10 (tests/test_pallas.py:56): the two packages perform
the same operations in the same order. float32, absolute on z and u'
(|z| up to ~5 here): median 1e-6, 99th percentile 2e-4, max 5e-2. With
the same op order, libm log / sqrt / division still differ between XLA
and PyTorch in the last ulp, and the backtracking accept test
fc < best_f then flips on a few lanes whose Newton objective is flat to
float32 precision, which takes those lanes to a different but equally
good stretch. Measured on this recipe: median 1.5e-7, 99th percentile
9e-5, max 6.3e-4 at T = 1500; at T = 7,680 the worst flipped lane
differs by 4.9e-2, which sets the max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_cuda import A_F32_MAX as F32_MAX
from test_torch_cuda import A_F32_P99 as F32_P99
from test_torch_cuda import local_step_inputs as _inputs

from admm_elastic_tpu.ops import hyper_soa as jhyper
from admm_elastic_tpu.ops import pallas_kernels
from admm_elastic_tpu.ops.prox import TET_NEOHOOKEAN
from admm_elastic_tpu_torch.ops import cuda_local_step
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain

torch.set_num_threads(1)

F32_MEDIAN = 1e-6


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_kernels.set_pallas_mode("interpret")
    yield
    pallas_kernels.set_pallas_mode("auto")


def _port(arrs):
    return [np.asarray(a) for a in local_step_plain(*(torch.as_tensor(a) for a in arrs))]


def _jax_pallas(arrs):
    dix, u, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    z, uo = pallas_kernels.local_step_tet_hyper_pallas(dix, u, TET_NEOHOOKEAN, mu, lam, kappa, k)
    return [np.asarray(z), np.asarray(uo)]


def _jax_soa(arrs):
    dix, u, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    v = dix + u
    z = jnp.stack(jhyper.prox_tet_hyper_tuple(tuple(v[i] for i in range(9)), TET_NEOHOOKEAN,
                                              mu, lam, kappa, k), axis=0)
    return [np.asarray(z), np.asarray(v - z)]


def _check(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == dtype and np.isfinite(g).all()
        if dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
            continue
        err = np.abs(g - w)
        assert err.max() < F32_MAX, err.max()
        assert np.quantile(err, 0.99) < F32_P99, np.quantile(err, 0.99)
        assert np.median(err) < F32_MEDIAN, np.median(err)


@pytest.mark.parametrize("t", [7, 129, 1500])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_local_step_matches_jax_soa(t, dtype):
    arrs = _inputs(t, t, dtype)
    _check(_port(arrs), _jax_soa(arrs), dtype)


# One shape per dtype: each interpret-mode trace of the kernel body costs
# ~14 s on the CPU. T = 129 pads to a 256-lane block with a ragged tail.
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_local_step_matches_pallas_interpret(dtype):
    arrs = _inputs(129, 129, dtype)
    _check(_port(arrs), _jax_pallas(arrs), dtype)


def test_dead_lanes_identity_stay_finite_f32():
    """Dead stencil lanes (identity F, u = 0) leave as z = I, u' = 0."""
    t = 130
    eye = np.tile(np.eye(3).reshape(9, 1), (1, t)).astype(np.float32)
    mu = np.full(t, 1e5, np.float32)
    lam = np.full(t, 2e5, np.float32)
    args = (eye, np.zeros_like(eye), mu, lam, np.zeros(t, np.float32), lam + (2.0 / 3.0) * mu)
    z, uo = _port(args)
    assert np.isfinite(z).all() and np.isfinite(uo).all()
    np.testing.assert_allclose(z, eye, atol=1e-6)
    np.testing.assert_allclose(uo, 0.0, atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu():
    arrs = _inputs(33, 5, np.float64)
    before = cuda_local_step.local_step_tet_hyper.launches
    got = cuda_local_step.local_step_tet_hyper(*(torch.as_tensor(a) for a in arrs))
    assert cuda_local_step.local_step_tet_hyper.launches == before
    for g, w in zip(got, _port(arrs)):
        np.testing.assert_array_equal(np.asarray(g), w)
