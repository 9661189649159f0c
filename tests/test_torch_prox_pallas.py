"""The plain versions of kernels D, F and A's other models against the JAX
package's Pallas kernels themselves, run in interpret mode as
tests/test_pallas.py runs them on the CPU. Inputs and bounds are those of
tests/test_torch_prox.py, which holds the same plain versions to the shared
SoA bodies at more shapes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_cuda import local_step_inputs, prox_inputs
from test_torch_prox import _check, _port_prox

from admm_elastic_tpu.ops import pallas_kernels
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
from admm_elastic_tpu_torch.ops.prox import TET_MODELS

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_kernels.set_pallas_mode("interpret")
    yield
    pallas_kernels.set_pallas_mode("auto")


def _jax_prox_pallas(arrs, model):
    zi, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    if model == "linear":
        return pallas_kernels.prox_tet_linear_pallas(zi)
    return pallas_kernels.prox_tet_hyper_pallas(zi, model, mu, lam, kappa, k)


# One shape per model and dtype: each interpret-mode trace of a hyperelastic
# kernel body costs ~10 s on the CPU. T = 130 pads to 256 lanes with a ragged
# tail of identity matrices, which the port replaces by a bounds check.
@pytest.mark.parametrize("model,dtype", [(m, np.float64) for m in TET_MODELS]
                         + [("neohookean", np.float32), ("linear", np.float32)])
def test_prox_matches_pallas_interpret(model, dtype):
    arrs = prox_inputs(130, 130, dtype, model)
    _check(_port_prox(arrs, model), _jax_prox_pallas(arrs, model), dtype, model)


@pytest.mark.parametrize("model", ["stvk"])
def test_local_step_other_models_match_pallas_interpret(model):
    arrs = local_step_inputs(129, 129, np.float64, model)
    got = local_step_plain(*(torch.as_tensor(a) for a in arrs), model=model)
    dix, u, mu, lam, kappa, k = (jnp.asarray(a) for a in arrs)
    want = pallas_kernels.local_step_tet_hyper_pallas(dix, u, model, mu, lam, kappa, k)
    for g, w in zip(got, want):
        _check(g.numpy(), w, np.float64, model)
