"""The port's other tet materials, end to end, against the JAX Solver on the
CPU: the 4x2x2 beam, -x face pinned, soft rubber, linsolver=0 "inv", 10 ADMM
iterations, dt 1/24, once for each of linear, stvk, spline_nh, spline_stvk and
spline_corot (benchmarks/crossval.py beam_linear_ldlt, beam_stvk_ldlt,
beam_spline_ldlt). The JAX side takes the Jacobi SoA prox
(set_svd_impl("jacobi")), the same body as the port's kernels.

Bounds, relative to max |x|: float32 1e-4 after one step and 2e-3 after eight
(benchmarks/crossval.py:299-302); float64 1e-9.
"""

import numpy as np
import pytest
import torch

from test_torch_solver import _assert_close, _pins, _settings, _traj

from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_prox
from admm_elastic_tpu_torch.system import system as p_sys

torch.set_num_threads(1)

DIMS = (4, 2, 2)
# model -> mesh flag of binding.add_tetmesh, or None where only
# Solver.add_tet_energies(model=...) reaches it; the splines with kappa > 0.
MODELS = {"linear": "LINEAR", "stvk": "STVK", "spline_nh": "SPLINE", "spline_stvk": None,
          "spline_corot": None}
KAPPA = 100.0


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _beam(make, bind, solver, lame, settings, model, dtype):
    mesh = make(*DIMS)
    flag = MODELS[model]
    if flag is not None:
        mesh.flags = bind.NOSELFCOLLISION | getattr(bind, flag)
        bind.add_tetmesh(solver, mesh, lame, verbose=False)
    else:
        solver.add_nodes(mesh.vertices, mesh.weighted_masses(bind.RUBBER_DENSITY))
        solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model, kappa=KAPPA,
                                lattice_dims=mesh.lattice_dims)
    solver.set_pins(_pins(mesh))
    assert solver.initialize(_settings(settings, dtype))
    return solver


def _jax_beam(model, dtype):
    return _beam(j_make, jbind, JSolver(), JLame.soft_rubber(), JSettings, model, dtype)


def _port_beam(model, dtype):
    return _beam(make_tet_blocks, binding, Solver(device="cpu"), Lame.soft_rubber(), Settings,
                 model, dtype)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_beam_matches_jax_f32(model):
    p = _port_beam(model, np.float32)
    assert p.system.tets[0].model == model
    _assert_close(_traj(p), _traj(_jax_beam(model, np.float32)), np.float32)


@pytest.mark.parametrize("model", ["linear", "spline_stvk"])
def test_beam_matches_jax_f64(model):
    _assert_close(_traj(_port_beam(model, np.float64)), _traj(_jax_beam(model, np.float64)),
                  np.float64)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_element_prox_entry(model):
    """TetBatch.prox on [T,3,3] (kernels D / F) equals its rows entry (kernel A
    with u = 0) on the stepped state, and launches nothing on the CPU."""
    p = _port_beam(model, np.float64)
    p.run(2)
    b = p.system.tets[0]
    rows = p_sys.Dx(p.system, p.state.x)[0]
    before = (cuda_prox.prox_tet_hyper.launches, cuda_prox.prox_tet_linear.launches,
              cuda_local_step.local_step_tet_hyper.launches)
    z33 = b.prox(rows.T.reshape(-1, 3, 3).contiguous())
    zr = b.prox(rows)
    assert z33.shape == (b.n, 3, 3) and torch.isfinite(z33).all()
    assert torch.equal(z33.reshape(-1, 9).T, zr)
    dead = b.weight == 0
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.allclose(z33[dead], eye.expand(int(dead.sum()), 3, 3), atol=1e-9)
    assert before == (cuda_prox.prox_tet_hyper.launches, cuda_prox.prox_tet_linear.launches,
                      cuda_local_step.local_step_tet_hyper.launches)
