"""A port copy of tests/test_inversion_recovery.py: extreme-inversion
robustness of the bunnyexpand tier (samples/sca2016/bunnyexpand.cpp) on the
port's CPU solver, on the same 250-point bunny-class mesh
(geometry/factory.make_tet_bunny_like, bit for bit the JAX package's).

Non-finite volumes count as inverted: a NaN state must never read as
recovered (admm_elastic_tpu_torch.apps.bunnyexpand.inverted). The float32
collapse is in tests/test_torch_inversion_recovery_f32.py (each file some
60 s on one CPU thread).
"""

import numpy as np
import torch

from admm_elastic_tpu_torch import Settings, Solver, binding
from admm_elastic_tpu_torch.apps.bunnyexpand import inverted
from admm_elastic_tpu_torch.geometry.factory import make_tet_bunny_like, make_xform

torch.set_num_threads(1)


def _bunny_solver(dtype=np.float64):
    mesh = make_tet_bunny_like(250)  # small bunny-class mesh
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    mesh.apply_xform(make_xform(rot_deg=20.0, rot_axis=(1, 0, 0)))
    solver = Solver(device="cpu")
    binding.add_tetmesh(solver, mesh, verbose=False)
    assert solver.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, gravity=0.0,
                                      dtype=dtype))
    return solver, mesh


def test_point_collapse_recovers_fully():
    """Every vertex collapsed to one point: the neo-Hookean prox's collapse
    inflation and sign rectification restore the whole mesh."""
    solver, mesh = _bunny_solver()
    solver.x = np.zeros_like(solver.x)
    for _ in range(80):
        solver.step()
    x = solver.x
    assert np.isfinite(x).all()
    assert inverted(x, mesh.tets) == 0


def test_random_scramble_stays_finite():
    """A uniform scramble is a globally knotted tangle that no local
    elasticity undoes; the state stays finite and bounded, and a good part of
    the elements recovers."""
    solver, mesh = _bunny_solver()
    rng = np.random.default_rng(100)
    x0 = solver.x
    lo, hi = x0.min(0), x0.max(0)
    solver.x = rng.uniform(lo, hi, size=x0.shape)
    for _ in range(60):
        solver.step()
    x = solver.x
    assert np.isfinite(x).all(), "scramble blew up to non-finite state"
    assert np.abs(x).max() < 50.0 * np.abs(hi).max()
    assert inverted(x, mesh.tets) < 0.75 * len(mesh.tets)
