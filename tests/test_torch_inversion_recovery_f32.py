"""tests/test_inversion_recovery.py's float32 point collapse on the port's
CPU solver (the rest of that file's port copy is
tests/test_torch_inversion_recovery.py)."""

import numpy as np
import torch

from admm_elastic_tpu_torch.apps.bunnyexpand import inverted
from test_torch_inversion_recovery import _bunny_solver

torch.set_num_threads(1)


def test_point_collapse_recovers_in_f32():
    """float32: the unpinned stored-inverse path takes one refinement pass
    (Solver._refine_eff); the recovery completes and stays finite, with at
    most 3 flickering boundary slivers."""
    solver, mesh = _bunny_solver(np.float32)
    assert solver._refine_eff >= 1
    solver.x = np.zeros_like(solver.x)
    for _ in range(120):
        solver.step()
    x = solver.x
    assert np.isfinite(x).all(), "f32 point collapse went non-finite"
    assert inverted(x, mesh.tets) <= 3
