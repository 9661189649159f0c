"""Contact through the port's Solver on the CPU in float64 against the JAX
package's goldens (tests/make_torch_golden.py): crossval's small floor scene
(chip_smoke.CONTACT_SCENES: the 6x3x3 linear beam, 14 steps, landing at
step 11) with Gauss-Seidel, Uzawa's direct inner and AL-PCG in both forms,
and crossval's sphere_obstacle_gs (20 steps, on the sphere from step 16),
held tight; the inner iterations of every step; the vertices in contact.
"""

import numpy as np
import pytest
import torch

from test_torch_contact_paths import check, rollout

torch.set_num_threads(1)

# (after the first step, after landing) on x relative to max |x|; the port on
# the CPU against the goldens: contact_gs_f64 3.4e-15 / 3.6e-14, contact_alpcg_f64
# 0 / 1.5e-14, contact_alpcg_twogrid_f64 0 / 3.1e-11 (the coarse matmul's sum
# order moves a CG trip: 174 against 176), sphere_gs_f64 4.5e-15 / 1.2e-13.
# Uzawa's direct inner: 1.1e-15 before landing, 1.8e-3 after: its Schur CG
# meets uzawa_max_iters (20) on the landed beam, and its unconverged iterate
# carries the two GEMMs' sum orders (XLA's and the CPU BLAS's, 1e-16 apart)
# into the contact forces; held at five times that (its PCG inner, whose
# sums run alike in both packages, holds 5.8e-15: test_torch_contact_inner.py).
F64_BOUNDS = {"contact_gs_f64": (1e-12, 1e-11), "contact_uzawa_f64": (1e-12, 1e-2),
              "contact_alpcg_f64": (1e-12, 1e-11), "contact_alpcg_twogrid_f64": (1e-12, 1e-9),
              "sphere_gs_f64": (1e-12, 1e-11)}
F64_INNER = {"contact_gs_f64": 0.0, "contact_uzawa_f64": 0.1, "contact_alpcg_f64": 0.0,
             "contact_alpcg_twogrid_f64": 0.02, "sphere_gs_f64": 0.0}


@pytest.mark.parametrize("name", sorted(F64_BOUNDS))
def test_float64_contact_scene_holds_its_bounds_against_the_golden(name):
    solver, g, xs, inner = rollout(name)
    check(name, xs, inner, g, F64_BOUNDS[name], F64_INNER[name],
          exact_contacts=name != "contact_uzawa_f64")
    assert solver.state.x.dtype == torch.float64
    if name.startswith("sphere"):  # tests/test_contact.py:404-406
        d = np.linalg.norm(xs[20] - np.array([0.0, -10.0, 0.0]), axis=1)
        assert 10.0 - 0.05 < d.min() < 10.2
