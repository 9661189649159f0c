"""Uzawa around its PCG inner (two-grid, kernel G on the card) through the
port's Solver on the CPU against the JAX package's goldens: crossval's small
floor scene (chip_smoke.CONTACT_SCENES contact_uzawa_pcg, the 6x3x3 linear
beam, uzawa_inner "pcg") for 12 steps, landing at step 11, in float32 and
float64; the Schur trips of every step; the vertices in contact.
"""

import pytest
import torch

from test_torch_contact_paths import check, rollout

torch.set_num_threads(1)

# (after the first step, after landing); the port on the CPU against the
# goldens: float32 0 / 3.4e-3 (the Schur CG meets its max_iters on the landed
# beam, see test_torch_contact_paths.F32_BOUNDS), its Schur trips within 10 %
# (105 against 117); float64 0 / 3.1e-15 in the golden's trips.
BOUNDS = {"contact_uzawa_pcg": ((1e-4, 2e-2), 0.15), "contact_uzawa_pcg_f64": ((1e-12, 1e-11), 0.0)}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_uzawa_pcg_inner_holds_its_bounds_against_the_golden(name):
    solver, g, xs, inner = rollout(name, stop=12)
    bounds, share = BOUNDS[name]
    check(name, xs, inner, g, bounds, share, exact_contacts=name.endswith("f64"))
    assert type(solver._solve_data).__name__ == "PCGData"
    assert solver._solve_data.agg is not None  # two-grid
