"""Self-collision under Gauss-Seidel through the port's Solver on the CPU
against the JAX package: the stacked boxes of
tests/test_torch_selfcollision_paths.py (tests/test_contact.py:317-345),
float32 and float64, ten steps through the first dynamic rows (step 9): the
positions at every step, the dynamic hits both packages detect at the JAX
package's state, the sweeps; then the JAX test's no-tunnelling oracle over
50 steps of AL-PCG on the port alone (tests/test_contact.py:199-220;
Gauss-Seidel's, whose plain sweeps take some 3 s a step here, is
tests/test_torch_selfcollision_oracle.py).
"""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from test_torch_selfcollision_paths import FLOOR_TOL, FLOOR_Y, HITS_F32, run_both, stack_scene

torch.set_num_threads(1)
# Gauss-Seidel's sweeps are the same in both packages (30 a solve after the
# landing) and its x within 1.2e-13 in float64 through step 14 (this
# scene's runs); float32 within some 1e-4 from the float32 direct steps of
# the fall on.
X_TOL_GS = {"f64": 1e-11, "f32": 5e-3}


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gs_stack_through_first_contact(dtype):
    np_dtype = np.float64 if dtype == "f64" else np.float32
    gaps, hj, ht, ij, it = run_both(1, np_dtype)
    assert next(k for k, h in enumerate(hj) if h > 0) == 8, hj
    assert max(gaps) <= X_TOL_GS[dtype], gaps
    bound = 0 if dtype == "f64" else HITS_F32
    assert all(abs(a - b) <= bound for a, b in zip(hj, ht)), (hj, ht)
    if dtype == "f64":
        assert it == ij, (ij, it)


def test_alpcg_stack_does_not_tunnel():
    """tests/test_contact.py test_boxes_stack_alpcg on the port alone: 50
    AL-PCG steps, float32, the floor held and the top box above the bottom
    one."""
    s = stack_scene(4, np.float32, False)
    s.run(50)
    x = s.x
    n_per = len(make_tet_blocks(3, 3, 3).vertices)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > FLOOR_Y - FLOOR_TOL
    assert x[n_per:, 1].min() > 0.2, x[n_per:, 1].min()
