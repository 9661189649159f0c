"""The JAX test's no-tunnelling oracle for Gauss-Seidel with self-collision
(tests/test_contact.py:317-345, test_boxes_stack_gs) on the port alone, on
the CPU: the stacked boxes of tests/test_torch_selfcollision_paths.py, 50
steps, float32; the floor held and the top box above the bottom one. Its own
file: the plain sweeps take some 3 s a step here.
"""

import numpy as np
import torch

from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from test_torch_selfcollision_paths import FLOOR_TOL, FLOOR_Y, stack_scene

torch.set_num_threads(1)


def test_gs_stack_does_not_tunnel():
    s = stack_scene(1, np.float32, False)
    s.run(50)
    x = s.x
    n_per = len(make_tet_blocks(3, 3, 3).vertices)
    assert np.isfinite(x).all()
    assert x[:, 1].min() > FLOOR_Y - FLOOR_TOL
    assert x[n_per:, 1].min() > 0.2, x[n_per:, 1].min()
    assert s.runtime_data().collision_overflow is False
