"""Self-collision's kernels on a CUDA card: K (a collider's detection), L (the
dynamic rows' face-corner sums) and the DYN forms of H and G. This file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_selfcollision.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the paths' full size). On the card:

- K and L bit for bit their plain twins (chip_smoke.k_detect, l_pair) on the
  folded block dense, broad and with HIT_CAP = 1, and on the 3x3x3 stacked
  boxes (two colliders) at a state with dynamic hits, float64 and float32;
- the captured rollout of the 3x3x3 stacks under Gauss-Seidel, Uzawa and
  AL-PCG through their first dynamic rows: bitwise equal to the eager loop,
  each step's overflow flag read outside the graph, the kernels launched.
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


def stack(ls, dtype=np.float32):
    """The 3x3x3 stacked boxes (tests/test_contact.py:317-345) on the card."""
    from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks, make_xform

    s = Solver(device="cuda")
    for i in range(2):
        m = make_tet_blocks(3, 3, 3, cell=1.0 / 3.0)
        m.apply_xform(make_xform(trans=(0.0, i * 1.25, 0.0)))
        m.flags = binding.LINEAR
        binding.add_tetmesh(s, m, Lame.rubber(), verbose=False)
    s.add_obstacle(Floor(y=-0.5))
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=ls, dtype=dtype))
    return s


@pytest.mark.parametrize("limits", [dict(BROADPHASE_MIN_TETS=10 ** 9),
                                    dict(BROADPHASE_MIN_TETS=1),
                                    dict(BROADPHASE_MIN_TETS=10 ** 9, HIT_CAP=1)],
                         ids=["dense", "broad", "hit_cap1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k_and_l_on_the_folded_block(cuda_device, dtype, limits):
    cols, x, surf = chip_smoke.folded_case(torch, 6)
    cols = [c.to("cuda", dtype) for c in cols]
    x = x.to(dtype)
    with chip_smoke.dyn_limits(**limits):
        rows_k, flag_k = chip_smoke.k_detect(torch, cols, x, surf, plain=False)
        rows_p, flag_p = chip_smoke.k_detect(torch, cols, x, surf, plain=True)
    for a, b in zip(rows_k, rows_p):
        assert torch.equal(a, b)
    assert int(flag_k.item()) == int(flag_p.item())
    hits = int(rows_k[0].sum().item())
    assert hits == 1 if "HIT_CAP" in limits else hits > 10
    h = chip_smoke.rows_hits(torch, rows_k, surf, x.shape[0])
    err, bitwise = chip_smoke.l_pair(torch, h, x.shape[0], seed=3)
    assert bitwise, err


@pytest.mark.parametrize("ls", [1, 2, 4])
def test_stack_graph_is_the_eager_loop(cuda_device, ls):
    """The stacks through their first dynamic rows (step 9): the graph's 10
    steps bitwise the eager loop's, the dynamic rows found, K's launches
    counted by its wrapper in the capture."""
    from admm_elastic_tpu_torch.ops import cuda_dynamic

    s = stack(ls)
    st0 = s.state.clone()
    before = cuda_dynamic.dyn_detect.launches
    s.run(10)
    assert cuda_dynamic.dyn_detect.launches > before
    x_graph = s.state.x.clone()
    assert bool(torch.isfinite(x_graph).all())
    assert chip_smoke.dyn_hits(s, x_graph) > 0
    s.state = st0.clone()
    s._run_eager(10)
    assert torch.equal(s.state.x, x_graph)
    s.state = st0.clone()
    for _ in range(10):
        s.step()
        assert s.runtime_data().collision_overflow is False
