"""Self-collision's kernels on a CUDA card: K (a collider's detection), L (the
dynamic rows' face-corner sums) and the DYN forms of H and G. This file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_selfcollision.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the paths' full size). On the card:

- K and L bit for bit their plain twins (chip_smoke.k_detect, l_pair) on the
  folded block dense, broad and with HIT_CAP = 1, and on the 3x3x3 stacked
  boxes (two colliders) at a state with dynamic hits, float64 and float32;
- K on the dense tiles' edges (chip_smoke.tile_case, 2,560 and 2,553 tets),
  overflowing cells, three colliders two of which list one vertex
  (chip_smoke.three_case, dense and broad) and the block at rest (no hit),
  bit for bit its twin with the flag equal; four launches a detection
  whatever the number of colliders, counted on the device; no candidate
  tensor built on the card (the plain _broad_phase_candidates unreached);
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


def _case(name):
    """(colliders, x, surf, limits, expect) of a named K case (chip_smoke's)."""
    import dataclasses

    dense, broad = dict(BROADPHASE_MIN_TETS=10 ** 9), dict(BROADPHASE_MIN_TETS=1)
    if name.startswith("tiles"):
        return (*chip_smoke.tile_case(torch, 0 if name == "tiles" else 7), dense,
                dict(hits="some"))
    if name.startswith("cell_cap"):
        cols, x, surf = chip_smoke.folded_case(torch, 8)
        cols = [dataclasses.replace(c, cell_cap=int(name[-1])) for c in cols]
        return cols, x, surf, broad, dict(overflow=1)
    if name.startswith("three"):
        return (*chip_smoke.three_case(torch), broad if name.endswith("broad") else dense,
                dict(hits="some"))
    return (*chip_smoke.folded_case(torch, 8, fold=False), dense, dict(hits=0, overflow=0))


@pytest.mark.parametrize("name", ["tiles", "tiles_ragged", "cell_cap1", "cell_cap2",
                                  "three_dense", "three_broad", "at_rest"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k_on_tiles_overflow_three_colliders_and_no_hit(cuda_device, dtype, name):
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    cols, x, surf, limits, expect = _case(name)
    table = dyn.collider_table([c.to("cuda", dtype) for c in cols])
    x = x.to(dtype)
    with chip_smoke.dyn_limits(**limits):
        rows_k, flag_k = chip_smoke.k_detect(torch, table, x, surf, plain=False)
        rows_p, flag_p = chip_smoke.k_detect(torch, table, x, surf, plain=True)
    for a, b in zip(rows_k, rows_p):
        assert torch.equal(a, b)
    assert int(flag_k.item()) == int(flag_p.item()) == expect.get("overflow", int(flag_p.item()))
    hits = int(rows_k[0].sum().item())
    assert hits > 0 if expect.get("hits") == "some" else hits == expect.get("hits", hits)


@pytest.mark.parametrize("broad", [False, True], ids=["dense", "broad"])
def test_k_is_four_launches_whatever_the_colliders(cuda_device, monkeypatch, broad):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from admm_elastic_tpu_torch.collision import dynamic as dyn

    def no_candidates(*args, **kwargs):
        raise AssertionError("the card path built the candidate tensor")

    cols, x, surf = chip_smoke.three_case(torch)
    table = dyn.collider_table(cols)
    limits = dict(BROADPHASE_MIN_TETS=1 if broad else 10 ** 9)
    monkeypatch.setattr(dyn, "_broad_phase_candidates", no_candidates)
    with chip_smoke.dyn_limits(**limits):
        chip_smoke.k_detect(torch, table, x, surf, plain=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chip_smoke.k_detect(torch, table, x, surf, plain=False)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum(any(k in n for k in chip_smoke.K_KERNELS) for n in names) == 4
    assert sum("dyn_rank_kernel" in n for n in names) == 1


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
