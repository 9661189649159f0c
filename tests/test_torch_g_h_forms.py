"""The host-side choice of form of kernels G and H (ops/cuda_pcg.g_form,
ops/cuda_gs.h_form): pure functions of N, the dtype and the card's cluster
and shared-memory budget, checked here on the CPU at the paths' shapes, at
each form's edge and beyond it; and the constants they share with the CUDA
sources. The kernels themselves run only on the card
(tests/test_torch_cuda_pcg.py, tests/test_torch_cuda_contact.py)."""

import re
from pathlib import Path

import pytest

from admm_elastic_tpu_torch.ops import cuda_gs, cuda_pcg

CSRC = Path(cuda_pcg.__file__).resolve().parent.parent / "csrc"
OPTIN = 232_448  # an H100's shared memory a block may take (cudaDevAttrMaxSharedMemoryPerBlockOptin)
F32, F64 = 4, 8


@pytest.mark.parametrize("n,itemsize,bands,rest,want", [
    (5_184, F32, 18, 0, ("cluster", 11, 9)),  # torus_pcg20k
    (8_192, F32, 18, 0, ("grid", 0, 0)),  # the edge beam: 16 blocks, the CLUSTER form lost
    (15_616, F32, 18, 0, ("grid", 0, 0)),  # floor_uzawa67k, floor_alpcg67k: beyond 8,192
    (600, F32, 0, 27, ("grid", 0, 0)),  # bunny_pcg: a rest-ELL
    (35_721, F32, 18, 0, ("grid", 0, 0)),  # beam_pcg160k
    (25_921, F32, 4, 0, ("grid", 0, 0)),  # cloth_ls0_160
])
def test_g_form_at_the_paths_shapes(n, itemsize, bands, rest, want):
    assert cuda_pcg.g_form(n, itemsize, bands, rest, 16, OPTIN) == want


@pytest.mark.parametrize("max_cluster,largest", [(16, 8_192), (8, 4_096), (4, 2_048)])
@pytest.mark.parametrize("itemsize", [F32, F64])
def test_g_form_edge_follows_the_cluster_limit(max_cluster, largest, itemsize):
    inside = cuda_pcg.g_form(largest, itemsize, 18, 0, max_cluster, OPTIN, want="cluster")
    assert inside == ("cluster", max_cluster, 9)
    chosen = min(max_cluster, cuda_pcg.CLUSTER_CHOSEN)
    assert cuda_pcg.g_form(chosen * 512, itemsize, 18, 0, max_cluster, OPTIN) == (
        "cluster", chosen, 9)
    assert cuda_pcg.g_form(chosen * 512 + 1, itemsize, 18, 0, max_cluster, OPTIN) == (
        "grid", 0, 0)
    assert cuda_pcg.g_form(largest + 1, itemsize, 18, 0, max_cluster, OPTIN) == ("grid", 0, 0)
    with pytest.raises(ValueError):
        cuda_pcg.g_form(largest + 1, itemsize, 18, 0, max_cluster, OPTIN, want="cluster")


def test_g_form_takes_the_smallest_blocks_that_cover_n():
    # one vertex a thread: the chosen 11 blocks of 256 reach 2,816 vertices,
    # of 512 5,632; asked for, 16 blocks of 256 reach 4,096, of 512 8,192
    assert cuda_pcg.g_form(2_816, F32, 4, 0, 16, OPTIN) == ("cluster", 11, 8)
    assert cuda_pcg.g_form(2_817, F32, 4, 0, 16, OPTIN) == ("cluster", 6, 9)
    assert cuda_pcg.g_form(4_096, F32, 4, 0, 16, OPTIN, want="cluster") == ("cluster", 16, 8)
    assert cuda_pcg.g_form(4_097, F32, 4, 0, 16, OPTIN, want="cluster") == ("cluster", 9, 9)
    assert cuda_pcg.g_form(1, F64, 0, 0, 16, OPTIN) == ("cluster", 1, 8)


def test_g_form_keeps_rest_ell_rows_on_the_grid():
    assert cuda_pcg.g_form(600, F32, 0, 27, 16, OPTIN) == ("grid", 0, 0)
    assert cuda_pcg.g_form(600, F32, 0, 27, 16, OPTIN, want="cluster") == ("cluster", 3, 8)


def test_g_form_follows_the_shared_memory_budget():
    # 48 KB: a block of 256 (24.6 KB of float32 vectors) fits, of 512 not
    small = 48 * 1024
    assert cuda_pcg.cluster_smem(8, F32) + cuda_pcg.CLUSTER_STATIC_SMEM <= small
    assert cuda_pcg.cluster_smem(9, F32) + cuda_pcg.CLUSTER_STATIC_SMEM > small
    assert cuda_pcg.g_form(2_816, F32, 4, 0, 16, small) == ("cluster", 11, 8)
    assert cuda_pcg.g_form(2_817, F32, 4, 0, 16, small) == ("grid", 0, 0)
    assert cuda_pcg.g_form(4_096, F32, 4, 0, 16, small, want="cluster") == ("cluster", 16, 8)
    with pytest.raises(ValueError):
        cuda_pcg.g_form(4_097, F32, 4, 0, 16, small, want="cluster")
    # float64 halves what fits
    assert cuda_pcg.g_form(2_048, F64, 4, 0, 16, small) == ("grid", 0, 0)
    assert cuda_pcg.g_form(2_048, F64, 4, 0, 16, 2 * small) == ("cluster", 8, 8)


def test_g_form_asked_for():
    assert cuda_pcg.g_form(5_184, F32, 18, 0, 16, OPTIN, want="grid") == ("grid", 0, 0)
    assert cuda_pcg.g_form(8_000, F64, 18, 0, 16, OPTIN, want="cluster") == ("cluster", 16, 9)
    assert cuda_pcg.g_form(35_721, F32, 18, 0, 16, OPTIN, want="grid") == ("grid", 0, 0)


@pytest.mark.parametrize("want", [None, "grid", "cluster"])
def test_g_form_refuses_what_no_form_takes(want):
    with pytest.raises(ValueError, match="bands"):
        cuda_pcg.g_form(1_000, F32, cuda_pcg.MAX_BANDS + 1, 0, 16, OPTIN, want=want)
    with pytest.raises(ValueError, match="form"):
        cuda_pcg.g_form(1_000, F32, 4, 0, 16, OPTIN, want="warp")


@pytest.mark.parametrize("n,itemsize,want", [
    (1_476, F32, "shared"),  # floor_gs5k
    (1_476, F64, "shared"),
    (45, F64, "shared"),  # sphere_gs
    (15_616, F32, "shared"),  # the floor_uzawa67k beam: 187 KB
    (15_616, F64, "global"),  # 375 KB
])
def test_h_form_at_the_paths_shapes(n, itemsize, want):
    assert cuda_gs.h_form(n, itemsize, OPTIN) == want


@pytest.mark.parametrize("itemsize", [F32, F64])
def test_h_form_edge_follows_the_shared_memory(itemsize):
    largest = (OPTIN - cuda_gs.STATIC_SMEM) // (3 * itemsize)
    assert cuda_gs.h_form(largest, itemsize, OPTIN) == "shared"
    assert cuda_gs.h_form(largest + 1, itemsize, OPTIN) == "global"
    assert cuda_gs.h_form(largest + 1, itemsize, OPTIN, want="global") == "global"
    with pytest.raises(ValueError):
        cuda_gs.h_form(largest + 1, itemsize, OPTIN, want="shared")
    with pytest.raises(ValueError, match="form"):
        cuda_gs.h_form(10, itemsize, OPTIN, want="cluster")


@pytest.mark.parametrize("width,wide", [(558, True), (5_888, True), (20, False), (512, False),
                                        (513, True)])
def test_h_wide_block_where_a_colour_outgrows_512_threads(width, wide):
    assert cuda_gs.h_wide(width) is wide


def _constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text()).group(1))


def test_constants_match_the_cuda_sources():
    pcg_src = (CSRC / "pcg.cu").read_text()
    vecs = re.search(r"enum Vec \{([^}]*)\}", pcg_src).group(1)
    assert len([v for v in vecs.split(",") if v.strip() != "kVecs"]) == cuda_pcg.CLUSTER_VECS
    assert _constant("pcg.cu", "kMaxBands") == cuda_pcg.MAX_BANDS
    assert _constant("pcg.cu", "kMaxCluster") == cuda_pcg.CLUSTER_MAX
    assert _constant("pcg.cu", "kClusterThreads") == 1 << cuda_pcg.CLUSTER_SHIFTS[-1]
    assert _constant("pcg.cu", "kGroup") == cuda_pcg.BLOCK
    assert re.search(r"kSlots = (\d+)", pcg_src).group(1) == str(cuda_pcg.SLOTS)
    # the static shared memory the sources declare stays within the budgets
    assert _constant("gs.cu", "kLanes") // 32 + 1 <= cuda_gs.STATIC_SMEM // 8
    assert _constant("gs.cu", "kLanes") == cuda_gs.LANES
    assert _constant("gs.cu", "kMaxObstacles") == cuda_gs.MAX_OBSTACLES


def test_h_plan_moves_the_ell_without_changing_it():
    import torch

    from admm_elastic_tpu_torch.solvers.gs import GSData

    rng = torch.Generator().manual_seed(3)
    n, k = 11, 5
    cols = torch.randint(0, n, (n, k), generator=rng, dtype=torch.int32)
    vals = torch.rand((n, k), generator=rng, dtype=torch.float64)
    colors = torch.tensor([[0, 3, 6, 9], [1, 4, 7, 10], [2, 5, 8, n]], dtype=torch.int32)
    data = GSData(ell_cols=cols, ell_vals=vals, diag=torch.ones(n, dtype=torch.float64),
                  colors=colors, colors_mask=colors < n)
    plan = cuda_gs.build_plan(data)
    assert plan.ccols.shape == (3, k, 4) and plan.ccols.is_contiguous()
    for c in range(3):
        for i in range(4):
            row = int(colors[c, i])
            if row < n:  # slot i of colour c: its row's entries in column order
                assert torch.equal(plan.ccols[c, :, i], cols[row])
                assert torch.equal(plan.cvals[c, :, i], vals[row])
    assert torch.equal(plan.tcols, cols.T) and torch.equal(plan.tvals, vals.T)
    assert plan.tcols.is_contiguous() and plan.tcols.dtype == torch.int32
    assert cuda_gs.plan_of(data) is cuda_gs.plan_of(data)
