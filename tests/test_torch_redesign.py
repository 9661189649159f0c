"""What the redesigned kernels A and C rest on, checked on the CPU against the
plain versions (no card, no JAX compile):

- kernel A (csrc/prox_body.cuh) leaves the Newton loop on the trip that finds
  a lane converged and leaves the line search at the first candidate below
  f0: the plain prox cut to each lane's own trip count must equal the 8-trip result bit for
  bit, and "first j with fc_j < f0" must pick what the sequential scan picks;
- kernel C (csrc/stencil.cu) has a tiled and a wide branch, chosen from the
  shapes alone (ops/cuda_stencil.rhs_plan), and walks a host-built match
  table (rhs_match_table); a plain PyTorch walk of the tiled algorithm, kept
  here, must equal tet_rhs_rows_plain bit for bit.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.ops.hyper_soa import _vgh_soa, prox_tet_hyper_tuple
from admm_elastic_tpu_torch.ops.prox import TET_MODELS
from admm_elastic_tpu_torch.system import elements as el

torch.set_num_threads(1)

HYPER_MODELS = [m for m in TET_MODELS if m != "linear"]
DTYPES = [torch.float64, torch.float32]
N_ITERS = 8


def _batch(dims, off, dtype, model="neohookean"):
    mesh = make_tet_blocks(*dims)
    lame = Lame.soft_rubber()
    kappa = lame.bulk_modulus() if model.startswith("spline") else 0.0
    b = el.build_tet_batch(mesh.vertices, mesh.tets, lame, model, device="cpu", dtype=dtype,
                           kappa=kappa, vertex_offset=off, lattice_dims=mesh.lattice_dims)
    return mesh, b, off + len(mesh.vertices)


def _prox_inputs(model, dtype, which):
    """F rows [9, T] of a 5x4x3 lattice and its material rows: D x of the
    perturbed lattice plus a small u ("main"), or near-identity F with every
    5th lane inverted and every 7th stretched x3 ("stress"; kappa = k / 1000
    for the splines, whose cubic term is unbounded below)."""
    mesh, b, _ = _batch((5, 4, 3), 0, dtype, model)
    rng = np.random.default_rng(21)
    if which == "main":
        x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                            dtype=dtype)
        f = st.tet_Dx_rows_plain(x, b) + torch.as_tensor(
            0.05 * rng.standard_normal((9, b.n)), dtype=dtype)
        kappa = b.kappa
    else:
        f_np = np.eye(3)[None] + 0.4 * rng.standard_normal((b.n, 3, 3))
        f_np[::5] *= -1.0
        f_np[1::7] *= 3.0
        f = torch.as_tensor(f_np.reshape(b.n, 9).T.copy(), dtype=dtype)
        kappa = 1e-3 * b.bulk if model.startswith("spline") else b.kappa
    return tuple(f), (b.mu, b.lam, kappa, b.bulk)


@pytest.mark.parametrize("which", ["main", "stress"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", HYPER_MODELS)
def test_leaving_the_newton_loop_on_convergence_changes_no_bit(model, dtype, which):
    f, params = _prox_inputs(model, dtype, which)
    trips = {"lanes": []}
    full = torch.stack(prox_tet_hyper_tuple(f, model, *params, n_iters=N_ITERS, trips=trips))
    # a lane's own trip count: the trips it is live in, the converging one included
    own = torch.stack([live for live, _, _ in trips["lanes"]]).sum(dim=0)
    assert own.min() >= 1 and own.max() <= N_ITERS
    assert int(own.sum()) == trips["gradients"]
    seen = 0
    for k in range(1, N_ITERS + 1):
        lanes = own == k
        if not lanes.any():
            continue
        cut = torch.stack(prox_tet_hyper_tuple(f, model, *params, n_iters=k))
        assert torch.equal(cut[:, lanes], full[:, lanes]), f"lanes that need {k} trips"
        seen += int(lanes.sum())
    assert seen == own.numel()
    assert len(torch.unique(own)) > 1  # the inputs do exercise different trip counts


def _sequential_pick(s, cands, fcs, f0):
    """The line search of ops/hyper_soa.newton_soa as it stands there."""
    best, best_f = s, f0
    accepted = torch.zeros_like(f0, dtype=torch.bool)
    for cand, fc in zip(cands, fcs):
        take = (~accepted) & (fc < best_f)
        best = tuple(torch.where(take, ci, bi) for ci, bi in zip(cand, best))
        best_f = torch.where(take, fc, best_f)
        accepted = accepted | take
    return best, accepted


def _first_below_pick(s, cands, fcs, f0):
    """What the kernel's search comes to: every candidate held against f0
    alone, the first one below it chosen."""
    below = torch.stack([fc < f0 for fc in fcs])  # [8, lanes]
    any_below = below.any(dim=0)
    first = torch.argmax(below.to(torch.int8), dim=0)  # the first True
    stacked = torch.stack([torch.stack(c) for c in cands])  # [8, 3, lanes]
    chosen = torch.gather(stacked, 0, first[None, None, :].expand(1, 3, -1))[0]
    return tuple(torch.where(any_below, chosen[i], s[i]) for i in range(3)), any_below


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", HYPER_MODELS)
def test_first_candidate_below_f0_is_the_sequential_scans_pick(model, dtype):
    f, (mu, lam, kappa, k) = _prox_inputs(model, dtype, "stress")
    n = f[0].shape[0]
    rng = np.random.default_rng(22)
    s0 = tuple(torch.as_tensor(1.0 + 0.3 * rng.standard_normal(n), dtype=dtype).abs() + 0.05
               for _ in range(3))
    value, grad, _ = _vgh_soa(model, mu, lam, kappa, k, s0)
    s = tuple(si * torch.as_tensor(1.0 + 0.2 * rng.standard_normal(n), dtype=dtype).abs()
              for si in s0)
    d = tuple(gi / (gi.abs().max() + 1.0) * 3.0 for gi in grad(s))
    # Lanes 0-9: an uphill direction, so that none is accepted; lanes 10-19: a
    # NaN direction (every candidate NaN); lanes 20-29: NaN in the first three
    # candidates only.
    d = tuple(torch.cat([-di[:10], torch.full((10,), float("nan"), dtype=dtype), di[20:]])
              for di in d)
    cands, fcs, t = [], [], 1.0
    for j in range(8):
        cand = tuple(torch.clamp(si - t * di, min=1e-9) for si, di in zip(s, d))
        if j < 3:
            cand = tuple(torch.cat([c[:20], torch.full((10,), float("nan"), dtype=dtype), c[30:]])
                         for c in cand)
        cands.append(cand)
        fcs.append(value(cand))
        t *= 0.5
    f0 = value(s)
    want, accepted = _sequential_pick(s, cands, fcs, f0)
    got, any_below = _first_below_pick(s, cands, fcs, f0)
    assert torch.equal(accepted, any_below)
    assert not accepted[10:20].any()  # NaN compares false: none accepted
    assert (~accepted).sum() > 10 and accepted.sum() > n // 4  # both outcomes occur
    for g, w, si in zip(got, want, s):
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        assert same.all()
        assert torch.equal(g[~accepted], si[~accepted])


@pytest.mark.parametrize("model", HYPER_MODELS)
def test_warp_chains_follow_the_slowest_lane_of_a_warp(model):
    """chip_smoke.warp_chains, which sizes kernel A's time from the plain
    version's masks: a warp runs as many trips as its slowest lane, so its
    mean over the warps lies between the mean over the lanes and 8."""
    f, params = _prox_inputs(model, torch.float32, "main")
    trips = {"lanes": []}
    prox_tet_hyper_tuple(f, model, *params, n_iters=N_ITERS, trips=trips)
    n = f[0].shape[0] // 32 * 32
    masks = [tuple(m[:n] for m in trip) for trip in trips["lanes"]]
    got = chip_smoke.warp_chains(torch, model, masks)
    own = torch.stack([live for live, _, _ in masks]).sum(dim=0).double()
    assert own.mean() <= got["trips_mean"] <= got["trips_max"] == own.max() <= N_ITERS
    assert 1 <= got["warps_at_max_trips"] <= n // 32
    assert got["candidates_mean"] <= got["candidates_max"] <= 8 * N_ITERS
    assert 0.0 < got["chain_mean"] <= got["chain_max"] <= 1.0
    with pytest.raises(chip_smoke.SmokeFailure, match="whole warps"):
        chip_smoke.warp_chains(torch, model, [tuple(m[:n - 1] for m in trip) for trip in masks])


# --- kernel C: the branch choice, the match table, the tiled walk ----------------

BENCH_HALO = 6 * 6 + 6 + 1  # make_tet_blocks(40, 5, 5): Y = Z = 6


@pytest.mark.parametrize("itemsize,want_bytes", [(4, 21372), (8, 42744)])
def test_rhs_plan_bench_beam_is_tiled(itemsize, want_bytes):
    assert cuda_stencil.rhs_plan(BENCH_HALO, itemsize) == ("tiled", cuda_stencil.RHS_TILE,
                                                          want_bytes)
    assert cuda_stencil.rhs_plan(BENCH_HALO, itemsize, branch="wide") == ("wide", 0, 0)
    assert cuda_stencil.rhs_plan(BENCH_HALO, itemsize, tile=128)[:2] == ("tiled", 128)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_rhs_plan_wide_cross_section_is_wide(itemsize):
    halo = 63 * 63 + 63 + 1  # a lattice of 3 x 63 x 63 vertices
    assert cuda_stencil.rhs_plan(halo, itemsize) == ("wide", 0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stencil.rhs_plan(halo, itemsize, branch="tiled")


def test_rhs_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="branch"):
        cuda_stencil.rhs_plan(BENCH_HALO, 4, branch="fast")
    with pytest.raises(ValueError, match="tile"):
        cuda_stencil.rhs_plan(BENCH_HALO, 4, tile=512)
    # the largest halo that still fits beside the default tile, and the next
    tile = cuda_stencil.RHS_TILE
    fits = (cuda_stencil.MAX_SHARED_BYTES // 4 - 24 * tile) // 61 - tile
    assert cuda_stencil.rhs_plan(fits, 4)[0] == "tiled"
    assert cuda_stencil.rhs_plan(fits + 1, 4)[0] == "wide"


@pytest.mark.parametrize("dims", [(5, 4, 3), (4, 2, 2), (40, 5, 5)])
def test_match_table_holds_every_pair_once_or_as_an_even_odd_couple(dims):
    _, _, _, _, pe, po = st._tet_geom(_batch(dims, 0, torch.float64)[1].stencil)
    table = cuda_stencil.rhs_match_table(pe, po)
    assert len(table) == 8
    seen = {}
    for cid, row in enumerate(table):
        assert [sj for sj, _ in row] == sorted(sj for sj, _ in row)  # slot-major
        for sj, kind in row:
            seen.setdefault(sj, []).append((kind, cid))
    assert sorted(seen) == list(range(20))
    for sj, uses in seen.items():
        he, ho = pe[sj // 4][sj % 4], po[sj // 4][sj % 4]
        if he == ho:
            assert uses == [(cuda_stencil.BOTH, he)]
        else:
            assert sorted(uses) == sorted([(cuda_stencil.EVEN, he), (cuda_stencil.ODD, ho)])
    assert sum(len(row) for row in table) <= 40
    # the struct the kernel reads: offs[8], start[9], ent[40], wrap
    match = list(cuda_stencil.geom_of(_batch(dims, 0, torch.float64)[1].stencil)[5])
    assert len(match) == 58 and match[8] == 0 and match[57] == 0
    assert match[16] == sum(len(row) for row in table)
    ent = [sj | kind << 8 for row in table for sj, kind in row]
    assert match[17:17 + len(ent)] == ent


def tiled_rhs_walk(z, u, b, n_verts, tile):
    """Kernel C's tiled branch in plain PyTorch, block by block: phase 1 fills
    a [60, tile + halo] buffer with the corner contributions of the cells that
    can feed the tile, phase 2 gathers them per vertex in the match table's
    order."""
    base, cells, n_vblock, offs, pe, po = st._tet_geom(b.stencil)
    table = cuda_stencil.rhs_match_table(pe, po)
    halo = max(offs)
    width = tile + halo
    zz, uu = z.reshape(9, 5, cells), u.reshape(9, 5, cells)
    w, dl, par = b.weight.reshape(5, cells), b.st_dl, b.st_par
    out = torch.full((n_verts, 3), float("nan"), dtype=z.dtype)
    for blk in range(-(-n_verts // tile)):
        q0 = blk * tile - base
        p0 = q0 - halo
        # phase 1
        sm = torch.full((60, width), float("nan"), dtype=z.dtype)
        lo, hi = max(p0, 0), min(p0 + width, cells)
        if lo < hi:
            cols = slice(lo - p0, hi - p0)
            for s in range(5):
                w2 = w[s, lo:hi] * w[s, lo:hi]
                g = w2 * (zz[:, s, lo:hi] - uu[:, s, lo:hi])
                for j in range(4):
                    for r in range(3):
                        cr = g[3 * r] * dl[s, j, 0, lo:hi]
                        cr = cr + g[3 * r + 1] * dl[s, j, 1, lo:hi]
                        sm[(s * 4 + j) * 3 + r, cols] = cr + g[3 * r + 2] * dl[s, j, 2, lo:hi]
        # phase 2
        for th in range(tile):
            q = q0 + th
            if q + base >= n_verts:
                break
            total = torch.zeros(3, dtype=z.dtype)
            if 0 <= q < n_vblock:
                for cid in range(8):
                    p = q - offs[cid]
                    if p < 0 or p >= cells or not table[cid]:
                        continue
                    col = p - p0
                    pr = par[p]
                    inv = 1.0 - pr
                    acc = None
                    for sj, kind in table[cid]:
                        c = sm[sj * 3:sj * 3 + 3, col]
                        v = c if kind == cuda_stencil.BOTH else (
                            pr if kind == cuda_stencil.EVEN else inv) * c
                        acc = v if acc is None else acc + v
                    total = total + acc
            out[q + base] = total
    return out


@pytest.mark.parametrize("tile", [7, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,off", [((5, 4, 3), 0), ((4, 2, 2), 11)])
def test_tiled_walk_equals_plain_rhs_bit_for_bit(dims, off, dtype, tile):
    _, b, n = _batch(dims, off, dtype)
    rng = np.random.default_rng(23)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), dtype=dtype) for _ in range(2))
    got = tiled_rhs_walk(z, u, b, n, tile)
    want = st.tet_rhs_rows_plain(z, u, b, n)
    assert torch.isfinite(got).all()  # no cell outside the staged range was read
    assert torch.equal(got, want)
    if off:
        assert torch.equal(got[:off], torch.zeros(off, 3, dtype=dtype))


def test_rhs_wrapper_takes_branch_and_tile_on_the_cpu():
    _, b, n = _batch((4, 2, 2), 11, torch.float64)
    rng = np.random.default_rng(24)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n))) for _ in range(2))
    want = st.tet_rhs_rows_plain(z, u, b, n)
    before = cuda_stencil.tet_rhs_rows.launches
    for kw in ({}, {"branch": "tiled"}, {"branch": "wide"}, {"tile": 32}):
        assert torch.equal(cuda_stencil.tet_rhs_rows(z, u, b, n, **kw), want)
    assert cuda_stencil.tet_rhs_rows.launches == before
