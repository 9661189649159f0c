"""The schedule of kernels J and H's exact walk and of J's ranking across
blocks, emulated in plain PyTorch on the CPU (no card, no JAX Solver):

- the grouped walk (csrc/obstacle_body.cuh candidates): a group of g threads
  takes a cell's row, thread t walks entries t, t + g, ... keeping its first
  least (d2, k) under a strict d2 < best from 1e30, then the group reduces by
  xor shuffles in the kernel's order (the smaller d2, the lower k on a tie).
  For g in 1-32 its pick is held to a serial walk, to torch.argmin over the
  masked row, to the port's PassiveMeshExact._closest_over and to the JAX
  package's, on the crossval slab's tables: planted equal d2, rows with no
  entry (entry 0), rows shorter than g, NaN lanes;
- the block-offset ranking (csrc/obstacle.cu): each block ranks its span's
  flags in 512-lane chunks, then adds the counts of the blocks before it;
  the listed lanes are held to the port's _first_k and to jax.lax.top_k on a
  0/1 mask, for several grids;
- the rules that choose J's grid, span and group.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.collision import passive as jpassive
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.geometry.factory import make_xform as j_make_xform
from admm_elastic_tpu_torch.collision import passive as tpassive
from admm_elastic_tpu_torch.ops import cuda_gs, cuda_obstacle

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
BIG = 1e30  # csrc/obstacle_body.cuh kBig
NONE = np.iinfo(np.int32).max  # a thread's "no entry below kBig"
GROUPS = (1, 2, 4, 8, 16, 32)
THREADS = cuda_obstacle.J_THREADS


def grouped_pick(d2: torch.Tensor, cnt: torch.Tensor, g: int):
    """The kernel's grouped walk over rows d2 [V, Kf] with cnt [V] entries:
    (best [V, g], j [V, g]) held by each thread of the group after the xor
    reduction."""
    v, kf = d2.shape
    best = torch.full((v, g), BIG, dtype=d2.dtype)
    j = torch.full((v, g), NONE, dtype=torch.int64)
    for t in range(g):
        for k in range(t, kf, g):
            take = (k < cnt) & (d2[:, k] < best[:, t])  # a NaN d2 never takes
            best[:, t] = torch.where(take, d2[:, k], best[:, t])
            j[:, t] = torch.where(take, k, j[:, t])
    off = g // 2
    while off > 0:
        partner = torch.arange(g) ^ off
        b2, j2 = best[:, partner], j[:, partner]
        take = (b2 < best) | ((b2 == best) & (j2 < j))
        best, j = torch.where(take, b2, best), torch.where(take, j2, j)
        off //= 2
    return best, torch.where(j == NONE, 0, j)


def serial_pick(d2: torch.Tensor, cnt: torch.Tensor):
    """The parent's serial walk: the first strict d2 < best from 1e30, j from 0."""
    out = []
    for row, c in zip(d2.tolist(), cnt.tolist()):
        best, j = BIG, 0
        for k in range(c):
            if row[k] < best:
                best, j = row[k], k
        out.append(j)
    return torch.tensor(out)


def planted_rows(dtype, seed=0):
    """Rows of squared distances with planted ties at the least value, rows
    shorter than 32, rows with no entry, all-NaN rows and rows with a NaN
    among finite values, and their entry counts."""
    rng = np.random.default_rng(seed)
    v, kf = 400, 70
    d2 = rng.uniform(0.0, 4.0, size=(v, kf))
    cnt = rng.integers(0, kf + 1, size=v)
    cnt[:40] = rng.integers(0, 6, size=40)  # shorter than most groups
    cnt[40:50] = 0  # no entry: the pick is entry 0
    for r in range(50, 250):  # the least value planted two to four times
        m = max(int(cnt[r]), 2)
        cnt[r] = m
        at = rng.choice(m, size=min(m, int(rng.integers(2, 5))), replace=False)
        d2[r, at] = d2[r, :m].min() - 0.5
    d2[250:260] = np.nan  # NaN lanes
    d2[260:280, rng.integers(0, kf, size=20)] = np.nan  # a NaN among finite values
    d2[280:290, :] = BIG  # nothing below 1e30
    return torch.as_tensor(d2).to(dtype), torch.as_tensor(cnt)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("g", GROUPS)
def test_the_grouped_walk_picks_the_serial_walk_s_entry(g, dtype):
    d2, cnt = planted_rows(dtype)
    best, j = grouped_pick(d2, cnt, g)
    # every thread of the group holds the same pick and distance
    assert bool((j == j[:, :1]).all()) and bool((best == best[:, :1]).all())
    assert torch.equal(j[:, 0], serial_pick(d2, cnt))
    # torch.argmin over the masked row: the same entry on every row without a
    # NaN (argmin takes a NaN; the walk never does, and picks entry 0 where
    # every entry is NaN)
    masked = torch.where(torch.arange(d2.shape[1])[None, :] < cnt[:, None], d2, BIG)
    keep = ~torch.isnan(masked).any(1)
    assert int(keep.sum()) >= 360
    assert torch.equal(j[keep, 0], torch.argmin(masked, dim=1)[keep])
    finite = torch.where(torch.isnan(masked), BIG, masked)
    assert torch.equal(j[~keep, 0], torch.argmin(finite, dim=1)[~keep])
    assert bool((j[40:50, 0] == 0).all()) and bool((j[250:260, 0] == 0).all())
    assert bool((j[280:290, 0] == 0).all())
    # the distance the kernel takes: 1e30 where no entry is below it
    assert bool((best[40:50, 0] == BIG).all()) and bool((best[250:260, 0] == BIG).all())


# the crossval slab's exact obstacle, baked by each package
_SLAB = {}


def slab():
    if not _SLAB:
        s = chip_smoke.CROSSVAL_SLAB
        mesh = j_make_tet_blocks(*s["blocks"], cell=s["cell"])
        mesh.apply_xform(j_make_xform(trans=s["trans"]))
        _SLAB["jax"] = jpassive.PassiveMeshExact.from_tet_mesh(mesh.vertices, mesh.tets, cells=16)
        _SLAB["port"] = tpassive.PassiveMeshExact.from_tet_mesh(mesh.vertices, mesh.tets,
                                                                cells=16)
        lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
        rng = np.random.default_rng(3)
        x = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), size=(300, 3))
        x[:5] = np.nan  # NaN lanes
        _SLAB["x"] = x
    return _SLAB["jax"], _SLAB["port"], _SLAB["x"]


def candidates_of(obs, p, plant):
    """(abc [V, Kf, 3, 3], fmask [V, Kf], fids [V, Kf]) of each lane's cell as
    the port's _narrow gathers them, every lane valid; with plant, each row's
    first least entry copied (its corners) into an earlier slot whose fid is
    another triangle's, an exact tie in d2 that only the lower slot wins."""
    cid, _ = obs.cells(p)
    kf = obs.face_table.shape[1]
    fids = obs.face_table[cid].to(torch.int64)
    fmask = torch.arange(kf)[None, :] < obs.face_count[cid][:, None]
    abc = obs.tri_abc.to(p.dtype)[fids]
    if plant:
        closest, _, _ = tpassive._pt_tri_closest(p[:, None, :], abc[..., 0, :], abc[..., 1, :],
                                                 abc[..., 2, :])
        dd = p[:, None, :] - closest
        d2 = torch.where(fmask, tpassive.dot3(dd, dd), BIG)
        k1 = torch.argmin(d2, dim=1)
        rows = torch.nonzero(k1 > 0)[:, 0]
        k2 = k1[rows] // 2
        abc[rows, k2] = abc[rows, k1[rows]]
        fids[rows, k2] = (fids[rows, k1[rows]] + 1) % obs.tri_abc.shape[0]
    return abc, fmask, fids


@pytest.mark.parametrize("plant", [False, True], ids=["as_baked", "planted_ties"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("g", GROUPS)
def test_the_grouped_pick_gives_closest_over_s_feature_in_both_packages(g, dtype, plant):
    jobs, tobs, x = slab()
    tobs = tobs.to("cpu", dtype)
    p = torch.as_tensor(x).to(dtype)
    abc, fmask, fids = candidates_of(tobs, p, plant)
    closest, _, _ = tpassive._pt_tri_closest(p[:, None, :], abc[..., 0, :], abc[..., 1, :],
                                             abc[..., 2, :])
    dd = p[:, None, :] - closest
    d2 = tpassive.dot3(dd, dd)
    cnt = fmask.sum(1)
    best, j = grouped_pick(d2, cnt, g)
    j = j[:, 0]
    nan = torch.isnan(p).any(1)
    assert bool((j[nan] == 0).all())  # a NaN lane: every d2 NaN, entry 0
    # the port's _closest_over over the row against the same over the one
    # picked candidate: the same bits
    dist, cl, n, any_face = tobs._closest_over(p, abc, fmask, fids=fids)
    one = torch.arange(p.shape[0])
    dist1, cl1, n1, _ = tobs._closest_over(p, abc[one, j][:, None], fmask[one, j][:, None],
                                           fids=fids[one, j][:, None])
    ok = ~nan
    assert torch.equal(dist[ok], dist1[ok]) and torch.equal(cl[ok], cl1[ok])
    assert torch.equal(n[ok], n1[ok])
    # the kernel's distance: sqrt(max(best, 0)), 1e15 where no entry counts
    kdist = torch.sqrt(torch.clamp_min(best[:, 0], 0.0))
    assert torch.equal(kdist[ok], dist[ok])
    assert torch.equal(any_face, cnt > 0)
    # the JAX package's _closest_over on the same candidates
    jd = jnp.float64 if dtype == F64 else jnp.float32
    jdist, jcl, jn, jany = jobs._closest_over(jnp.asarray(p.numpy(), jd),
                                              jnp.asarray(abc.numpy(), jd),
                                              jnp.asarray(fmask.numpy()),
                                              fids=jnp.asarray(fids.numpy(), jnp.int32))
    tol = 1e-12 if dtype == F64 else 2e-6
    assert np.array_equal(np.asarray(jany), any_face.numpy())
    for a, b in ((jdist, dist1), (jcl, cl1), (jn, n1)):
        a, b = np.asarray(a)[ok.numpy()], b[ok].numpy()
        if dtype == F32:  # rounding ties between two triangles: each package its first
            close = np.abs(a - b).reshape(len(a), -1).max(1) <= tol * 4
            assert close.mean() >= 0.97
        else:
            assert np.abs(a - b).max() <= tol * 4


def block_ranked(mask: np.ndarray, k: int, nb: int, threads: int = THREADS):
    """csrc/obstacle.cu's compaction on nb blocks: each block ranks its span
    in chunks of threads lanes (block_rank), writes its count, then lists
    its flagged lanes at the ranks after the blocks before it; the first k
    are kept. Returns (list, total)."""
    v = len(mask)
    span = cuda_obstacle.j_span(v, nb)
    counts, local = np.zeros(nb, np.int64), np.full(v, -1, np.int64)
    for b in range(nb):
        lo, hi = min(b * span, v), min(b * span + span, v)
        mine = 0
        for c in range(lo, hi, threads):
            chunk = mask[c:min(c + threads, hi)]
            ranks = np.cumsum(chunk) - chunk
            local[c:c + len(chunk)] = np.where(chunk, mine + ranks, -1)
            mine += int(chunk.sum())
        counts[b] = mine
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out = np.full(k, -1, np.int64)
    for b in range(nb):
        for lane in range(min(b * span, v), min(b * span + span, v)):
            r = local[lane]
            if r >= 0 and before[b] + r < k:
                out[before[b] + r] = lane
    return out, int(counts.sum())


@pytest.mark.parametrize("nb", [1, 2, 3, 5, 7, 132])
def test_the_block_offset_ranking_lists_top_k_s_lanes(nb):
    rng = np.random.default_rng(nb)
    for v, k, density in ((1_100, 64, 0.1), (1_100, 300, 0.5), (15_616, 2_048, 0.125),
                          (777, 5, 0.9)):
        mask = rng.random(v) < density
        listed, total = block_ranked(mask, k, nb)
        n = min(total, k)
        assert total == int(mask.sum()) and bool((listed[n:] == -1).all())
        first = tpassive._first_k(torch.as_tensor(mask), k).numpy()
        _, top = jax.lax.top_k(jnp.asarray(mask.astype(np.int32)), k)
        assert np.array_equal(listed[:n], first[:n])
        assert np.array_equal(listed[:n], np.asarray(top)[:n])


def test_the_grid_span_and_group_rules():
    # J on the 67k path: 15,616 lanes over the card's blocks, 1,952 listed
    assert cuda_obstacle.j_grid(15_616, 132) == 132  # one block a SM
    assert cuda_obstacle.j_grid(36, 132) == 3 and cuda_obstacle.j_grid(1, 132) == 1
    assert cuda_obstacle.j_grid(15_616, 132, cap=5) == 5
    assert cuda_obstacle.j_span(15_616, 5) == 3_124 and cuda_obstacle.j_span(15_616, 132) == 119
    assert cuda_obstacle.j_group(cuda_obstacle.j_span(1_952, 132)) == 32  # a warp a lane
    assert cuda_obstacle.j_group(cuda_obstacle.j_span(15_616, 132)) == 4  # the dense form
    assert cuda_obstacle.j_group(3_124) == 1
    # H's exact pass: some 123 evaluated slots on 1,024 threads take 8 a slot
    assert cuda_obstacle.j_group(123, 1_024) == 8 and cuda_obstacle.j_group(20, 512) == 16


@pytest.mark.parametrize("threads", [512, 1_024])
def test_the_group_is_no_wider_than_a_table_row(threads):
    # the crossval slab's tables at cells 16 hold at most 24 candidates a
    # cell, at cells 32 at most 8 (the deep scene): a group wider than the
    # row would only add reduction rounds
    for slots in (1, 16, 123, 558):
        for kf in (1, 3, 8, 24, 90):
            g = cuda_obstacle.j_group(slots, threads, kf)
            assert g & (g - 1) == 0 and 1 <= g <= 32 and (g == 1 or (g * slots <= threads
                                                                      and g <= kf))
            assert 2 * g > min(32, kf, threads // slots) or g == 32
    assert cuda_obstacle.j_group(16, 512, 8) == 8 and cuda_obstacle.j_group(16, 512, 90) == 32
    assert cuda_gs.GROUPS == GROUPS
    _, tobs, _ = slab()
    assert tobs.face_table.shape[1] >= int(tobs.face_count.max())


def test_the_wrappers_constants_match_the_cuda_sources():
    import re
    from pathlib import Path

    csrc = Path(cuda_obstacle.__file__).resolve().parent.parent / "csrc"
    obstacle = (csrc / "obstacle.cu").read_text()
    assert int(re.search(r"constexpr int kThreads = (\d+);", obstacle).group(1)) == THREADS
    # the barrier's struct (grid_sync.cuh: count, 31 pads, gen) fits the wrapper's buffer
    barrier = re.search(r"struct Barrier \{(.*?)\};", (csrc / "grid_sync.cuh").read_text(), re.S)
    words = sum(int(n) if n else 1 for n in re.findall(r"unsigned \w+(?:\[(\d+)\])?;",
                                                        barrier.group(1)))
    assert words == 33 and words <= cuda_obstacle.BARRIER_INTS
    gs = (csrc / "gs.cu").read_text()
    assert "iscratch" in gs and cuda_gs.SLOT_INTS == 3
    assert re.search(r"int\* list = a\.iscratch \+ 2 \* L;", gs)
