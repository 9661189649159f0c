"""Kernel I's level schedule on the CPU (ops/cuda_wind.py): the bake's
invariants, checked exactly on the sheets chip_smoke.cloth_sheet builds, a
shuffled order, a fan, repeated vertices, W = 0 and W = 1; every route that
builds a sequential WindForce carries its schedule, and a mismatched one
raises; the level walk in plain PyTorch (wind_seq_levels_plain, the kernel's
schedule) against the scan (wind_seq_plain) and the JAX package's lax.scan
(admm_elastic_tpu/forces.py:76-84).

Bounds: the level walk is held bit for bit to the scan wherever PyTorch's CPU
square root gives a batch the bits it gives each element alone (it does on
the AVX-512 host these tests were written on; on the card every operation is
IEEE-rounded and chip_smoke.kernel_i_checks holds it bit for bit), else, as
both against the JAX scan, within 1e-12 (float64) and 1e-5 (float32) of max
|v| (tests/test_torch_wind_seq.py's bounds: the two packages sum the mean's
three terms and the norm's squares in their own orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.forces import make_wind_force as j_make_wind_force
from admm_elastic_tpu_torch import convert
from admm_elastic_tpu_torch import forces as p_forces
from admm_elastic_tpu_torch.forces import WindForce, make_wind_force
from admm_elastic_tpu_torch.ops import cuda_wind
from test_torch_solver import _rel

torch.set_num_threads(1)

WIND = (0.05, 0.1, 0.02)
BOUND = {np.float64: 1e-12, np.float32: 1e-5}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _sheet(nx):
    return chip_smoke.cloth_sheet(nx, nx)[1]


def _shuffled(nx):
    tris = _sheet(nx)
    return tris[np.random.default_rng(7).permutation(len(tris))]


# name -> (triangles, levels, widest); None where the count is not pinned
LISTS = {
    "sheet4": (lambda: _sheet(4), 20, 2),
    "sheet40": (lambda: _sheet(40), 236, 20),
    "sheet160": (lambda: _sheet(160), 956, 80),
    "shuffled160": (lambda: _shuffled(160), None, None),
    "fan": (lambda: chip_smoke.wind_fan(chip_smoke.WIND_FAN)[1], chip_smoke.WIND_FAN, 1),
    "repeated": (lambda: chip_smoke.wind_repeated()[1], None, None),
    "empty": (lambda: np.zeros((0, 3), np.int64), 0, 0),
    "single": (lambda: np.array([[2, 0, 1]]), 1, 1),
}


def _levels_by_brute_force(tris):
    """level(t) = 1 + the largest level of an earlier triangle sharing a
    vertex, by a search over every earlier triangle."""
    levels = np.zeros(len(tris), dtype=np.int64)
    for t, tri in enumerate(tris):
        shares = np.isin(tris[:t], tri).any(axis=1)
        levels[t] = levels[:t][shares].max() + 1 if shares.any() else 0
    return levels


@pytest.mark.parametrize("name", list(LISTS))
def test_schedule_invariants(name):
    make, n_levels, widest = LISTS[name]
    tris = np.asarray(make(), dtype=np.int64)
    w = len(tris)
    s = cuda_wind.bake_schedule(tris, "cpu")
    order, offs = s.order.numpy(), s.offsets.numpy()
    assert s.order.dtype == s.offsets.dtype == torch.int32
    assert np.array_equal(np.sort(order), np.arange(w))  # every triangle once
    assert offs[0] == 0 and offs[-1] == w and len(offs) == s.n_levels + 1
    assert (np.diff(offs) > 0).all()  # no empty level
    assert s.widest == (np.diff(offs).max() if w else 0)
    assert s.n_verts == (tris.max() + 1 if w else 0)
    level = np.repeat(np.arange(s.n_levels), np.diff(offs))[np.argsort(order)]
    same = level[order][1:] == level[order][:-1]
    assert (np.diff(order)[same] > 0).all()  # file order within a level
    # each triangle's distinct vertices, as (vertex, triangle) pairs
    keep = np.stack([np.ones(w, bool), tris[:, 1] != tris[:, 0],
                     (tris[:, 2] != tris[:, 0]) & (tris[:, 2] != tris[:, 1])], axis=1)
    vtx, t_of = tris[keep], np.repeat(np.arange(w), 3)[keep.reshape(-1)]
    key = level[t_of] * (vtx.max() + 1 if w else 1) + vtx
    assert len(np.unique(key)) == len(key)  # a vertex at most once a level
    by_vertex = np.lexsort((t_of, vtx))  # each vertex's triangles in file order
    same = vtx[by_vertex][1:] == vtx[by_vertex][:-1]
    assert (np.diff(level[t_of[by_vertex]])[same] > 0).all()  # at increasing levels
    if w <= 3200:
        assert np.array_equal(level, _levels_by_brute_force(tris))
    assert np.array_equal(level, cuda_wind.triangle_levels(tris))
    if n_levels is not None:
        assert (s.n_levels, s.widest) == (n_levels, widest)
    if name == "shuffled160":
        assert s.widest > 512  # levels wider than the kernel's block
    if name == "repeated":
        assert any(len(set(t)) < 3 for t in tris.tolist())


def _routes(tris):
    """name -> a sequential WindForce of tris built by one route."""
    jw = j_make_wind_force(tris, direction=WIND, sequential=True)
    d = dict(tris=np.asarray(jw.tris), direction=np.asarray(jw.direction), alpha_n=jw.alpha_n,
             sequential=jw.sequential)
    direct = WindForce(tris=torch.as_tensor(tris), direction=torch.tensor(WIND),
                       sequential=True)
    return {
        "make_wind_force": make_wind_force(tris, WIND, sequential=True, device="cpu",
                                           dtype=torch.float64),
        "forces.wind_force_from_numpy": p_forces.wind_force_from_numpy(
            tris, WIND, sequential=True, device="cpu", dtype=torch.float64),
        "convert.wind_force_from_numpy": convert.wind_force_from_numpy(
            d, device="cpu", dtype=torch.float64),
        "WindForce": direct,
        "dataclasses.replace": dataclasses.replace(direct, alpha_n=500.0),
    }


@pytest.mark.parametrize("route", ["make_wind_force", "forces.wind_force_from_numpy",
                                   "convert.wind_force_from_numpy", "WindForce",
                                   "dataclasses.replace"])
def test_every_route_carries_the_schedule(route):
    tris = _sheet(4)
    w = _routes(tris)[route]
    want = cuda_wind.bake_schedule(tris, "cpu")
    assert w.sequential and isinstance(w.schedule, cuda_wind.WindSchedule)
    assert torch.equal(w.schedule.order, want.order)
    assert torch.equal(w.schedule.offsets, want.offsets)
    assert (w.schedule.n_levels, w.schedule.widest, w.schedule.n_verts) == (20, 2, 25)
    cuda_wind.check_schedule(w.schedule, w.tris)
    assert make_wind_force(tris, WIND, device="cpu", dtype=torch.float64).schedule is None
    assert make_wind_force(tris, WIND, colored=True, device="cpu",
                           dtype=torch.float64).schedule is None


def test_a_mismatched_schedule_raises():
    tris = _sheet(4)
    w = make_wind_force(tris, WIND, sequential=True, device="cpu", dtype=torch.float64)
    other = torch.as_tensor(_shuffled(4))
    with pytest.raises(ValueError, match="does not describe"):
        dataclasses.replace(w, tris=other)
    with pytest.raises(ValueError, match="does not describe"):
        WindForce(tris=torch.as_tensor(tris[:-1]), direction=w.direction, sequential=True,
                  schedule=w.schedule)
    forged = dataclasses.replace(w.schedule, widest=3)
    with pytest.raises(ValueError, match="does not describe"):
        dataclasses.replace(w, schedule=forged)
    with pytest.raises(ValueError, match="no WindSchedule"):
        dataclasses.replace(w, schedule=(w.schedule.order, w.schedule.offsets))
    assert dataclasses.replace(w, tris=other, schedule=None).schedule.n_levels > 0
    with pytest.raises(ValueError, match="negative"):
        cuda_wind.bake_schedule(np.array([[0, -1, 2]]), "cpu")


def _walk_inputs(name, seed=0):
    """(triangles, x, v) of a list: positions jittered, small velocities."""
    sheet4, sheet40 = chip_smoke.cloth_sheet(4, 4)[0], chip_smoke.cloth_sheet(40, 40)[0]
    verts, tris = {"sheet4": lambda: (sheet4, _sheet(4)),
                   "sheet40": lambda: (sheet40, _sheet(40)),
                   "shuffled40": lambda: (sheet40, _shuffled(40)),
                   "fan": lambda: chip_smoke.wind_fan(chip_smoke.WIND_FAN),
                   "repeated": chip_smoke.wind_repeated}[name]()
    rng = np.random.default_rng(seed)
    return tris, verts + 0.1 * rng.standard_normal(verts.shape), \
        0.01 * rng.standard_normal(verts.shape)


def _sqrt_batch_is_scalar(x, tris):
    """Whether the CPU's square root gives the batch of these triangles'
    squared normal lengths the bits it gives each alone."""
    p = x[torch.as_tensor(tris)]
    a, b = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    n = a.roll(-1, -1) * b.roll(1, -1) - a.roll(1, -1) * b.roll(-1, -1)
    sq = n * n
    sq = sq[:, 0] + sq[:, 1] + sq[:, 2]
    return torch.equal(torch.sqrt(sq), torch.stack([torch.sqrt(q) for q in sq]))


@pytest.mark.parametrize("name", ["sheet4", "sheet40", "shuffled40", "fan", "repeated"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_level_walk_is_the_scan(name, dtype):
    tris, x, v = _walk_inputs(name)
    td = TDTYPE[dtype]
    pw = make_wind_force(tris, direction=WIND, sequential=True, device="cpu", dtype=td)
    xt, vt = torch.as_tensor(x).to(td), torch.as_tensor(v).to(td)
    scan = cuda_wind.wind_seq_plain(pw.tris, pw.direction, pw.alpha_n, 1.0 / 24.0, xt, vt)
    walk = cuda_wind.wind_seq_levels_plain(pw.schedule, pw.tris, pw.direction, pw.alpha_n,
                                           1.0 / 24.0, xt, vt)
    assert walk.dtype == td and torch.isfinite(walk).all()
    assert np.abs(walk.numpy() - v).max() > 1e-3  # the wind kicks
    if _sqrt_batch_is_scalar(xt, tris):
        assert torch.equal(walk, scan), (walk - scan).abs().max()
    else:
        assert _rel(walk.numpy(), scan.numpy()) < BOUND[dtype]
    jw = j_make_wind_force(tris, direction=WIND, dtype=dtype, sequential=True)
    want = np.asarray(jw.project(1.0 / 24.0, jnp.asarray(x, dtype), jnp.asarray(v, dtype), None))
    assert _rel(walk.numpy(), want) < BOUND[dtype], _rel(walk.numpy(), want)
    if name == "repeated":  # a triangle with a repeated vertex adds nothing
        one = make_wind_force(np.array([[3, 3, 7]]), WIND, sequential=True, device="cpu",
                              dtype=td)
        assert torch.equal(one.project(0.1, xt, vt, None), vt)
        assert (one.schedule.n_levels, one.schedule.widest) == (1, 1)


def _block_walk(s, tris, d, alpha_n, dt, x, v, walkers):
    """Kernel I's walk (csrc/wind_seq.cu walk) in plain PyTorch, a slot at a
    time on v in place: a level's slots over `walkers` ranks, rank r taking
    slots r, r + walkers, ... (a level wider than the walkers loops), the
    ranks taken last to first, the interleaving furthest from file order."""
    out, three = v.clone(), torch.full((), 3.0, dtype=v.dtype)
    order, offs = s.order.long(), s.offsets.tolist()
    for lo, hi in zip(offs[:-1], offs[1:]):
        for rank in reversed(range(walkers)):
            for sl in range(lo + rank, hi, walkers):
                tri = tris[order[sl]]
                w = out[tri]
                out[tri] = w + cuda_wind.wind_force_plain(dt, alpha_n, x[tri], w, d, three)
    return out


@pytest.mark.parametrize("name", ["sheet4", "shuffled40", "fan", "repeated"])
@pytest.mark.parametrize("walkers", [32, 512])
def test_block_walk_is_the_scan(name, walkers):
    """The kernel's reads and writes, emulated slot by slot in float64 on v in
    place, give the scan's bits whatever order a level's slots take (the
    same scalar operations in the same order, a level vertex-disjoint)."""
    tris, x, v = _walk_inputs(name)
    pw = make_wind_force(tris, direction=WIND, sequential=True, device="cpu",
                         dtype=torch.float64)
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    scan = cuda_wind.wind_seq_plain(pw.tris, pw.direction, pw.alpha_n, 1.0 / 24.0, xt, vt)
    got = _block_walk(pw.schedule, pw.tris, pw.direction, pw.alpha_n, 1.0 / 24.0, xt, vt,
                      walkers)
    assert torch.equal(got, scan), (got - scan).abs().max()
    if name == "shuffled40" and walkers == 32:
        assert pw.schedule.widest > walkers  # its levels loop
