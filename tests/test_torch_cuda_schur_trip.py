"""Uzawa's Schur trip on a CUDA card: kernel L's full C^T (ct_apply) and
kernel M (schur_trip), csrc/uzawa.cu. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_schur_trip.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the paths' full size). On the card:

- every trip of a Schur solve, L and M torch.equal to their twins and L to
  the parent's C^T, and uzawa.solve bitwise the trips walked launch by launch
  (chip_smoke.trip_pairs), float32 and float64: on boxes_uzawa8's,
  floor_uzawa5k's and floor_uzawa67k's states (dense query sets; 2H of 2,916,
  2,952 and 31,232 rows, none a multiple of 1,024; floor_uzawa67k's 15,616
  vertices above 1,024 x 8; the floor paths without dynamic rows) and on the
  3x3x3 stacked boxes past their first dynamic rows (a query set that is not
  every vertex: slot_of);
- on random rows (dense and not, with and without dynamic rows, 9,000
  vertices): one launch of each against its twin, M on the wrapper's grid and
  on grids of 1 and 3 blocks, with done set before the trip (every output
  bitwise as it was) and with a bad denominator (q2 = 0);
- the refusals: a wrong shape, a wrong dtype, a query set that is not every
  vertex without slot_of.
"""

import dataclasses

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


@pytest.mark.parametrize("name", chip_smoke.UZAWA_PATHS)
def test_every_trip_against_the_twins_on_the_paths(cuda_device, name):
    solver, b, x0, hits, y = chip_smoke.uzawa_state(torch, name)
    s, c = solver.m_settings, solver._contact
    for dtype in (torch.float32, torch.float64):
        _, res = chip_smoke.trip_pairs(
            torch, f"{name} {dtype}", chip_smoke.widened(hits, dtype), c.ck.to(dtype),
            b.to(dtype), x0.to(dtype), y.to(dtype), s.uzawa_max_iters, s.uzawa_tol,
            chip_smoke.uzawa_apply(solver, dtype), c.slot_of)
        assert res["bitwise"] and res["trips"] >= 1
        assert res["rows"] % 1024 != 0
        if name == "floor_uzawa67k":
            assert res["vertices"] > 1024 * 8


def test_every_trip_on_the_stacked_boxes_with_slot_of(cuda_device):
    from admm_elastic_tpu_torch.collision import constraints as con
    from test_torch_cuda_selfcollision import stack

    solver = stack(2)
    solver.run(10)
    c = solver._contact
    assert not c.dense and c.slot_of is not None
    b, x0 = chip_smoke.first_solve(torch, solver)
    hits = con.with_table(solver._detect(x0).dedup(), x0.shape[0])
    assert bool(hits.d_mask.any())
    s = solver.m_settings
    for dtype in (torch.float32, torch.float64):
        y = torch.zeros(2 * hits.capacity, dtype=dtype, device="cuda")
        _, res = chip_smoke.trip_pairs(
            torch, f"stacked boxes {dtype}", chip_smoke.widened(hits, dtype), c.ck.to(dtype),
            b.to(dtype), x0.to(dtype), y, s.uzawa_max_iters, s.uzawa_tol,
            chip_smoke.uzawa_apply(solver, dtype), c.slot_of)
        assert res["bitwise"] and not res["dense"] and res["dynamic"] > 0


def random_case(dense, may_dyn, dtype, n=9000, seed=0):
    """Random rows on the card with their table, ck, y, q2 and a trip's
    state (x, r on the active rows, d), as tests/test_torch_contact.py _hits
    draws them."""
    from admm_elastic_tpu_torch.collision import constraints as con

    rng = np.random.default_rng(seed + 2 * dense + may_dyn)
    h = n if dense else n // 2
    surf = np.arange(n) if dense else np.sort(rng.choice(n, h, replace=False))
    nrm = rng.standard_normal((h, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    dev = "cuda"
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    i = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    hits = con.Hits(p_mask=i(rng.random(h) < 0.5), p_vidx=i(surf), p_normal=f(nrm),
                    p_point=f(rng.standard_normal((h, 3))),
                    d_mask=i((rng.random(h) < 0.4) if may_dyn else np.zeros(h, bool)),
                    d_vidx=i(surf), d_face=i(rng.integers(0, n, (h, 3))),
                    d_barys=f(rng.dirichlet(np.ones(3), h)),
                    d_normal=f(rng.standard_normal((h, 3))),
                    overflow=torch.zeros((), dtype=torch.bool, device=dev), dense=dense,
                    may_dyn=may_dyn).dedup()
    hits = con.with_table(hits, n)
    slots = None
    if not dense:
        slots = torch.full((n,), -1, dtype=torch.int32, device=dev)
        slots[hits.p_vidx] = torch.arange(h, dtype=torch.int32, device=dev)
    active = torch.cat([hits.p_mask, hits.d_mask])
    r = torch.where(active, f(rng.standard_normal(2 * h)), 0.0)
    return dict(hits=hits, slots=slots, ck=torch.tensor(7.5, dtype=dtype, device=dev),
                y=f(rng.standard_normal(2 * h)), q2=f(rng.standard_normal((n, 3))),
                x=f(rng.standard_normal((n, 3))), r=r, d=r + 0.25 * f(rng.standard_normal(2 * h)))


def tiny_tol2(dtype):
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    return float(fi.tiny), float(fi.dtype.type(1e-3) ** 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("may_dyn", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_one_launch_each_on_random_rows(cuda_device, dense, may_dyn, dtype):
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    c = random_case(dense, may_dyn, dtype)
    hits, ck, n = c["hits"], c["ck"], c["x"].shape[0]
    assert (2 * hits.capacity) % 1024 != 0 and n > 1024 * 8
    got = cu.ct_apply(hits, ck, c["y"], n, c["slots"])
    assert torch.equal(got, cu.ct_plain(hits, ck, c["y"], n))
    tiny, tol2 = tiny_tol2(dtype)
    k = torch.tensor(2, dtype=torch.int32, device="cuda")
    for blocks in (None, 1, 3):
        for flag in (False, True):
            done = torch.tensor(flag, device="cuda")
            state = (c["x"], c["y"], c["r"], c["d"], k, done)
            want = cu.schur_trip_plain(hits, ck, c["q2"], *state, tiny, tol2)
            out = cu.schur_trip(hits, ck, c["q2"], *[t.clone() for t in state], tiny, tol2,
                                blocks=blocks)
            for a, w in zip(out, want):
                assert torch.equal(a, w)
            if flag:  # done set before the trip: everything as it was
                for a, w in zip(out, state):
                    assert torch.equal(a, w)
            else:
                assert int(out[4].item()) == 3


def test_a_bad_denominator(cuda_device):
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    for dtype in (torch.float32, torch.float64):
        c = random_case(True, True, dtype, n=3000)
        tiny, tol2 = tiny_tol2(dtype)
        q2 = torch.zeros_like(c["q2"])  # C q2 = 0: d.q3 = 0 < tiny
        state = (c["x"], c["y"], c["r"], c["d"], torch.tensor(0, dtype=torch.int32, device="cuda"),
                 torch.tensor(False, device="cuda"))
        want = cu.schur_trip_plain(c["hits"], c["ck"], q2, *state, tiny, tol2)
        for blocks in (None, 1):
            out = cu.schur_trip(c["hits"], c["ck"], q2, *[t.clone() for t in state], tiny, tol2,
                                blocks=blocks)
            for a, w in zip(out, want):
                assert torch.equal(a, w)
            assert torch.equal(out[0], c["x"]) and torch.equal(out[3], c["r"])
            assert bool(out[5].item())


def test_refusals(cuda_device):
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    c = random_case(False, True, torch.float32, n=2000)
    hits, ck, n = c["hits"], c["ck"], c["x"].shape[0]
    with pytest.raises(ValueError, match="slot_of"):
        cu.ct_apply(hits, ck, c["y"], n, None)
    with pytest.raises(ValueError):
        cu.ct_apply(hits, ck, c["y"][:-1], n, c["slots"])
    with pytest.raises(ValueError, match="dtype"):
        cu.ct_apply(hits, ck, c["y"].half(), n, c["slots"])
    tiny, tol2 = tiny_tol2(torch.float32)
    k = torch.tensor(0, dtype=torch.int32, device="cuda")
    done = torch.tensor(False, device="cuda")
    with pytest.raises(ValueError):
        cu.schur_trip(hits, ck, c["q2"], c["x"][:-1], c["y"], c["r"], c["d"], k, done, tiny, tol2)
    with pytest.raises(ValueError):
        cu.schur_trip(hits, ck, c["q2"].double(), c["x"], c["y"], c["r"], c["d"], k, done,
                      tiny, tol2)
    with pytest.raises(ValueError):
        cu.schur_trip(hits, ck, c["q2"], c["x"], c["y"], c["r"], c["d"], k.long(), done, tiny,
                      tol2)
    with pytest.raises(ValueError, match="blocks"):
        cu.schur_trip(hits, ck, c["q2"], c["x"], c["y"], c["r"], c["d"], k, done, tiny, tol2,
                      blocks=0)
    no_table = dataclasses.replace(hits, d_order=None, d_start=None)
    with pytest.raises(ValueError, match="table"):
        cu.ct_apply(no_table, ck, c["y"], n, c["slots"])
