"""The sequential wind (WindForce(sequential=True)) against the JAX package,
on the CPU: kernel I's plain version (ops/cuda_wind.wind_seq_plain), a loop
over the triangles in file order, against the JAX package's lax.scan
(admm_elastic_tpu/forces.py:76-84) on the 4x4 and 40x40 sheets; the
cloth_wind40_seq scene (chip_smoke.VARIANT_SCENES: cloth_wind40 with the
sequential order) stepped by the port against the JAX Solver and against its
golden; the flag through convert; kernel I's form choice.

Bounds, relative to max |v| (or |x|): float64 1e-12 (measured 5e-16; the two
sum the mean's three terms and the norm's squares in their own orders);
float32 1e-5 (measured 1.9e-7). The scene: 1e-4 after one step and 2e-3
after eight, as every golden (benchmarks/crossval.py:299-302).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu.forces import make_wind_force as j_make_wind_force
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import convert
from admm_elastic_tpu_torch.forces import make_wind_force
from admm_elastic_tpu_torch.ops import cuda_wind
from test_torch_solver import _rel

torch.set_num_threads(1)

WIND = (0.05, 0.1, 0.02)
BOUND = {np.float64: 1e-12, np.float32: 1e-5}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
SEQ = chip_smoke.WIND_SEQ_PATH


def _inputs(nx, seed=0):
    verts, tris, _, _ = chip_smoke.cloth_sheet(nx, nx)
    rng = np.random.default_rng(seed)
    return tris, verts + 0.1 * rng.standard_normal(verts.shape), \
        0.01 * rng.standard_normal(verts.shape)


@pytest.mark.parametrize("nx", [4, 40])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sequential_twin_is_the_jax_scan(nx, dtype):
    tris, x, v = _inputs(nx)
    jw = j_make_wind_force(tris, direction=WIND, dtype=dtype, sequential=True)
    want = np.asarray(jw.project(1.0 / 24.0, jnp.asarray(x, dtype), jnp.asarray(v, dtype), None))
    pw = make_wind_force(tris, direction=WIND, sequential=True, device="cpu",
                         dtype=TDTYPE[dtype])
    assert pw.sequential and pw.vert_slots is None and not pw.color_verts
    launches = cuda_wind.wind_seq.launches
    got = pw.project(1.0 / 24.0, torch.as_tensor(x).to(TDTYPE[dtype]),
                     torch.as_tensor(v).to(TDTYPE[dtype]), None).numpy()
    assert cuda_wind.wind_seq.launches == launches  # the CPU takes the plain version
    assert got.dtype == dtype
    assert np.abs(want - v).max() > 1e-3  # the wind kicks
    assert _rel(got, want) < BOUND[dtype], _rel(got, want)


def test_the_order_is_sequential():
    """Two triangles sharing a vertex: the second reads the velocity the first
    kicked (the reference's loop), which the batched order does not."""
    tris = np.array([[0, 1, 2], [1, 3, 2]])
    x = np.array([[0.0, 0, 0], [1, 0, 0], [0, 0, 1], [1, 0, 1]])
    v = np.zeros((4, 3))
    args = dict(direction=WIND, device="cpu", dtype=torch.float64)
    seq = make_wind_force(tris, sequential=True, **args).project(
        0.1, torch.as_tensor(x), torch.as_tensor(v), None)
    first = make_wind_force(tris[:1], sequential=True, **args).project(
        0.1, torch.as_tensor(x), torch.as_tensor(v), None)
    second = make_wind_force(tris[1:], sequential=True, **args).project(
        0.1, torch.as_tensor(x), first, None)
    assert torch.equal(seq, second)
    batched = make_wind_force(tris, **args).project(0.1, torch.as_tensor(x),
                                                    torch.as_tensor(v), None)
    assert not torch.allclose(seq, batched, rtol=0, atol=1e-12)


def test_convert_carries_the_flag():
    tris, _, _ = _inputs(4)
    jw = j_make_wind_force(tris, direction=WIND, sequential=True)
    d = dict(tris=np.asarray(jw.tris), direction=np.asarray(jw.direction),
             alpha_n=jw.alpha_n, sequential=jw.sequential)
    w = convert.wind_force_from_numpy(d, device="cpu", dtype=torch.float64)
    assert w.sequential and np.array_equal(w.tris.numpy(), tris)
    d["sequential"] = False
    assert not convert.wind_force_from_numpy(d, device="cpu", dtype=torch.float64).sequential


@pytest.mark.parametrize("n, w, itemsize, want", [
    (1681, 3200, 4, "shared"), (1681, 3200, 8, "shared"),  # cloth_wind40_seq
    (25921, 51200, 4, "global"), (25921, 51200, 8, "global"),  # the 160x160 sheet
    (19366, 2, 4, "shared"), (19367, 2, 4, "global"),  # 232,448 bytes staged, one vertex more
    (9678, 4, 8, "shared"), (9679, 4, 8, "global"),
    (1, 8301, 4, "shared"), (1, 8302, 4, "global"),  # ... one triangle more
    (1, 5282, 8, "shared"), (1, 5283, 8, "global"),
    (0, 0, 4, "shared")])
def test_kernel_i_form(n, w, itemsize, want):
    """SHARED where v, the geometry and the ids fit the 232,448 bytes an H100
    block may take; else GLOBAL. The walkers: the widest level in warps, one
    warp to the block's 512 threads."""
    optin = 232448
    assert cuda_wind.i_form(n, w, itemsize, optin) == want
    fits = cuda_wind.staged_bytes(n, w, itemsize) <= optin
    assert fits == (want == "shared")
    assert cuda_wind.staged_bytes(n, w, itemsize) == (3 * n + 4 * w) * itemsize + 12 * w
    if not fits:
        with pytest.raises(ValueError, match="does not fit"):
            cuda_wind.i_form(n, w, itemsize, optin, want="shared")
    else:
        assert cuda_wind.i_form(n, w, itemsize, optin, want="shared") == "shared"
    assert cuda_wind.i_form(n, w, itemsize, optin, want="global") == "global"
    for widest, walkers in ((0, 32), (1, 32), (20, 32), (33, 64), (80, 96), (512, 512),
                            (3963, 512)):
        assert cuda_wind.walkers(widest) == walkers
    with pytest.raises(ValueError, match="expected one of"):
        cuda_wind.i_form(n, w, itemsize, optin, want="pool")


@pytest.fixture(scope="module")
def port_rollout():
    """The port's cloth_wind40_seq on the CPU: x after steps 1 and 8."""
    chip_smoke.DEVICE = "cpu"
    solver, g, _ = chip_smoke.make_cloth_solver(SEQ, device="cpu")
    assert solver.ext_forces[0].sequential
    solver.step()
    x1 = solver.x
    solver.run(7)
    return g, x1, solver.x


def test_cloth_wind40_seq_golden(port_rollout):
    g, x1, x8 = port_rollout
    assert int(g["admm_iters"]) == 10 and tuple(g["steps"]) == (1, 8)
    assert np.isfinite(x8).all()
    assert _rel(x1, g["x1"]) < chip_smoke.STEP1_TOL, _rel(x1, g["x1"])
    assert _rel(x8, g["x8"]) < chip_smoke.STEP8_TOL, _rel(x8, g["x8"])
    for step, x in ((1, x1), (8, x8)):
        disp, tol = chip_smoke.disp_err(x, g, step)
        assert disp < tol, (step, disp)
    assert np.abs(x8[g["pins"]] - g["x0"][g["pins"]]).max() < 1e-3
    assert _rel(x8, g["x0"]) > 1e-4  # the sheet moved


def test_cloth_wind40_seq_against_the_jax_solver(port_rollout):
    """The port's steps 1 and 8 against the JAX Solver built from the same
    arrays (chip_smoke.cloth_sheet)."""
    _, x1, x8 = port_rollout
    base = chip_smoke.CLOTH_SCENES["cloth_wind40"]
    verts, tris, masses, pins = chip_smoke.cloth_sheet(base["nx"], base["ny"])
    jprox.set_svd_impl("jacobi")
    try:
        js = JSolver()
        js.add_nodes(verts, masses)
        js.add_tri_energies(verts, tris, JLame.from_youngs_poisson(10000000, 0.399))
        js.set_pins([int(i) for i in pins])
        js.add_explicit_force(j_make_wind_force(tris, direction=base["wind"], sequential=True))
        assert js.initialize(JSettings(verbose=0, admm_iters=10, linsolver=0, gravity=0.0,
                                       timestep_s=1.0 / 24.0, dtype=np.float32))
        js.step()
        assert _rel(x1, np.asarray(js.x)) < chip_smoke.STEP1_TOL
        js.run(7)
        assert _rel(x8, np.asarray(js.x)) < chip_smoke.STEP8_TOL
    finally:
        jprox.set_svd_impl("auto")
