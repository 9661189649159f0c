"""Anderson acceleration (aa_window > 0) against the JAX package, on the CPU:
solvers/anderson.update on the toy linear fixed point of tests/test_anderson.py
with every accept / reject decision equal; the three JAX tests' counterparts;
the port's Solver(aa_window=4) against the JAX Solver on the 10x3x3
neo-Hookean beam, on a small Floor scene with AL-PCG (linsolver=4) and on a
sheet; the Anderson iteration's local step (TriBatch.prox, system.prox_split);
the goldens beam_aa4 and cloth_aa4 (chip_smoke.VARIANT_SCENES).

Bounds: update's iterate relative to max |v|, float64, 1e-10 (the two sum
the Gram matrix in their own orders; the m x m solve is LU with partial
pivoting in both). The scenes relative to max |x|: float64 1e-9 after one
step (measured 1e-15 on the beam), the 14-step contact scene 1e-6; float32
2e-3 after eight steps (benchmarks/crossval.py:299-302; measured 3e-5 on the
beam). The goldens: 1e-4 after one step and 2e-3 after eight.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu.geometry.factory import make_plane as j_make_plane
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.ops import soa as jsoa
from admm_elastic_tpu.solvers import anderson as janderson
from admm_elastic_tpu_torch import Lame, Settings, Solver
from admm_elastic_tpu_torch.geometry.factory import make_plane
from admm_elastic_tpu_torch.solvers import anderson as tanderson
from admm_elastic_tpu_torch.system import system as tsys
from test_torch_contact import _jax_api
from test_torch_solver import _jax_solver, _port_solver, _rel

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _toy(n=50, seed=0):
    """tests/test_anderson.py's linear fixed point g(x) = c + B x."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    b = q @ np.diag(rng.uniform(0.3, 0.95, n)) @ q.T
    c = rng.standard_normal(n)
    return b, c, np.linalg.solve(np.eye(n) - b, c)


@pytest.mark.parametrize("safeguard, seed", [(1e9, 0), (1.0, 3)])
def test_update_is_the_jax_package_s(safeguard, seed):
    """40 updates fed the same (v, g(v)), float64: each accept / reject
    decision (the count after the update) equal, the iterate within 1e-10."""
    b, c, _ = _toy(seed=seed)
    x = jnp.zeros(len(c))
    aj = janderson.init(4, x)
    at = tanderson.init(4, torch.zeros(len(c), dtype=F64))
    resets = 0
    for _ in range(40):
        gv = jnp.asarray(c) + jnp.asarray(b) @ x
        xn, aj, fj = janderson.update(aj, x, gv, safeguard=safeguard)
        xt, at, ft = tanderson.update(at, torch.as_tensor(np.array(x)),
                                      torch.as_tensor(np.array(gv)), safeguard=safeguard)
        assert int(at.count) == int(aj.count)
        resets += int(aj.count) == 1
        assert _rel(xt.numpy(), xn) <= 1e-10 and abs(float(ft) - float(fj)) <= 1e-10 * float(fj)
        assert at.count.dtype == torch.int32 and at.prev_fnorm.dtype == F64
        x = xn
    assert resets >= 1  # the first update at least starts from an empty history


def test_aa_beats_plain_on_linear_fixed_point():
    b, c, x_star = (torch.as_tensor(a) for a in _toy())
    x = torch.zeros_like(c)
    for _ in range(40):
        x = c + b @ x
    err_plain = float(torch.linalg.norm(x - x_star))
    x = torch.zeros_like(c)
    aa = tanderson.init(5, x)
    for _ in range(40):
        x, aa, _ = tanderson.update(aa, x, c + b @ x, safeguard=1e9)
    assert float(torch.linalg.norm(x - x_star)) < 1e-3 * err_plain


def test_aa_safeguard_falls_back_to_plain():
    b, c, _ = (torch.as_tensor(a) for a in _toy(seed=3))
    x_plain = torch.zeros_like(c)
    x = torch.zeros_like(c)
    aa = tanderson.init(4, x)
    for _ in range(20):
        x_plain = c + b @ x_plain
        x, aa, fn = tanderson.update(aa, x, c + b @ x, safeguard=1.0)
        assert bool(torch.isfinite(fn))
    f_aa = float(torch.linalg.norm(c + b @ x - x))
    f_plain = float(torch.linalg.norm(c + b @ x_plain - x_plain))
    assert f_aa <= f_plain * 1.5


def _beam(aa, iters, dtype=np.float64, dims=(10, 3, 3)):
    s = _port_solver(dims, dtype, aa_window=aa)
    s.m_settings.admm_iters = iters
    return s


def test_aa_wins_on_elastic_scene():
    """tests/test_anderson.py:53-91 on the port: at 10 ADMM iterations
    aa_window=4 is below half the plain error against the converged step (600
    iterations, as there: past the ~100 where the two variants reach the ADMM
    noise floor, admm_elastic_tpu/config.py:86-99)."""
    ref = _beam(0, 600)
    ref.step()
    errs = {}
    for aa in (0, 4):
        s = _beam(aa, 10)
        s.step()
        errs[aa] = float(np.linalg.norm(ref.x - s.x))
    assert np.isfinite(errs[4]) and errs[4] < 0.5 * errs[0], errs


@pytest.mark.parametrize("dtype, steps", [(np.float64, 1), (np.float32, 8)])
def test_solver_aa4_is_the_jax_solver_s(dtype, steps):
    """The 10x3x3 neo-Hookean beam, -x face pinned, linsolver=0 "inv", 10
    iterations with aa_window=4."""
    jx = _jax_solver((10, 3, 3), dtype)
    jx.m_settings.aa_window = 4
    port = _port_solver((10, 3, 3), dtype, aa_window=4)
    for _ in range(steps):
        jx.step()
    port.run(steps)
    bound = 1e-9 if dtype == np.float64 else chip_smoke.STEP8_TOL
    assert _rel(port.x, np.asarray(jx.x)) < bound, _rel(port.x, np.asarray(jx.x))
    assert _rel(port.x, _port_solver((10, 3, 3), dtype).x) > 0  # it moved


def test_floor_alpcg_aa4_is_the_jax_solver_s():
    """crossval's 6x3x3 linear beam falling onto a Floor, AL-PCG, float64,
    aa_window=4, the golden's 14 steps (landing at about 12): the inner
    iterations and the active rows of each step equal, x and y within 1e-6."""
    chip_smoke.DEVICE = "cpu"
    port = chip_smoke.contact_scene("contact_alpcg_f64", chip_smoke.torch_api("cpu"),
                                    aa_window=4)
    jx = chip_smoke.contact_scene("contact_alpcg_f64", _jax_api(), aa_window=4)
    rows = 0
    for _ in range(chip_smoke.contact_steps("contact_alpcg_f64")[0]):
        port.step()
        jx.step()
        assert port.runtime_data().inner_iters == jx.runtime_data().inner_iters
        active = port.state.prev_active.numpy()
        assert np.array_equal(active, np.asarray(jx.state.prev_active))
        assert _rel(port.state.y.numpy(), np.asarray(jx.state.y)) < 1e-6
        rows += int(active.sum())
    assert _rel(port.x, np.asarray(jx.x)) < 1e-6
    assert rows > 0  # in contact on some step


def _sheet(api, lame_cls, settings_cls, plane):
    mesh = plane(6, 6, size=2.0)
    s = api()
    s.add_nodes(mesh.vertices, mesh.weighted_masses(1.0))
    lame = lame_cls.soft_rubber()
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s.add_tri_energies(mesh.vertices, mesh.faces, lame)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < -2.0 + 1e-9)[0]])
    assert s.initialize(settings_cls(verbose=0, admm_iters=10, linsolver=0, dtype=np.float64,
                                     gravity=-9.8, aa_window=4))
    return s


def test_sheet_aa4_is_the_jax_solver_s():
    """A strain-limited 6x6 sheet under gravity, float64, aa_window=4, three
    steps: within 1e-9."""
    port = _sheet(lambda: Solver(device="cpu"), Lame, Settings, make_plane)
    jx = _sheet(JSolver, JLame, JSettings, j_make_plane)
    for _ in range(3):
        port.step()
        jx.step()
    assert _rel(port.x, np.asarray(jx.x)) < 1e-9


def test_tri_prox_is_kernel_e_s_rows_entry_and_u_is_v_minus_z():
    """TriBatch.prox on rows [6, T] against the JAX package's
    soa.prox_tri_tuple (float64, within 1e-12); the rows entry with u = 0
    gives u' = v - z bit for bit, so the Anderson step takes u from it."""
    port = _sheet(lambda: Solver(device="cpu"), Lame, Settings, make_plane)
    b = port.system.tris[0]
    rng = np.random.default_rng(4)
    v = torch.as_tensor(rng.standard_normal((6, b.n)) * 0.3
                        + np.array([1, 0, 0, 0, 1, 0])[:, None])
    z = b.prox(v)
    want = np.stack(jsoa.prox_tri_tuple(tuple(jnp.asarray(r) for r in v.numpy()),
                                        jnp.asarray(b.limit_min.numpy()),
                                        jnp.asarray(b.limit_max.numpy())))
    assert np.abs(z.numpy() - want).max() <= 1e-12
    zz, u = b.local_step_rows(v, torch.zeros_like(v))
    assert torch.equal(zz, z) and torch.equal(u, v - z)
    with pytest.raises(ValueError, match="rows"):
        b.prox(v.T.reshape(-1, 3, 2))


def test_prox_split_is_the_prox_and_v_minus_z():
    """system.prox_split on the beam (tets and pins) and flat / unflat."""
    s = _port_solver((4, 2, 2), np.float64)
    v_list = tsys.Dx(s.system, s.state.x + 0.01)
    vec = tsys.flat(v_list)
    back = tsys.unflat(s.system, vec)
    assert all(torch.equal(a, b) for a, b in zip(back, v_list))
    z, u = tsys.prox_split(s.system, back)
    assert len(z) == len(u) == 2 and s.system.pins is not None
    assert torch.equal(z[0], s.system.tets[0].prox(v_list[0]))
    assert torch.equal(z[1], s.system.pins.prox(v_list[1]))
    assert all(torch.equal(ui, vi - zi) for ui, vi, zi in zip(u, v_list, z))


def test_graph_key_names_the_anderson_settings():
    s = _port_solver((4, 2, 2), np.float32)
    key = s._graph_key()
    base = s.m_settings
    for change in (dict(aa_window=4), dict(aa_safeguard=2.0)):
        s.m_settings = dataclasses.replace(base, **change)
        assert s._graph_key() != key


@pytest.mark.parametrize("name", ["beam_aa4", "cloth_aa4"])
def test_aa_golden(name):
    """The bench beam and cloth_limit40 with aa_window=4 against their JAX
    goldens (tests/make_torch_golden.py), 8 steps on the CPU."""
    chip_smoke.DEVICE = "cpu"
    if name == "beam_aa4":
        solver, _, g, _ = chip_smoke.make_solver(chip_smoke.NH, device="cpu", name=name)
    else:
        solver, g, _ = chip_smoke.make_cloth_solver(name, device="cpu")
    assert solver.m_settings.aa_window == chip_smoke.AA_WINDOW
    solver.step()
    x1 = solver.x
    solver.run(7)
    assert _rel(x1, g["x1"]) < chip_smoke.STEP1_TOL, _rel(x1, g["x1"])
    assert _rel(solver.x, g["x8"]) < chip_smoke.STEP8_TOL, _rel(solver.x, g["x8"])
    assert np.abs(solver.x[g["pins"]] - g["x0"][g["pins"]]).max() < 1e-3
