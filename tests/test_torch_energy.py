"""The port's element energies (ops/prox.py, TetBatch.energy / TriBatch.energy,
system.total_energy) and diag_A against the JAX package on the CPU.

- every tet model and cloth, float64, on seeded F with lanes at rest,
  rotated, inverted and stretched at random: within ENERGY_TOL (1e-10) of the
  JAX package's energies relative to their largest, the hyperelastic models
  on both packages' Jacobi SVD (set_svd_impl("jacobi"); the linear model on
  unsigned singular values: torch.linalg.svdvals against jnp.linalg.svd);
- total_energy on the bench beam lattice (7,680 lanes, 2,680 of them dead),
  the reference's bunny_1124 as a gather family and the 40x40 sheet, at a
  perturbed x, against the JAX package's within ENERGY_TOL; the dead lanes'
  energies exactly 0, also where their value is infinite;
- diag_A against the JAX package's and against the PCG operator's diagonal
  (solvers/pcg.PCGData.diag) within 1e-12 relative;
- init_state and the port copies of the energy oracles of
  tests/test_lineartet.py (TestEnergy), tests/test_materials.py (rest energy
  zero, rotation invariant) and tests/test_cloth.py (rest, rotation, weight).
"""

import numpy as np
import pytest
import torch

import chip_smoke

import jax.numpy as jnp
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_blocks
from admm_elastic_tpu.geometry.io import load_elenode as j_load
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.system import elements as jel
from admm_elastic_tpu.system import system as jsys
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.geometry.io import load_elenode
from admm_elastic_tpu_torch.ops import prox
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.solvers import pcg
from admm_elastic_tpu_torch.system import elements as el
from admm_elastic_tpu_torch.system import system as sysm

torch.set_num_threads(1)

ENERGY_TOL = 1e-10
MODELS = ("linear", "neohookean", "stvk", "spline_nh", "spline_stvk", "spline_corot")
VERTS = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
TET = np.array([[0, 1, 2, 3]])
TRI_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float64)
TRI = np.array([[0, 1, 2]])


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    """The JAX side on its Jacobi SVD, as the port's energy; the default is
    handed back after the module."""
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def rot_matrix(deg, axis):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)


def seeded_F(n, cols=3, seed=5):
    """n deformation gradients [n, 3, cols]: a quarter at rest, a quarter
    rotated, a quarter inverted (a column negated after a random stretch),
    the rest I + 0.3 N(0, 1)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(3)[:, :cols]
    F = eye + 0.3 * rng.standard_normal((n, 3, cols))
    q = n // 4
    F[:q] = eye
    for i in range(q, 2 * q):
        F[i] = rot_matrix(rng.uniform(0, 360), rng.standard_normal(3))[:, :cols]
    F[2 * q:3 * q, :, 0] *= -1.0
    return F


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("model", MODELS)
def test_tet_energy_matches_jax(model):
    lame = Lame.from_youngs_poisson(1e6, 0.3)
    n = 64
    rng = np.random.default_rng(11)
    vol = rng.uniform(0.5, 2.0, n)
    F = seeded_F(n)
    kappa = lame.bulk_modulus() if model.startswith("spline") else 0.0
    mu, lam = np.full(n, lame.mu), np.full(n, lame.lam)
    kap, k = np.full(n, kappa), np.full(n, lame.bulk_modulus())
    if model == "linear":
        got = prox.energy_tet_linear(torch.as_tensor(F), torch.as_tensor(k), torch.as_tensor(vol))
        want = jprox.energy_tet_linear(jnp.asarray(F), jnp.asarray(k), jnp.asarray(vol))
    else:
        t = [torch.as_tensor(a) for a in (mu, lam, kap, k)]
        got = prox.energy_tet_hyper(torch.as_tensor(F), model, *t, torch.as_tensor(vol))
        want = jprox.energy_tet_hyper(jnp.asarray(F), model, *[jnp.asarray(a) for a in
                                                              (mu, lam, kap, k)],
                                      jnp.asarray(vol))
    assert got.dtype == torch.float64 and got.shape == (n,)
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) < ENERGY_TOL, (model, _rel(got.numpy(), want))


def test_tri_energy_matches_jax():
    n = 64
    rng = np.random.default_rng(12)
    F = seeded_F(n, cols=2)
    k, area = np.full(n, 3.7e4), rng.uniform(0.1, 1.0, n)
    got = prox.energy_tri(torch.as_tensor(F), torch.as_tensor(k), torch.as_tensor(area))
    want = jprox.energy_tri(jnp.asarray(F), jnp.asarray(k), jnp.asarray(area))
    assert _rel(got.numpy(), want) < ENERGY_TOL


@pytest.mark.parametrize("model", ["linear", "neohookean", "spline_nh"])
def test_batch_energy_matches_jax(model):
    """TetBatch.energy / TriBatch.energy on built batches (a 4x2x2 block of
    tets as a gather family, a 6x6 sheet): each batch's own bulk modulus,
    material rows and volumes or areas."""
    rng = np.random.default_rng(13)
    mesh = make_tet_blocks(4, 2, 2)
    verts = mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape)
    b = el.build_tet_batch(verts, mesh.tets, Lame.soft_rubber(), model, device="cpu",
                           dtype=torch.float64)
    jb = jel.build_tet_batch(verts, mesh.tets, JLame.soft_rubber(), model=model)
    F = seeded_F(b.n, seed=16)
    assert _rel(b.energy(torch.as_tensor(F)).numpy(), jb.energy(jnp.asarray(F))) < ENERGY_TOL
    sheet = chip_smoke.cloth_sheet(6, 6)
    tb = el.build_tri_batch(sheet[0], sheet[1], Lame.soft_rubber(), device="cpu",
                            dtype=torch.float64)
    jtb = jel.build_tri_batch(sheet[0], sheet[1], JLame.soft_rubber())
    F = seeded_F(tb.n, cols=2, seed=17)
    assert _rel(tb.energy(torch.as_tensor(F)).numpy(), jtb.energy(jnp.asarray(F))) < ENERGY_TOL


# --- total_energy and diag_A on the paths' systems ---------------------------------

def _beam(pkg):
    if pkg == "jax":
        s, m = JSolver(), j_blocks(40, 5, 5)
        m.flags = jbind.NOSELFCOLLISION | jbind.NEOHOOKEAN
        jbind.add_tetmesh(s, m, JLame.soft_rubber(), verbose=False)
        settings = JSettings
    else:
        s, m = Solver(device="cpu"), make_tet_blocks(40, 5, 5)
        m.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
        binding.add_tetmesh(s, m, Lame.soft_rubber(), verbose=False)
        settings = Settings
    s.set_pins([int(i) for i in np.where(m.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize(settings(verbose=0, dtype=np.float64))
    return s


def _bunny(pkg):
    path = chip_smoke.BUNNY
    if pkg == "jax":
        s, m = JSolver(), j_load(path)
        m.flags = jbind.NOSELFCOLLISION | jbind.NEOHOOKEAN
        jbind.add_tetmesh(s, m, JLame.soft_rubber(), verbose=False)
        settings = JSettings
    else:
        s, m = Solver(device="cpu"), load_elenode(path)
        m.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
        binding.add_tetmesh(s, m, Lame.soft_rubber(), verbose=False)
        settings = Settings
    assert s.initialize(settings(verbose=0, dtype=np.float64))
    return s


def _sheet(pkg):
    verts, tris, masses, pins = chip_smoke.cloth_sheet(40, 40)
    s = JSolver() if pkg == "jax" else Solver(device="cpu")
    lame = (JLame if pkg == "jax" else Lame).from_youngs_poisson(1e7, 0.399)
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s.add_nodes(verts, masses)
    s.add_tri_energies(verts, tris, lame)
    s.set_pins([int(i) for i in pins])
    assert s.initialize((JSettings if pkg == "jax" else Settings)(verbose=0, dtype=np.float64))
    return s


SCENES = {"beam": _beam, "bunny": _bunny, "sheet": _sheet}


@pytest.fixture(scope="module", params=list(SCENES))
def both(request):
    make = SCENES[request.param]
    return request.param, make("port"), make("jax")


def test_total_energy_matches_jax(both):
    name, ps, js = both
    x0 = ps.x
    rng = np.random.default_rng(14)
    # a tenth of the mean vertex spacing
    h = float((x0.max(0) - x0.min(0)).max()) / len(x0) ** (1.0 / 3.0)
    x = x0 + 0.1 * h * rng.standard_normal(x0.shape)
    got = sysm.total_energy(ps.system, torch.as_tensor(x))
    want = float(jsys.total_energy(js.system, jnp.asarray(x)))
    assert got.dtype == torch.float64 and got.shape == ()
    assert np.isfinite(float(got)) and want > 0.0
    assert abs(float(got) - want) <= ENERGY_TOL * abs(want), (name, float(got), want)
    # at rest every element's energy is ~0 (the lattice's dead lanes exactly 0)
    assert abs(float(sysm.total_energy(ps.system, torch.as_tensor(x0)))) < 1e-8 * want


def test_dead_lanes_give_exactly_zero():
    """The bench beam's lattice: 2,680 of its 7,680 lanes are dead (volume 0,
    weight 0); their energies are exactly 0, also in float32 where F is so
    small (1e-15 I) that a neo-Hookean value overflows to inf (0 * inf would be NaN)."""
    mesh = make_tet_blocks(40, 5, 5)
    for dtype in (torch.float64, torch.float32):
        b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                               device="cpu", dtype=dtype, lattice_dims=mesh.lattice_dims)
        dead = b.vol == 0
        assert int(dead.sum()) == b.n - b.n_real == 2680
        F = torch.eye(3, dtype=dtype).repeat(b.n, 1, 1)
        F[dead] = 1e-15 * torch.eye(3, dtype=dtype)
        e = b.energy(F)
        assert torch.isfinite(e).all()
        assert (e[dead] == 0).all()
        if dtype == torch.float32:  # the value itself is inf there
            v = prox.energy_tet_hyper(F[dead][:1], "neohookean", b.mu[:1], b.lam[:1],
                                      b.kappa[:1], b.bulk[:1], torch.ones(1, dtype=dtype))
            assert torch.isinf(v).all()
        for fn in (lambda: prox.energy_tet_linear(F, b.bulk, b.vol),):
            assert (fn()[dead] == 0).all()


def test_diag_A_matches_jax_and_the_pcg_diagonal(both):
    name, ps, js = both
    got = sysm.diag_A(ps.system)
    want = np.asarray(jsys.diag_A(js.system))
    assert got.shape == (ps.system.n_verts,)
    assert _rel(got.numpy(), want) < 1e-12, name
    data = pcg.prepare(ps.system, torch.float64, spmv_format="ell")
    assert _rel(got.numpy(), data.diag().numpy()) < 1e-12, name


def test_init_state_matches_jax():
    x = np.random.default_rng(15).standard_normal((7, 3))
    for rows in (0, 6):
        st = sysm.init_state(torch.as_tensor(x), rows)
        jst = jsys.init_state(jnp.asarray(x), rows)
        for f in ("x", "v", "y", "prev_active"):
            got, want = getattr(st, f), np.asarray(getattr(jst, f))
            assert got.shape == want.shape and np.array_equal(got.numpy(), want), f
        assert st.prev_active.dtype == torch.bool and st.y.dtype == torch.float64


# --- port copies of the JAX package's energy oracles --------------------------------

def _tet_F(b, x):
    return red.tet_Dx_rows(torch.as_tensor(x), b.inds, b.Dlocal).T.reshape(-1, 3, 3)


def _linear(lame):
    return el.build_tet_batch(VERTS, TET, lame, "linear", device="cpu", dtype=torch.float64)


class TestLinearTetEnergy:
    """tests/test_lineartet.py TestEnergy (test_lineartet.cpp:55-159)."""

    def test_zero_at_rest(self):
        b = _linear(Lame(mu=0.0, lam=1.0))
        assert abs(float(b.energy(_tet_F(b, VERTS))[0])) < 1e-12

    def test_rotation_invariance(self):
        b = _linear(Lame(mu=0.0, lam=1.0))
        R = rot_matrix(45.0, (1, 1, 1))
        assert abs(float(b.energy(_tet_F(b, VERTS @ R.T))[0])) < 1e-10

    def test_stretch_energy(self):
        b = _linear(Lame(mu=0.0, lam=1.0))
        assert abs(float(b.energy(_tet_F(b, VERTS * 2.0))[0]) - 0.25) < 1e-12

    def test_energy_linear_in_stiffness(self):
        b2 = _linear(Lame(mu=0.0, lam=2.123))
        e2 = float(b2.energy(_tet_F(b2, VERTS * 2.0))[0])
        assert abs(e2 - 0.25 * 2.123) < 1e-12 and e2 > 0


@pytest.mark.parametrize("model", MODELS[1:])
def test_rest_energy_zero_and_rotation_invariant(model):
    """tests/test_materials.py:70-81."""
    lame = Lame.from_youngs_poisson(1e6, 0.3)
    b = el.build_tet_batch(VERTS, TET, lame, model, device="cpu", dtype=torch.float64,
                           kappa=0.0)
    F_rest = torch.eye(3, dtype=torch.float64)[None]
    e0 = float(b.energy(F_rest)[0])
    assert abs(e0) < 1e-8 * lame.mu
    R = torch.as_tensor(rot_matrix(33.0, (1, 2, 3)))
    eR = float(b.energy(R[None] @ F_rest)[0])
    assert abs(eR - e0) < 1e-7 * lame.mu


def test_tri_energy_rest_and_rotation():
    """tests/test_cloth.py:26-39."""
    lame = Lame(mu=0.0, lam=1.0)
    b = el.build_tri_batch(TRI_VERTS, TRI, lame, device="cpu", dtype=torch.float64)

    def F(x):
        return red.tri_Dx_rows(torch.as_tensor(x), b.inds, b.Dlocal).T.reshape(-1, 3, 2)

    assert abs(float(b.energy(F(TRI_VERTS))[0])) < 1e-12
    R = rot_matrix(72.0, (3, 1, 2))
    assert abs(float(b.energy(F(TRI_VERTS @ R.T))[0])) < 1e-10
    assert abs(float(b.weight[0]) ** 2 - lame.bulk_modulus() * 0.5) < 1e-12
