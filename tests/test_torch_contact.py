"""Contact's host code and plain versions against the JAX package, on the
CPU: Floor, Sphere and detect_passive bit for bit in float64; every
constraints.py function, dynamic rows included, on random dense and
non-dense hits; greedy_coloring and color_groups on the Gauss-Seidel paths'
graphs bit for bit; one gs.solve, one uzawa.solve (direct and PCG inner) and
one alcg.solve (the dense Jacobi form and the two-grid form) each on fixed
hits, in the JAX package's iterations; and the schedules of kernel H (each
vertex of a colour updated in place, one after the other) and of kernel G's
penalty form (the banded order of its plan) walked in plain PyTorch.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu import Floor as JFloor
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import Sphere as JSphere
from admm_elastic_tpu import binding as jbinding
from admm_elastic_tpu import solver as jsolver_mod
from admm_elastic_tpu.collision import constraints as jcon
from admm_elastic_tpu.collision import passive as jpassive
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.geometry.factory import make_tet_torus as j_make_tet_torus
from admm_elastic_tpu.geometry.factory import make_xform as j_make_xform
from admm_elastic_tpu.geometry.io import load_elenode as j_load_elenode
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.solvers import alcg as jalcg
from admm_elastic_tpu.solvers import gs as jgs
from admm_elastic_tpu.solvers import uzawa as juzawa
from admm_elastic_tpu.system import assembly as jasm
from admm_elastic_tpu_torch import Floor, Sphere
from admm_elastic_tpu_torch.collision import constraints as tcon
from admm_elastic_tpu_torch.collision import passive as tpassive
from admm_elastic_tpu_torch.ops import cuda_gs, cuda_pcg
from admm_elastic_tpu_torch.solvers import alcg as talcg
from admm_elastic_tpu_torch.solvers import gs as tgs
from admm_elastic_tpu_torch.solvers import pcg as tpcg
from admm_elastic_tpu_torch.solvers import uzawa as tuzawa
from admm_elastic_tpu_torch.system import assembly as tasm

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """_both sets the JAX package's Jacobi SVD (set_svd_impl, module state);
    the default goes back after the module, so that a later file in the same
    worker (tests/test_lineartet.py, which holds the default SVD's volume
    error) does not run on the Jacobi one."""
    yield
    jprox.set_svd_impl("auto")


def _jax_api():
    return types.SimpleNamespace(
        Solver=JSolver, Settings=JSettings, Lame=JLame, binding=jbinding,
        make_tet_blocks=j_make_tet_blocks, make_tet_torus=j_make_tet_torus,
        load_elenode=j_load_elenode, Floor=JFloor, Sphere=JSphere, make_xform=j_make_xform,
        asarray=jnp.asarray)


def _port(name):
    chip_smoke.DEVICE = "cpu"
    return chip_smoke.contact_scene(name, chip_smoke.torch_api("cpu"))


def _both(name):
    jprox.set_svd_impl("jacobi")
    return _port(name), chip_smoke.contact_scene(name, _jax_api())


def _t(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# --- obstacles ---------------------------------------------------------------

OBSTACLE_SETS = {
    "floor": [("floor", -1.0)],
    "sphere": [("sphere", (0.3, -10.0, 0.2), 10.0)],
    "floor_sphere": [("floor", -0.2), ("sphere", (0.1, -10.0, 0.0), 10.0)],
    "sphere_floor": [("sphere", (0.1, -10.0, 0.0), 10.0), ("floor", -0.2)],
    "tie": [("floor", 0.0), ("floor", 0.0)],
    "none": [],
}


def _obstacles(spec):
    port, jx = [], []
    for o in spec:
        if o[0] == "floor":
            port.append(Floor(y=o[1]))
            jx.append(JFloor(y=jnp.asarray(o[1], jnp.float64)))
        else:
            port.append(Sphere(center=o[1], rad=o[2]))
            jx.append(JSphere(center=jnp.asarray(o[1], jnp.float64),
                              rad=jnp.asarray(o[2], jnp.float64)))
    return port, jx


@pytest.mark.parametrize("which", sorted(OBSTACLE_SETS))
def test_detect_passive_is_the_jax_package_s_bit_for_bit(which):
    """dx, point, normal and hit of the deepest obstacle (the first of least
    dx) at 500 points around the surfaces, float64, bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 3)) * 0.5
    x[:5] = [[0.0, 0.0, 0.0], [0.1, -0.2, 0.0], [0.0, 0.2, 0.0], [0.1, -0.1, 0.0],
             [0.3, 0.0, 0.2]]  # on a surface, on both
    port, jx = _obstacles(OBSTACLE_SETS[which])
    got = tpassive.detect_passive([o.to("cpu", F64) for o in port], _t(x))
    want = jpassive.detect_passive(tuple(jx), jnp.asarray(x))
    for a, b in zip(got[:4], want[:4]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert not bool(got[4]) and not bool(want[4])


def test_obstacles_hold_float64_and_round_once():
    """A number becomes a float64 tensor; to(device, dtype) rounds it once, as
    jnp.asarray does in float32."""
    s = Sphere(center=[0.1, -10.0, 0.3], rad=10.0)
    assert s.center.dtype == F64 and s.rad.dtype == F64
    s32 = s.to("cpu", torch.float32)
    assert np.array_equal(s32.center.numpy(), np.asarray(jnp.asarray([0.1, -10.0, 0.3],
                                                                      jnp.float32)))
    f = Floor(y=-1.0).to("cpu", torch.float32)
    assert f.y.dtype == torch.float32 and f.unit_y.dtype == torch.float32
    with pytest.raises(dataclasses.FrozenInstanceError):
        f.y = torch.tensor(0.0)


# --- constraints ---------------------------------------------------------------

def _hits(rng, n, dense, may_dyn):
    h = n if dense else n // 2
    surf = np.arange(n) if dense else np.sort(rng.choice(n, h, replace=False))
    nrm = rng.standard_normal((h, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    fields = dict(p_mask=rng.random(h) < 0.5, p_vidx=surf, p_normal=nrm,
                  p_point=rng.standard_normal((h, 3)),
                  d_mask=(rng.random(h) < 0.4) if may_dyn else np.zeros(h, bool),
                  d_vidx=surf, d_face=rng.integers(0, n, (h, 3)),
                  d_barys=rng.dirichlet(np.ones(3), h), d_normal=rng.standard_normal((h, 3)))
    jh = jcon.Hits(**{k: jnp.asarray(v) for k, v in fields.items()},
                   overflow=jnp.asarray(False), dense=dense, may_dyn=may_dyn)
    th = tcon.Hits(**{k: (_t(v) if v.dtype.kind == "f" else torch.as_tensor(v))
                      for k, v in fields.items()},
                   overflow=torch.tensor(False), dense=dense, may_dyn=may_dyn)
    return th, jh


@pytest.mark.parametrize("may_dyn", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_constraints_are_the_jax_package_s(dense, may_dyn):
    """C, c, C^T, diag(C^T C), C^T C and C^T c on random hits (a dedup
    between), float64, within 1e-12 of the JAX package's."""
    rng = np.random.default_rng(3 + 2 * dense + may_dyn)
    n = 40
    th, jh = _hits(rng, n, dense, may_dyn)
    th, jh = th.dedup(), jh.dedup()
    ck = 7.5
    x = rng.standard_normal((n, 3))
    yp, yd = rng.standard_normal(th.capacity), rng.standard_normal(th.capacity)
    pairs = [(tcon.C_apply(th, ck, _t(x)), jcon.C_apply(jh, ck, jnp.asarray(x))),
             (tcon.C_rhs(th, ck), jcon.C_rhs(jh, ck)),
             ((tcon.Ct_apply(th, ck, _t(yp), _t(yd), n),),
              (jcon.Ct_apply(jh, ck, jnp.asarray(yp), jnp.asarray(yd), n),)),
             ((tcon.CtC_diag(th, ck, n, F64),), (jcon.CtC_diag(jh, ck, n, jnp.float64),)),
             ((tcon.CtC_apply(th, ck, _t(x)),), (jcon.CtC_apply(jh, ck, jnp.asarray(x)),)),
             ((tcon.Ct_c(th, ck, n),), (jcon.Ct_c(jh, ck, n),))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert a.shape == tuple(b.shape)
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * max(
                1.0, np.abs(np.asarray(b)).max())
    assert int(th.n_active()) == int(jh.n_active())
    e = tcon.empty_hits(torch.arange(5), F64, dense=True, may_dyn=False)
    assert e.capacity == 5 and not bool(e.p_mask.any()) and not bool(e.overflow)


def test_dynamic_rows_stay_off_the_card():
    """The d_face scatter adds duplicates: on a CUDA tensor it raises, naming
    ROADMAP Queue 1 item 10 (tested here on a stand-in device check)."""
    rng = np.random.default_rng(5)
    th, _ = _hits(rng, 12, False, True)
    meta = torch.empty((th.capacity, 3), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
        tcon.C_apply(dataclasses.replace(th, p_normal=meta), 1.0, _t(np.zeros((12, 3))))


# --- colouring -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["floor_gs5k", "sphere_gs", "contact_gs"])
def test_coloring_is_the_jax_package_s(name):
    """vertex_adjacency, greedy_coloring (the JAX package's native library
    where it loads) and color_groups bit for bit, and the port's GSData
    holds them."""
    s = _port(name)
    adj = tasm.vertex_adjacency(s.system)
    colors = tasm.greedy_coloring(adj)
    jcolors = np.asarray(jasm.greedy_coloring(jasm.vertex_adjacency(s.system)))
    assert colors.dtype == np.int32 and np.array_equal(colors, jcolors)
    groups, mask = tasm.color_groups(colors)
    jgroups, jmask = jasm.color_groups(jcolors)
    assert np.array_equal(groups, jgroups) and np.array_equal(mask, jmask)
    assert np.array_equal(s._solve_data.colors.numpy(), groups)
    # no two vertices of a colour share a row of A: kernel H updates in place
    cols = s._solve_data.ell_cols.numpy()
    vals = s._solve_data.ell_vals.numpy()
    for c in range(groups.shape[0]):
        rows = groups[c][mask[c]]
        nz = set(cols[rows][vals[rows] != 0].tolist())
        assert not nz & set(rows.tolist())


# --- the solves on fixed inputs ----------------------------------------------------

@pytest.fixture(scope="module")
def gs64():
    return _both("contact_gs_f64")


def _landed(drop=0.05):
    """A landed state of the small beam (the float64 GS golden's step 12) and
    the position drop below it, into the floor."""
    g = chip_smoke.golden("contact_gs_f64")
    x = _t(g["x12"])
    target = x.clone()
    target[:, 1] -= drop
    return x, target


def test_gs_solve_is_the_jax_package_s(gs64):
    """gs.solve from a landed state with a rhs below the floor (contacts in
    every sweep) and three pinned vertices, float64: the JAX package's
    sweeps, x within 1e-10."""
    port, jx = gs64
    d = port._solve_data
    x0, target = _landed()
    b = d.diag[:, None] * target + tgs.ell_offdiag_mv(d.ell_cols, d.ell_vals, target)
    pin_mask = torch.zeros(x0.shape[0], dtype=torch.bool)
    pin_mask[[0, 5, 50]] = True
    pin_target = x0 + 0.01
    obstacles = [o.to("cpu", F64) for o in port.obstacles]
    x, k = tgs.solve(d.ell_cols, d.ell_vals, d.diag, d.colors, d.colors_mask, b, x0, pin_mask,
                     pin_target, obstacles, None, None, 1.9, 30, 1e-10, may_have_dyn=False)
    jd = jx._solve_data
    jhits = jcon.empty_hits(jnp.arange(x0.shape[0]), jnp.float64, dense=True, may_dyn=False)
    xj, kj = jax.jit(lambda b_, x0_, pm, pt: jgs.solve(
        jd.ell_cols, jd.ell_vals, jd.diag, jd.colors, jd.colors_mask, b_, x0_, pm, pt,
        tuple(jx.obstacles), jhits, 1.0, 1.9, 30, 1e-10, may_have_dyn=False))(
        jnp.asarray(b.numpy()), jnp.asarray(x0.numpy()), jnp.asarray(pin_mask.numpy()),
        jnp.asarray(pin_target.numpy()))
    assert k == int(kj) and _rel(x.numpy(), xj) <= 1e-10
    assert np.abs(x.numpy()[[0, 5, 50]] - pin_target.numpy()[[0, 5, 50]]).max() == 0.0
    assert x.numpy()[:, 1].min() >= -1.0 - 1e-12  # projected onto the floor


def test_gs_penalty_branch_is_the_jax_package_s(gs64):
    """The self-collision penalty fold of gs.solve (may_have_dyn, plain only),
    on random dynamic rows, float64."""
    port, jx = gs64
    d = port._solve_data
    n = d.diag.shape[0]
    rng = np.random.default_rng(11)
    th, jh = _hits(rng, n, True, True)
    th = dataclasses.replace(th, p_mask=torch.zeros_like(th.p_mask))
    jh = dataclasses.replace(jh, p_mask=jnp.zeros_like(jh.p_mask))
    x0, target = _landed()
    b = d.diag[:, None] * target
    no_pin = torch.zeros(n, dtype=torch.bool)
    x, k = tgs.solve(d.ell_cols, d.ell_vals, d.diag, d.colors, d.colors_mask, b, x0, no_pin,
                     x0, [], th, 2.0, 1.9, 8, 1e-10, may_have_dyn=True)
    jd = jx._solve_data
    xj, kj = jgs.solve(jd.ell_cols, jd.ell_vals, jd.diag, jd.colors, jd.colors_mask,
                       jnp.asarray(b.numpy()), jnp.asarray(x0.numpy()),
                       jnp.asarray(no_pin.numpy()), jnp.asarray(x0.numpy()), (), jh, 2.0, 1.9,
                       8, 1e-10, may_have_dyn=True)
    assert k == int(kj) and _rel(x.numpy(), xj) <= 1e-10


def _fixed_hits(port, jx, x_at):
    """The passive hits of both packages' detection at x_at."""
    hits = port._detect(x_at)
    jhits = jsolver_mod._detect(tuple(jx.obstacles), (), jnp.asarray(x_at.numpy()),
                                jx._surf_inds_dev, True, jnp.float64, True)
    assert np.array_equal(hits.p_mask.numpy(), np.asarray(jhits.p_mask))
    assert int(hits.p_mask.sum()) > 0
    return hits, jhits


@pytest.mark.parametrize("name", ["contact_uzawa_f64", "contact_uzawa_pcg_f64"])
def test_uzawa_solve_is_the_jax_package_s(name):
    """uzawa.solve around the direct inner and the PCG inner, float64, from a
    landed state on the hits of a position 5 cm into the floor: the JAX
    package's Schur trips, x and y within 1e-10."""
    port, jx = _both(name)
    x0, target = _landed()
    hits, jhits = _fixed_hits(port, jx, target)
    b = tpcg.PCGData.apply(port._solve_data, target) if isinstance(
        port._solve_data, tpcg.PCGData) else _A(port, target)
    y0 = torch.zeros(2 * hits.capacity, dtype=F64)
    s = port.m_settings
    x, y, it = tuzawa.solve(port._uzawa_Ainv, hits, port._contact.ck, b, x0, y0,
                            s.uzawa_max_iters, s.uzawa_tol)
    japply = jsolver_mod._make_apply_Ainv(jx.system, jx._solve_data, jx._params(),
                                          jx._refine_eff)
    xj, yj, itj = juzawa.solve(japply, jhits, jnp.asarray(jx._ck), jnp.asarray(b.numpy()),
                               jnp.asarray(x0.numpy()), jnp.asarray(y0.numpy()),
                               s.uzawa_max_iters, s.uzawa_tol)
    assert int(it) == int(itj) and int(it) > 1
    assert _rel(x.numpy(), xj) <= 1e-10 and _rel(y.numpy(), yj) <= 1e-10


@pytest.mark.parametrize("name", ["contact_uzawa_f64", "contact_uzawa_pcg_f64"])
def test_uzawa_predicates_every_schur_trip(name):
    """uzawa.solve runs all of its max_iters Schur trips, on the CPU as in a
    captured step: one A^-1 apply for the first iterate and one per trip, each
    trip's with the device flag, set on every trip after the exit (at a
    tolerance that both inners meet within the trips). Those trips change
    nothing: three more give the same bits and the same trip count."""
    port, jx = _both(name)
    x0, target = _landed()
    hits, _ = _fixed_hits(port, jx, target)
    b = tpcg.PCGData.apply(port._solve_data, target) if isinstance(
        port._solve_data, tpcg.PCGData) else _A(port, target)
    y0 = torch.zeros(2 * hits.capacity, dtype=F64)
    s = port.m_settings
    flags = []

    def apply(rhs, x, done):
        flags.append(None if done is None else bool(done))
        return port._uzawa_Ainv(rhs, x, done)

    tol = 1e-6
    x, y, it = tuzawa.solve(apply, hits, port._contact.ck, b, x0, y0, s.uzawa_max_iters, tol)
    assert len(flags) == 1 + s.uzawa_max_iters and flags[0] is None
    assert flags[1:].count(False) == int(it) < s.uzawa_max_iters
    assert flags[1:] == [False] * int(it) + [True] * (s.uzawa_max_iters - int(it))
    x3, y3, it3 = tuzawa.solve(port._uzawa_Ainv, hits, port._contact.ck, b, x0, y0,
                               s.uzawa_max_iters + 3, tol)
    assert torch.equal(x, x3) and torch.equal(y, y3) and int(it) == int(it3)


def _A(port, x):
    from admm_elastic_tpu_torch.system import system as sysm

    return sysm.A_mv(port.system, x)


@pytest.mark.parametrize("name", ["contact_alpcg_f64", "contact_alpcg_twogrid_f64"])
def test_alcg_solve_is_the_jax_package_s(name):
    """alcg.solve in its two forms (dense Jacobi: solve_T on A + pn pn^T;
    two-grid: pcg.solve with C^T C and the folded smoother), float64, on the
    hits of a position 5 cm into the floor with a nonzero multiplier: the JAX
    package's CG trips, x and y within 1e-10."""
    port, jx = _both(name)
    x0, target = _landed()
    hits, jhits = _fixed_hits(port, jx, target)
    data = port._solve_data
    b = data.apply(target)
    y0 = torch.as_tensor(np.random.default_rng(2).standard_normal(2 * hits.capacity))
    s = port.m_settings
    trips = torch.zeros(1, dtype=torch.int32)
    x, y = talcg.solve(data, hits, port._contact.ck, b, x0, y0, s.pcg_tol, s.pcg_max_iters,
                       trips)
    xj, yj, itj = jalcg.solve(jx._solve_data, jhits, jnp.asarray(jx._ck),
                              jnp.asarray(b.numpy()), jnp.asarray(x0.numpy()),
                              jnp.asarray(y0.numpy()), s.pcg_tol, s.pcg_max_iters)
    assert int(trips) == int(itj) > 0
    assert _rel(x.numpy(), xj) <= 1e-10
    # y = y0 + C x - c carries x's rounding times ck: held against ck max |x|
    ck = float(port._contact.ck)
    assert np.abs(y.numpy() - np.asarray(yj)).max() <= 1e-10 * ck * np.abs(np.asarray(xj)).max()
    xp, yp, kp = talcg.solve_plain(data, hits, port._contact.ck, b, x0, y0, s.pcg_tol,
                                   s.pcg_max_iters)
    assert torch.equal(xp, x) and torch.equal(yp, y) and kp == int(trips)


# --- the kernels' schedules in plain PyTorch -----------------------------------------

def h_walk(d, b, x0, pin_mask, pin_target, obstacles, omega, sweeps):
    """Kernel H's schedule: each vertex of a colour updated in place, one
    after the other, its row read from the x that the others of its colour
    are writing (the ELL's pad entries read column 0 with value 0)."""
    n = d.diag.shape[0]
    x = x0.clone()
    om = torch.as_tensor(omega, dtype=x.dtype)
    for _ in range(sweeps):
        for c in range(d.colors.shape[0]):
            for row in d.colors[c].tolist():
                if row >= n:
                    continue
                lux = torch.zeros(3, dtype=x.dtype)
                for k in range(d.ell_cols.shape[1]):
                    lux = lux + d.ell_vals[row, k] * x[int(d.ell_cols[row, k])]
                xg = (b[row] - lux) / d.diag[row]
                xn = (1.0 - om) * x[row] + om * xg
                _, p, nrm, hit, _ = tpassive.detect_passive(obstacles, xn[None])
                if bool(hit[0]):
                    u, v = tgs._ortho_tangent(nrm)
                    delta = xg[None] - p
                    xn = (u * tgs._dot3(u, delta) + v * tgs._dot3(v, delta) + p)[0]
                if bool(pin_mask[row]):
                    xn = pin_target[row]
                x[row] = xn
    return x


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_kernel_h_schedule_is_the_plain_solve_bit_for_bit(dtype):
    """Three sweeps of the 4x2x2 sphere scene pushed into the sphere and a
    floor (both obstacles, the first of least distance), two vertices
    pinned: kernel H's in-place schedule gives gs.solve's x bit for bit."""
    port = _port("sphere_gs_f64")
    d = port._solve_data
    d = dataclasses.replace(d, ell_vals=d.ell_vals.to(dtype), diag=d.diag.to(dtype))
    x0 = port.state.x.to(dtype)
    x0[:, 1] -= 2.05  # into the sphere's top
    target = x0.clone()
    target[:, 1] -= 0.1
    b = d.diag[:, None] * target + tgs.ell_offdiag_mv(d.ell_cols, d.ell_vals, target)
    pin_mask = torch.zeros(x0.shape[0], dtype=torch.bool)
    pin_mask[[3, 17]] = True
    obstacles = [Sphere(center=[0.0, -10.0, 0.0], rad=10.0).to("cpu", dtype),
                 Floor(y=-0.01).to("cpu", dtype)]
    want, k = tgs.solve(d.ell_cols, d.ell_vals, d.diag, d.colors, d.colors_mask, b, x0, pin_mask,
                        x0 + 0.5, obstacles, None, None, 1.9, 3, 1e-30, may_have_dyn=False)
    got = h_walk(d, b, x0, pin_mask, x0 + 0.5, obstacles, 1.9, 3)
    assert k == 3 and torch.equal(got, want)
    sweeps = torch.zeros(1, dtype=torch.int32)
    via = cuda_gs.gs_solve(d, b, x0, pin_mask, x0 + 0.5, obstacles, 1.9, 3, 1e-30, sweeps)
    assert torch.equal(via, want) and int(sweeps) == 3 and cuda_gs.gs_solve.launches == 0


def g_pen_walk(data, pn, pen_diag, b, x0, tol, max_iters):
    """Kernel G's penalty form as csrc/pcg.cu runs it: the banded order of
    its plan, pn and the per-component inverse permuted with it."""
    plan = cuda_pcg._build_plan(data)
    perm = plan.perm
    n = data.n
    pnb = pn if perm is None else pn[perm]
    inv3 = 1.0 / (plan.diag[:, None] + (pen_diag if perm is None else pen_diag[perm]))

    def spmv(v):
        acc = torch.zeros_like(v)
        for d, o in enumerate(data.band_offsets):
            q = torch.arange(n) + o
            if data.band_circular:
                q = q % n
            ok = (q >= 0) & (q < n)
            acc[ok] += plan.bands[d][ok, None] * v[q[ok]]
        for k in range(plan.rest_cols.shape[0]):
            acc += plan.rest_vals[k, :, None] * v[plan.rest_cols[k].long()]
        cx = pnb[:, 0] * v[:, 0] + pnb[:, 1] * v[:, 1] + pnb[:, 2] * v[:, 2]
        return plan.diag[:, None] * v + acc + pnb * cx[:, None]

    def precond(r):
        if plan.agg is None:
            return inv3 * r
        z = cuda_pcg.OMEGA * inv3 * r
        res = r - spmv(z)
        ext = torch.cat([res, res.new_zeros((1, 3))])
        rc = ext[plan.agg_gather.long()].sum(dim=1)
        z2 = z + (plan.coarse_inv @ rc)[plan.agg.long()]
        return z2 + cuda_pcg.OMEGA * inv3 * (r - spmv(z2))

    bb = b if perm is None else b[perm]
    xb = x0 if perm is None else x0[perm]
    xb, k = tpcg.solve(spmv, precond, bb, xb, tol, max_iters)
    if perm is None:
        return xb, k
    out = torch.empty_like(xb)
    out[perm] = xb
    return out, k


@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("scene", ["contact_alpcg_f64", "bunny_pcg_f64"])
def test_kernel_g_penalty_plan_solves_what_penalty_solve_solves(scene, precond):
    """The penalty form walked in the banded order (bands on the beam; RCM
    and a rest-ELL on the bunny) against alcg.penalty_solve in the vertex
    order, random masked normals on a third of the vertices, float64; and
    pcg_solve with a penalty on CPU tensors is penalty_solve."""
    if scene.startswith("bunny"):
        chip_smoke.DEVICE = "cpu"
        solver, _ = chip_smoke.pcg_scene(scene, chip_smoke.torch_api("cpu"))
    else:
        solver = _port(scene)
    data = tpcg.prepare(solver.system, F64, precond=precond, spmv_format="bands")
    n = data.n
    rng = np.random.default_rng(9)
    nrm = rng.standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[rng.random(n) < 0.66] = 0.0
    ck = 300.0
    pn = _t(ck * nrm)
    pen_diag = _t(ck * ck * nrm ** 2)
    x0 = solver.state.x.double()
    b = data.apply(x0 + 0.01) + _t(rng.standard_normal((n, 3)))
    x, k = g_pen_walk(data, pn, pen_diag, b, x0, 1e-10, 400)
    want, kw = talcg.penalty_solve(data, pn, pen_diag, b, x0, 1e-10, 400)
    err = _rel(x.numpy(), want.numpy())
    if data.perm is not None:  # the RCM order moves the bunny's sums (test_torch_pcg.py)
        assert abs(k - kw) <= max(2, kw // 20) and err <= chip_smoke.PCG_F64_TOL_BUNNY
    else:
        assert k == kw > 0 and err <= 1e-10
    trips = torch.zeros(1, dtype=torch.int32)
    via = cuda_pcg.pcg_solve_penalty(data, b, x0, 1e-10, 400, trips, pn, pen_diag)
    assert torch.equal(via, want) and int(trips) == kw


def test_pcg_solve_without_a_counter_counts_nothing():
    """pcg_solve with trips None (Uzawa's inner solve, whose trips are not the
    step's inner iterations) solves as with a counter."""
    port = _port("contact_alpcg_f64")
    data = port._solve_data
    x0 = port.state.x
    b = data.apply(x0 + 0.1)
    trips = torch.zeros(1, dtype=torch.int32)
    want = cuda_pcg.pcg_solve(data, b, x0, 1e-8, 50, trips)
    assert int(trips) > 0 and torch.equal(cuda_pcg.pcg_solve(data, b, x0, 1e-8, 50, None), want)


def test_obstacle_params_are_what_kernel_h_reads():
    """The obstacles' parameters as kernel H takes them (Floor y; Sphere centre
    and radius), read once by the solver on the card only; more than
    MAX_OBSTACLES raise."""
    kinds, par = cuda_gs.obstacle_params(
        [Floor(y=-1.0), Sphere(center=[20.0, -11.0, 2.5], rad=10.0)])
    assert kinds == (cuda_gs.FLOOR, cuda_gs.SPHERE)
    assert list(par) == [-1.0, 0.0, 0.0, 0.0, 20.0, -11.0, 2.5, 10.0]
    with pytest.raises(ValueError, match="at most"):
        cuda_gs.obstacle_params([Floor(y=-1.0)] * (cuda_gs.MAX_OBSTACLES + 1))
    port = _port("contact_gs_f64")
    assert port._contact.gs_params is None  # the CPU's gs_solve reads the obstacles


def test_pcg_solve_takes_no_trip_where_done_is_set():
    port = _port("contact_alpcg_f64")
    data = port._solve_data
    x0 = port.state.x
    b = data.apply(x0 + 0.1)
    trips = torch.zeros(1, dtype=torch.int32)
    x = cuda_pcg.pcg_solve(data, b, x0, 1e-8, 50, trips, done=torch.tensor(True))
    assert torch.equal(x, x0) and int(trips) == 0
    x = cuda_pcg.pcg_solve(data, b, x0, 1e-8, 50, trips, done=torch.tensor(False))
    assert int(trips) > 0 and not torch.equal(x, x0)
