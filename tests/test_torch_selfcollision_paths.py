"""Self-collision through the port's Solver on the CPU against the JAX package:
the stacked boxes of tests/test_contact.py:199-220,317-345 (two 3x3x3
make_tet_blocks boxes of cell 1/3, the second 1.25 above the first, each with
its collider, a Floor at y = -0.5, the default settings) under Uzawa and
AL-PCG, float32 and float64, ten steps (Gauss-Seidel's are in
tests/test_torch_selfcollision_gs.py): the floor is reached at step 8 and the
first dynamic rows appear at step 9 (AL-PCG float32: 10). Before each step the
port takes the JAX package's state (x, v, y, prev_active), so each gap is one
step's: the positions after it against the JAX package's under a bound per
solver and dtype, and the dynamic hits that both packages detect at the JAX
package's state (their _detect without the passive rows): equal in float64,
within HITS_F32 in float32, where a barycentric within rounding of 0 can flip
a hit. The JAX package takes its Jacobi SVD (set_svd_impl("jacobi")), the
body of the port's local step. One Schur solve from the same state and rows,
trip by trip, is held tighter (test_schur_solve_trip_by_trip). The JAX tests'
no-tunnelling oracles over 50 steps on the port alone are in
tests/test_torch_selfcollision_gs.py (AL-PCG) and
tests/test_torch_selfcollision_oracle.py (Gauss-Seidel).

Why one step and not the trajectory: from the landing on, the JAX package
parts from itself as far as from the port. tools/selfcoll_onestep.py steps
both packages from the JAX package's state, and the JAX package once more
from that state with x one ulp up: the port's one-step gap and that control's
are of one size at every step (Uzawa float64 at step 11: 1.15e-2 and 1.17e-2;
AL-PCG float64 at step 9, the first dynamic rows: 1.436e-7 both, the control
and the port taking 265 PCG trips where the JAX package takes 314). The
Schur CG's trips exit on an absolute |r|^2 < tol^2, and its residual after
the first few trips is rounding, in either package alone.

The float32 runs rebuild the JAX solver's colliders with float32 rest
vertices before initialize (make_tet_mesh_collider(..., dtype=np.float32)):
under jax_enable_x64, which tests/conftest.py sets, the JAX package's default
float64 rest vertices promote its float32 detection to float64 (ROADMAP
Queue 3), and its Uzawa and AL-PCG loops then fail to trace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu as J
from admm_elastic_tpu import binding as jbinding
from admm_elastic_tpu.collision import constraints as jcon
from admm_elastic_tpu.collision.dynamic import make_tet_mesh_collider as j_collider
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_blocks
from admm_elastic_tpu.geometry.factory import make_xform as j_xform
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.solver import _detect as j_detect
from admm_elastic_tpu.solver import _make_apply_Ainv
from admm_elastic_tpu.solvers import uzawa as juz
from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks, make_xform
from admm_elastic_tpu_torch.solvers import uzawa as tuz

torch.set_num_threads(1)
STEPS = 10
FLOOR_Y = -0.5
FLOOR_TOL = 1e-3  # tests/test_contact.py FLOOR_TOL
# The one-step bound (relative to max |x|) per (linsolver, dtype), some 3-4x
# the largest one-step gap of these ten steps (tools/selfcoll_onestep.py):
# Uzawa 5.3e-5 in float64 (step 10; the control 5.7e-2) and 1.0e-2 in float32
# (step 9; the control 1.0e-2), AL-PCG 1.4e-7 in float64 (step 9, the
# control's too) and 1.6e-3 in float32 (step 8; the control 1.3e-3).
X_TOL = {(2, "f64"): 2e-4, (2, "f32"): 3e-2, (4, "f64"): 5e-7, (4, "f32"): 5e-3}
HITS_F32 = 2  # float32: the hits may differ by this many at a step
# the step (from 0) whose state first shows a dynamic row in the JAX package's
# run: step 9, and step 10 for AL-PCG in float32, whose step 9 lands the top
# box a little higher (its one-ulp control shows 18 rows there)
FIRST_ROWS = {(2, "f64"): 8, (2, "f32"): 8, (4, "f64"): 8, (4, "f32"): 9}
# AL-PCG float64: the PCG trips of each step equal the JAX package's, but at
# step 9 (index 8), where its own one-ulp control takes the port's 265 for its
# 314
ALPCG_TRIPS_PART = 8
# One Schur solve from the same state and rows (the JAX package's after 9
# steps: 6 passive and 14 dynamic rows): its first SCHUR_TRIPS trips'
# residuals within SCHUR_RES_TOL of the JAX package's (relative; measured
# 5.0e-13 at most, then 5.9e-11 at trip 6 and 1.6e-2 at trip 7, where the
# Krylov space is spent and the residual is rounding), and the solve's x
# within SCHUR_X_TOL of max |x| in the same trips (its 20, measured 4.9e-11).
SCHUR_TRIPS, SCHUR_RES_TOL, SCHUR_X_TOL = 5, 2e-12, 2e-10


def stack_scene(ls, dtype, jax_pkg):
    """The two stacked boxes with their colliders in one package."""
    if jax_pkg:
        s = J.Solver()
        blocks, xform, bind, lame = j_blocks, j_xform, jbinding, J.Lame.rubber()
    else:
        s = Solver(device="cpu")
        blocks, xform, bind, lame = make_tet_blocks, make_xform, binding, Lame.rubber()
    for i in range(2):
        m = blocks(3, 3, 3, cell=1.0 / 3.0)
        m.apply_xform(xform(trans=(0.0, i * 1.25, 0.0)))
        m.flags = bind.LINEAR
        bind.add_tetmesh(s, m, lame, verbose=False)
    if jax_pkg:
        s.add_obstacle(J.Floor(y=jnp.asarray(FLOOR_Y)))
        if dtype == np.float32:
            s.colliders[:] = [j_collider(np.asarray(c.rest_verts),
                                         np.asarray(c.tets) - c.vert_offset, np.asarray(c.faces),
                                         c.vert_offset, dtype=np.float32) for c in s.colliders]
        assert s.initialize(J.Settings(verbose=0, admm_iters=10, linsolver=ls, dtype=dtype))
    else:
        s.add_obstacle(Floor(y=FLOOR_Y))
        assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=ls, dtype=dtype))
    return s


def jax_hits(js, x):
    h = j_detect(tuple(js.obstacles), tuple(js.colliders), jnp.asarray(x), js._surf_inds_dev,
                 False, js._dtype, js._surf_dense)
    return int(np.asarray(h.d_mask).sum())


def port_hits(ts, x):
    xt = torch.as_tensor(np.array(x)).to(ts.state.x.dtype)
    return int(ts._detect(xt, with_passive=False).d_mask.sum())


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """run_both may set the JAX package's Jacobi SVD (module state); the
    default goes back after the module."""
    yield
    jprox.set_svd_impl("auto")


def take_jax_state(ts, js):
    """The port's state set to the JAX package's (x, v, y, prev_active)."""
    st = js.state
    ts.state = type(ts.state)(**{f: torch.as_tensor(np.array(getattr(st, f))) for f in
                                 ("x", "v", "y", "prev_active")})


def run_both(ls, dtype, steps=STEPS, from_jax=False):
    """(per-step relative x gaps, JAX hits, port hits, JAX inner, port inner)
    of the two packages stepped side by side; from_jax: the port takes the
    JAX package's state before each step, which runs its Jacobi SVD."""
    if from_jax:
        jprox.set_svd_impl("jacobi")
    js, ts = stack_scene(ls, dtype, True), stack_scene(ls, dtype, False)
    assert ts.surface_inds == [int(i) for i in np.asarray(js.surface_inds)]
    gaps, hj, ht, ij, it = [], [], [], [], []
    for _ in range(steps):
        if from_jax:
            take_jax_state(ts, js)
        js.step()
        ts.step()
        xj, xt = np.asarray(js.x, np.float64), ts.x
        assert np.isfinite(xt).all()
        gaps.append(float(np.abs(xj - xt).max() / np.abs(xj).max()))
        hj.append(jax_hits(js, js.state.x))
        ht.append(port_hits(ts, js.state.x))
        ij.append(js.runtime_data().inner_iters)
        it.append(ts.runtime_data().inner_iters)
        assert ts.runtime_data().collision_overflow == js.runtime_data().collision_overflow
    return gaps, hj, ht, ij, it


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("ls", [2, 4])
def test_stack_through_first_contact(ls, dtype):
    np_dtype = np.float64 if dtype == "f64" else np.float32
    gaps, hj, ht, ij, it = run_both(ls, np_dtype, from_jax=True)
    first = next(k for k, h in enumerate(hj) if h > 0)
    assert first == FIRST_ROWS[(ls, dtype)], hj  # the boxes' first dynamic rows
    assert max(gaps) <= X_TOL[(ls, dtype)], gaps
    bound = 0 if dtype == "f64" else HITS_F32
    assert all(abs(a - b) <= bound for a, b in zip(hj, ht)), (hj, ht)
    assert all(k > 0 for k in it[7:]), it  # every step from the landing iterates
    if ls == 4 and dtype == "f64":
        keep = [k for k in range(STEPS) if k != ALPCG_TRIPS_PART]
        assert [it[k] for k in keep] == [ij[k] for k in keep], (ij, it)


def test_schur_solve_trip_by_trip():
    """Uzawa, float64: one Schur solve in both packages from the JAX
    package's state after 9 steps, on its rows (6 passive, 14 dynamic) taken
    into the port as they are: C and C^T of the rows bit for bit the JAX
    package's, the first SCHUR_TRIPS trips' residuals (solve_traced) within
    SCHUR_RES_TOL of the JAX package's, and the solve itself in the same trips,
    its x within SCHUR_X_TOL."""
    import dataclasses

    import jax.numpy as jnp

    jprox.set_svd_impl("jacobi")
    js, ts = stack_scene(2, np.float64, True), stack_scene(2, np.float64, False)
    for _ in range(9):
        js.step()
    x = np.asarray(js.state.x)
    n = x.shape[0]
    jh = j_detect(tuple(js.obstacles), tuple(js.colliders), jnp.asarray(x), js._surf_inds_dev,
                  True, js._dtype, js._surf_dense).dedup()
    th = ts._detect(torch.as_tensor(x), with_passive=True).dedup()
    for f in ("p_mask", "d_mask", "d_face"):
        assert np.array_equal(np.asarray(getattr(jh, f)), getattr(th, f).numpy()), f
    assert int(jh.p_mask.sum()) == 6 and int(jh.d_mask.sum()) == 14
    th = con.with_table(dataclasses.replace(th, **{
        f: torch.as_tensor(np.array(getattr(jh, f))) for f in
        ("p_normal", "p_point", "d_barys", "d_normal")}), n)
    h = th.capacity
    ck_t = ts._contact.ck
    ck_j = jnp.asarray(float(ck_t))
    rng = np.random.default_rng(0)
    Aj = _make_apply_Ainv(js.system, js._solve_data, {}, js._refine_eff)
    b0 = np.asarray(Aj(jnp.asarray(x))) + 1e-2 * rng.standard_normal(x.shape)
    yv = rng.standard_normal(2 * h)
    ct_j = np.asarray(jcon.Ct_apply(jh, ck_j, jnp.asarray(yv[:h]), jnp.asarray(yv[h:]), n))
    ct_t = con.Ct_apply(th, ck_t, torch.as_tensor(yv[:h]), torch.as_tensor(yv[h:]), n).numpy()
    assert np.array_equal(ct_j, ct_t)
    c_j = np.concatenate([np.asarray(a) for a in jcon.C_apply(jh, ck_j, jnp.asarray(b0))])
    c_t = torch.cat(con.C_apply(th, ck_t, torch.as_tensor(b0))).numpy()
    assert np.array_equal(c_j, c_t)
    y0 = np.zeros(2 * h)
    _, _, tr_j = juz.solve_traced(lambda r, x0=None: Aj(r), jh, ck_j, jnp.asarray(b0),
                                  jnp.asarray(x), jnp.asarray(y0), SCHUR_TRIPS)
    _, _, tr_t = tuz.solve_traced(ts._uzawa_Ainv, th, ck_t, torch.as_tensor(b0),
                                  torch.as_tensor(x), torch.as_tensor(y0), SCHUR_TRIPS)
    res_j, res_t = np.asarray(tr_j["res"]), np.asarray(tr_t["res"])
    assert np.all(np.abs(res_j - res_t) <= SCHUR_RES_TOL * res_j), (res_j, res_t)
    s = js.m_settings
    xj, _, kj = juz.solve(lambda r, x0=None: Aj(r), jh, ck_j, jnp.asarray(b0), jnp.asarray(x),
                          jnp.asarray(y0), s.uzawa_max_iters, s.uzawa_tol)
    xt, _, kt = tuz.solve(ts._uzawa_Ainv, th, ck_t, torch.as_tensor(b0), torch.as_tensor(x),
                          torch.as_tensor(y0), s.uzawa_max_iters, s.uzawa_tol)
    xj = np.asarray(xj)
    assert int(kj) == int(kt)
    assert np.abs(xj - xt.numpy()).max() <= SCHUR_X_TOL * np.abs(xj).max()


def test_linsolver_0_refuses_a_collider():
    """A self-colliding mesh with linsolver=0 raises, as an obstacle does
    (admm_elastic_tpu/solver.py:697-703)."""
    s = Solver(device="cpu")
    m = make_tet_blocks(2, 2, 2)
    m.flags = binding.LINEAR
    binding.add_tetmesh(s, m, verbose=False)
    with pytest.raises(RuntimeError, match="No collisions with LDLT solver"):
        s.initialize(Settings(verbose=0, linsolver=0))


def test_add_tetmesh_registers_the_collider_and_surface():
    """binding.add_tetmesh on a mesh without NOSELFCOLLISION: a collider at
    the mesh's offset and its surface vertices appended to surface_inds, in
    both packages alike; with NOSELFCOLLISION neither."""
    ts, js = stack_scene(1, np.float64, False), stack_scene(1, np.float64, True)
    assert len(ts.colliders) == len(js.colliders) == 2
    for tc, jc in zip(ts.colliders, js.colliders):
        assert tc.vert_offset == jc.vert_offset and tc.cell_cap == jc.cell_cap
        assert np.array_equal(tc.tets.numpy(), np.asarray(jc.tets))
        assert np.array_equal(tc.faces.numpy(), np.asarray(jc.faces))
    assert ts.surface_inds == [int(i) for i in js.surface_inds]
    assert not ts._contact.dense and ts._contact.slot_of is not None
    assert ts.state.y.shape[0] == 2 * len(set(ts.surface_inds))
    s = Solver(device="cpu")
    m = make_tet_blocks(2, 2, 2)
    m.flags = binding.NOSELFCOLLISION | binding.LINEAR
    binding.add_tetmesh(s, m, verbose=False)
    assert not s.colliders and not s.surface_inds
    assert ts._contact.colliders[0].rest_verts.dtype == torch.float64
