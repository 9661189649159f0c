"""The logged and profiled steps and the traced solves against the JAX
package, on the CPU, float64:

- each solve_traced (pcg, gs, uzawa, alcg) on the same inputs as the JAX
  function: the residual trace, the error trace against x_star and x;
- Solver.step_logged on tests/test_solverlog.py's scenes (the 2x1x1 beam on
  PCG and on the direct solve, the dropped box on Gauss-Seidel, Uzawa and
  AL-PCG after 12 steps) against the JAX Solver's: the traces, the x_star
  errors, final_r and x; and that file's assertions on the port's traces;
- step_profiled: x bitwise equal to step()'s, the phases filled;
- utils/logging.admm_error_trace; the log_inner / verbose routing; the
  Anderson refusal of both diagnostic steps.

Bounds: a trace within 1e-8 of its row's largest value (the two sum the dots
in their own orders; a CG residual falls some ten decades, so its tail is
held at that scale, not its own), 1e-7 around Uzawa's PCG inner (see there);
x within 1e-9 relative to max |x|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu import Floor as JFloor
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbinding
from admm_elastic_tpu import solver as jsolver_mod
from admm_elastic_tpu.collision import constraints as jcon
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.geometry.mesh import lumped_masses_tet as j_lumped
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.solvers import alcg as jalcg
from admm_elastic_tpu.solvers import gs as jgs
from admm_elastic_tpu.solvers import pcg as jpcg
from admm_elastic_tpu.solvers import uzawa as juzawa
from admm_elastic_tpu.utils.logging import admm_error_trace as j_error_trace
from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.collision import constraints as tcon
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.geometry.mesh import lumped_masses_tet
from admm_elastic_tpu_torch.solvers import alcg as talcg
from admm_elastic_tpu_torch.solvers import gs as tgs
from admm_elastic_tpu_torch.solvers import pcg as tpcg
from admm_elastic_tpu_torch.solvers import uzawa as tuzawa
from admm_elastic_tpu_torch.system.system import SimState
from admm_elastic_tpu_torch.utils import logging as tlog
from test_torch_contact import _A, _both, _fixed_hits, _landed
from test_torch_solver import _rel

torch.set_num_threads(1)
F64 = torch.float64
TRACE_TOL = 1e-8
X_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """test_torch_contact._both sets the JAX package's Jacobi SVD (set_svd_impl, module state);
    the default goes back after the module, so that a later file in the same
    worker (tests/test_lineartet.py, which holds the default SVD's volume
    error) does not run on the Jacobi one."""
    yield
    jprox.set_svd_impl("auto")


def _traces_close(got, want, tol=TRACE_TOL, floor=1e-300):
    got, want = np.atleast_2d(np.asarray(got)), np.atleast_2d(np.asarray(want))
    assert got.shape == want.shape
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), floor)
    assert np.all(np.abs(got - want) <= tol * scale), np.abs(got - want).max()


def _j(t):
    return jnp.asarray(t.numpy())


# --- the traced solves on the same inputs -------------------------------------------

def _x_star(x0):
    return x0 + 0.01


def test_pcg_solve_traced_is_the_jax_package_s():
    port, jx = _small(3)
    data, jdata = port._solve_data, jx._solve_data
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal((data.n, 3)))
    x0 = torch.zeros_like(b)
    xs = _x_star(x0)
    x, tr = tpcg.solve_traced(data.apply, data.precondition(), b, x0, 30, x_star=xs)
    xj, trj = jpcg.solve_traced(jdata.apply, jdata.precondition(), _j(b), _j(x0), 30,
                                x_star=_j(xs))
    _traces_close(tr["res"], trj["res"])
    _traces_close(tr["err"], trj["err"])
    assert _rel(x.numpy(), xj) <= X_TOL
    # the freeze: past convergence the trace goes flat, not NaN
    assert np.isfinite(tr["res"].numpy()).all() and float(tr["res"][-1]) < 1e-10


def test_gs_solve_traced_is_the_jax_package_s():
    port, jx = _both("contact_gs_f64")
    d, jd = port._solve_data, jx._solve_data
    x0, target = _landed()
    b = d.diag[:, None] * target + tgs.ell_offdiag_mv(d.ell_cols, d.ell_vals, target)
    pin_mask = torch.zeros(x0.shape[0], dtype=torch.bool)
    pin_mask[[0, 5]] = True
    pin_target = x0 + 0.01
    obstacles = [o.to("cpu", F64) for o in port.obstacles]
    empty = tcon.empty_hits(torch.arange(x0.shape[0]), F64, dense=True, may_dyn=False)
    xs = _x_star(x0)
    x, tr = tgs.solve_traced(d.ell_cols, d.ell_vals, d.diag, d.colors, d.colors_mask, b, x0,
                             pin_mask, pin_target, obstacles, empty, 1.0, 1.9, 12, x_star=xs,
                             may_have_dyn=False)
    jhits = jcon.empty_hits(jnp.arange(x0.shape[0]), jnp.float64, dense=True, may_dyn=False)
    xj, trj = jgs.solve_traced(jd.ell_cols, jd.ell_vals, jd.diag, jd.colors, jd.colors_mask,
                               _j(b), _j(x0), _j(pin_mask), _j(pin_target),
                               tuple(jx.obstacles), jhits, 1.0, 1.9, 12, x_star=_j(xs),
                               may_have_dyn=False)
    _traces_close(tr["res"], trj["res"])
    _traces_close(tr["err"], trj["err"])
    assert _rel(x.numpy(), xj) <= X_TOL


@pytest.mark.parametrize("name", ["contact_uzawa_f64", "contact_uzawa_pcg_f64"])
def test_uzawa_solve_traced_is_the_jax_package_s(name):
    port, jx = _both(name)
    x0, target = _landed()
    hits, jhits = _fixed_hits(port, jx, target)
    b = (tpcg.PCGData.apply(port._solve_data, target)
         if isinstance(port._solve_data, tpcg.PCGData) else _A(port, target))
    y0 = torch.zeros(2 * hits.capacity, dtype=F64)
    xs = _x_star(x0)
    x, y, tr = tuzawa.solve_traced(port._uzawa_Ainv, hits, port._contact.ck, b, x0, y0, 8,
                                   x_star=xs)
    japply = jsolver_mod._make_apply_Ainv(jx.system, jx._solve_data, jx._params(),
                                          jx._refine_eff)
    xj, yj, trj = juzawa.solve_traced(japply, jhits, jnp.asarray(jx._ck), _j(b), _j(x0),
                                      _j(y0), 8, x_star=_j(xs))
    # around the PCG inner (to uzawa_inner_tol) the tail of the trace carries
    # the inner solves' rounding: measured 1.2e-8 of the row's largest value
    tol = 1e-7 if isinstance(port._solve_data, tpcg.PCGData) else TRACE_TOL
    _traces_close(tr["res"], trj["res"], tol)
    _traces_close(tr["err"], trj["err"], tol)
    # y, likewise (measured 3.7e-9)
    assert _rel(x.numpy(), xj) <= X_TOL and _rel(y.numpy(), yj) <= max(tol, X_TOL) * 10
    assert float(tr["res"][-1]) < float(tr["res"][0])


@pytest.mark.parametrize("name", ["contact_alpcg_f64", "contact_alpcg_twogrid_f64"])
def test_alcg_solve_traced_is_the_jax_package_s(name):
    port, jx = _both(name)
    x0, target = _landed()
    hits, jhits = _fixed_hits(port, jx, target)
    data = port._solve_data
    b = data.apply(target)
    y0 = torch.as_tensor(np.random.default_rng(2).standard_normal(2 * hits.capacity))
    xs = _x_star(x0)
    x, y, tr = talcg.solve_traced(data, hits, port._contact.ck, b, x0, y0, 25, x_star=xs)
    xj, yj, trj = jalcg.solve_traced(jx._solve_data, jhits, jnp.asarray(jx._ck), _j(b),
                                     _j(x0), _j(y0), 25, x_star=_j(xs))
    _traces_close(tr["res"], trj["res"])
    _traces_close(tr["err"], trj["err"])
    assert _rel(x.numpy(), xj) <= X_TOL
    ck = float(port._contact.ck)
    assert np.abs(y.numpy() - np.asarray(yj)).max() <= X_TOL * ck * np.abs(np.asarray(xj)).max()


# --- step_logged against the JAX Solver ------------------------------------------------

def _small(linsolver):
    """tests/test_parallel.py's _small_solver (the 2x1x1 linear beam, pin 0,
    5 ADMM iterations), float64, in both packages."""
    def one(cls, pkg_binding, make, lame, settings, **kw):
        mesh = make(2, 1, 1)
        mesh.flags = pkg_binding.NOSELFCOLLISION | pkg_binding.LINEAR
        s = cls(**kw)
        pkg_binding.add_tetmesh(s, mesh, lame.from_youngs_poisson(1e6, 0.3), verbose=False)
        s.set_pins([0])
        assert s.initialize(settings(verbose=0, admm_iters=5, linsolver=linsolver,
                                     dtype=np.float64))
        return s

    return (one(Solver, binding, make_tet_blocks, Lame, Settings, device="cpu"),
            one(JSolver, jbinding, j_make_tet_blocks, JLame, JSettings))


def _drop_box(linsolver):
    """tests/test_contact.py's drop_box_solver (the unit cube of 5 tets on a
    Floor at -0.75), float64, in both packages."""
    def one(cls, make, lumped, lame, floor, settings, **kw):
        mesh = make(1, 1, 1)
        s = cls(**kw)
        s.add_nodes(mesh.vertices, lumped(mesh.vertices, mesh.tets, 1522.0))
        s.add_tet_energies(mesh.vertices, mesh.tets, lame.from_youngs_poisson(10000000, 0.399))
        s.add_obstacle(floor)
        assert s.initialize(settings(verbose=0, admm_iters=10, linsolver=linsolver,
                                     dtype=np.float64))
        return s

    return (one(Solver, make_tet_blocks, lumped_masses_tet, Lame, Floor(y=-0.75), Settings,
                device="cpu"),
            one(JSolver, j_make_tet_blocks, j_lumped, JLame, JFloor(y=jnp.asarray(-0.75)),
                JSettings))


LOGGED = {  # linsolver, scene, n_inner, steps before the logged one
    "direct": (0, _small, 4, 0),
    "pcg": (3, _small, 30, 0),
    "gs": (1, _drop_box, 20, 12),
    "uzawa": (2, _drop_box, 12, 12),
    "alpcg": (4, _drop_box, 25, 12),
}


def _check_solverlog(case, r):
    """tests/test_solverlog.py's assertions on one step's residual traces."""
    assert np.isfinite(r).all()
    if case == "pcg":
        assert np.all(r[:, -1] <= 1e-6 * r[:, 0] + 1e-12)
    elif case == "gs":
        assert r[0, -1] < 0.1 * r[0, 0] and np.all(r[:, -1] <= 1.1 * r[:, 0] + 1e-9)
    elif case == "uzawa":
        assert np.all(np.diff(r, axis=1) <= 1e-12 + 0.5 * r[:, :-1])
        assert np.all(r[:, -1] <= r[:, 0] + 1e-15) and r.max() > 0
    elif case == "alpcg":
        nz = r[:, 0] > 1e-12
        assert np.all(r[nz, -1] <= 1e-4 * r[nz, 0] + 1e-10)


@pytest.mark.parametrize("case", sorted(LOGGED))
def test_step_logged_is_the_jax_solver_s(case):
    """From the same state: the traces of every solve, the x_star errors,
    final_r and x. Uzawa's first solve alone: its Schur CG puts the contact
    vertices on the floor within rounding, and whether the next detection
    finds them below it (dx < 0) is then a coin flip of the last bit (here
    the JAX package's second solve has active rows and the port's none), after
    which the two iterations part."""
    linsolver, scene, n_inner, before = LOGGED[case]
    port, jx = scene(linsolver)
    for _ in range(before):
        jx.step()
    # both from the JAX package's state: contact steps part by rounding (on the
    # dropped box Uzawa's Schur trips, 31 against 29 at step 10)
    port.state = SimState(**{f: torch.as_tensor(np.array(getattr(jx.state, f)))
                             for f in ("x", "v", "y", "prev_active")})
    # a known solution: the state after the plain step from here
    ref = port.state.clone()
    port.step()
    x_star = port.x
    port.state = ref
    for s in (port, jx):
        s.m_settings.log_inner = True
        s.m_settings.log_inner_iters = n_inner
        s.solver_log.x_star = x_star
    log = port.step()
    jlog = jx.step()
    assert log is port.solver_log and isinstance(log, tlog.InnerLog)
    assert log.residuals.shape == (port.m_settings.admm_iters, n_inner)
    if case == "direct":
        # ||b - A x|| after an exact solve is rounding noise in both
        assert np.abs(log.residuals).max() < 1e-9 and np.abs(jlog.residuals).max() < 1e-9
        assert np.all(log.residuals == log.residuals[:, :1])  # one value a row
    rows = 1 if case == "uzawa" else log.residuals.shape[0]
    if case != "direct":
        _traces_close(log.residuals[:rows], jlog.residuals[:rows])
    # the errors are normalised (1 before the step): held at that scale at least
    _traces_close(log.errors[:rows], jlog.errors[:rows], floor=1e-4)
    assert log.final_r == float(log.residuals[-1, -1])
    if case != "uzawa":
        assert abs(log.final_r - jlog.final_r) <= TRACE_TOL * max(np.abs(jlog.residuals).max(),
                                                                  1e-4)
        assert _rel(port.x, np.asarray(jx.x)) <= X_TOL
    _check_solverlog(case, log.residuals)
    if before:  # contact: the GS scene rests on the floor
        assert port.x[:, 1].min() > -0.75 - 2e-2


def test_step_logged_without_x_star_and_the_routing():
    port, _ = _small(3)
    port.m_settings.log_inner = True
    port.m_settings.log_inner_iters = 10
    assert port.step() is port.solver_log  # routed
    assert port.solver_log.residuals.shape == (5, 10) and port.solver_log.errors is None
    port.m_settings.log_inner_iters = 0  # the solver's own max iterations
    assert port.step_logged().residuals.shape == (5, port.m_settings.pcg_max_iters)
    x = port.x
    port.run(1)  # run(n) reads neither log_inner nor verbose
    assert not np.array_equal(port.x, x) and port.solver_log.residuals.shape[1] == 200


def test_step_profiled_is_step():
    for linsolver, scene in ((0, _small), (3, _small), (1, _drop_box), (2, _drop_box),
                             (4, _drop_box)):
        port, _ = scene(linsolver)
        for _ in range(12 if scene is _drop_box else 1):
            port.step()
        state0 = port.state.clone()
        port.step()
        x_step, inner = port.state.x.clone(), port.runtime_data().inner_iters
        port.state = state0
        port.m_settings.verbose = 2
        rt = port.step()
        port.m_settings.verbose = 0
        assert torch.equal(port.state.x, x_step), linsolver
        assert rt is port.runtime_data() and rt.inner_iters == inner
        phases = (rt.local_ms, rt.collision_ms, rt.global_ms)
        assert min(phases) > 0 and sum(phases) <= rt.step_ms


def test_diagnostic_steps_refuse_anderson():
    port, _ = _small(0)
    port.m_settings.aa_window = 4
    for fn in (port.step_logged, port.step_profiled):
        with pytest.raises(ValueError, match="Anderson"):
            fn()


def test_admm_error_trace_is_the_jax_package_s():
    """utils/logging.admm_error_trace on the one-tet scene of
    tests/test_utils.py, both packages, float64: the same curve within 1e-9,
    falling, and the solver left one full step past the start."""
    def one(cls, lame, settings, **kw):
        verts = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
        s = cls(**kw)
        s.add_nodes(verts, np.ones(4))
        s.add_tet_energies(verts, np.array([[0, 1, 2, 3]]), lame.from_youngs_poisson(5e5, 0.25))
        s.set_pins([0])
        assert s.initialize(settings(verbose=0, admm_iters=200, dtype=np.float64))
        x = s.x
        x[3] = [5.0, 0.0, 0.0]
        s.x = x
        return s

    port = one(Solver, Lame, Settings, device="cpu")
    jx = one(JSolver, JLame, JSettings)
    state0 = port.state
    port.step()
    x_star = port.x
    port.state = state0
    port.m_settings.admm_iters = 15
    jx.m_settings.admm_iters = 15
    errors = tlog.admm_error_trace(port, x_star)
    jerrors = j_error_trace(jx, x_star)
    assert len(errors) == 15 and errors[-1] < errors[0] and errors[-1] < 0.2
    assert np.abs(errors - jerrors).max() <= X_TOL
    assert _rel(port.x, np.asarray(jx.x)) <= X_TOL


def test_solverlog_collector():
    log = tlog.SolverLog(x_star=np.ones((4, 3)))
    log.add(np.zeros((4, 3)), 1.0)
    log.add(0.5 * np.ones((4, 3)), 2.0)
    assert log.errors == [1.0, 0.5] and log.runtimes == [1.0, 2.0]
    log.finalize(lambda x: 2.0 * x, np.ones((4, 3)), np.ones((4, 3)))
    assert log.final_r == pytest.approx(np.sqrt(12.0))
    log.add(np.zeros((2, 3)))  # another shape: not recorded
    assert len(log.errors) == 2
    log.reset()
    assert log.errors == [] and log.runtimes == []
