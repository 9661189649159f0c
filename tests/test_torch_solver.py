"""The port's slice, end to end, against the JAX Solver on the CPU.

Scene: the 4x2x2 neo-Hookean beam, -x face pinned, linsolver=0 "inv",
10 ADMM iterations, dt 1/24 (the bench scene is in
test_torch_bench_scene.py). The JAX side takes the Jacobi SoA prox
(set_svd_impl("jacobi")), the same body as the port's local-step kernel.

Bounds, relative to max |x|: float32 1e-4 after one step and 2e-3 after
eight (benchmarks/crossval.py:299-302). float64 1e-9: both packages run
the same operations in the same order; measured 6e-16 (4x2x2) and 2e-14
(bench scene, 8 steps), the gap being GEMM summation order.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.system import system as j_sys
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding, convert
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.system import system as p_sys

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS = {np.float32: (1e-4, 2e-3), np.float64: (1e-9, 1e-9)}


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _settings(cls, dtype, **kw):
    base = dict(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv", dtype=dtype)
    return cls(**{**base, **kw})


def _pins(mesh):
    return [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]


def _jax_solver(dims, dtype, pinned=True):
    mesh = j_make(*dims)
    mesh.flags = jbind.NOSELFCOLLISION | jbind.NEOHOOKEAN
    s = JSolver()
    jbind.add_tetmesh(s, mesh, JLame.soft_rubber(), verbose=False)
    if pinned:
        s.set_pins(_pins(mesh))
    assert s.initialize(_settings(JSettings, dtype))
    return s


def _port_solver(dims, dtype, pinned=True, **kw):
    mesh = make_tet_blocks(*dims)
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    s = Solver(device="cpu")
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    if pinned:
        s.set_pins(_pins(mesh))
    assert s.initialize(_settings(Settings, dtype, **kw))
    return s


def _traj(solver, steps=(1, 8)):
    out, done = {}, 0
    for k in steps:
        for _ in range(k - done):
            solver.step()
        done = k
        out[k] = np.asarray(solver.x, np.float64)
    return out


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def _assert_close(got, want, dtype):
    b1, b8 = BOUNDS[dtype]
    for k, bound in ((1, b1), (8, b8)):
        assert np.isfinite(got[k]).all()
        assert _rel(got[k], want[k]) < bound, (k, _rel(got[k], want[k]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_small_beam_matches_jax(dtype):
    want = _traj(_jax_solver((4, 2, 2), dtype))
    got = _traj(_port_solver((4, 2, 2), dtype))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_A_mv_matches_jax(dtype):
    """A x = M x + dt^2 D^T W^2 D x (kernels B and C with u = 0), which the
    refinement pass of an unpinned float32 system runs."""
    j = _jax_solver((4, 2, 2), dtype, pinned=False)
    p = _port_solver((4, 2, 2), dtype, pinned=False)
    assert p._refine_eff == (1 if dtype == np.float32 else 0)
    x = p.x + np.random.default_rng(2).standard_normal(p.x.shape) * 0.1
    want = np.asarray(j_sys.A_mv(j.system, np.asarray(x, dtype)))
    got = p_sys.A_mv(p.system, torch.as_tensor(np.asarray(x, dtype))).numpy()
    assert _rel(got, want) < (1e-12 if dtype == np.float64 else 1e-5)


def test_pins_follow_targets_moved_after_initialize():
    dims, dtype = (4, 2, 2), np.float64
    j, p = _jax_solver(dims, dtype), _port_solver(dims, dtype)
    pins = _pins(make_tet_blocks(*dims))
    targets = p.x[pins] + np.array([0.1, 0.05, 0.0])
    for s in (j, p):
        s.set_pins(pins, targets)
        for _ in range(3):
            s.step()
    assert _rel(p.x, np.asarray(j.x)) < 1e-9
    assert np.abs(p.x[pins] - targets).max() < 1e-3
    with pytest.raises(RuntimeError):
        p.set_pins([pins[0], len(p.x) - 1], targets[:2])  # not pinnable


def _jax_arrays(s):
    """The JAX solver's system, direct data and state as numpy dicts."""
    sysj, d = s.system, s._solve_data
    tets = [dict({f: np.asarray(getattr(b, f)) for f in (
        "inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa", "st_dl", "st_par",
        "st_dead")}, stencil=b.stencil, model=b.model, n_live=b.n_live) for b in sysj.tets]
    pins = {f: np.asarray(getattr(sysj.pins, f)) for f in ("idx", "target", "active", "weight")}
    system = dict(masses=np.asarray(sysj.masses), dt=sysj.dt, tets=tets, pins=pins)  # no "tris"
    direct = {f: np.asarray(getattr(d, f)) for f in (
        "mat", "scale", "pin_idx", "pin_cols", "pin_vals", "pin_diag")}
    return system, direct, np.asarray(s.state.x), np.asarray(s.state.v)


def test_convert_round_trip_steps_like_both():
    dims, dtype = (4, 2, 2), np.float64
    j = _jax_solver(dims, dtype)
    system, direct, x, v = _jax_arrays(j)
    conv = Solver(Settings(verbose=0, dtype=dtype), device="cpu")
    kw = dict(device="cpu", dtype=torch.float64)
    conv.load_arrays(convert.system_from_numpy(system, **kw),
                     convert.direct_from_numpy(direct, **kw),
                     convert.state_from_numpy(x, v, **kw))
    own = _port_solver(dims, dtype)
    for f in ("st_dl", "st_par", "st_dead", "weight", "bulk", "mu"):
        assert torch.equal(getattr(conv.system.tets[0], f), getattr(own.system.tets[0], f))
    assert torch.equal(conv._solve_data.mat, own._solve_data.mat)
    for s in (j, conv, own):
        for _ in range(2):
            s.step()
    np.testing.assert_array_equal(conv.x, own.x)
    assert _rel(conv.x, np.asarray(j.x)) < 1e-9


def _beam(flags=binding.NOSELFCOLLISION | binding.NEOHOOKEAN, dims=(4, 2, 2)):
    mesh = make_tet_blocks(*dims)
    mesh.flags = flags
    return mesh


def _init_with(settings_kw=None, mesh=None, before=None):
    s = Solver(device="cpu")
    binding.add_tetmesh(s, mesh if mesh is not None else _beam(), verbose=False)
    if before is not None:
        before(s)
    s.initialize(_settings(Settings, np.float64, **(settings_kw or {})))


# What raises: (call, exception, message). Every obstacle of the JAX package
# runs since the mesh obstacles' slice; an object that is no obstacle raises
# TypeError, naming the four. Self-collision runs since its slice (ROADMAP
# Queue 1 item 10): an object that is no collider raises TypeError, naming the
# converter of a JAX package collider, and a self-colliding mesh with
# linsolver=0 raises as an obstacle does (admm_elastic_tpu/solver.py:697-703).
def _self_colliding_ldlt():
    s = Solver(device="cpu")
    binding.add_tetmesh(s, _beam(binding.NEOHOOKEAN), verbose=False)
    s.initialize(_settings(Settings, np.float64))


UNSUPPORTED = {
    "unroll_admm": (lambda: _init_with(dict(unroll_admm=True)), NotImplementedError, "ROADMAP"),
    "obstacle": (lambda: Solver(device="cpu").add_obstacle(object()), TypeError,
                 "is not an obstacle: Floor, Sphere, PassiveMeshSDF or PassiveMeshExact"),
    "dynamic_collider": (lambda: Solver(device="cpu").add_dynamic_collider(object()),
                         TypeError, r"convert\.collider_from_numpy"),
    "self_collision": (_self_colliding_ldlt, RuntimeError, "No collisions with LDLT solver"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_raises_with_roadmap_item(case):
    fn, exc, match = UNSUPPORTED[case]
    with pytest.raises(exc, match=match):
        fn()


def test_import_loads_no_jax():
    code = ("import sys, admm_elastic_tpu_torch, admm_elastic_tpu_torch.convert, "
            "admm_elastic_tpu_torch.binding, admm_elastic_tpu_torch.ops.cuda_local_step, "
            "admm_elastic_tpu_torch.ops.cuda_stencil, admm_elastic_tpu_torch.ops.cuda_wind, "
            "admm_elastic_tpu_torch.solvers.anderson, admm_elastic_tpu_torch.utils.checkpoint, "
            "admm_elastic_tpu_torch.utils.logging, admm_elastic_tpu_torch.collision.passive, "
            "admm_elastic_tpu_torch.ops.cuda_obstacle; "
            "from admm_elastic_tpu_torch import PassiveMeshSDF, PassiveMeshExact; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'admm_elastic_tpu', 'triton')]; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_solver_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Solver(device="cuda")


def test_default_device_is_the_card_and_never_the_cpu():
    """Solver() asks for "cuda": without a CUDA device it raises and builds no
    CPU solver; the CPU is taken only when asked for."""
    import inspect

    assert inspect.signature(Solver.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Solver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Solver()
        with pytest.raises(RuntimeError, match="CUDA"):
            Solver(Settings(verbose=0))
    assert Solver(device="cpu").device.type == "cpu"
