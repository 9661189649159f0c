"""The port's cloth path, end to end, against the JAX Solver on the CPU.

Scenes, all linsolver=0 "inv", 10 ADMM iterations, dt 1/24:
- a 6x6 make_plane sheet pinned at its -x edge, the soft material of
  apps/trianglestrain.py with strain limits (0.95, 1.05), gravity -9.8
  (benchmarks/crossval.py "cloth" with limits);
- the same sheet in soft rubber without limits under a colored and a batched
  wind force, gravity 0 ("cloth_wind");
- the layout of apps/trianglestrain.py at 4x4: two sheets in one system, the
  second at a vertex offset and strain-limited, top corners pinned.

Bounds, relative to max |x|: float32 1e-4 after one step and 2e-3 after eight
(benchmarks/crossval.py:299-302); float64 1e-9, both packages running the
same operations in the same order.
"""

import numpy as np
import pytest
import torch

from test_torch_solver import _assert_close, _rel, _settings, _traj

from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu import forces as jforces
from admm_elastic_tpu.geometry import factory as jfactory
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding, convert, forces
from admm_elastic_tpu_torch.geometry import factory
from admm_elastic_tpu_torch.ops import cuda_tri_local_step

torch.set_num_threads(1)

WIND_A, WIND_B = (0.05, 0.1, 0.02), (0.02, 0.05, 0.01)


class _Jax:
    Lame, Settings, Solver, binding, factory = JLame, JSettings, JSolver, jbind, jfactory

    @staticmethod
    def solver():
        return JSolver()

    @staticmethod
    def wind(tris, direction, colored):
        return jforces.make_wind_force(tris, direction=direction, colored=colored)


class _Port:
    Lame, Settings, Solver, binding, factory = Lame, Settings, Solver, binding, factory

    @staticmethod
    def solver():
        return Solver(device="cpu")

    @staticmethod
    def wind(tris, direction, colored):
        return forces.make_wind_force(tris, direction=direction, colored=colored,
                                      device="cpu", dtype=torch.float64)


def _sheet(pkg, dtype, wind):
    mesh = pkg.factory.make_plane(6, 6, size=2.0)
    if wind:
        lame = pkg.Lame.soft_rubber()
    else:  # soft enough to reach the limits within eight steps
        lame = pkg.Lame.from_youngs_poisson(100, 0.1)
        lame.limit_min, lame.limit_max = 0.95, 1.05
    s = pkg.solver()
    pkg.binding.add_trimesh(s, mesh, lame, verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < -2.0 + 1e-9)[0]])
    if wind:
        s.add_explicit_force(pkg.wind(mesh.faces, WIND_A, True))
        s.add_explicit_force(pkg.wind(mesh.faces, WIND_B, False))
    assert s.initialize(_settings(pkg.Settings, dtype, gravity=0.0 if wind else -9.8))
    return s


def _two_sheets(pkg, dtype):
    """apps/trianglestrain.py at 4x4 cells a sheet."""
    meshes = [pkg.factory.make_plane(4, 4), pkg.factory.make_plane(4, 4)]
    meshes[0].apply_xform(pkg.factory.make_xform(trans=(-2, 0, 0)))
    meshes[1].apply_xform(pkg.factory.make_xform(trans=(2, 0, 0)))
    s = pkg.solver()
    off1 = pkg.binding.add_trimesh(s, meshes[1], pkg.Lame.from_youngs_poisson(100, 0.1),
                                   verbose=False)
    limited = pkg.Lame.from_youngs_poisson(100, 0.1)
    limited.limit_min, limited.limit_max = 0.95, 1.05
    off0 = pkg.binding.add_trimesh(s, meshes[0], limited, verbose=False)
    pins = []
    for m, off in ((meshes[1], off1), (meshes[0], off0)):
        v = m.vertices
        top = np.where(v[:, 1] > v[:, 1].max() - 1e-6)[0]
        pins.append(int(top[np.argmin(v[top, 0])]) + off)
        pins.append(int(top[np.argmax(v[top, 0])]) + off)
    s.set_pins(pins)
    assert s.initialize(_settings(pkg.Settings, dtype))
    return s, pins


@pytest.mark.parametrize("wind", [False, True], ids=["limits", "wind"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sheet_matches_jax(dtype, wind):
    want = _traj(_sheet(_Jax, dtype, wind))
    p = _sheet(_Port, dtype, wind)
    x0 = p.x
    got = _traj(p)
    _assert_close(got, want, dtype)
    assert _rel(got[8], x0) > 1e-3  # the sheet moved


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_two_sheets_match_jax(dtype):
    j, _ = _two_sheets(_Jax, dtype)
    p, pins = _two_sheets(_Port, dtype)
    assert len(p.system.tris) == 2 and p.system.tris[1].stencil[0] == 25
    x0 = p.x
    got = _traj(p)
    _assert_close(got, _traj(j), dtype)
    assert np.abs(got[8][pins] - x0[pins]).max() < 1e-3  # corners held


def _jax_arrays(s):
    """A JAX cloth solver's system, direct data and state as numpy dicts."""
    sysj, d = s.system, s._solve_data
    tris = [dict({f: np.asarray(getattr(b, f)) for f in (
        "inds", "Dlocal", "area", "weight", "mu", "lam", "limit_min", "limit_max", "st_dl",
        "st_dead")}, stencil=b.stencil, n_live=b.n_live) for b in sysj.tris]
    pins = {f: np.asarray(getattr(sysj.pins, f)) for f in ("idx", "target", "active", "weight")}
    system = dict(masses=np.asarray(sysj.masses), dt=sysj.dt, tets=[], tris=tris, pins=pins)
    direct = {f: np.asarray(getattr(d, f)) for f in (
        "mat", "scale", "pin_idx", "pin_cols", "pin_vals", "pin_diag")}
    winds = [{f: (None if getattr(w, f) is None else np.asarray(getattr(w, f)))
              for f in ("tris", "direction", "color_tris", "color_mask")}
             for w in s.ext_forces]
    return system, direct, winds, np.asarray(s.state.x), np.asarray(s.state.v)


def test_convert_round_trip_steps_like_both():
    """Both packages step from the same arrays (tri batch, colored and batched
    wind force) to the same x."""
    dtype = np.float64
    j = _sheet(_Jax, dtype, wind=True)
    system, direct, winds, x, v = _jax_arrays(j)
    kw = dict(device="cpu", dtype=torch.float64)
    conv = Solver(Settings(verbose=0, dtype=dtype, gravity=0.0), device="cpu")
    conv.load_arrays(convert.system_from_numpy(system, **kw),
                     convert.direct_from_numpy(direct, **kw),
                     convert.state_from_numpy(x, v, **kw))
    for w in winds:
        conv.add_explicit_force(convert.wind_force_from_numpy(w, **kw))
    own = _sheet(_Port, dtype, wind=True)
    for f in ("st_dl", "st_dead", "weight", "limit_min", "limit_max", "inds"):
        assert torch.equal(getattr(conv.system.tris[0], f), getattr(own.system.tris[0], f))
    assert conv.system.tris[0].stencil == own.system.tris[0].stencil
    assert torch.equal(conv._solve_data.mat, own._solve_data.mat)
    for s in (j, conv, own):
        for _ in range(2):
            s.step()
    np.testing.assert_array_equal(conv.x, own.x)
    assert _rel(conv.x, np.asarray(j.x)) < 1e-9


def test_forces_project_before_the_gravity_kick():
    """v <- forces(x, v) reads the state's velocity, then gravity kicks
    (admm_elastic_tpu/solver.py:208-213): one step from a moving state."""
    j, p = _sheet(_Jax, np.float64, wind=True), _sheet(_Port, np.float64, wind=True)
    v0 = 0.3 * np.random.default_rng(1).standard_normal(p.x.shape)
    for s in (j, p):
        s.m_settings.gravity = -9.8
        s.v = v0
        s.step()
    assert _rel(p.x, np.asarray(j.x)) < 1e-9


def test_cpu_solver_launches_no_kernel():
    before = cuda_tri_local_step.local_step_tri.launches
    _sheet(_Port, np.float32, wind=False).run(2)
    assert cuda_tri_local_step.local_step_tri.launches == before


def _unsupported_sheet(**kw):
    mesh = factory.make_plane(4, 4)
    s = Solver(device="cpu")
    binding.add_trimesh(s, mesh, verbose=False)
    s.initialize(_settings(Settings, np.float64, **kw))


def _unsupported_non_grid():
    mesh = factory.make_plane(4, 4)
    mesh.faces = mesh.faces[:-1]
    s = Solver(device="cpu")
    s.add_nodes(mesh.vertices, np.ones(len(mesh.vertices)))
    s.add_tri_energies(mesh.vertices, mesh.faces, Lame.soft_rubber())
    s.initialize(_settings(Settings, np.float64))


UNSUPPORTED = {
    "cloth_above_direct_max_verts": lambda: _unsupported_sheet(direct_max_verts=10),
    "cloth_pcg": lambda: _unsupported_sheet(linsolver=3),
    "non_grid_trimesh": _unsupported_non_grid,
    "wind_sequential": lambda: forces.make_wind_force(
        factory.make_plane(2, 2).faces, sequential=True, device="cpu", dtype=torch.float64),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_cloth_raises_with_roadmap_item(case):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        UNSUPPORTED[case]()
