"""Contact through the port's Solver on the CPU against the JAX package:

- crossval's small contact scenes in float32 (chip_smoke.CONTACT_SCENES: the
  6x3x3 linear beam dropped on a Floor with Gauss-Seidel, Uzawa's direct
  inner, AL-PCG in its Jacobi and two-grid forms; benchmarks/crossval.py:
  39-41,102-111), 14 steps (the floor is reached at step 11), against the JAX
  package's goldens (tests/make_torch_golden.py): crossval's 1e-4 after one
  step and a measured contact bound after landing, the vertices in contact,
  the inner iterations of every step;
- linsolver=0 with an obstacle raises RuntimeError at every size, before the
  switch to PCG; a collider and self-collision raise, naming their ROADMAP
  item, and a JAX package obstacle raises, naming convert.obstacle_from_numpy;
- runtime_data().inner_iters after step() (the GS sweeps, the Schur trips,
  the CG trips of the step) and after run(n) (0); set_pins after initialize
  rewrites Gauss-Seidel's dense pin arrays in place; the graph key names
  the contact settings;
- convert.gs_from_numpy, obstacle_from_numpy and state_from_numpy (y,
  prev_active): both packages step from the JAX package's arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu import Floor as JFloor
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbinding
from admm_elastic_tpu.collision.passive import PassiveMeshSDF
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, Sphere, binding, convert
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """Two tests set the JAX package's Jacobi SVD (set_svd_impl, module state);
    the default goes back after the module, so that a later file in the same
    worker (tests/test_lineartet.py, which holds the default SVD's volume
    error) does not run on the Jacobi one."""
    yield
    jprox.set_svd_impl("auto")

# float32 bounds on x relative to max |x|: (after the first step, after
# landing: the other compared steps). The port on the CPU against the
# goldens: contact_gs 1.2e-6 / 1.9e-5, contact_uzawa 1.2e-7 / 2.0e-3,
# contact_alpcg 0 / 1.1e-6, contact_alpcg_twogrid 0 / 4.2e-6. Uzawa's Schur CG
# meets its max_iters on the landed beam, so its iterate carries each
# package's rounding (a float32 GEMM in another sum order) into the contact
# forces: held at three to five times its gap, as crossval's 2e-3 would be.
F32_BOUNDS = {"contact_gs": (1e-4, 1e-4), "contact_uzawa": (1e-4, 1e-2),
              "contact_alpcg": (1e-4, 1e-5), "contact_alpcg_twogrid": (1e-4, 4e-5)}
# the inner iterations of a step against the golden's: equal, or within this
# share (Uzawa's Schur trips follow its rounding; the two-grid CG trips its
# coarse matmul's, 61 against 62)
F32_INNER = {"contact_gs": 0.0, "contact_uzawa": 0.1, "contact_alpcg": 0.0,
             "contact_alpcg_twogrid": 0.05}


def _port(name):
    chip_smoke.DEVICE = "cpu"
    return chip_smoke.contact_scene(name, chip_smoke.torch_api("cpu"))


def rollout(name, stop=None):
    """The port's rollout of a contact scene against its golden: x at the
    compared steps, the inner iterations, the vertices in contact."""
    solver = _port(name)
    g = chip_smoke.golden(name)
    steps, compare = chip_smoke.contact_steps(name)
    assert g["n_steps"] == steps and g["steps"].tolist() == list(compare)
    xs, inner = {}, []
    for step in range(1, (stop or steps) + 1):
        solver.step()
        inner.append(solver.runtime_data().inner_iters)
        if step in compare:
            xs[step] = solver.x
    return solver, g, xs, inner


def check(name, xs, inner, g, bounds, inner_share, exact_contacts=True):
    compare = [s for s in g["steps"].tolist() if s in xs]
    for k, step in enumerate(compare):
        x = xs[step]
        assert np.isfinite(x).all()
        bound = bounds[0] if step == compare[0] else bounds[1]
        assert chip_smoke.rel_err(x, g[f"x{step}"]) < bound, (name, step)
        touching = chip_smoke.contacts(name, x)
        want = int(g["contacts"][k])
        assert touching == want if exact_contacts else (touching > 0) == (want > 0)
        assert x[:, 1].min() > -1.1  # bench.py:67: no tunnelling
    gold = g["inner"][:len(inner)].tolist()
    for a, b in zip(inner, gold):
        assert abs(a - b) <= inner_share * b, (inner, gold)
    assert int(g["contacts"][1]) > 0  # the golden lands


@pytest.mark.parametrize("name", sorted(F32_BOUNDS))
def test_float32_contact_scene_holds_its_bounds_against_the_golden(name):
    solver, g, xs, inner = rollout(name)
    check(name, xs, inner, g, F32_BOUNDS[name], F32_INNER[name],
          exact_contacts=name != "contact_uzawa")
    assert solver.m_settings.linsolver == int(g["linsolver"])
    assert type(solver._solve_data).__name__ == str(g["uzawa_inner"])


# --- refusals ----------------------------------------------------------------

def _beam_with(obstacle=None, dims=(4, 2, 2), **settings):
    s = Solver(device="cpu")
    mesh = make_tet_blocks(*dims)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    binding.add_tetmesh(s, mesh, verbose=False)
    if obstacle is not None:
        s.add_obstacle(obstacle)
    kw = dict(verbose=0, dtype=np.float64)
    kw.update(settings)
    s.initialize(Settings(**kw))
    return s


@pytest.mark.parametrize("direct_max_verts", [12000, 10])
def test_linsolver_0_with_an_obstacle_raises_at_every_size(direct_max_verts):
    """Checked before the switch to PCG above direct_max_verts, as the JAX
    package checks it (admm_elastic_tpu/solver.py:697-703)."""
    with pytest.raises(RuntimeError, match="No collisions with LDLT solver"):
        _beam_with(Floor(y=-1.0), linsolver=0, direct_max_verts=direct_max_verts)
    j = JSolver()
    mesh = j_make_tet_blocks(4, 2, 2)
    mesh.flags = jbinding.NOSELFCOLLISION | jbinding.LINEAR
    jbinding.add_tetmesh(j, mesh, verbose=False)
    j.add_obstacle(JFloor(y=jnp.asarray(-1.0)))
    with pytest.raises(RuntimeError, match="No collisions with LDLT solver"):
        j.initialize(JSettings(verbose=0, linsolver=0, direct_max_verts=direct_max_verts))


def _sdf():
    obs = j_make_tet_blocks(2, 1, 2, cell=0.5)
    return PassiveMeshSDF.from_tet_mesh(obs.vertices, obs.tets, resolution=8)


# what each refuses: (call, exception, message). The mesh obstacles run since
# their slice (ROADMAP Queue 1 item 9); a JAX package obstacle handed to the
# port raises, naming the converter that carries its arrays over.
REFUSED = {
    "mesh_obstacle": (lambda: Solver(device="cpu").add_obstacle(_sdf()), TypeError,
                      r"convert\.obstacle_from_numpy"),
    "collider": (lambda: Solver(device="cpu").add_dynamic_collider(object()),
                 NotImplementedError, "ROADMAP Queue 1 item 10"),
    "self_collision": (lambda: binding.add_tetmesh(
        Solver(device="cpu"), make_tet_blocks(2, 2, 2), verbose=False), NotImplementedError,
        "ROADMAP Queue 1 item 10"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_is_not_ported_raises_naming_its_item(case):
    fn, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        fn()


# --- counters, pins, graph key ----------------------------------------------------

def test_inner_iters_are_the_steps_and_zero_after_run():
    """GS: the sweeps of a step's 10 solves (30 each in float64 at tol 1e-10,
    the contact_gs_f64 golden's); run(n) reports 0, as the JAX package."""
    s = _port("contact_gs_f64")
    g = chip_smoke.golden("contact_gs_f64")
    s.step()
    assert s.runtime_data().inner_iters == int(g["inner"][0]) == int(s._inner.item())
    s.run(1)
    assert s.runtime_data().inner_iters == 0
    s.step()
    assert s.runtime_data().inner_iters == int(g["inner"][2])
    assert not s.runtime_data().collision_overflow


def test_gs_set_pins_rewrites_the_dense_pin_arrays_in_place():
    s = _beam_with(Floor(y=-1.0), linsolver=1)
    mask, target = s._contact.pin_mask, s._contact.pin_target
    assert s.system.pins is None and not bool(mask.any())
    s.set_pins([0, 7], [[0.0, 0.5, 0.0], [1.0, 0.5, 0.0]])
    assert s._contact.pin_mask is mask and s._contact.pin_target is target
    assert mask.nonzero().flatten().tolist() == [0, 7]
    assert target[7].tolist() == [1.0, 0.5, 0.0]
    s.step()
    assert s.x[7].tolist() == [1.0, 0.5, 0.0]  # pins have the last word


def test_graph_key_names_the_contact_settings():
    s = _beam_with(Floor(y=-1.0), linsolver=2)
    key = s._graph_key()
    base = s.m_settings
    for change in (dict(gs_max_iters=3), dict(gs_tol=1e-6), dict(gs_omega=1.5),
                   dict(uzawa_max_iters=3), dict(uzawa_tol=1e-6), dict(uzawa_inner_tol=1e-3),
                   dict(uzawa_inner_iters=3), dict(constraint_w=5.0)):
        s.m_settings = dataclasses.replace(base, **change)
        assert s._graph_key() != key, change
    s.m_settings = base
    assert s._graph_key() == key
    s.add_obstacle(Sphere(center=[0.0, -20.0, 0.0], rad=10.0))
    assert s._graph_key() != key and len(s._contact.obstacles) == 2


def test_constraint_weight_and_query_set_follow_the_jax_package():
    """ck = 3 x the stiffest weight (GS, AL-PCG) or 1 (Uzawa), constraint_w
    over both, kept as sqrt; the query set every vertex (dense) or the
    explicit surface_inds; y and prev_active sized 2 H."""
    jprox.set_svd_impl("jacobi")
    for ls, cw in ((1, -1.0), (2, -1.0), (4, -1.0), (4, 9.0)):
        p = _beam_with(Floor(y=-1.0), linsolver=ls, constraint_w=cw)
        j = JSolver()
        mesh = j_make_tet_blocks(4, 2, 2)
        mesh.flags = jbinding.NOSELFCOLLISION | jbinding.LINEAR
        jbinding.add_tetmesh(j, mesh, verbose=False)
        j.add_obstacle(JFloor(y=jnp.asarray(-1.0)))
        j.initialize(JSettings(verbose=0, linsolver=ls, constraint_w=cw, dtype=np.float64))
        assert float(p._contact.ck) == float(j._ck)
        assert p._contact.dense and p.state.y.shape == (2 * p._n_verts,)
    s = Solver(device="cpu")
    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
    binding.add_tetmesh(s, mesh, verbose=False)
    s.add_obstacle(Floor(y=-1.0))
    s.surface_inds = [9, 3, 3, 0]
    s.initialize(Settings(verbose=0, linsolver=4))
    assert not s._contact.dense and s._contact.surf.tolist() == [0, 3, 9]
    assert s.state.y.shape == (6,) and s.state.prev_active.dtype == torch.bool
    s.step()
    assert np.isfinite(s.x).all()


# --- convert ---------------------------------------------------------------------

@pytest.mark.parametrize("ls", [1, 4])
def test_contact_arrays_from_numpy_step_like_both(ls):
    """The JAX package's GSData / PCGData, its Floor and a state with y and
    prev_active through convert into a port solver: its first step is the
    JAX package's."""
    jprox.set_svd_impl("jacobi")
    name = "contact_gs_f64" if ls == 1 else "contact_alpcg_f64"
    j = chip_smoke.contact_scene(name, _jax_api())
    own = _port(name)
    kw = dict(device="cpu", dtype=torch.float64)
    jd = j._solve_data
    fields = (("ell_cols", "ell_vals", "diag", "colors", "colors_mask") if ls == 1 else
              ("ell_cols", "ell_vals", "diag_mass", "diag_stiff", "diag_pin", "agg",
               "agg_gather", "coarse_inv", "bands", "perm", "iperm"))
    arrays = {f: (None if getattr(jd, f) is None else np.asarray(getattr(jd, f)))
              for f in fields}
    if ls == 1:
        data = convert.gs_from_numpy(arrays, **kw)
    else:
        arrays.update(band_offsets=jd.band_offsets, band_circular=jd.band_circular)
        data = convert.pcg_from_numpy(arrays, **kw)
    for f in fields:
        a = getattr(data, f)
        if a is not None:
            assert torch.equal(a, getattr(own._solve_data, f)), f
    conv = Solver(own.m_settings, device="cpu")
    conv.add_obstacle(convert.obstacle_from_numpy(dict(kind="Floor", y=np.asarray(-1.0))))
    st = j.state
    conv.load_arrays(own.system, data, convert.state_from_numpy(
        np.asarray(st.x), np.asarray(st.v), np.asarray(st.y), np.asarray(st.prev_active), **kw))
    for _ in range(12):
        j.step()
        conv.step()
    assert chip_smoke.rel_err(conv.x, np.asarray(j.x)) < 1e-9
    assert conv.runtime_data().inner_iters == j.runtime_data().inner_iters
    sph = convert.obstacle_from_numpy(dict(kind="Sphere", center=[0, 1, 2], rad=3.0))
    assert sph.center.tolist() == [0.0, 1.0, 2.0] and float(sph.rad) == 3.0
    with pytest.raises(ValueError, match="y / prev_active"):
        conv.load_arrays(own.system, data, convert.state_from_numpy(
            np.asarray(st.x), np.asarray(st.v), **kw))


def _jax_api():
    import types

    from admm_elastic_tpu import Sphere as JSphere
    from admm_elastic_tpu.geometry.factory import make_tet_torus, make_xform
    from admm_elastic_tpu.geometry.io import load_elenode

    return types.SimpleNamespace(
        Solver=JSolver, Settings=JSettings, Lame=JLame, binding=jbinding,
        make_tet_blocks=j_make_tet_blocks, make_tet_torus=make_tet_torus,
        load_elenode=load_elenode, Floor=JFloor, Sphere=JSphere, make_xform=make_xform,
        asarray=jnp.asarray)


def test_every_linsolver_runs_without_an_obstacle():
    """ls 1, 2 and 4 on a scene with no collision object: no query vertex, y
    and prev_active of size 0; Uzawa and AL-PCG give linsolver=0's x within
    their solves' tolerance (a pinned beam sagging; pins as energies), and
    Gauss-Seidel holds its pins exactly (its pins are hard)."""
    xs = {}
    for ls in (0, 1, 2, 4):
        s = Solver(device="cpu")
        mesh = make_tet_blocks(4, 2, 2)
        mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
        s.set_pins(pins)
        s.initialize(Settings(verbose=0, linsolver=ls, dtype=np.float64))
        assert s.state.y.shape == (0,) and s._contact.surf.shape == (0,)
        s.step()
        xs[ls] = s.x
        assert s.m_settings.linsolver == ls and np.isfinite(xs[ls]).all()
    for ls in (2, 4):
        assert chip_smoke.rel_err(xs[ls], xs[0]) < 1e-6, ls
    assert np.array_equal(xs[1][pins], mesh.vertices[pins])
    assert xs[1][:, 1].min() < -1e-3  # it sags
