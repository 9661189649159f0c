"""The gather D / D^T path and direct_mode="cho" of the port, against the JAX
package on the CPU, and the reference's ctest goldens on the port's CPU
solver.

- build_gather_table bit-equal to the JAX table on the bench beam, the
  reference's bunny and the renumbered 40x40 sheet;
- tet / tri D x and D^T (ops/reduction.py) against admm_elastic_tpu.ops.
  reduction on seeded inputs: float64 within 1e-12, float32 within 1e-6,
  relative to max |want|;
- the "cho" solve against the JAX one within 1e-10 (float64);
- a system mixing a lattice beam, a gather tet family and a gather sheet,
  8 steps against the JAX Solver in float64 (1e-9 relative), and the same
  system loaded from the JAX package's arrays (convert.py) bitwise equal to
  the port's own;
- the bench beam as a gather family, one step against the JAX Solver in
  float32 (1e-4), its gather table bit-equal;
- tests/test_lineartet.py's solver goldens (the pulled vertex converges
  monotonically to 52.2321 +- 1e-4; an inverted tet comes back, to the JAX
  package's Jacobi-path numbers, chip_smoke.JAX_JACOBI_VOL_ERR) and
  tests/test_inversion_recovery.py's point collapse in float64 and float32,
  all on the gather path;
- the renumbered sheet: both packages' verify_tri_grid reject it, and it
  steps as the grid sheet does under the permutation.

The JAX side takes the Jacobi SoA prox (set_svd_impl("jacobi")), the same
body as the port's kernels.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_solver import _rel

import jax.numpy as jnp
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_blocks
from admm_elastic_tpu.geometry.factory import make_tet_bunny_like, make_xform
from admm_elastic_tpu.geometry.io import load_elenode as j_load_elenode
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.ops import reduction as j_red
from admm_elastic_tpu.ops import stencil as j_st
from admm_elastic_tpu.solvers import direct as j_direct
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding, convert
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.geometry.io import load_elenode
from admm_elastic_tpu_torch.geometry.mesh import TetMesh, tet_volumes
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.ops import stencil as p_st
from admm_elastic_tpu_torch.solvers import direct
from admm_elastic_tpu_torch.system import assembly

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-6}
SHEET = chip_smoke.CLOTH_SCENES["cloth_limit40"]


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _element_lists():
    beam = make_tet_blocks(40, 5, 5)
    bunny = load_elenode(chip_smoke.BUNNY)
    verts, tris, _, _, _ = chip_smoke.renumbered_sheet(SHEET["nx"], SHEET["ny"])
    return {"beam": (beam.tets, len(beam.vertices)), "bunny": (bunny.tets, len(bunny.vertices)),
            "sheet": (tris, len(verts))}


@pytest.mark.parametrize("mesh", ["beam", "bunny", "sheet"])
def test_gather_table_bit_equal(mesh):
    inds, n = _element_lists()[mesh]
    got, want = red.build_gather_table(inds, n), j_red.build_gather_table(inds, n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_loaded_bunny_matches_jax_load():
    p, j = load_elenode(chip_smoke.BUNNY), j_load_elenode(chip_smoke.BUNNY)
    assert p.vertices.shape == (600, 3) and p.tets.shape == (3460, 4)
    np.testing.assert_array_equal(p.vertices, j.vertices)
    np.testing.assert_array_equal(p.tets, j.tets)
    assert p.lattice_dims is None


def _reduction_inputs(kind, dtype):
    """A gather family's inds, Dlocal and table with seeded x and G rows."""
    rng = np.random.default_rng(7)
    if kind == "tet":
        m = load_elenode(chip_smoke.BUNNY)
        verts, inds, cols, arity = m.vertices, m.tets, 3, 4
    else:
        verts, inds, _, _, _ = chip_smoke.renumbered_sheet(8, 6)
        cols, arity = 2, 3
    t, n = len(inds), len(verts)
    dl = rng.standard_normal((t, arity, cols))
    x = verts + 0.1 * rng.standard_normal(verts.shape)
    g = rng.standard_normal((3 * cols, t))
    table = red.build_gather_table(inds, n)
    arrs = [np.asarray(a, dtype) for a in (x, dl, g)]
    return inds.astype(np.int32), table, n, arrs


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["tet", "tri"])
def test_gather_D_and_Dt_match_jax(kind, dtype):
    inds, table, n, (x, dl, g) = _reduction_inputs(kind, dtype)
    p_dx, p_dt = ((red.tet_Dx_rows, red.tet_Dt_rows) if kind == "tet"
                  else (red.tri_Dx_rows, red.tri_Dt_rows))
    j_dx, j_dt = ((j_red.tet_Dx_rows, j_red.tet_Dt_rows) if kind == "tet"
                  else (j_red.tri_Dx_rows, j_red.tri_Dt_rows))
    t = torch.as_tensor
    got = p_dx(t(x), t(inds), t(dl)).numpy()
    want = np.asarray(j_dx(jnp.asarray(x), jnp.asarray(inds), jnp.asarray(dl)))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel(got, want) < TOL[dtype]
    got = p_dt(t(g), t(dl), t(table)).numpy()
    want = np.asarray(j_dt(jnp.asarray(g), jnp.asarray(inds), jnp.asarray(dl), n,
                           jnp.asarray(table)))
    assert got.shape == (n, 3) and _rel(got, want) < TOL[dtype]
    # D^T is the transpose of D: <D x, G> = <x, D^T G>
    lhs = float(np.sum(p_dx(t(x), t(inds), t(dl)).double().numpy() * g))
    rhs = float(np.sum(x.astype(np.float64) * got))
    assert abs(lhs - rhs) <= (1e-4 if dtype == np.float32 else 1e-10) * abs(lhs)


def _bunny_solver(dtype, direct_mode="inv", pinned=True, model="NEOHOOKEAN"):
    mesh = load_elenode(chip_smoke.BUNNY)
    mesh.flags = binding.NOSELFCOLLISION | getattr(binding, model)
    s = Solver(device="cpu")
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    if pinned:
        s.set_pins([int(i) for i in chip_smoke.bunny_pins(mesh.vertices)])
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, dtype=dtype,
                                 direct_mode=direct_mode))
    return s


def test_cho_solve_matches_jax():
    s = _bunny_solver(np.float64, direct_mode="cho")
    A = assembly.assemble_dense(s.system)
    b = np.random.default_rng(3).standard_normal((A.shape[0], 3))
    got = direct.solve(s._solve_data, torch.as_tensor(b)).numpy()
    jd = j_direct.prepare(A, np.float64, mode="cho")
    np.testing.assert_array_equal(s._solve_data.mat.numpy(), np.asarray(jd.mat))
    want = np.asarray(j_direct.solve(jd, jnp.asarray(b)))
    assert _rel(got, want) < 1e-10
    assert _rel(A @ got, b) < 1e-10
    assert s._refine_eff == 0  # the refinement pass is the float32 inverse's


def test_cho_and_inv_agree_on_the_bunny():
    """The two factorizations step the pinned bunny alike (float64)."""
    xs = []
    for mode in ("cho", "inv"):
        s = _bunny_solver(np.float64, direct_mode=mode)
        assert s._solve_data.mode == mode and s.system.tets[0].stencil is None
        s.run(3)
        xs.append(s.x)
    assert np.isfinite(xs[0]).all() and _rel(xs[0], xs[1]) < 1e-9


# --- a system that mixes a lattice and gather families ------------------------

MIXED_SHIFT = np.array([0.0, 0.0, 10.0])


def _mixed(jax):
    """Pinned 4x2x2 lattice beam (neo-Hookean), the same beam shifted as a
    gather family (StVK, no lattice_dims), and a renumbered 4x3 sheet, in
    the JAX package or the port (float64)."""
    pkg, blocks = (jbind, j_blocks) if jax else (binding, make_tet_blocks)
    s = JSolver() if jax else Solver(device="cpu")
    lat = blocks(4, 2, 2)
    lat.flags = pkg.NOSELFCOLLISION | pkg.NEOHOOKEAN
    lame = (JLame if jax else Lame).soft_rubber()
    off0 = pkg.add_tetmesh(s, lat, lame, verbose=False)
    gat = blocks(4, 2, 2)
    gat.vertices = gat.vertices + MIXED_SHIFT
    gat.lattice_dims = None
    gat.flags = pkg.NOSELFCOLLISION | pkg.STVK
    off1 = pkg.add_tetmesh(s, gat, lame, verbose=False)
    verts, tris, masses, spins, _ = chip_smoke.renumbered_sheet(4, 3)
    verts = verts + np.array([0.0, 3.0, 0.0])
    off2 = s.add_nodes(verts, masses) - len(verts)
    s.add_tri_energies(verts, tris, lame, vertex_offset=off2)
    pins = [off0 + int(i) for i in np.where(lat.vertices[:, 0] < 1e-9)[0]]
    pins += [off1 + int(i) for i in np.where(gat.vertices[:, 0] < 1e-9)[0]]
    pins += [off2 + int(i) for i in spins]
    s.set_pins(pins)
    kw = dict(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv", dtype=np.float64)
    assert s.initialize((JSettings if jax else Settings)(**kw))
    return s


@pytest.fixture(scope="module")
def mixed_jax():
    s = _mixed(jax=True)
    x0 = np.asarray(s.x)
    traj = {}
    for k in range(1, 9):
        s.step()
        traj[k] = np.asarray(s.x)
    return s, x0, traj


def test_mixed_families_match_jax(mixed_jax):
    j, _, want = mixed_jax
    p = _mixed(jax=False)
    assert [b.stencil is None for b in p.system.tets] == [False, True]
    assert [b.stencil is None for b in p.system.tris] == [True]
    for pb, jb in zip(p.system.tets[1:] + p.system.tris, j.system.tets[1:] + j.system.tris):
        np.testing.assert_array_equal(pb.gather_idx.numpy(), np.asarray(jb.gather_idx))
        np.testing.assert_array_equal(pb.inds.numpy(), np.asarray(jb.inds))
    p.step()
    assert _rel(p.x, want[1]) < 1e-9, _rel(p.x, want[1])
    p.run(7)
    assert _rel(p.x, want[8]) < 1e-9, _rel(p.x, want[8])


def _jax_arrays(s):
    """A JAX solver's system, direct data and state as numpy dicts (gather
    families with their tables and no stencil fields)."""
    sysj, d = s.system, s._solve_data

    def fam(b, fields):
        out = {f: np.asarray(getattr(b, f)) for f in fields}
        if b.stencil is None:
            out["gather_idx"] = np.asarray(b.gather_idx)
        return dict(out, stencil=b.stencil, n_live=b.n_live)

    tet_f = ("inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa")
    tri_f = ("inds", "Dlocal", "area", "weight", "mu", "lam", "limit_min", "limit_max")
    tets = [dict(fam(b, tet_f + (("st_dl", "st_par", "st_dead") if b.stencil else ())),
                 model=b.model) for b in sysj.tets]
    tris = [fam(b, tri_f + (("st_dl", "st_dead") if b.stencil else ())) for b in sysj.tris]
    pins = {f: np.asarray(getattr(sysj.pins, f)) for f in ("idx", "target", "active", "weight")}
    system = dict(masses=np.asarray(sysj.masses), dt=sysj.dt, tets=tets, tris=tris, pins=pins)
    direct_d = {f: np.asarray(getattr(d, f)) for f in (
        "mat", "scale", "pin_idx", "pin_cols", "pin_vals", "pin_diag")}
    return system, dict(direct_d, mode=d.mode), np.asarray(s.state.x), np.asarray(s.state.v)


def test_convert_loads_gather_families(mixed_jax):
    j, x0, want = mixed_jax
    system, direct_d, _, _ = _jax_arrays(j)
    kw = dict(device="cpu", dtype=torch.float64)
    conv = Solver(Settings(verbose=0, dtype=np.float64), device="cpu")
    conv.load_arrays(convert.system_from_numpy(system, **kw),
                     convert.direct_from_numpy(direct_d, **kw),
                     convert.state_from_numpy(x0, np.zeros_like(x0), **kw))
    own = _mixed(jax=False)
    assert conv.system.tets[1].stencil is None and conv.system.tris[0].stencil is None
    for f in ("inds", "Dlocal", "weight", "gather_idx"):
        assert torch.equal(getattr(conv.system.tets[1], f), getattr(own.system.tets[1], f))
        assert torch.equal(getattr(conv.system.tris[0], f), getattr(own.system.tris[0], f))
    for s in (conv, own):
        s.run(2)
    np.testing.assert_array_equal(conv.x, own.x)
    assert _rel(conv.x, want[2]) < 1e-9


# --- the bench beam as a gather family ----------------------------------------

def test_beam_gather_one_step_matches_jax():
    jm = j_blocks(40, 5, 5)
    jm.lattice_dims = None
    jm.flags = jbind.NOSELFCOLLISION | jbind.NEOHOOKEAN
    j = JSolver()
    jbind.add_tetmesh(j, jm, JLame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(jm.vertices[:, 0] < 1e-9)[0]]
    j.set_pins(pins)
    assert j.initialize(JSettings(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv",
                                  dtype=np.float32))
    p, _, _ = chip_smoke.make_gather_solver("beam_gather", device="cpu")
    pb, jb = p.system.tets[0], j.system.tets[0]
    assert pb.stencil is None and jb.stencil is None and pb.n == 5000
    np.testing.assert_array_equal(pb.gather_idx.numpy(), np.asarray(jb.gather_idx))
    np.testing.assert_array_equal(pb.Dlocal.numpy(), np.asarray(jb.Dlocal))
    j.step()
    p.step()
    assert _rel(p.x, np.asarray(j.x)) < 1e-4


# --- the reference's ctest goldens (tests/test_lineartet.py) ------------------

def test_one_tet_converges_to_golden():
    """test_lineartet.cpp:165-229: the pulled vertex converges monotonically
    to x = 52.2321 (+-1e-4 beyond 20 ADMM iterations); every 4th iteration
    count from 5, as tests/test_lineartet.py."""
    got = chip_smoke.one_tet_convergence(device="cpu")
    assert len(got) == 24 and abs(got[97] - chip_smoke.ONE_TET_PULLED_X) < 1e-4


def test_one_tet_inversion_recovers():
    """test_lineartet.cpp:236-323: an inverted tet comes back. The reference
    restores its rest volume to 1e-6 whatever the iteration count; the Jacobi
    SVD that both packages run on the card and the TPU misses that by
    1.2e-4-3.9e-4 (10 to 90 iterations) on this symmetric pose, and the port
    gives the JAX package's Jacobi numbers (chip_smoke.JAX_JACOBI_VOL_ERR, at
    10, 20, ..., 90 iterations, as tests/test_lineartet.py)."""
    got = chip_smoke.one_tet_inversion(device="cpu")
    assert all(0.0 < err < 5e-4 for err in got.values())


# --- tests/test_inversion_recovery.py's point collapse ------------------------

def _collapse_solver(dtype):
    jm = make_tet_bunny_like(250)
    jm.apply_xform(make_xform(rot_deg=20.0, rot_axis=(1, 0, 0)))
    mesh = TetMesh(vertices=jm.vertices, tets=jm.tets,
                   flags=binding.NOSELFCOLLISION | binding.NEOHOOKEAN)
    s = Solver(device="cpu")
    binding.add_tetmesh(s, mesh, verbose=False)
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, gravity=0.0,
                                 dtype=dtype))
    assert s.system.tets[0].stencil is None
    return s, mesh


def _bad_count(x, tets):
    vols = tet_volumes(x, tets)
    return int(((vols <= 0) | ~np.isfinite(vols)).sum())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_point_collapse_recovers(dtype):
    """Every vertex collapsed to one point: the neo-Hookean prox's collapse
    handling restores the whole mesh (float64); float32 takes one refinement
    pass (unpinned "inv") and must stay finite with at most 3 flickering
    slivers. 80 and 120 steps, as tests/test_inversion_recovery.py takes."""
    s, mesh = _collapse_solver(dtype)
    assert s._refine_eff == (1 if dtype == np.float32 else 0)
    s.x = np.zeros_like(s.x)
    s.run(80 if dtype == np.float64 else 120)
    x = s.x
    assert np.isfinite(x).all()
    assert _bad_count(x, mesh.tets) <= (0 if dtype == np.float64 else 3)


# --- the renumbered sheet -------------------------------------------------------

def test_renumbered_sheet_is_no_grid():
    verts, tris, _, _ = chip_smoke.cloth_sheet(SHEET["nx"], SHEET["ny"])
    v2, t2, _, _, perm = chip_smoke.renumbered_sheet(SHEET["nx"], SHEET["ny"])
    assert p_st.verify_tri_grid(tris, n_local_verts=len(verts)) is not None
    assert j_st.verify_tri_grid(tris, n_local_verts=len(verts)) is not None
    assert p_st.verify_tri_grid(t2, n_local_verts=len(v2)) is None
    assert j_st.verify_tri_grid(t2, n_local_verts=len(v2)) is None
    np.testing.assert_array_equal(v2[perm], verts)


def _sheet_solver(renumbered):
    nx, ny = 6, 4
    if renumbered:
        verts, tris, masses, pins, perm = chip_smoke.renumbered_sheet(nx, ny)
    else:
        (verts, tris, masses, pins), perm = chip_smoke.cloth_sheet(nx, ny), None
    s = Solver(device="cpu")
    s.add_nodes(verts, masses)
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    lame.limit_min, lame.limit_max = SHEET["limits"]
    s.add_tri_energies(verts, tris, lame)
    s.set_pins([int(i) for i in pins])
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, dtype=np.float64))
    assert (s.system.tris[0].stencil is None) == renumbered
    return s, perm


def test_renumbered_sheet_steps_as_the_grid():
    grid, _ = _sheet_solver(False)
    ren, perm = _sheet_solver(True)
    for s in (grid, ren):
        s.run(8)
    assert _rel(ren.x[perm], grid.x) < 1e-10
    assert _rel(grid.x, chip_smoke.cloth_sheet(6, 4)[0]) > 1e-3  # the sheet moved
