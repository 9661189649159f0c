"""Self-collision's detection and dynamic rows on the CPU against the JAX
package (float64 unless named):

- detect_dynamic (kernel K's plain twin, collision/dynamic.py) against the
  JAX package's: the one-cube oracle of tests/test_contact.py:254-283; the
  folded 8x8x8 block of tests/test_broadphase.py, dense and with the hash-grid
  broad phase forced, each way against the JAX package's and the broad phase
  against the dense one (masks, faces and overflows exact, barycentrics,
  normals and dx within 1e-12); HIT_CAP = 1 (the hit overflow, one hit kept);
  the cell capacity of _rest_cell_cap exact and in its bounds;
- merge across two colliders, the first collider's hit per vertex, as the JAX
  package's _detect takes it;
- the dynamic rows' C^T, diag(C^T C), C^T C and C^T c (kernel L's ordered
  gather, constraints.with_table) on rows whose faces share vertices many
  times, against the JAX package's scatters within 1e-12, and the gather bit
  for bit index_add over the table's entries (the order .at[].add applies
  them);
- convert.collider_from_numpy: a JAX collider's arrays carried across equal
  the port's own collider.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu.collision.dynamic as jdyn
from admm_elastic_tpu.collision import constraints as jcon
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets as j_surface_faces
from admm_elastic_tpu.geometry.mesh import surface_vertex_indices as j_surface_verts
from admm_elastic_tpu_torch import convert
from admm_elastic_tpu_torch.collision import constraints as tcon
from admm_elastic_tpu_torch.collision import dynamic as tdyn
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.geometry.mesh import surface_faces_from_tets, surface_vertex_indices

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64
TOL = 1e-12  # barycentrics, normals and dx in float64: the same sums in the same order


def _both_detect(mesh_v, tets, faces, x, surf, offset=0):
    jc = jdyn.make_tet_mesh_collider(mesh_v, tets, faces, offset, dtype=np.float64)
    tc = tdyn.make_tet_mesh_collider(mesh_v, tets, faces, offset)
    rj = jax.jit(lambda: jdyn.detect_dynamic(jc, jnp.asarray(x), jnp.asarray(x[surf]),
                                             jnp.asarray(surf, jnp.int32)))()
    rt = tdyn.detect_dynamic(tc, torch.as_tensor(x), torch.as_tensor(x[surf]),
                             torch.as_tensor(surf))
    return {k: np.asarray(v) for k, v in rj.items()}, {k: v.numpy() for k, v in rt.items()}


def _held(rj, rt):
    """Masks, faces and overflows exact; the rest within TOL on the mask."""
    m = rj["mask"]
    assert np.array_equal(m, rt["mask"])
    assert np.array_equal(rj["face"][m], rt["face"][m])
    for k in ("barys", "normal", "dx"):
        assert np.abs(rj[k][m] - rt[k][m]).max(initial=0.0) <= TOL, k
    assert np.array_equal(rj["broad_overflow"], rt["broad_overflow"])
    assert bool(rj["hit_overflow"]) == bool(rt["hit_overflow"])


def _folded(n):
    """tests/test_broadphase.py's block folded onto itself in x."""
    mesh = make_tet_blocks(n, n, n)
    x = mesh.vertices.astype(np.float64).copy()
    x[:, 0] = np.abs(x[:, 0] - n / 2 - 0.2) * 0.9
    return mesh, surface_faces_from_tets(mesh.tets), x, surface_vertex_indices(mesh.tets)


@pytest.fixture
def limits(monkeypatch):
    """Set BROADPHASE_MIN_TETS and HIT_CAP in both packages for one test."""
    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setattr(jdyn, k, v)
            monkeypatch.setattr(tdyn, k, v)
    return set_


def test_one_cube_oracle():
    """A vertex pushed inside a unit cube is found, its nearest face the top
    (the normal +-z), dx < 0, barycentrics summing to 1; one outside and one
    of the cube itself are not (tests/test_contact.py:254-283)."""
    box = make_tet_blocks(1, 1, 1)
    x = np.concatenate([box.vertices, [[0.5, 0.5, 0.9]]], axis=0)
    n_box = len(box.vertices)
    rj, rt = _both_detect(box.vertices, box.tets, box.faces, x, np.asarray([n_box]))
    _held(rj, rt)
    assert rt["mask"][0] and abs(rt["normal"][0, 2]) > 0.9 and rt["dx"][0] < 0
    assert abs(rt["barys"][0].sum() - 1.0) < 1e-12 and (rt["barys"][0] > -1e-12).all()
    tc = tdyn.make_tet_mesh_collider(box.vertices, box.tets, box.faces, 0)
    out = x.copy()
    out[-1] = [0.5, 0.5, 1.5]
    q = torch.as_tensor([n_box])
    assert not bool(tdyn.detect_dynamic(tc, torch.as_tensor(out), torch.as_tensor(out[-1:]),
                                        q)["mask"][0])
    own = tdyn.detect_dynamic(tc, torch.as_tensor(x), torch.as_tensor(x[:1]), torch.as_tensor([0]))
    assert not bool(own["mask"][0])


@pytest.mark.parametrize("phase", ["dense", "broad"])
def test_folded_block_is_the_jax_package_s(phase, limits):
    """The folded 8x8x8 block (2,560 tets, many real penetrations), dense and
    with the broad phase forced (BROADPHASE_MIN_TETS = 1), in both packages."""
    limits(BROADPHASE_MIN_TETS=1 if phase == "broad" else 10 ** 9)
    mesh, faces, x, surf = _folded(8)
    rj, rt = _both_detect(mesh.vertices, mesh.tets, faces, x, surf)
    assert rj["mask"].sum() > 50
    _held(rj, rt)
    assert not rt["broad_overflow"].any()


def test_broad_phase_matches_dense(limits):
    """The port's broad phase finds the dense walk's hits, bit for bit."""
    mesh, faces, x, surf = _folded(8)
    tc = tdyn.make_tet_mesh_collider(mesh.vertices, mesh.tets, faces, 0)
    args = (tc, torch.as_tensor(x), torch.as_tensor(x[surf]), torch.as_tensor(surf))
    limits(BROADPHASE_MIN_TETS=1)
    rb = tdyn.detect_dynamic(*args)
    limits(BROADPHASE_MIN_TETS=10 ** 9)
    rd = tdyn.detect_dynamic(*args)
    for k in ("mask", "face", "barys", "normal", "dx"):
        assert torch.equal(rb[k], rd[k]), k


def test_hit_cap_one(limits):
    """HIT_CAP = 1: the first hit in query order is kept, the rest dropped,
    hit_overflow set, as in the JAX package."""
    limits(HIT_CAP=1)
    mesh, faces, x, surf = _folded(4)
    rj, rt = _both_detect(mesh.vertices, mesh.tets, faces, x, surf)
    assert rt["mask"].sum() == 1 and bool(rt["hit_overflow"])
    _held(rj, rt)


@pytest.mark.parametrize("dims", [(4, 4, 4), (2, 3, 5), (8, 8, 8)])
def test_rest_cell_cap(dims):
    """_rest_cell_cap equals the JAX package's and lies in [16, 64]."""
    mesh = make_tet_blocks(*dims)
    cap = tdyn._rest_cell_cap(mesh.vertices, mesh.tets)
    assert cap == jdyn._rest_cell_cap(mesh.vertices, mesh.tets)
    assert 16 <= cap <= 64


def test_merge_takes_the_first_collider_s_hit():
    """Two colliders (two folded blocks, the second shifted 0.3 in z, so that
    many query vertices lie in both): the merged rows are the first collider's where it hits,
    the second's elsewhere, as the JAX package's _detect merges them."""
    from admm_elastic_tpu.solver import _detect as j_detect

    mesh, faces, x, surf = _folded(4)
    nv = len(mesh.vertices)
    x2 = np.concatenate([x, x + [0.0, 0.0, 0.3]])
    surf2 = np.concatenate([surf, surf + nv])
    jcols = [jdyn.make_tet_mesh_collider(mesh.vertices, mesh.tets, faces, o, dtype=np.float64)
             for o in (0, nv)]
    tcols = [tdyn.make_tet_mesh_collider(mesh.vertices, mesh.tets, faces, o) for o in (0, nv)]
    hj = j_detect((), tuple(jcols), jnp.asarray(x2), jnp.asarray(surf2, jnp.int32), False,
                  jnp.float64)
    h = len(surf2)
    rows = (torch.zeros(h, dtype=torch.bool), torch.zeros((h, 3), dtype=torch.int64),
            torch.zeros((h, 3), dtype=F64), torch.zeros((h, 3), dtype=F64))
    xt, st = torch.as_tensor(x2), torch.as_tensor(surf2)
    ovf = torch.tensor(False)
    for c in tcols:
        rows, o = tdyn.merge(rows, tdyn.detect_dynamic(c, xt, xt[st], st))
        ovf = ovf | o
    m = np.asarray(hj.d_mask)
    assert m.sum() > 0 and np.array_equal(m, rows[0].numpy())
    assert np.array_equal(np.asarray(hj.d_face)[m], rows[1].numpy()[m])
    assert np.abs(np.asarray(hj.d_barys)[m] - rows[2].numpy()[m]).max() <= TOL
    assert np.abs(np.asarray(hj.d_normal)[m] - rows[3].numpy()[m]).max() <= TOL
    assert bool(hj.overflow) == bool(ovf)


def _shared_hits(rng, n, h, dense):
    """Random hits whose faces share a few vertices many times over."""
    surf = np.arange(n) if dense else np.sort(rng.choice(n, h, replace=False))
    h = len(surf)
    nrm = rng.standard_normal((h, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    fields = dict(p_mask=rng.random(h) < 0.3, p_vidx=surf, p_normal=nrm,
                  p_point=rng.standard_normal((h, 3)), d_mask=rng.random(h) < 0.6, d_vidx=surf,
                  d_face=rng.integers(0, 6, (h, 3)), d_barys=rng.dirichlet(np.ones(3), h),
                  d_normal=rng.standard_normal((h, 3)))
    jh = jcon.Hits(**{k: jnp.asarray(v) for k, v in fields.items()},
                   overflow=jnp.asarray(False), dense=dense, may_dyn=True)
    th = tcon.Hits(**{k: torch.as_tensor(v) for k, v in fields.items()},
                   overflow=torch.tensor(False), dense=dense, may_dyn=True)
    return th, jh


@pytest.mark.parametrize("dense", [True, False])
def test_rows_with_shared_corners_are_the_jax_package_s(dense):
    """C^T y, diag(C^T C), C^T C x and C^T c with every face among six
    vertices (each vertex in some 20 corners): the ordered gather against
    the JAX package's scatters with duplicates, within 1e-12."""
    rng = np.random.default_rng(11 + dense)
    n = 30
    th, jh = _shared_hits(rng, n, 20, dense)
    th = tcon.with_table(th.dedup(), n)
    jh = jh.dedup()
    ck = 3.5
    x = rng.standard_normal((n, 3))
    yp, yd = rng.standard_normal(th.capacity), rng.standard_normal(th.capacity)
    pairs = [(tcon.Ct_apply(th, ck, torch.as_tensor(yp), torch.as_tensor(yd), n),
              jcon.Ct_apply(jh, ck, jnp.asarray(yp), jnp.asarray(yd), n)),
             (tcon.CtC_diag(th, ck, n, F64), jcon.CtC_diag(jh, ck, n, jnp.float64)),
             (tcon.CtC_apply(th, ck, torch.as_tensor(x)), jcon.CtC_apply(jh, ck, jnp.asarray(x))),
             (tcon.Ct_c(th, ck, n), jcon.Ct_c(jh, ck, n))]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("mode", ["ct", "diag"])
def test_gather_is_index_add_in_table_order(mode):
    """The plain ordered gather equals, bit for bit, index_add of the same
    terms over the table's entries (sorted by vertex, a vertex's in (row,
    corner) order): the order in which the JAX package's .at[].add and
    index_add apply them. A vertex's count is the active corners on it."""
    rng = np.random.default_rng(17)
    n = 30
    th, _ = _shared_hits(rng, n, 24, False)
    th = tcon.with_table(th, n)
    ck = torch.tensor(2.25, dtype=F64)
    yd = torch.as_tensor(rng.standard_normal(th.capacity))
    m = tcon.CT if mode == "ct" else tcon.DIAG
    vals = tcon.corner_values(th, m, ck, yd).reshape(-1, 3)
    base = torch.as_tensor(rng.standard_normal((n, 3)))
    got = tcon.gather_plain(th.d_order, th.d_start, vals, base)
    k = int(th.d_start[-1])
    assert k == 3 * int(th.d_mask.sum())
    ent = th.d_order[:k]
    want = base.index_add(0, th.d_face.reshape(-1)[ent], vals[ent])
    assert torch.equal(got, want)
    counts = (th.d_start[1:] - th.d_start[:-1]).numpy()
    live = th.d_face[th.d_mask].reshape(-1).numpy()
    assert np.array_equal(counts, np.bincount(live, minlength=n))


def test_collider_from_numpy_round_trip():
    """A JAX collider's arrays (tets, rest_verts, faces, vert_offset,
    cell_cap) carried across equal the port's own collider of the mesh."""
    jm = j_make_tet_blocks(3, 2, 2)
    jc = jdyn.make_tet_mesh_collider(jm.vertices, jm.tets, j_surface_faces(jm.tets), 17)
    d = {k: np.asarray(getattr(jc, k)) for k in ("tets", "rest_verts", "faces")}
    d.update(vert_offset=jc.vert_offset, cell_cap=jc.cell_cap)
    got = convert.collider_from_numpy(d)
    tm = make_tet_blocks(3, 2, 2)
    want = tdyn.make_tet_mesh_collider(tm.vertices, tm.tets, tm.faces, 17)
    assert got.vert_offset == want.vert_offset == 17 and got.cell_cap == want.cell_cap
    for k in ("tets", "rest_verts", "faces"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert np.array_equal(surface_vertex_indices(tm.tets), j_surface_verts(jm.tets))
    g32 = got.to("cpu", torch.float32)
    assert g32.rest_verts.dtype == torch.float32 and g32.tets.dtype == torch.int32


def test_self_collision_modules_load_no_jax():
    """The port with self-collision (collision.dynamic, ops.cuda_dynamic, the
    binding) in a fresh interpreter: neither jax nor the JAX package loads."""
    code = ("import sys, admm_elastic_tpu_torch, admm_elastic_tpu_torch.binding, "
            "admm_elastic_tpu_torch.convert, admm_elastic_tpu_torch.collision.dynamic, "
            "admm_elastic_tpu_torch.ops.cuda_dynamic, admm_elastic_tpu_torch.ops.cuda_gs, "
            "admm_elastic_tpu_torch.ops.cuda_pcg; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'admm_elastic_tpu', 'triton')]; print(bad); assert not bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_crossval_boxes_reach_no_self_contact_in_eight_steps():
    """A reference quirk (ROADMAP Queue 3): crossval's selfcollision_gs scene
    (benchmarks/crossval.py:166-172, 188-190: two 4x4x4 boxes of cell 0.25,
    the second 1.1 up and 0.05 across, a Floor at -1, Gauss-Seidel) shows no
    dynamic row at the states of its 8 compared steps, in the JAX package's
    detection and in the port's; the first rows come at step 12, after the
    bottom box lands. A check that stops at step 8 runs no dynamic row."""
    import admm_elastic_tpu as J
    from admm_elastic_tpu import binding as jb
    from admm_elastic_tpu.geometry.factory import make_xform as j_xform
    from admm_elastic_tpu.solver import _detect as j_detect
    from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu_torch.geometry.factory import make_xform

    js, ts = J.Solver(), Solver(device="cpu")
    for i in range(2):
        jm, tm = j_make_tet_blocks(4, 4, 4, cell=0.25), make_tet_blocks(4, 4, 4, cell=0.25)
        jm.flags, tm.flags = jb.LINEAR, binding.LINEAR
        jm.apply_xform(j_xform(trans=(0.0, i * 1.1, 0.05 * i)))
        tm.apply_xform(make_xform(trans=(0.0, i * 1.1, 0.05 * i)))
        jb.add_tetmesh(js, jm, J.Lame.rubber(), verbose=False)
        binding.add_tetmesh(ts, tm, Lame.rubber(), verbose=False)
    js.add_obstacle(J.Floor(y=jnp.asarray(-1.0)))
    ts.add_obstacle(Floor(y=-1.0))
    st = dict(verbose=0, admm_iters=10, linsolver=1, dtype=np.float64, direct_mode="inv")
    assert js.initialize(J.Settings(**st)) and ts.initialize(Settings(**st))
    hits = []
    for _ in range(12):
        js.step()
        h = j_detect(tuple(js.obstacles), tuple(js.colliders), js.state.x, js._surf_inds_dev,
                     False, js._dtype, js._surf_dense)
        x = torch.as_tensor(np.array(js.state.x))
        hits.append(int(np.asarray(h.d_mask).sum()))
        assert int(ts._detect(x, with_passive=False).d_mask.sum()) == hits[-1]
    assert hits[:8] == [0] * 8 and hits[11] > 0, hits


def test_jax_f32_detection_under_x64_runs_in_float64():
    """A reference quirk (ROADMAP Queue 3): under jax_enable_x64 (set by
    tests/conftest.py) the JAX package's make_tet_mesh_collider keeps float64
    rest vertices by default, so a float32 run's detection promotes its
    barycentrics and normals to float64 (and its Uzawa and AL-PCG loops fail
    to trace); with dtype=np.float32 it stays float32. The port takes the
    collider to the run dtype at initialize."""
    box = j_make_tet_blocks(1, 1, 1)
    x = np.concatenate([box.vertices, [[0.5, 0.5, 0.9]]], axis=0).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(x[-1:]), jnp.asarray([8], jnp.int32))
    c64 = jdyn.make_tet_mesh_collider(box.vertices, box.tets, j_surface_faces(box.tets), 0)
    c32 = jdyn.make_tet_mesh_collider(box.vertices, box.tets, j_surface_faces(box.tets), 0,
                                      dtype=np.float32)
    assert c64.rest_verts.dtype == jnp.float64
    assert jdyn.detect_dynamic(c64, *args)["normal"].dtype == jnp.float64
    assert jdyn.detect_dynamic(c32, *args)["normal"].dtype == jnp.float32
    tm = make_tet_blocks(1, 1, 1)
    tc = tdyn.make_tet_mesh_collider(tm.vertices, tm.tets, tm.faces, 0).to("cpu", torch.float32)
    r = tdyn.detect_dynamic(tc, torch.as_tensor(x), torch.as_tensor(x[-1:]), torch.as_tensor([8]))
    assert r["normal"].dtype == torch.float32 and bool(r["mask"][0])
