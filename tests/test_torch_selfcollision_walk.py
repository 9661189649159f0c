"""Kernel K's host side and walks on the CPU (float64), with no JAX step
compile. K (csrc/self_collision.cu) runs only on the card; what its design
adds around the plain twin is checked here:

- the broad phase as the kernel walks it: the wrapper's keys and query cells
  (dynamic._grid_cells) and stable key sort (torch.sort), then, per query,
  the 27 cells' runs found by the kernel's binary search and walked for at
  most cell_cap slots while the key matches (emulated here): the same
  candidate set and broad_overflow as the port's _broad_phase_candidates and
  the JAX package's, on random, folded and overflowing states;
- the lowest inside tet over those runs (the kernel's integer minimum) equal
  to point_in_tet's pick over the plain candidate rows, its barycentrics bit
  for bit;
- the merge written once over a collider table (a query takes the listed hit
  of the lowest-index collider that lists it, where its row is not set yet),
  emulated: the rows of the sequential merge for one, two and three
  colliders, from empty rows and from rows already set;
- the collider table (dynamic.collider_table, built by the solver at
  initialize) round-trips each collider's arrays, and dyn_detect over it on
  the CPU is the collider-by-collider plain twin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu.collision.dynamic as jdyn
from admm_elastic_tpu_torch.collision import dynamic as tdyn
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.geometry.mesh import surface_vertex_indices
from admm_elastic_tpu_torch.ops import cuda_dynamic

torch.set_num_threads(1)
# the kernel's lane order of the 27 cells around a query's
OFFS = np.array([(i // 9 - 1, i // 3 % 3 - 1, i % 3 - 1) for i in range(27)], dtype=np.int64)


def _key(c):
    """csrc/self_collision.cu cell_key: unsigned products, XORed, as int32."""
    u = np.asarray(c, dtype=np.int64).astype(np.uint32)
    k = (u[..., 0] * np.uint32(73856093)) ^ (u[..., 1] * np.uint32(19349663)) \
        ^ (u[..., 2] * np.uint32(83492791))
    return k.astype(np.uint32).view(np.int32)


def _lower_bound(ks, key):
    """The kernel's binary search: the first slot whose key is not below key."""
    lo, hi = 0, len(ks)
    while lo < hi:
        mid = (lo + hi) >> 1
        if ks[mid] < key:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _sorted_cells(x4, q):
    """The wrapper's part: (sorted keys, order, query cells) as numpy."""
    keys, qc = tdyn._grid_cells(x4, q)
    ks, order = torch.sort(keys, stable=True)
    return ks.numpy(), order.numpy(), qc.numpy()


def _kernel_walk(ks, order, qc, cap):
    """Per query the candidate set and the overflow, as the kernel walks the
    sorted keys."""
    t = len(ks)
    sets, over = [], np.zeros(len(qc), dtype=bool)
    for h, c in enumerate(qc):
        got = set()
        for key in _key(c[None, :].astype(np.int64) + OFFS):
            lo = _lower_bound(ks, key)
            s = lo
            while s < lo + cap and s < t and ks[s] == key:
                got.add(int(order[s]))
                s += 1
            over[h] |= lo + cap < t and ks[lo + cap] == key
        sets.append(got)
    return sets, over


def _state(kind):
    """(mesh, x, cap) of a state: a 6^3 block jittered at random, the 8^3
    block folded onto itself (tests/test_broadphase.py), or folded with a cell
    capacity of 1 or 2 (its cells overflow)."""
    if kind == "random":
        mesh = make_tet_blocks(6, 6, 6)
        rng = np.random.default_rng(16)
        x = mesh.vertices + rng.uniform(-0.35, 0.35, mesh.vertices.shape)
        return mesh, x, tdyn.CELL_CAP
    mesh = make_tet_blocks(8, 8, 8)
    x = mesh.vertices.astype(np.float64).copy()
    x[:, 0] = np.abs(x[:, 0] - 4 - 0.2) * 0.9
    cap = {"folded": tdyn._rest_cell_cap(mesh.vertices, mesh.tets), "cap1": 1, "cap2": 2}[kind]
    return mesh, x, cap


STATES = ("random", "folded", "cap1", "cap2")


@pytest.mark.parametrize("kind", STATES)
def test_broad_runs_give_the_candidate_sets(kind):
    mesh, x, cap = _state(kind)
    surf = surface_vertex_indices(mesh.tets)
    x4 = torch.as_tensor(x)[torch.as_tensor(mesh.tets)]
    q = torch.as_tensor(x[surf])
    sets, over = _kernel_walk(*_sorted_cells(x4, q), cap)
    t = len(mesh.tets)
    cand, t_over = tdyn._broad_phase_candidates(x4, q, cap)
    j_cand, j_over = jdyn._broad_phase_candidates(jnp.asarray(x4.numpy()), jnp.asarray(x[surf]),
                                                  cap)
    for rows in (cand.numpy(), np.asarray(j_cand)):
        assert [set(int(v) for v in r if v < t) for r in rows] == sets
    assert np.array_equal(over, t_over.numpy())
    assert np.array_equal(over, np.asarray(j_over))
    if kind != "random":
        assert over.any() == (kind in ("cap1", "cap2"))
    assert sum(len(s) for s in sets) > len(surf)


@pytest.mark.parametrize("kind", STATES)
def test_lowest_inside_over_the_runs_is_point_in_tets(kind):
    mesh, x, cap = _state(kind)
    surf = surface_vertex_indices(mesh.tets)
    col = tdyn.make_tet_mesh_collider(mesh.vertices, mesh.tets, mesh.faces, 0)
    xt, st = torch.as_tensor(x), torch.as_tensor(surf)
    x4 = xt[col.tets.long()]
    sets, _ = _kernel_walk(*_sorted_cells(x4, xt[st]), cap)
    cand, _ = tdyn._broad_phase_candidates(x4, xt[st], cap)
    hit, hit_tet, bary4 = tdyn.point_in_tet(col, xt, xt[st], st, cand)
    _, einv, base, safe = tdyn.tet_frames(col, xt)
    tets = col.tets.long()
    n_hits = 0
    for h, got in enumerate(sets):
        ids = torch.as_tensor(sorted(got), dtype=torch.int64)
        b4 = tdyn._bary4(einv[ids], base[ids], xt[st[h]][None, :])
        inside = (torch.all(b4 >= 0.0, dim=-1) & safe[ids]
                  & ~torch.any(tets[ids] == st[h], dim=-1))
        assert bool(inside.any()) == bool(hit[h])
        if inside.any():
            k = int(torch.argmin(torch.where(inside, ids, len(tets))))  # the integer minimum
            assert int(ids[k]) == int(hit_tet[h])
            assert torch.equal(b4[k], bary4[h])
            n_hits += 1
    assert n_hits > 0


def _blocks(n_col, shift=(0.3, 0.2, 0.0)):
    """Three 4^3 blocks shifted by `shift` one from the next, the first n_col
    of them colliders: (colliders, x, every vertex as the queries). A vertex
    of the third block lies in tets of the first two."""
    m = make_tet_blocks(4, 4, 4)
    nv = len(m.vertices)
    x = np.concatenate([m.vertices + i * np.asarray(shift) for i in range(3)])
    cols = [tdyn.make_tet_mesh_collider(m.vertices, m.tets, m.faces, i * nv) for i in range(n_col)]
    return cols, torch.as_tensor(x.astype(np.float64)), torch.arange(3 * nv)


def _empty_rows(h):
    return (torch.zeros((h,), dtype=torch.bool), torch.zeros((h, 3), dtype=torch.int64),
            torch.zeros((h, 3), dtype=torch.float64), torch.zeros((h, 3), dtype=torch.float64))


def _one_pass_merge(rows, results):
    """The face walk's merge: each query row not set yet takes the listed hit
    of the lowest-index collider that lists it."""
    d_mask, d_face, d_barys, d_normal = (r.clone() for r in rows)
    for h in range(d_mask.shape[0]):
        if d_mask[h]:
            continue
        for r in results:
            if r["mask"][h]:
                d_face[h], d_barys[h], d_normal[h] = r["face"][h], r["barys"][h], r["normal"][h]
                d_mask[h] = True
                break
    return d_mask, d_face, d_barys, d_normal


@pytest.mark.parametrize("preset", [False, True], ids=["empty", "preset"])
@pytest.mark.parametrize("n_col", [1, 2, 3])
def test_one_pass_merge_is_the_sequential_merge(n_col, preset):
    cols, x, surf = _blocks(n_col)
    h = surf.shape[0]
    results = [tdyn.detect_dynamic(c, x, x[surf], surf) for c in cols]
    if n_col > 1:  # two colliders list one query vertex
        assert int((torch.stack([r["mask"] for r in results]).sum(0) >= 2).sum()) > 0
    rows = _empty_rows(h)
    if preset:  # rows already set (by an earlier call) keep theirs
        rng = np.random.default_rng(n_col)
        keep = torch.as_tensor(rng.random(h) < 0.3)
        rows = (keep, torch.where(keep[:, None], 7, rows[1]),
                torch.where(keep[:, None], 0.5, rows[2]), torch.where(keep[:, None], -1.0, rows[3]))
    seq = rows
    for r in results:
        seq, _ = tdyn.merge(seq, r)
    one = _one_pass_merge(rows, results)
    assert int(one[0].sum()) > int(rows[0].sum())
    for a, b in zip(one, seq):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_col", [1, 3])
def test_collider_table_round_trips(n_col):
    cols, x, surf = _blocks(n_col)
    cols = [dataclasses.replace(c, cell_cap=16 + i) for i, c in enumerate(cols)]
    table = tdyn.collider_table(cols)
    assert table.tet_off == tuple(int(v) for v in np.cumsum([0] + [c.n_tets for c in cols]))
    for i, c in enumerate(cols):
        back = table.collider(i)
        for f in ("tets", "rest_verts", "faces"):
            assert torch.equal(getattr(back, f), getattr(c, f)), f
        assert (back.vert_offset, back.cell_cap) == (c.vert_offset, c.cell_cap)
    flag = torch.zeros((1,), dtype=torch.int32)
    rows = cuda_dynamic.dyn_detect(table, x, x[surf], surf, _empty_rows(surf.shape[0]), flag)
    seq, ovf = _empty_rows(surf.shape[0]), False
    for c in cols:
        seq, o = tdyn.merge(seq, tdyn.detect_dynamic(c, x, x[surf], surf))
        ovf |= bool(o)
    for a, b in zip(rows, seq):
        assert torch.equal(a, b)
    assert int(flag) == int(ovf)


def test_solver_table_is_its_colliders():
    """The table the solver builds at initialize, and again when a collider
    is added after it, holds its colliders in order."""
    from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu_torch.geometry.factory import make_xform

    s = Solver(device="cpu")
    for i in range(2):
        m = make_tet_blocks(3, 3, 3, cell=1.0 / 3.0)
        m.apply_xform(make_xform(trans=(0.0, i * 1.25, 0.0)))
        m.flags = binding.LINEAR
        binding.add_tetmesh(s, m, Lame.rubber(), verbose=False)
    s.add_obstacle(Floor(y=-0.5))
    assert s.initialize(Settings(verbose=0, admm_iters=2, linsolver=1))
    c = s._contact
    assert c.table is not None and c.table.colliders == c.colliders and len(c.colliders) == 2
    for i, col in enumerate(c.colliders):
        back = c.table.collider(i)
        assert all(torch.equal(getattr(back, f), getattr(col, f))
                   for f in ("tets", "rest_verts", "faces"))
        assert back.vert_offset == col.vert_offset
    extra = tdyn.make_tet_mesh_collider(make_tet_blocks(2, 2, 2).vertices,
                                        make_tet_blocks(2, 2, 2).tets,
                                        make_tet_blocks(2, 2, 2).faces, 0)
    s.add_dynamic_collider(extra)
    table = s._contact.table
    assert len(table.colliders) == 3 and table.tet_off[-1] == table.tets.shape[0]
    assert torch.equal(table.collider(2).tets, extra.tets)
