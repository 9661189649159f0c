"""Ring (wrap) lattices in the port against the JAX package, on the CPU:
make_tet_torus, the ring verify_lattice / flat plan / TetBatch fields bit for
bit, the ring D x, D^T and rhs against the JAX jnp ring stencil (exact in
float64, within 1e-6 relative in float32), and kernel C's tiled and wide
algorithms on a ring, walked in plain PyTorch, bit for bit the plain rhs (the
CUDA kernels are held to the same on the card by chip_smoke.py). No JAX step
compile: the jnp stencil runs op by op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.geometry import factory as jfactory
from admm_elastic_tpu.materials import Lame as JLame
from admm_elastic_tpu.ops import stencil as jst
from admm_elastic_tpu.system import elements as jel
from admm_elastic_tpu_torch.geometry import factory as tfactory
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.system import elements as el

torch.set_num_threads(1)

RINGS = [(10, 4), (12, 4)]
BATCH_FIELDS = ("inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa", "st_dl", "st_par",
                "st_dead")


@pytest.mark.parametrize("n_ring,n_sec", RINGS + [(11, 3), (6, 2)])
def test_make_tet_torus_is_the_jax_package_s(n_ring, n_sec):
    a = jfactory.make_tet_torus(n_ring=n_ring, n_sec=n_sec)
    b = tfactory.make_tet_torus(n_ring=n_ring, n_sec=n_sec)
    assert np.array_equal(a.vertices, b.vertices)
    assert np.array_equal(a.tets, b.tets) and b.tets.dtype == np.int64
    assert a.lattice_dims == b.lattice_dims and b.lattice_wrap is True
    assert b.lattice_dims[0] % 2 == 0  # an odd ring closes one segment longer


def _batches(ring, off, jdtype, tdtype):
    mesh = tfactory.make_tet_torus(n_ring=ring[0], n_sec=ring[1])
    jb = jel.build_tet_batch(mesh.vertices, mesh.tets, JLame.soft_rubber(), "neohookean", off,
                             dtype=jdtype, lattice_dims=mesh.lattice_dims, lattice_wrap=True)
    tb = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                            device="cpu", dtype=tdtype, vertex_offset=off,
                            lattice_dims=mesh.lattice_dims, lattice_wrap=True)
    return mesh, jb, tb


@pytest.mark.parametrize("off", [0, 7])
@pytest.mark.parametrize("ring", RINGS)
def test_ring_meta_plan_and_batch_are_bit_equal(ring, off):
    mesh, jb, tb = _batches(ring, off, jnp.float64, torch.float64)
    meta = st.verify_lattice(mesh.tets, mesh.lattice_dims, base=off, wrap=True)
    assert meta == jst.verify_lattice(mesh.tets, mesh.lattice_dims, base=off, wrap=True)
    assert meta[6] is True and tb.stencil == meta == jb.stencil
    p, q = st.tet_flat_plan(meta), jst.tet_flat_plan(meta)
    for f in ("src", "dead", "par"):
        assert np.array_equal(getattr(p, f), getattr(q, f)), f
    # a ring keeps its exact cell count: no +1 slab, no 128-cell pad
    cells = ring[0] * (ring[1] + 1) ** 2
    assert p.t_cap == 5 * cells and st._tet_geom(meta)[1:3] == (cells, cells)
    for f in BATCH_FIELDS:
        assert np.array_equal(np.asarray(getattr(jb, f)), getattr(tb, f).numpy()), f
    assert tb.n_live == len(mesh.tets)


def test_ring_verification_refuses_what_the_jax_package_refuses():
    mesh = tfactory.make_tet_torus(n_ring=12, n_sec=4)
    assert st.verify_lattice(mesh.tets, mesh.lattice_dims, wrap=False) is None
    assert jst.verify_lattice(mesh.tets, mesh.lattice_dims, wrap=False) is None
    # an odd ring count cannot close the parity pattern
    assert st.verify_lattice(mesh.tets, (11, 4, 4), wrap=True) is None
    # a beam checked as a ring reads as the JAX package reads it
    beam = tfactory.make_tet_blocks(6, 3, 3)
    assert (st.verify_lattice(beam.tets, beam.lattice_dims, wrap=True)
            == jst.verify_lattice(beam.tets, beam.lattice_dims, wrap=True))
    # a torus without its wrap flag runs as a gather family
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                           device="cpu", dtype=torch.float64, lattice_dims=mesh.lattice_dims)
    assert b.stencil is None


def _inputs(mesh, tb, off, extra, dtype, seed):
    rng = np.random.default_rng(seed)
    verts = np.concatenate([np.zeros((off, 3)), mesh.vertices, np.zeros((extra, 3))])
    x = verts + 0.01 * rng.standard_normal(verts.shape)
    g = rng.standard_normal((9, tb.n))
    z, u = rng.standard_normal((9, tb.n)), 0.05 * rng.standard_normal((9, tb.n))
    return x, g, z, u


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("ring,off,extra", [((12, 4), 0, 0), ((10, 4), 7, 3)])
def test_ring_stencil_matches_the_jax_jnp_ring_stencil(ring, off, extra, dtype):
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    mesh, jb, tb = _batches(ring, off, jd, td)
    x, g, z, u = _inputs(mesh, tb, off, extra, dtype, 31)
    n = len(x)
    got = [st.tet_Dx_rows_plain(torch.as_tensor(x, dtype=td), tb),
           st.tet_Dt_rows_plain(torch.as_tensor(g, dtype=td), tb, n),
           st.tet_rhs_rows_plain(torch.as_tensor(z, dtype=td), torch.as_tensor(u, dtype=td),
                                 tb, n)]
    w2 = jb.weight * jb.weight
    want = [jst.tet_Dx_rows(jnp.asarray(x, jd), jb),
            jst.tet_Dt_rows(jnp.asarray(g, jd), jb, n),
            jst.tet_Dt_rows(w2[None, :] * (jnp.asarray(z, jd) - jnp.asarray(u, jd)), jb, n)]
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.shape == w.shape and torch.isfinite(a).all()
        if dtype == "f64":
            assert np.array_equal(a.numpy(), w)
        else:
            assert np.abs(a.numpy() - w).max() <= 1e-6 * max(1.0, np.abs(w).max())
    if off:  # zero outside the family's vertex block
        assert not got[1][:off].any() and not got[1][off + len(mesh.vertices):].any()


def test_ring_dead_lanes_carry_an_identity_f():
    mesh, _, tb = _batches((12, 4), 0, jnp.float64, torch.float64)
    x = torch.as_tensor(mesh.vertices + 0.01, dtype=torch.float64)
    rows = st.tet_Dx_rows_plain(x, tb)
    dead = np.tile(tb.st_dead.numpy() > 0, 5)
    assert dead.any()
    assert torch.equal(rows[:, torch.as_tensor(dead)],
                       torch.eye(3, dtype=torch.float64).reshape(9, 1).expand(9, int(dead.sum())))
    assert not tb.weight[torch.as_tensor(dead)].any()


def _contrib_sm(zz, uu, w, dl, s, lo, hi):
    """Phase 1 of the tiled kernel for slot s over cells lo..hi: [12, 3, cols]."""
    w2 = w[s, lo:hi] * w[s, lo:hi]
    g = w2 * (zz[:, s, lo:hi] - uu[:, s, lo:hi])
    out = []
    for j in range(4):
        for r in range(3):
            cr = g[3 * r] * dl[s, j, 0, lo:hi]
            cr = cr + g[3 * r + 1] * dl[s, j, 1, lo:hi]
            out.append(cr + g[3 * r + 2] * dl[s, j, 2, lo:hi])
    return out


def ring_rhs_walk(z, u, b, n_verts, tile):
    """Kernel C on a ring in plain PyTorch, as csrc/stencil.cu's tiled branch
    runs it (tile > 0: a block's cells staged, a ring's column p < 0 holding
    cell p + cells) or its wide branch (tile 0: every cell read where it is
    used): per vertex the corner ids' sums in turn, the wrapped ones (cell
    q - offs < 0) apart, then the two added."""
    base, cells, n_vblock, offs, pe, po = st._tet_geom(b.stencil)
    assert b.stencil[6]
    table = cuda_stencil.rhs_match_table(pe, po)
    halo = max(offs)
    zz, uu = z.reshape(9, 5, cells), u.reshape(9, 5, cells)
    w, dl, par = b.weight.reshape(5, cells), b.st_dl, b.st_par
    out = torch.full((n_verts, 3), float("nan"), dtype=z.dtype)
    step = tile if tile else 1
    for blk in range(-(-n_verts // step)):
        q0 = blk * step - base
        if tile:  # phase 1: columns p0 .. p0 + width of the block
            p0 = q0 - halo
            width = tile + halo
            sm = torch.full((60, width), float("nan"), dtype=z.dtype)
            for col in range(width):
                p = p0 + col
                p = p + cells if p < 0 else p
                if 0 <= p < cells:
                    for s in range(5):
                        for k, v in enumerate(_contrib_sm(zz, uu, w, dl, s, p, p + 1)):
                            sm[s * 12 + k, col] = v[0]
        for th in range(step):
            q = q0 + th
            if q + base >= n_verts:
                break
            total = torch.zeros(3, dtype=z.dtype)
            tail = torch.zeros(3, dtype=z.dtype)
            if 0 <= q < n_vblock:
                for cid in range(8):
                    p = q - offs[cid]
                    if p >= cells or not table[cid]:
                        continue
                    pw = p + cells if p < 0 else p
                    pr = par[pw]
                    inv = 1.0 - pr
                    acc = None
                    for sj, kind in table[cid]:
                        if tile:
                            c = sm[sj * 3:sj * 3 + 3, p - p0]
                        else:
                            c = torch.stack(_contrib_sm(zz, uu, w, dl, sj // 4, pw, pw + 1)[
                                (sj % 4) * 3:(sj % 4) * 3 + 3])[:, 0]
                        v = c if kind == cuda_stencil.BOTH else (
                            pr if kind == cuda_stencil.EVEN else inv) * c
                        acc = v if acc is None else acc + v
                    if p >= 0:
                        total = total + acc
                    else:
                        tail = tail + acc
            out[q + base] = total + tail
    return out


@pytest.mark.parametrize("tile", [0, 7, 32])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ring,off,extra", [((6, 2), 0, 0), ((4, 3), 5, 2)])
def test_ring_rhs_walk_equals_plain_rhs_bit_for_bit(ring, off, extra, dtype, tile):
    mesh = tfactory.make_tet_torus(n_ring=ring[0], n_sec=ring[1])
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                           device="cpu", dtype=dtype, vertex_offset=off,
                           lattice_dims=mesh.lattice_dims, lattice_wrap=True)
    n = off + len(mesh.vertices) + extra
    rng = np.random.default_rng(37)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), dtype=dtype) for _ in range(2))
    got = ring_rhs_walk(z, u, b, n, tile)
    want = st.tet_rhs_rows_plain(z, u, b, n)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_ring_wrappers_take_the_plain_versions_on_the_cpu():
    mesh, _, tb = _batches((12, 4), 3, jnp.float64, torch.float64)
    x, g, z, u = _inputs(mesh, tb, 3, 2, "f64", 41)
    n = len(x)
    x, z, u = (torch.as_tensor(a) for a in (x, z, u))
    before = (cuda_stencil.tet_Dx_rows.launches, cuda_stencil.tet_rhs_rows.launches)
    assert torch.equal(cuda_stencil.tet_Dx_rows(x, tb), st.tet_Dx_rows_plain(x, tb))
    for kw in ({}, {"branch": "tiled"}, {"branch": "wide"}):
        assert torch.equal(cuda_stencil.tet_rhs_rows(z, u, tb, n, **kw),
                           st.tet_rhs_rows_plain(z, u, tb, n))
    assert (cuda_stencil.tet_Dx_rows.launches, cuda_stencil.tet_rhs_rows.launches) == before
    geom, match = cuda_stencil.geom_of(tb.stencil)[4:]
    assert len(geom) == 49 and geom[48] == 1 and len(match) == 58 and match[57] == 1


@pytest.mark.parametrize("n_sec,halo_fits", [(4, True), (16, True), (40, False)])
def test_ring_rhs_plan_follows_the_halo(n_sec, halo_fits):
    mesh = tfactory.make_tet_torus(n_ring=4, n_sec=n_sec)
    meta = st.verify_lattice(mesh.tets, mesh.lattice_dims, wrap=True)
    halo = max(st._tet_geom(meta)[3])
    assert halo == (n_sec + 1) ** 2 + (n_sec + 1) + 1
    assert (cuda_stencil.rhs_plan(halo, 4)[0] == "tiled") == halo_fits
