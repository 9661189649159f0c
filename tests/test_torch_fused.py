"""D x computed by the lane that consumes it: the stencil entries of kernels A
and E (csrc/local_step.cu, csrc/tri_local_step.cu over csrc/stencil_body.cuh),
checked on the CPU.

- The per-lane algorithm of stencil_body.cuh as a plain PyTorch walk kept here
  (index arithmetic per lane t = slot * cells + p, corners past the family's
  vertex block read 0, the sums in the device function's order, every product
  and sum a separate rounding as __fmul_rn / __fadd_rn are) must equal
  ops/stencil.tet_Dx_rows_plain and tri_Dx_rows bit for bit.
- The wrappers local_step_tet_stencil and local_step_tri_stencil on CPU
  tensors must equal the two-call route (D x rows, then the rows entry) bit
  for bit and launch nothing; a family whose vertex block lies outside x
  raises.
- The port's system.local_step, which goes through them, against the JAX
  package's system.local_step on the same numpy inputs (the JAX side on its
  jnp SoA bodies, set_svd_impl("jacobi")). Bounds: float64 1e-10 (the same
  operations in the same order); float32 tets the flip-tolerant bounds of
  tests/test_torch_local_step.py (median 1e-6, 99th percentile 2e-4, max
  5e-2, absolute on z and u'); float32 sheets and pins 2e-5 absolute (no
  iteration: the 1e-5 of the sheet stencil in tests/test_torch_tri.py, then
  one sqrt / division chain).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_local_step import F32_MAX, F32_MEDIAN, F32_P99

import chip_smoke
from admm_elastic_tpu import Lame as JLame
from admm_elastic_tpu import Settings as JSettings
from admm_elastic_tpu import Solver as JSolver
from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu.geometry import factory as jfactory
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.system import system as j_sys
from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.geometry import factory
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil, cuda_tri_local_step
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.ops.prox import TET_MODELS
from admm_elastic_tpu_torch.system import elements as el
from admm_elastic_tpu_torch.system import system as p_sys

torch.set_num_threads(1)

DTYPES = [torch.float64, torch.float32]
F32_DIRECT = 2e-5


def _tet_batch(dims, dtype, model="neohookean", off=0):
    mesh = factory.make_tet_blocks(*dims)
    lame = Lame.soft_rubber()
    kappa = lame.bulk_modulus() if model.startswith("spline") else 0.0
    b = el.build_tet_batch(mesh.vertices, mesh.tets, lame, model, device="cpu", dtype=dtype,
                           kappa=kappa, vertex_offset=off, lattice_dims=mesh.lattice_dims)
    return mesh, b


def _sheet_batch(verts, tris, dtype, limits, off=0):
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if limits:
        lame.limit_min, lame.limit_max = 0.95, 1.05
    return el.build_tri_batch(verts, tris, lame, device="cpu", dtype=dtype, vertex_offset=off)


def _noisy(rng, verts, dtype, before=0, after=0):
    """Perturbed positions with `before` / `after` foreign vertices around them."""
    x = np.concatenate([rng.standard_normal((before, 3)),
                        verts + 0.05 * rng.standard_normal(verts.shape),
                        rng.standard_normal((after, 3))])
    return torch.as_tensor(x, dtype=dtype)


def _corner(x, base, n_vblock, q):
    """stencil_corner: vertex base + q of x, 0 where q lies past the block."""
    inside = q < n_vblock
    v = base + torch.where(inside, q, torch.zeros_like(q))
    return torch.where(inside[:, None], x[v], torch.zeros((), dtype=x.dtype))


def tet_dx_lane_walk(x, b):
    """tet_dx_lane of csrc/stencil_body.cuh for every lane at once -> [9, T]."""
    base, cells, n_vblock, offs, pe, po = st._tet_geom(b.stencil)
    offs, pe, po = (torch.as_tensor(a) for a in (offs, pe, po))
    t = torch.arange(5 * cells)
    s = t // cells
    p = t - s * cells
    pr = b.st_par[p]
    inv = 1.0 - pr
    dd = b.st_dead[p]
    xs, d = [], []
    for j in range(4):
        e, o = pe[s, j], po[s, j]
        xe = _corner(x, base, n_vblock, p + offs[e])
        xo = _corner(x, base, n_vblock, p + offs[o])
        xs.append(torch.where((e == o)[:, None], xe, pr[:, None] * xe + inv[:, None] * xo))
        d.append(b.st_dl[s, j, :, p])  # [T, 3]
    rows = []
    for r in range(3):
        for c in range(3):
            acc = xs[0][:, r] * d[0][:, c]
            for j in range(1, 4):
                acc = acc + xs[j][:, r] * d[j][:, c]
            rows.append(acc + dd if r == c else acc)
    return torch.stack(rows)


def tri_dx_lane_walk(x, b):
    """tri_dx_lane of csrc/stencil_body.cuh for every lane at once -> [6, T]."""
    base, cells, offs, pats = st._tri_geom(b.stencil)
    offs, pats = torch.as_tensor(offs), torch.as_tensor(pats)
    t = torch.arange(len(pats) * cells)
    s = t // cells
    p = t - s * cells
    dd = b.st_dead[p]
    xs = [_corner(x, base, cells, p + offs[pats[s, j]]) for j in range(3)]
    d = [b.st_dl[s, j, :, p] for j in range(3)]  # [T, 2]
    rows = []
    for r in range(3):
        for c in range(2):
            acc = (xs[0][:, r] * d[0][:, c] + xs[1][:, r] * d[1][:, c]) + xs[2][:, r] * d[2][:, c]
            rows.append(acc + dd if r == c else acc)
    return torch.stack(rows)


# --- (a) the per-lane walk against the plain versions ---------------------------------------

@pytest.mark.parametrize("dims,off", [((40, 5, 5), 0), ((4, 2, 2), 0), ((4, 2, 2), 11)],
                         ids=["bench", "4x2x2", "4x2x2-offset"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tet_lane_walk_equals_plain(dims, off, dtype):
    mesh, b = _tet_batch(dims, dtype, off=off)
    x = _noisy(np.random.default_rng(31), mesh.vertices, dtype, before=off, after=3 if off else 0)
    want = st.tet_Dx_rows_plain(x, b)
    got = tet_dx_lane_walk(x, b)
    assert got.shape == want.shape == (9, b.n)
    assert torch.equal(got, want)
    dead = b.st_dead.bool().repeat(5)
    assert dead.any() and torch.equal(got[:, dead], torch.eye(3, dtype=dtype).reshape(9, 1)
                                      .expand(9, int(dead.sum())))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sheet_lane_walk_equals_plain_40x40(dtype):
    verts, tris, _, _ = chip_smoke.cloth_sheet(40, 40)
    b = _sheet_batch(verts, tris, dtype, limits=True)
    assert b.n == 3362
    x = _noisy(np.random.default_rng(32), verts, dtype)
    assert torch.equal(tri_dx_lane_walk(x, b), st.tri_Dx_rows(x, b))


def _two_sheets(dtype):
    """Two 4x4 sheets in one vertex array, the second at a vertex offset and
    strain-limited (the layout of apps/trianglestrain.py)."""
    meshes = [factory.make_plane(4, 4), factory.make_plane(4, 4)]
    meshes[1].apply_xform(factory.make_xform(trans=(4, 0, 0)))
    n0 = len(meshes[0].vertices)
    batches = [_sheet_batch(meshes[0].vertices, meshes[0].faces, dtype, limits=False),
               _sheet_batch(meshes[1].vertices, meshes[1].faces, dtype, limits=True, off=n0)]
    verts = np.concatenate([m.vertices for m in meshes])
    return batches, verts


@pytest.mark.parametrize("dtype", DTYPES)
def test_sheet_lane_walk_equals_plain_two_sheets(dtype):
    batches, verts = _two_sheets(dtype)
    assert batches[1].stencil[0] == 25
    x = _noisy(np.random.default_rng(33), verts, dtype)
    for b in batches:
        assert torch.equal(tri_dx_lane_walk(x, b), st.tri_Dx_rows(x, b))


# --- (b) the wrappers on CPU tensors against the two-call route ---------------------------------

def _launches():
    return (cuda_local_step.local_step_tet_stencil.launches,
            cuda_local_step.local_step_tet_hyper.launches, cuda_stencil.tet_Dx_rows.launches,
            cuda_tri_local_step.local_step_tri_stencil.launches,
            cuda_tri_local_step.local_step_tri.launches)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tet_stencil_entry_equals_two_calls_on_cpu(model, dtype):
    mesh, b = _tet_batch((4, 2, 2), dtype, model)
    rng = np.random.default_rng(34)
    x = _noisy(rng, mesh.vertices, dtype)
    u = torch.as_tensor(0.05 * rng.standard_normal((9, b.n)), dtype=dtype)
    before = _launches()
    got = cuda_local_step.local_step_tet_stencil(x, u, b, 8)
    want = cuda_local_step.local_step_tet_hyper(cuda_stencil.tet_Dx_rows(x, b), u, b.mu, b.lam,
                                                b.kappa, b.bulk, n_iters=8, model=model)
    assert _launches() == before
    for g, w in zip(got, want):
        assert g.shape == (9, b.n) and torch.isfinite(g).all() and torch.equal(g, w)
    for g, w in zip(b.local_step_x(x, u, 8), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("limits", [False, True], ids=["free", "limits"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sheet_stencil_entry_equals_two_calls_on_cpu(limits, dtype):
    verts, tris, _, _ = chip_smoke.cloth_sheet(6, 5)
    b = _sheet_batch(verts, tris, dtype, limits)
    rng = np.random.default_rng(35)
    x = _noisy(rng, verts, dtype)
    u = torch.as_tensor(0.02 * rng.standard_normal((6, b.n)), dtype=dtype)
    before = _launches()
    got = cuda_tri_local_step.local_step_tri_stencil(x, u, b)
    want = cuda_tri_local_step.local_step_tri(st.tri_Dx_rows(x, b), u, b.limit_min, b.limit_max)
    assert _launches() == before
    for g, w in zip(got, want):
        assert g.shape == (6, b.n) and torch.isfinite(g).all() and torch.equal(g, w)
    for g, w in zip(b.local_step_x(x, u), want):
        assert torch.equal(g, w)
    if limits:  # the limits do bind on these inputs
        free = cuda_tri_local_step.local_step_tri_stencil(
            x, u, _sheet_batch(verts, tris, dtype, False))
        assert not torch.equal(free[0], got[0])


# --- (c) a family whose vertex block lies outside x ---------------------------------------------

def test_tet_family_outside_x_raises():
    mesh, b = _tet_batch((4, 2, 2), torch.float64, off=11)
    x = torch.zeros((11 + len(mesh.vertices) - 1, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="outside x"):
        cuda_local_step.local_step_tet_stencil(x, torch.zeros((9, b.n), dtype=torch.float64), b)


def test_sheet_family_outside_x_raises():
    batches, verts = _two_sheets(torch.float64)
    x = torch.zeros((len(verts) - 1, 3), dtype=torch.float64)
    u = torch.zeros((6, batches[1].n), dtype=torch.float64)
    cuda_tri_local_step.local_step_tri_stencil(x, u, batches[0])  # the first sheet fits
    with pytest.raises(ValueError, match="outside x"):
        cuda_tri_local_step.local_step_tri_stencil(x, u, batches[1])


# --- system.local_step against the JAX package ----------------------------------------------------

@pytest.fixture(scope="module")
def jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _settings(cls, dtype):
    return cls(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv", dtype=dtype)


def _beam_solver(pkg_solver, pkg_bind, pkg_make, pkg_lame, pkg_settings, dtype):
    mesh = pkg_make(4, 2, 2)
    mesh.flags = pkg_bind.NOSELFCOLLISION | pkg_bind.NEOHOOKEAN
    s = pkg_solver()
    pkg_bind.add_tetmesh(s, mesh, pkg_lame.soft_rubber(), verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize(_settings(pkg_settings, dtype))
    return s


def _sheet_solver(pkg_solver, pkg_bind, pkg_plane, pkg_lame, pkg_settings, dtype):
    mesh = pkg_plane(4, 4)
    lame = pkg_lame.from_youngs_poisson(100, 0.1)
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s = pkg_solver()
    pkg_bind.add_trimesh(s, mesh, lame, verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < mesh.vertices[:, 0].min() + 1e-9)[0]])
    assert s.initialize(_settings(pkg_settings, dtype))
    return s


def _port_cpu_solver():
    return Solver(device="cpu")


SCENES = {
    "beam": (lambda dt: _beam_solver(JSolver, jbind, jfactory.make_tet_blocks, JLame, JSettings, dt),
             lambda dt: _beam_solver(_port_cpu_solver, binding, factory.make_tet_blocks, Lame,
                                     Settings, dt)),
    "sheet": (lambda dt: _sheet_solver(JSolver, jbind, jfactory.make_plane, JLame, JSettings, dt),
              lambda dt: _sheet_solver(_port_cpu_solver, binding, factory.make_plane, Lame,
                                       Settings, dt)),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_system_local_step_matches_jax(jacobi_svd, scene, dtype):
    j, p = (make(dtype) for make in SCENES[scene])
    rng = np.random.default_rng(36)
    x = (p.x + 0.03 * rng.standard_normal(p.x.shape)).astype(dtype)
    shapes = [tuple(z.shape) for z in p_sys.zeros_like_Dx(p.system, p.state.x.dtype, "cpu")]
    u = [(0.02 * rng.standard_normal(sh)).astype(dtype) for sh in shapes]
    assert len(shapes) == 2 and shapes[0][0] == (9 if scene == "beam" else 6)
    want = j_sys.local_step(j.system, jnp.asarray(x), None, [jnp.asarray(a) for a in u])
    got = p_sys.local_step(p.system, torch.as_tensor(x), None, [torch.as_tensor(a) for a in u])
    for family, (gs, ws) in enumerate(zip(zip(*got), zip(*want))):
        for g, w in zip(gs, ws):
            g, w = g.numpy(), np.asarray(w)
            assert g.dtype == dtype and g.shape == w.shape and np.isfinite(g).all()
            err = np.abs(g - w)
            if dtype == np.float64:
                assert err.max() < 1e-10, (family, err.max())
            elif scene == "beam" and family == 0:
                assert err.max() < F32_MAX and np.quantile(err, 0.99) < F32_P99
                assert np.median(err) < F32_MEDIAN
            else:
                assert err.max() < F32_DIRECT, (family, err.max())
    # the step moved the iterates: z is not D x + u, u' is not u
    assert np.abs(got[1][0].numpy() - u[0]).max() > 1e-4
