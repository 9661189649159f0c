"""The port's cloth pieces against the JAX package on the CPU: kernel E's plain
version, the sheet stencil, the host-side build functions and the wind force.

Inputs come from a numpy seed (tests/test_torch_cuda.py's recipes); the same
arrays go through both packages. Bounds: float64 1e-12 (the two packages
perform the same operations in the same order); float32 stated per test.
Host arrays must be equal bit for bit, in float64 and after the float32 cast.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from test_torch_cuda import tri_inputs

from admm_elastic_tpu import forces as j_forces
from admm_elastic_tpu.geometry.factory import make_plane as j_plane
from admm_elastic_tpu.materials import Lame as JLame
from admm_elastic_tpu.ops import pallas_kernels
from admm_elastic_tpu.ops import soa as j_soa
from admm_elastic_tpu.ops import stencil as j_st
from admm_elastic_tpu.system import assembly as j_asm
from admm_elastic_tpu.system import elements as j_el
from admm_elastic_tpu.system import system as j_sys
from admm_elastic_tpu_torch import forces as p_forces
from admm_elastic_tpu_torch.geometry.factory import make_plane as p_plane
from admm_elastic_tpu_torch.materials import Lame as PLame
from admm_elastic_tpu_torch.ops import cuda_tri_local_step
from admm_elastic_tpu_torch.ops import stencil as p_st
from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain
from admm_elastic_tpu_torch.system import assembly as p_asm
from admm_elastic_tpu_torch.system import elements as p_el
from admm_elastic_tpu_torch.system import system as p_sys
from chip_smoke import cloth_sheet

torch.set_num_threads(1)

DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
TRI_FIELDS = ("inds", "Dlocal", "area", "weight", "mu", "lam", "limit_min", "limit_max",
              "st_dl", "st_dead")
# float32 local step: libm sqrt / division differ in the last ulp between XLA
# and PyTorch; |z| ~ 1 here.
E_TOL = {np.float64: 1e-12, np.float32: 5e-6}


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_kernels.set_pallas_mode("interpret")
    yield
    pallas_kernels.set_pallas_mode("auto")


def _port_local_step(arrs):
    return [t.numpy() for t in local_step_tri_plain(*(torch.as_tensor(a) for a in arrs))]


@pytest.mark.parametrize("ref", ["pallas_interpret", "soa"])
@pytest.mark.parametrize("t", [4, 150])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tri_local_step_matches_jax(ref, t, dtype):
    """Kernel E's plain version; lanes 0-3 are the rest state, a collapsed
    column, a zero F and a = c with b != 0; limits on about half the lanes."""
    arrs = tri_inputs(t, t, dtype)
    dix, u, lm, lx = (jnp.asarray(a) for a in arrs)
    if ref == "pallas_interpret":
        want = pallas_kernels.local_step_tri_pallas(dix, u, lm, lx)
    else:
        v = dix + u
        z = jnp.stack(j_soa.prox_tri_tuple(tuple(v[i] for i in range(6)), lm, lx), axis=0)
        want = (z, v - z)
    for g, w in zip(_port_local_step(arrs), want):
        assert g.dtype == dtype and np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=E_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_tri_rest_state_is_a_fixed_point(dtype):
    """Identity F with u = 0 (every dead lane, every lane of step 0) takes the
    (1, 0) eigenvector fallback and leaves as z = F, u' = 0, limits or not."""
    t = 6
    ident = np.tile(np.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])[:, None], (1, t)).astype(dtype)
    lm = np.asarray([0.95, -100.0] * 3, dtype)
    lx = np.asarray([1.05, 100.0] * 3, dtype)
    z, uo = _port_local_step((ident, np.zeros_like(ident), lm, lx))
    np.testing.assert_array_equal(z, ident)
    np.testing.assert_array_equal(uo, np.zeros_like(ident))


def test_tri_wrapper_takes_plain_version_on_cpu():
    arrs = [torch.as_tensor(a) for a in tri_inputs(33, 5, np.float64)]
    before = cuda_tri_local_step.local_step_tri.launches
    got = cuda_tri_local_step.local_step_tri(*arrs)
    assert cuda_tri_local_step.local_step_tri.launches == before
    for g, w in zip(got, local_step_tri_plain(*arrs)):
        assert torch.equal(g, w)


# --- host-side build functions, bit for bit ---------------------------------------------

def _fast_major(nx, ny):
    """A sheet whose cells are enumerated along the fast vertex axis last:
    vid = i * (ny + 1) + j with j outer, i inner."""
    tris = []
    for j in range(ny):
        for i in range(nx):
            v = lambda a, b: a * (ny + 1) + b  # noqa: E731
            tris.append([v(i, j), v(i + 1, j), v(i, j + 1)])
            tris.append([v(i + 1, j), v(i + 1, j + 1), v(i, j + 1)])
    verts = np.array([[i, 0.0, j] for i in range(nx + 1) for j in range(ny + 1)], float)
    return verts, np.asarray(tris)


def _sheets():
    plane = j_plane(5, 4, size=2.0)
    mv, mt, _, _ = cloth_sheet(6, 5)
    fv, ft = _fast_major(4, 3)
    return {"make_plane": (plane.vertices, plane.faces), "matrix": (mv, mt),
            "fast_major": (fv, ft)}


def test_make_plane_equal():
    for args in ((10, 10), (5, 4, 2.0)):
        jm, pm = j_plane(*args), p_plane(*args)
        np.testing.assert_array_equal(pm.vertices, jm.vertices)
        np.testing.assert_array_equal(pm.faces, jm.faces)
        np.testing.assert_array_equal(pm.weighted_masses(3.0), jm.weighted_masses(3.0))


@pytest.mark.parametrize("name", ["make_plane", "matrix", "fast_major"])
@pytest.mark.parametrize("off", [0, 7])
def test_tri_grid_and_flat_plan_equal(name, off):
    verts, tris = _sheets()[name]
    jm = j_st.verify_tri_grid(tris, base=off, n_local_verts=len(verts))
    pm = p_st.verify_tri_grid(tris, base=off, n_local_verts=len(verts))
    assert pm is not None and pm == jm
    jp, pp = j_st.tri_flat_plan(tris, jm), p_st.tri_flat_plan(tris, pm)
    for f in ("src", "dead", "par"):
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f))
    assert (pp.n_slots, pp.arity, pp.cols) == (jp.n_slots, jp.arity, jp.cols)


def test_non_grid_triangles_are_rejected():
    verts, tris = _sheets()["make_plane"]
    cut = tris[:-1]  # a cell with one triangle missing
    swapped = tris.copy()
    swapped[3] = swapped[3][[0, 2, 1]]  # one slot with another corner pattern
    fan = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4]])
    for bad in (cut, swapped, fan):
        assert j_st.verify_tri_grid(bad, n_local_verts=len(verts)) is None
        assert p_st.verify_tri_grid(bad, n_local_verts=len(verts)) is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p_el.build_tri_batch(verts, cut, PLame.soft_rubber(), device="cpu",
                             dtype=torch.float64)


def _eq(p, j):
    a = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    b = np.asarray(j)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _lame(cls, limits):
    lame = cls.from_youngs_poisson(10000000, 0.399)
    if limits is not None:
        lame.limit_min, lame.limit_max = limits
    return lame


def _batches(name, off, np_dt, t_dt, limits=(0.95, 1.05)):
    verts, tris = _sheets()[name]
    jb = j_el.build_tri_batch(verts, tris, _lame(JLame, limits), vertex_offset=off, dtype=np_dt)
    pb = p_el.build_tri_batch(verts, tris, _lame(PLame, limits), device="cpu", dtype=t_dt,
                              vertex_offset=off)
    return jb, pb, off + len(verts)


@pytest.mark.parametrize("name,off,limits", [("make_plane", 0, (0.95, 1.05)),
                                             ("matrix", 7, None), ("fast_major", 0, None)])
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_tri_batch_equal(name, off, limits, np_dt, t_dt):
    jb, pb, _ = _batches(name, off, np_dt, t_dt, limits)
    assert pb.stencil == jb.stencil and pb.n_live == jb.n_live and pb.model == jb.model
    for f in TRI_FIELDS:
        _eq(getattr(pb, f), getattr(jb, f))
    _eq(pb.bulk, jb.bulk)


def test_tri_batch_validation():
    verts, tris = _sheets()["make_plane"]
    kw = dict(device="cpu", dtype=torch.float64)
    for lo, hi in ((1.1, 1.2), (0.5, 0.9)):
        with pytest.raises(ValueError, match="strain limit"):
            p_el.build_tri_batch(verts, tris, PLame(mu=1.0, lam=1.0, limit_min=lo,
                                                    limit_max=hi), **kw)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_assembly_with_tri_family_equal(np_dt, t_dt):
    jb, pb, n = _batches("matrix", 7, np_dt, t_dt)
    masses = np.linspace(1.0, 2.0, n)
    pins = np.array([7, 8, 9])
    jp = j_el.build_pin_batch(pins, np.zeros((3, 3)), dtype=np_dt)
    pp = p_el.build_pin_batch(pins, np.zeros((3, 3)), device="cpu", dtype=t_dt)
    js = j_sys.System(masses=jnp.asarray(masses, dtype=np_dt), tets=(), tris=(jb,), pins=jp,
                      dt=1.0 / 24.0)
    ps = p_sys.System(masses=torch.as_tensor(masses).to(t_dt), tets=(), tris=(pb,), pins=pp,
                      dt=1.0 / 24.0)
    np.testing.assert_array_equal(p_asm.assemble_dense(ps), j_asm.assemble_dense(js))
    for a, b in zip(p_asm.assemble_ell(ps), j_asm.assemble_ell(js)):
        np.testing.assert_array_equal(a, b)


# --- sheet stencil ---------------------------------------------------------------------

@pytest.mark.parametrize("name,off", [("make_plane", 0), ("matrix", 7), ("fast_major", 3)])
@pytest.mark.parametrize("np_dt,t_dt,tol", [(np.float64, torch.float64, 1e-12),
                                            (np.float32, torch.float32, 1e-5)])
def test_tri_stencil_matches_jax(name, off, np_dt, t_dt, tol):
    """float32: XLA fuses the three-term sums with FMAs, PyTorch rounds each
    product; relative to max |D x| and max |D^T g|."""
    jb, pb, n = _batches(name, off, np_dt, t_dt)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((n, 3)).astype(np_dt)
    g = rng.standard_normal((6, pb.n)).astype(np_dt)
    for got, want in (
            (p_st.tri_Dx_rows(torch.as_tensor(x), pb), j_st.tri_Dx_rows(jnp.asarray(x), jb)),
            (p_st.tri_Dt_rows(torch.as_tensor(g), pb, n),
             j_st.tri_Dt_rows(jnp.asarray(g), jb, n))):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())


def test_tri_Dt_is_the_transpose_of_D_and_repeats():
    _, pb, n = _batches("matrix", 7, np.float64, torch.float64)
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((n, 3)))
    g = torch.as_tensor(rng.standard_normal((6, pb.n)))
    dx = p_st.tri_Dx_rows(x, pb)
    dead = pb.st_dead.repeat(len(pb.stencil[3])).bool()
    ident = torch.tensor([1.0, 0, 0, 1.0, 0, 0], dtype=torch.float64)[:, None]
    assert torch.equal(dx[:, dead], ident.expand(6, int(dead.sum())))
    dx_lin = dx - p_st.tri_Dx_rows(torch.zeros_like(x), pb)  # drop the dead lanes' identity
    dtg = p_st.tri_Dt_rows(g, pb, n)
    assert abs(float((dx_lin * g).sum() - (x * dtg).sum())) < 1e-9
    assert torch.equal(dtg, p_st.tri_Dt_rows(g, pb, n))
    assert torch.all(dtg[:7] == 0)


# --- wind force --------------------------------------------------------------------------

def test_color_triangles_equal():
    for _, tris in _sheets().values():
        for a, b in zip(p_forces._color_triangles(tris), j_forces._color_triangles(tris)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("colored", [False, True])
@pytest.mark.parametrize("np_dt,t_dt,tol", [(np.float64, torch.float64, 1e-12),
                                            (np.float32, torch.float32, 1e-5)])
def test_wind_project_matches_jax(colored, np_dt, t_dt, tol):
    verts, tris, masses, _ = cloth_sheet(6, 5)
    rng = np.random.default_rng(9)
    x = (verts + 0.1 * rng.standard_normal(verts.shape)).astype(np_dt)
    v = (0.2 * rng.standard_normal(verts.shape)).astype(np_dt)
    wind = (0.05, 0.1, 0.02)
    jf = j_forces.make_wind_force(tris, direction=wind, colored=colored)
    pf = p_forces.make_wind_force(tris, direction=wind, colored=colored, device="cpu",
                                  dtype=torch.float64)
    want = np.asarray(jf.project(1.0 / 24.0, jnp.asarray(x), jnp.asarray(v), None))
    got = pf.project(1.0 / 24.0, torch.as_tensor(x), torch.as_tensor(v), None)
    assert got.dtype == t_dt and want.dtype == np_dt
    assert np.abs(want - v).max() > 1e-4  # the kick is not a no-op
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    again = pf.project(1.0 / 24.0, torch.as_tensor(x), torch.as_tensor(v), None)
    assert torch.equal(got, again)


def test_wind_sequential_is_not_ported():
    _, tris, _, _ = cloth_sheet(2, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        p_forces.make_wind_force(tris, sequential=True, device="cpu", dtype=torch.float64)
