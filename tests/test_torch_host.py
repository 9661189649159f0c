"""Host arrays of the PyTorch port, bit for bit against the JAX package.

The port copies the numpy host code (mesh factory, masses, the flat-stencil
plan, element and pin batches, assembly, the f64 inverse of the direct
solve) instead of importing it. Every array it builds must equal the JAX
package's exactly, in float64 and after the float32 cast. Scenes: the
bench beam 40x5x5 (bench.py:23) and a 4x2x2 beam at vertex offset 11.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make
from admm_elastic_tpu.geometry.mesh import lumped_masses_tet as j_masses
from admm_elastic_tpu.materials import Lame as JLame
from admm_elastic_tpu.solvers import direct as j_direct
from admm_elastic_tpu.system import assembly as j_asm
from admm_elastic_tpu.system import elements as j_el
from admm_elastic_tpu.system import system as j_sys
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks as p_make
from admm_elastic_tpu_torch.geometry.mesh import lumped_masses_tet as p_masses
from admm_elastic_tpu_torch.materials import Lame as PLame
from admm_elastic_tpu_torch.solvers import direct as p_direct
from admm_elastic_tpu_torch.system import assembly as p_asm
from admm_elastic_tpu_torch.system import elements as p_el
from admm_elastic_tpu_torch.system import system as p_sys

torch.set_num_threads(1)

SCENES = [((40, 5, 5), 0), ((4, 2, 2), 11)]
DTYPES = [(np.float64, torch.float64), (np.float32, torch.float32)]
TET_FIELDS = ("inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa",
              "st_dl", "st_par", "st_dead")


def _eq(p, j):
    a = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    b = np.asarray(j)
    assert a.shape == b.shape
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _scene(dims, off, np_dt, t_dt):
    """Both packages' System for one beam at vertex offset `off`, its -x
    face pinned, 11 leading vertices of extra mass when off > 0."""
    jm, pm = j_make(*dims), p_make(*dims)
    n = off + len(jm.vertices)
    masses = np.concatenate([np.ones(off), j_masses(jm.vertices, jm.tets, 1522.0)])
    pins = np.where(jm.vertices[:, 0] < 1e-9)[0] + off
    tgts = np.concatenate([np.zeros((off, 3)), jm.vertices])[pins] + 0.25
    jb = j_el.build_tet_batch(jm.vertices, jm.tets, JLame.soft_rubber(), "neohookean",
                              vertex_offset=off, dtype=np_dt, lattice_dims=jm.lattice_dims)
    pb = p_el.build_tet_batch(pm.vertices, pm.tets, PLame.soft_rubber(), "neohookean",
                              device="cpu", dtype=t_dt, vertex_offset=off,
                              lattice_dims=pm.lattice_dims)
    jp = j_el.build_pin_batch(pins, tgts, dtype=np_dt)
    pp = p_el.build_pin_batch(pins, tgts, device="cpu", dtype=t_dt)
    js = j_sys.System(masses=jnp.asarray(masses, dtype=np_dt), tets=(jb,), tris=(),
                      pins=jp, dt=1.0 / 24.0)
    ps = p_sys.System(masses=torch.as_tensor(masses).to(t_dt), tets=(pb,), pins=pp,
                      dt=1.0 / 24.0)
    assert n == ps.n_verts == js.n_verts
    return js, ps


@pytest.mark.parametrize("dims", [(40, 5, 5), (4, 2, 2)])
def test_mesh_and_masses_equal(dims):
    jm, pm = j_make(*dims), p_make(*dims)
    np.testing.assert_array_equal(pm.vertices, jm.vertices)
    np.testing.assert_array_equal(pm.tets, jm.tets)
    assert pm.lattice_dims == jm.lattice_dims
    np.testing.assert_array_equal(p_masses(pm.vertices, pm.tets, 1522.0),
                                  j_masses(jm.vertices, jm.tets, 1522.0))
    np.testing.assert_array_equal(pm.surface_inds(), jm.surface_inds())


@pytest.mark.parametrize("dims,off", SCENES)
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_tet_and_pin_batches_equal(dims, off, np_dt, t_dt):
    js, ps = _scene(dims, off, np_dt, t_dt)
    jb, pb = js.tets[0], ps.tets[0]
    assert pb.stencil == jb.stencil and pb.n_live == jb.n_live
    for f in TET_FIELDS:
        _eq(getattr(pb, f), getattr(jb, f))
    _eq(pb.bulk, jb.bulk)
    _eq(ps.pins.idx, np.asarray(js.pins.idx).astype(np.int64))
    for f in ("target", "active", "weight"):
        _eq(getattr(ps.pins, f), getattr(js.pins, f))
    _eq(ps.masses, js.masses)


@pytest.mark.parametrize("dims,off", SCENES)
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_assembly_and_direct_prepare_equal(dims, off, np_dt, t_dt):
    js, ps = _scene(dims, off, np_dt, t_dt)
    A = p_asm.assemble_dense(ps)
    np.testing.assert_array_equal(A, j_asm.assemble_dense(js))
    pc, pv, pd = p_asm.assemble_ell(ps)
    jc, jv, jd = j_asm.assemble_ell(js)
    idx = ps.pins.idx.numpy()
    for a, b in ((pc, jc), (pv, jv), (pd, jd)):
        np.testing.assert_array_equal(a[idx], b[idx])
    pin_rows = (idx, pc[idx], pv[idx], pd[idx])
    pdata = p_direct.prepare(A, device="cpu", dtype=t_dt, mode="inv", pin_rows=pin_rows)
    jdata = j_direct.prepare(A, np_dt, mode="inv", pin_rows=pin_rows)
    for f in ("mat", "scale", "pin_vals", "pin_diag"):
        _eq(getattr(pdata, f), getattr(jdata, f))
    for f in ("pin_idx", "pin_cols"):
        np.testing.assert_array_equal(getattr(pdata, f).numpy(), np.asarray(getattr(jdata, f)))
