"""The port's flat-stencil D x and rhs (plain versions of kernels B and C)
against the JAX package's jnp stencil and its Pallas kernels in interpret
mode (tests/test_pallas_stencil.py's scenes and bound: f64, rtol and atol
1e-12). Inputs come from a numpy seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from admm_elastic_tpu.geometry.factory import make_tet_blocks
from admm_elastic_tpu.materials import Lame as JLame
from admm_elastic_tpu.ops import pallas_kernels, pallas_stencil
from admm_elastic_tpu.ops import stencil as j_st
from admm_elastic_tpu.system import elements as j_el
from admm_elastic_tpu_torch.materials import Lame as PLame
from admm_elastic_tpu_torch.ops import cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as p_st
from admm_elastic_tpu_torch.system import elements as p_el

torch.set_num_threads(1)

SCENES = [((5, 4, 3), 0), ((4, 2, 2), 11)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    pallas_kernels.set_pallas_mode("interpret")
    yield
    pallas_kernels.set_pallas_mode("auto")


def _batches(dims, off):
    mesh = make_tet_blocks(*dims)
    jb = j_el.build_tet_batch(mesh.vertices, mesh.tets, JLame.soft_rubber(), "neohookean",
                              vertex_offset=off, lattice_dims=mesh.lattice_dims)
    pb = p_el.build_tet_batch(mesh.vertices, mesh.tets, PLame.soft_rubber(), "neohookean",
                              device="cpu", dtype=torch.float64, vertex_offset=off,
                              lattice_dims=mesh.lattice_dims)
    return jb, pb, off + len(mesh.vertices)


@pytest.mark.parametrize("dims,off", SCENES)
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_dx_matches_jax(dims, off, ref):
    jb, pb, n = _batches(dims, off)
    x = np.random.default_rng(3).standard_normal((n, 3))
    fn = j_st.tet_Dx_rows if ref == "jnp" else pallas_stencil.tet_Dx_rows
    want = np.asarray(fn(jnp.asarray(x), jb))
    got = p_st.tet_Dx_rows_plain(torch.as_tensor(x), pb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dims,off", SCENES)
@pytest.mark.parametrize("ref", ["jnp", "pallas_interpret"])
def test_rhs_matches_jax(dims, off, ref):
    jb, pb, n = _batches(dims, off)
    rng = np.random.default_rng(4)
    t = pb.n
    z, u = rng.standard_normal((9, t)), rng.standard_normal((9, t))
    if ref == "jnp":
        w2 = (jb.weight * jb.weight)[None, :]
        want = np.asarray(j_st.tet_Dt_rows(w2 * (jnp.asarray(z) - jnp.asarray(u)), jb, n))
    else:
        want = np.asarray(pallas_stencil.tet_rhs_rows(jnp.asarray(z), jnp.asarray(u), jb, n))
    got = p_st.tet_rhs_rows_plain(torch.as_tensor(z), torch.as_tensor(u), pb, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dims,off", SCENES)
def test_dx_dead_lanes_get_identity(dims, off):
    """Dead lanes: identity F whatever x holds, even past the vertex block."""
    _, pb, n = _batches(dims, off)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((n, 3)))
    rows = p_st.tet_Dx_rows_plain(x, pb).reshape(9, 5, -1)
    dead = pb.st_dead.bool()
    eye = torch.eye(3, dtype=torch.float64).reshape(9, 1, 1)
    assert torch.equal(rows[:, :, dead], eye.expand(9, 5, int(dead.sum())))


def test_rhs_is_deterministic():
    _, pb, n = _batches((5, 4, 3), 0)
    rng = np.random.default_rng(6)
    z = torch.as_tensor(rng.standard_normal((9, pb.n)))
    u = torch.as_tensor(rng.standard_normal((9, pb.n)))
    a = p_st.tet_rhs_rows_plain(z, u, pb, n)
    b = p_st.tet_rhs_rows_plain(z, u, pb, n)
    assert torch.equal(a, b)


def test_wrappers_take_plain_versions_on_cpu():
    _, pb, n = _batches((4, 2, 2), 11)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((n, 3)))
    z, u = (torch.as_tensor(rng.standard_normal((9, pb.n))) for _ in range(2))
    before = (cuda_stencil.tet_Dx_rows.launches, cuda_stencil.tet_rhs_rows.launches)
    assert torch.equal(cuda_stencil.tet_Dx_rows(x, pb), p_st.tet_Dx_rows_plain(x, pb))
    assert torch.equal(cuda_stencil.tet_rhs_rows(z, u, pb, n),
                       p_st.tet_rhs_rows_plain(z, u, pb, n))
    assert (cuda_stencil.tet_Dx_rows.launches, cuda_stencil.tet_rhs_rows.launches) == before
