"""Kernels A, B and C and the slice on a CUDA card, against the port's own
plain versions and CPU path. This file imports no JAX, so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets JAX up for the
other test files). Without a card every test here skips; chip_smoke.py
runs the same comparisons at the bench shapes.
"""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
from admm_elastic_tpu_torch.system import elements as el

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

# Kernel A in float32: the flip-tolerant bounds of test_torch_local_step.py.
A_F32_MAX, A_F32_P99 = 5e-2, 2e-4
STENCIL_SCENES = [((5, 4, 3), 0), ((4, 2, 2), 11)]
# Trajectory bounds relative to max |x|, after 1 and 8 steps.
TRAJ_BOUNDS = {np.float32: (1e-4, 2e-3), np.float64: (1e-9, 1e-9)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def local_step_inputs(t, seed, dtype):
    """tests/test_pallas.py's _random_f recipe (near-identity, every 5th
    inverted, every 7th stretched x3) as rows [9, t], with u and
    per-lane material rows mu, lam, kappa, k."""
    rng = np.random.default_rng(seed)
    f = np.eye(3)[None] + 0.4 * rng.standard_normal((t, 3, 3))
    f[::5] *= -1.0
    f[1::7] *= 3.0
    rng = np.random.default_rng(seed + 1000)
    dix = f.reshape(t, 9).T.copy()
    u = 0.05 * rng.standard_normal((9, t))
    mu = rng.uniform(1e4, 1e6, t)
    lam = rng.uniform(1e4, 1e6, t)
    k = lam + (2.0 / 3.0) * mu
    return tuple(a.astype(dtype) for a in (dix, u, mu, lam, np.zeros(t), k))


@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_local_step_kernel_matches_plain(cuda_device, dtype, p99):
    arrs = [torch.as_tensor(a, device=cuda_device) for a in local_step_inputs(1500, 3, dtype)]
    got = cuda_local_step.local_step_tet_hyper(*arrs)
    want = local_step_plain(*arrs)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().flatten().cpu().numpy()
        assert err.max() < A_F32_MAX and np.quantile(err, 0.99) < p99


@pytest.mark.parametrize("dims,off", STENCIL_SCENES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_stencil_kernels_match_plain(cuda_device, dims, off, dtype, tol):
    mesh = make_tet_blocks(*dims)
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                           device=cuda_device, dtype=dtype, vertex_offset=off,
                           lattice_dims=mesh.lattice_dims)
    n = off + len(mesh.vertices)
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((n, 3)), device=cuda_device, dtype=dtype)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), device=cuda_device, dtype=dtype)
            for _ in range(2))
    for got, want in ((cuda_stencil.tet_Dx_rows(x, b), st.tet_Dx_rows_plain(x, b)),
                      (cuda_stencil.tet_rhs_rows(z, u, b, n), st.tet_rhs_rows_plain(z, u, b, n))):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol * scale
    assert torch.equal(cuda_stencil.tet_rhs_rows(z, u, b, n),
                       cuda_stencil.tet_rhs_rows(z, u, b, n))


def _beam_positions(device, dtype, steps=(1, 8)):
    """The 4x2x2 pinned beam through the port's Solver; x after each step count."""
    mesh = make_tet_blocks(4, 2, 2)
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    s = Solver(device=device)
    binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv",
                                 dtype=dtype))
    out, done = {}, 0
    for k in steps:
        s.run(k - done)
        done = k
        out[k] = s.x
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_matches_cpu_port(cuda_device, dtype):
    got = _beam_positions(cuda_device, dtype)
    want = _beam_positions("cpu", dtype)
    for k, bound in zip((1, 8), TRAJ_BOUNDS[dtype]):
        assert np.isfinite(got[k]).all()
        assert np.abs(got[k] - want[k]).max() / np.abs(want[k]).max() < bound
