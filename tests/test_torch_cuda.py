"""Kernels A (every model), B, C, D, E and F and the beam and cloth steps on a
CUDA card, against the port's own plain versions and CPU path. This file
imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets JAX up for the
other test files). Without a card every test here skips; chip_smoke.py
runs the same comparisons at the bench shapes.
"""

import numpy as np
import pytest
import torch

from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
from admm_elastic_tpu_torch.forces import make_wind_force
from admm_elastic_tpu_torch.geometry.factory import make_plane, make_tet_blocks
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_prox, cuda_stencil, cuda_tri_local_step
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, prox_plain
from admm_elastic_tpu_torch.ops.prox import TET_MODELS
from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain
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


def local_step_inputs(t, seed, dtype, model="neohookean"):
    """tests/test_pallas.py's _random_f recipe (near-identity, every 5th
    inverted, every 7th stretched x3) as rows [9, t], with u and
    per-lane material rows mu, lam, kappa, k. The spline models get the
    compression stabiliser kappa = k / 1000, the others 0: its cubic term is
    unbounded below, and on the x3-stretched lanes (J ~ 100) a kappa above
    ~k / 100 outgrows the quadratic and the Newton iterates run away."""
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
    kappa = 1e-3 * k if model.startswith("spline") else np.zeros(t)
    return tuple(a.astype(dtype) for a in (dix, u, mu, lam, kappa, k))


def prox_inputs(t, seed, dtype, model="neohookean"):
    """The same recipe as [t, 3, 3] with mu, lam, kappa, k."""
    dix, _, mu, lam, kappa, k = local_step_inputs(t, seed, dtype, model)
    return np.ascontiguousarray(dix.T).reshape(t, 3, 3), mu, lam, kappa, k


def tri_inputs(t, seed, dtype):
    """tests/test_pallas.py:104-122's cloth recipe as rows [6, t] (identity
    3x2 plus 0.3 noise, u of 0.05, limits (0.95, 1.05) on about half the
    lanes), with the special lanes first: 0 the rest state with u = 0 (the
    (1, 0) eigenvector fallback), 1 a collapsed second column, 2 a zero F,
    3 equal column norms with a cross term (a = c, b != 0)."""
    rng = np.random.default_rng(seed)
    ident = np.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
    dix = rng.standard_normal((6, t)) * 0.3 + ident[:, None]
    u = rng.standard_normal((6, t)) * 0.05
    special = np.array([[1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                        [1.2, 0.0, 0.3, 0.0, -0.1, 0.0],
                        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                        [1.0, 0.5, 0.5, 1.0, 0.0, 0.0]]).T
    k = min(4, t)
    dix[:, :k] = special[:, :k]
    u[:, :k] = 0.0
    lm = np.where(rng.random(t) < 0.5, 0.95, -100.0)
    lx = np.where(lm > 0, 1.05, 100.0)
    return tuple(a.astype(dtype) for a in (dix, u, lm, lx))


def _assert_flip_tolerant(got, want, p99):
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        err = (g - w).abs().flatten().cpu().numpy()
        assert err.max() < A_F32_MAX and np.quantile(err, 0.99) < p99


@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_local_step_kernel_matches_plain(cuda_device, dtype, p99):
    arrs = [torch.as_tensor(a, device=cuda_device) for a in local_step_inputs(1500, 3, dtype)]
    _assert_flip_tolerant(cuda_local_step.local_step_tet_hyper(*arrs),
                          local_step_plain(*arrs), p99)


@pytest.mark.parametrize("model", [m for m in TET_MODELS if m != "neohookean"])
@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_local_step_kernel_other_models_match_plain(cuda_device, model, dtype, p99):
    arrs = [torch.as_tensor(a, device=cuda_device)
            for a in local_step_inputs(1500, 3, dtype, model)]
    _assert_flip_tolerant(cuda_local_step.local_step_tet_hyper(*arrs, model=model),
                          local_step_plain(*arrs, model=model), p99)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("t", [1, 7, 130])
@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_prox_kernels_match_plain(cuda_device, model, t, dtype, p99):
    """Kernel D for the hyperelastic models, F for the linear one."""
    zi, mu, lam, kappa, k = (torch.as_tensor(a, device=cuda_device)
                             for a in prox_inputs(t, t, dtype, model))
    if model == "linear":
        got = cuda_prox.prox_tet_linear(zi)
    else:
        got = cuda_prox.prox_tet_hyper(zi, model, mu, lam, kappa, k)
    want = prox_plain(zi, model, mu, lam, kappa, k)
    assert got.shape == (t, 3, 3)
    _assert_flip_tolerant([got], [want], p99)


@pytest.mark.parametrize("t", [4, 150, 3362])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5)])
def test_tri_local_step_kernel_matches_plain(cuda_device, t, dtype, tol):
    """Kernel E. float32: FMA contraction in the kernel against separate
    rounding in the plain ops, through one sqrt and one division."""
    arrs = [torch.as_tensor(a, device=cuda_device) for a in tri_inputs(t, t, dtype)]
    got = cuda_tri_local_step.local_step_tri(*arrs)
    again = cuda_tri_local_step.local_step_tri(*arrs)
    for g, a, w in zip(got, again, local_step_tri_plain(*arrs)):
        assert torch.isfinite(g).all() and torch.equal(g, a)
        assert (g - w).abs().max().item() <= tol


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


def _run_steps(s, dtype, steps, **settings):
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv",
                                 dtype=dtype, **settings))
    out, done = {}, 0
    for k in steps:
        s.run(k - done)
        done = k
        out[k] = s.x
    return out


def _beam_positions(device, dtype, model="neohookean", steps=(1, 8)):
    """The 4x2x2 pinned beam through the port's Solver; x after each step count."""
    mesh = make_tet_blocks(4, 2, 2)
    s = Solver(device=device)
    s.add_nodes(mesh.vertices, mesh.weighted_masses(binding.RUBBER_DENSITY))
    s.add_tet_energies(mesh.vertices, mesh.tets, Lame.soft_rubber(), model=model,
                       lattice_dims=mesh.lattice_dims)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    return _run_steps(s, dtype, steps)


def _sheet_positions(device, dtype, wind, steps=(1, 8)):
    """A 6x6 sheet pinned at its -x edge, strain-limited, through the port's
    Solver; with wind the colored and the batched force and no gravity."""
    mesh = make_plane(6, 6, size=2.0)
    lame = Lame.soft_rubber()
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s = Solver(device=device)
    binding.add_trimesh(s, mesh, lame, verbose=False)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < -2.0 + 1e-9)[0]])
    if wind:
        kw = dict(device=device, dtype=torch.float32)
        s.add_explicit_force(make_wind_force(mesh.faces, (0.05, 0.1, 0.02), colored=True, **kw))
        s.add_explicit_force(make_wind_force(mesh.faces, (0.02, 0.05, 0.01), **kw))
    return _run_steps(s, dtype, steps, gravity=0.0 if wind else -9.8)


def _assert_traj_close(got, want, dtype):
    for k, bound in zip((1, 8), TRAJ_BOUNDS[dtype]):
        assert np.isfinite(got[k]).all()
        assert np.abs(got[k] - want[k]).max() / np.abs(want[k]).max() < bound


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_matches_cpu_port(cuda_device, dtype, model):
    _assert_traj_close(_beam_positions(cuda_device, dtype, model),
                       _beam_positions("cpu", dtype, model), dtype)


@pytest.mark.parametrize("wind", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_sheet_matches_cpu_port(cuda_device, dtype, wind):
    _assert_traj_close(_sheet_positions(cuda_device, dtype, wind),
                       _sheet_positions("cpu", dtype, wind), dtype)
    assert cuda_tri_local_step.local_step_tri.launches > 0
