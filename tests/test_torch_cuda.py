"""Kernels A (every model), B, C, D, E and F, the stencil entries of A and E
(each lane computing its own D x) and the beam and cloth steps on a
CUDA card, against the port's own plain versions and CPU path; D and F also
bit for bit against A's rows entry, and on an unaligned tensor. This file
imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` leaves out tests/conftest.py, which sets JAX up for the
other test files). Without a card every test here skips; chip_smoke.py
runs the same comparisons at the bench shapes.
"""

import numpy as np
import pytest
import torch

import chip_smoke
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
# (cells, vertex offset, vertices past the family's block): the two scenes,
# one with n_verts above the block, and one whose halo (41 * 41 + 41 + 1 cell
# columns) fits no tile of kernel C, so that only its wide branch runs.
STENCIL_CASES = [(d, o, 0) for d, o in STENCIL_SCENES] + [((4, 2, 2), 11, 7), ((2, 40, 40), 5, 3)]
LANE_COUNTS = [1, 7, 31, 33, 130]  # none fills a block of 16, 32 or 64 lanes
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
@pytest.mark.parametrize("t", LANE_COUNTS)
@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_local_step_kernel_ragged_lane_counts(cuda_device, model, t, dtype, p99):
    """Kernel A at lane counts that leave a block part empty."""
    arrs = [torch.as_tensor(a, device=cuda_device)
            for a in local_step_inputs(t, t, dtype, model)]
    got = cuda_local_step.local_step_tet_hyper(*arrs, model=model)
    assert got[0].shape == (9, t) and got[1].shape == (9, t)
    _assert_flip_tolerant(got, local_step_plain(*arrs, model=model), p99)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("t", LANE_COUNTS)
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


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype,p99", [(np.float64, 1e-10), (np.float32, A_F32_P99)])
def test_prox_kernels_bitwise_against_the_rows_entry(cuda_device, model, dtype, p99):
    """Kernels D / F at a ragged 7,681 lanes: against plain, and bit for bit
    kernel A's rows entry on the same values with u = 0
    (chip_smoke.rows_entry_bits: only a zero's sign may differ, where the
    input holds a -0)."""
    zi, *params = (torch.as_tensor(a, device=cuda_device)
                   for a in prox_inputs(7681, 11, dtype, model))
    got = chip_smoke.prox_call(zi, params, model)
    assert got.shape == zi.shape
    _assert_flip_tolerant([got], [prox_plain(zi, model, *params)], p99)
    chip_smoke.rows_entry_bits(torch, got, zi, params, model, model)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_prox_kernels_on_an_unaligned_tensor(cuda_device, model, dtype):
    """A [T,3,3] tensor that starts one lane into its storage gives the bits
    of the same values at the start of their own."""
    zi, *params = (torch.as_tensor(a, device=cuda_device)
                   for a in prox_inputs(1001, 5, dtype, model))
    view, p1 = zi[1:], [p[1:].contiguous() for p in params]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = chip_smoke.prox_call(view, p1, model)
    want = chip_smoke.prox_call(view.clone(), p1, model)
    assert torch.equal(got, want) and torch.isfinite(got).all()


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


@pytest.mark.parametrize("dims,off,past", STENCIL_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_stencil_kernels_match_plain(cuda_device, dims, off, past, dtype, tol):
    """Kernel B, and kernel C by the wrapper's own choice and by each branch
    the shape can take: against plain, against each other, twice bitwise."""
    mesh = make_tet_blocks(*dims)
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                           device=cuda_device, dtype=dtype, vertex_offset=off,
                           lattice_dims=mesh.lattice_dims)
    n = off + len(mesh.vertices) + past
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.standard_normal((n, 3)), device=cuda_device, dtype=dtype)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), device=cuda_device, dtype=dtype)
            for _ in range(2))

    def close(got, want):
        scale = max(1.0, want.abs().max().item())
        return torch.isfinite(got).all() and (got - want).abs().max().item() <= tol * scale

    assert close(cuda_stencil.tet_Dx_rows(x, b), st.tet_Dx_rows_plain(x, b))
    # B sums with __fmul_rn / __fadd_rn in the plain version's order: exact.
    assert torch.equal(cuda_stencil.tet_Dx_rows(x, b), st.tet_Dx_rows_plain(x, b))
    want = st.tet_rhs_rows_plain(z, u, b, n)
    chosen = cuda_stencil.tet_rhs_rows(z, u, b, n)
    assert close(chosen, want)
    plan = cuda_stencil.rhs_plan_of(b, z.element_size())
    assert plan[0] == ("wide" if dims == (2, 40, 40) else "tiled")
    for kw in (dict(branch="wide"), dict(branch="tiled"), dict(branch="tiled", tile=7)):
        if kw["branch"] == "tiled" and plan[0] == "wide":
            with pytest.raises(ValueError, match="shared memory"):
                cuda_stencil.tet_rhs_rows(z, u, b, n, **kw)
            continue
        got = cuda_stencil.tet_rhs_rows(z, u, b, n, **kw)
        assert torch.equal(got, chosen)  # the branches agree bit for bit
        assert torch.equal(got, cuda_stencil.tet_rhs_rows(z, u, b, n, **kw))
    if past:
        assert torch.equal(chosen[n - past:], torch.zeros_like(chosen[n - past:]))


# Lattices of the stencil entry: 640 lanes at a vertex offset with vertices
# past the block, 5,120 lanes, and the bench beam's 7,680.
FUSED_LATTICES = [((4, 2, 2), 11, 7), ((5, 4, 3), 0, 0), ((40, 5, 5), 0, 0)]


@pytest.mark.parametrize("dims,off,past", FUSED_LATTICES)
@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype,p99", [(torch.float64, 1e-10), (torch.float32, A_F32_P99)])
def test_tet_stencil_entry_on_the_card(cuda_device, dims, off, past, model, dtype, p99):
    """Kernel A's stencil entry: bit for bit kernel B followed by the rows
    entry, twice the same, and within the rows entry's bounds of the plain
    composition."""
    mesh = make_tet_blocks(*dims)
    lame = Lame.soft_rubber()
    kappa = 1e-3 * lame.bulk_modulus() if model.startswith("spline") else 0.0
    b = el.build_tet_batch(mesh.vertices, mesh.tets, lame, model, device=cuda_device,
                           dtype=dtype, vertex_offset=off, kappa=kappa,
                           lattice_dims=mesh.lattice_dims)
    rng = np.random.default_rng(9)
    x_np = np.concatenate([rng.standard_normal((off, 3)),
                           mesh.vertices + 0.1 * rng.standard_normal(mesh.vertices.shape),
                           rng.standard_normal((past, 3))])
    x = torch.as_tensor(x_np, device=cuda_device, dtype=dtype)
    u = torch.as_tensor(0.05 * rng.standard_normal((9, b.n)), device=cuda_device, dtype=dtype)
    before = cuda_local_step.local_step_tet_stencil.launches
    got = cuda_local_step.local_step_tet_stencil(x, u, b)
    assert cuda_local_step.local_step_tet_stencil.launches == before + 1
    dix = cuda_stencil.tet_Dx_rows(x, b)
    two = cuda_local_step.local_step_tet_hyper(dix, u, b.mu, b.lam, b.kappa, b.bulk, model=model)
    again = b.local_step_x(x, u)
    for g, t, a in zip(got, two, again):
        assert g.shape == (9, b.n) and torch.equal(g, t) and torch.equal(g, a)
    _assert_flip_tolerant(got, local_step_plain(st.tet_Dx_rows_plain(x, b), u, b.mu, b.lam,
                                                b.kappa, b.bulk, model=model), p99)
    with pytest.raises(ValueError, match="outside x"):
        cuda_local_step.local_step_tet_stencil(x[:off + len(mesh.vertices) - 1].contiguous(),
                                               u, b)


def _sheets(device, dtype, limits):
    """(verts, TriBatch) of the 40x40 bench sheet (3,362 lanes, a last block
    part empty) and of a 6x6 make_plane sheet at vertex offset 7 (98 lanes)."""
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if limits:
        lame.limit_min, lame.limit_max = 0.95, 1.05
    nx = 40
    verts = np.array([[i, 0.0, j] for i in range(nx + 1) for j in range(nx + 1)], np.float64)
    tris = np.asarray([t for i in range(nx) for j in range(nx) for t in (
        [i * (nx + 1) + j, (i + 1) * (nx + 1) + j, i * (nx + 1) + j + 1],
        [(i + 1) * (nx + 1) + j, (i + 1) * (nx + 1) + j + 1, i * (nx + 1) + j + 1])])
    plane = make_plane(6, 6, size=2.0)
    return [(verts, 0, el.build_tri_batch(verts, tris, lame, device=device, dtype=dtype)),
            (plane.vertices, 7, el.build_tri_batch(plane.vertices, plane.faces, lame,
                                                   device=device, dtype=dtype, vertex_offset=7))]


@pytest.mark.parametrize("limits", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_sheet_stencil_entry_on_the_card(cuda_device, limits, dtype, tol):
    """Kernel E's stencil entry: bit for bit tri_Dx_rows followed by the rows
    entry, twice the same, and within the rows entry's bound of plain."""
    rng = np.random.default_rng(10)
    for verts, off, b in _sheets(cuda_device, dtype, limits):
        x_np = np.concatenate([rng.standard_normal((off, 3)),
                               verts + 0.03 * rng.standard_normal(verts.shape),
                               rng.standard_normal((3, 3))])
        x = torch.as_tensor(x_np, device=cuda_device, dtype=dtype)
        u = torch.as_tensor(0.03 * rng.standard_normal((6, b.n)), device=cuda_device, dtype=dtype)
        before = cuda_tri_local_step.local_step_tri_stencil.launches
        got = cuda_tri_local_step.local_step_tri_stencil(x, u, b)
        assert cuda_tri_local_step.local_step_tri_stencil.launches == before + 1
        dix = st.tri_Dx_rows(x, b)
        two = cuda_tri_local_step.local_step_tri(dix, u, b.limit_min, b.limit_max)
        want = local_step_tri_plain(dix, u, b.limit_min, b.limit_max)
        for g, t, a, w in zip(got, two, b.local_step_x(x, u), want):
            assert g.shape == (6, b.n) and torch.isfinite(g).all()
            assert torch.equal(g, t) and torch.equal(g, a)
            assert (g - w).abs().max().item() <= tol
        with pytest.raises(ValueError, match="outside x"):
            cuda_tri_local_step.local_step_tri_stencil(x[:off + len(verts) - 1].contiguous(), u, b)


def _run_steps(s, dtype, steps, counted=None, **settings):
    """x after each step count. run(0) first captures the step on the card;
    counted, a dict of kernel wrappers, gets each one's calls by run(0) (the
    warm-up step and the capture) and by the steps (replays, which call no
    wrapper; chip_smoke.py counts their launches on the device)."""
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, direct_mode="inv",
                                 dtype=dtype, **settings))
    before = {fn: fn.launches for fn in (counted or {})}
    s.run(0)
    captured = {fn: fn.launches - before[fn] for fn in before}
    out, done = {}, 0
    for k in steps:
        s.run(k - done)
        done = k
        out[k] = s.x
    for fn in before:
        counted[fn] = (captured[fn], fn.launches - before[fn] - captured[fn])
    return out


def _beam_positions(device, dtype, model="neohookean", steps=(1, 8), pinned=True, counted=None):
    """The 4x2x2 beam, pinned at its -x face unless told otherwise, through
    the port's Solver; x after each step count."""
    mesh = make_tet_blocks(4, 2, 2)
    s = Solver(device=device)
    s.add_nodes(mesh.vertices, mesh.weighted_masses(binding.RUBBER_DENSITY))
    s.add_tet_energies(mesh.vertices, mesh.tets, Lame.soft_rubber(), model=model,
                       lattice_dims=mesh.lattice_dims)
    if pinned:
        s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    return _run_steps(s, dtype, steps, counted)


def _sheet_positions(device, dtype, wind, steps=(1, 8), counted=None):
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
    return _run_steps(s, dtype, steps, counted, gravity=0.0 if wind else -9.8)


def _assert_traj_close(got, want, dtype):
    for k, bound in zip((1, 8), TRAJ_BOUNDS[dtype]):
        assert np.isfinite(got[k]).all()
        assert np.abs(got[k] - want[k]).max() / np.abs(want[k]).max() < bound


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_matches_cpu_port(cuda_device, dtype, model):
    _assert_traj_close(_beam_positions(cuda_device, dtype, model),
                       _beam_positions("cpu", dtype, model), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_unpinned_beam_matches_cpu_port(cuda_device, dtype):
    """Without pins a float32 system takes a refinement pass per ADMM
    iteration: A_mv, the standalone kernel B and kernel C once more."""
    counted = {cuda_stencil.tet_Dx_rows: None}
    _assert_traj_close(_beam_positions(cuda_device, dtype, pinned=False, counted=counted),
                       _beam_positions("cpu", dtype, pinned=False), dtype)
    assert counted[cuda_stencil.tet_Dx_rows] == ((20, 0) if dtype == np.float32 else (0, 0))


@pytest.mark.parametrize("wind", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_card_sheet_matches_cpu_port(cuda_device, dtype, wind):
    counted = {cuda_tri_local_step.local_step_tri_stencil: None}
    _assert_traj_close(_sheet_positions(cuda_device, dtype, wind, counted=counted),
                       _sheet_positions("cpu", dtype, wind), dtype)
    assert counted[cuda_tri_local_step.local_step_tri_stencil] == (20, 0)
