"""The PCG global step's host code and plain versions against the JAX package,
on the CPU: vertex_adjacency, greedy_aggregates and coarse_matrix on the
graphs of the four PCG paths and crossval's scenes; plan_bands on a lattice,
a ring (circular bands), a renumbered beam (RCM) and the bunny, bit for bit;
every array of pcg.prepare (Jacobi and two-grid, every spmv_format) in
float64 against np.asarray of the JAX PCGData; apply_T and precondition_T;
the plain solve_T against the JAX solve_T on the same b and x0; and kernel
G's plan (ops/cuda_pcg.py: the banded order, the remapped two-grid tables)
walked in plain PyTorch. The JAX side runs op by op or through one small
while_loop per scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import spmv as jspmv
from admm_elastic_tpu.solvers import pcg as jpcg
from admm_elastic_tpu.system import assembly as jasm
from admm_elastic_tpu_torch.ops import cuda_pcg
from admm_elastic_tpu_torch.ops import spmv as tspmv
from admm_elastic_tpu_torch.solvers import pcg as tpcg
from admm_elastic_tpu_torch.system import assembly as tasm

torch.set_num_threads(1)

PLAN_FIELDS = ("offsets", "bands", "rest_cols", "rest_vals", "perm", "iperm", "coverage",
               "circular")
PCG_FIELDS = ("ell_cols", "ell_vals", "diag_mass", "diag_stiff", "diag_pin", "agg",
              "agg_gather", "coarse_inv", "bands", "perm", "iperm")
SMALL = ("beam_pcg", "torus_pcg", "bunny_pcg")


def _scene(name, dtype=None):
    """The port's solver of chip_smoke.PCG_SCENES[name] on the CPU."""
    chip_smoke.DEVICE = "cpu"
    solver, _ = chip_smoke.pcg_scene(name, chip_smoke.torch_api("cpu"))
    return solver


@pytest.fixture(scope="module")
def small():
    return {n: _scene(n) for n in SMALL}


@pytest.mark.parametrize("name", list(chip_smoke.PCG_PATHS) + ["beam_pcg", "torus_pcg"])
def test_aggregation_is_the_jax_package_s(name):
    """vertex_adjacency and coarse_matrix on one system, and greedy_aggregates
    against what the JAX package returns (its native library where it loads)."""
    system = _scene(name).system
    adj = tasm.vertex_adjacency(system)
    jadj = jasm.vertex_adjacency(system)
    assert len(adj) == len(jadj) == system.n_verts
    assert all(np.array_equal(a, b) for a, b in zip(adj, jadj))
    agg = tasm.greedy_aggregates(adj)
    jagg = jasm.greedy_aggregates(jadj)
    assert agg.dtype == np.int32 and np.array_equal(agg, np.asarray(jagg))
    if system.n_verts < 10000:  # the dense coarse matrix of the full-size paths is large
        assert np.array_equal(tasm.coarse_matrix(system, agg), jasm.coarse_matrix(system, agg))


def _renumbered_beam_ell():
    from admm_elastic_tpu_torch.ops import reduction  # noqa: F401

    system = _scene("beam_pcg").system
    cols, vals, _ = tasm.assemble_ell(system)
    n = cols.shape[0]
    perm = np.random.default_rng(5).permutation(n)
    inv = np.argsort(perm)
    live = vals != 0
    return np.where(live, inv[cols], 0)[perm].astype(np.int32), vals[perm]


@pytest.mark.parametrize("which", ["lattice", "ring", "renumbered", "bunny"])
def test_plan_bands_is_the_jax_package_s(small, which):
    if which == "renumbered":
        cols, vals = _renumbered_beam_ell()
    else:
        name = {"lattice": "beam_pcg", "ring": "torus_pcg", "bunny": "bunny_pcg"}[which]
        cols, vals, _ = tasm.assemble_ell(small[name].system)
    p, q = tspmv.plan_bands(cols, vals), jspmv.plan_bands(cols, vals)
    for f in PLAN_FIELDS:
        a, b = getattr(p, f), getattr(q, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f
    assert p.circular == (which == "ring")
    assert (p.perm is not None) == (which in ("renumbered", "bunny"))
    x = np.random.default_rng(6).standard_normal((cols.shape[0], 3))
    assert np.array_equal(tspmv.apply_bands_ref(p, x), jspmv.apply_bands_ref(q, x))


def _jax_system(name):
    """The JAX package's system of a scene, built by its own Solver.initialize."""
    solver, _ = chip_smoke.pcg_scene(name, _jax_api())
    return solver


def _jax_api():
    import types

    from admm_elastic_tpu import Lame, Settings, Solver, binding
    from admm_elastic_tpu.geometry.factory import make_tet_blocks, make_tet_torus
    from admm_elastic_tpu.geometry.io import load_elenode

    return types.SimpleNamespace(Solver=Solver, Settings=Settings, Lame=Lame, binding=binding,
                                 make_tet_blocks=make_tet_blocks, make_tet_torus=make_tet_torus,
                                 load_elenode=load_elenode)


@pytest.fixture(scope="module")
def jax_small():
    return {n: _jax_system(n) for n in SMALL}


@pytest.mark.parametrize("fmt", ["auto", "bands", "ell"])
@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("name", SMALL)
def test_prepare_is_the_jax_package_s_in_float64(small, jax_small, name, precond, fmt):
    got = tpcg.prepare(small[name].system, torch.float64, precond=precond, spmv_format=fmt)
    want = jpcg.prepare(jax_small[name].system, jnp.float64, precond=precond, spmv_format=fmt)
    for f in PCG_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), f
    assert got.band_offsets == want.band_offsets
    assert got.band_circular == want.band_circular


def _ops(data_t, data_j, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, data_t.n))
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    xt, xj = torch.as_tensor(x, dtype=dtype), jnp.asarray(x, jd)
    return [(data_t.apply_T(xt), data_j.apply_T(xj)),
            (data_t.precondition_T()(xt), data_j.precondition_T()(xj)),
            (data_t.apply(xt.T), data_j.apply(xj.T))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("fmt", ["auto", "bands", "ell"])
@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("name", ["torus_pcg", "bunny_pcg"])
def test_operators_match_the_jax_package(small, jax_small, name, precond, fmt, dtype):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    dt = tpcg.prepare(small[name].system, dtype, precond=precond, spmv_format=fmt)
    dj = jpcg.prepare(jax_small[name].system, jd, precond=precond, spmv_format=fmt)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    for a, b in _ops(dt, dj, dtype, 7):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= tol * np.abs(b).max()


def test_scale_and_unknown_options_raise(small, jax_small):
    """A stiffness scale (scenario batching) scales the operator as the JAX
    package's diag(scale) and apply(scale) do; unknown options raise."""
    system = small["beam_pcg"].system
    data = tpcg.prepare(system, torch.float64)
    want = jpcg.prepare(jax_small["beam_pcg"].system, jnp.float64)
    x = np.random.default_rng(8).standard_normal((data.n, 3))
    for got, ref in ((data.diag(scale=2.0), want.diag(scale=2.0)),
                     (data.apply(torch.as_tensor(x), scale=2.0),
                      want.apply(jnp.asarray(x), scale=2.0))):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(ValueError, match="spmv_format"):
        tpcg.prepare(system, torch.float64, spmv_format="dia")
    with pytest.raises(ValueError, match="preconditioner"):
        tpcg.prepare(system, torch.float64, precond="ilu")


def _first_solve(solver):
    chip_smoke.DEVICE = "cpu"
    return chip_smoke.first_solve(torch, solver)


# The plain solve_T against the JAX solve_T on a step's first solve (tol
# 1e-10, 200 trips), relative to max |x|, measured on the CPU: float32 beam
# 4.0e-8, torus 1.8e-7 (Jacobi and two-grid, equal trips); float64 at most
# 3.3e-16 in equal trips. The pin-stiffened bunny (diagonal ratios of ~1e5)
# carries the two packages' sum orders through its Krylov iteration
# (benchmarks/crossval.py:277-287): float64 1.7e-8 (Jacobi) and 3.2e-11
# (two-grid) in equal trips, float32 1.4e-2 in 67 against 65 trips (Jacobi)
# and 2.0e-3 (two-grid); there x is held at about six times that, and in
# float64 both solutions to the solve's criterion as well: a true residual
# |b - A x| / |b| within twice the tolerance.
F32_SOLVE_TOL = {"beam_pcg": 2e-6, "torus_pcg": 2e-6, "bunny_pcg": 0.1}
F64_SOLVE_TOL = {"beam_pcg": 1e-10, "torus_pcg": 1e-10, "bunny_pcg": 1e-7}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("name", SMALL)
def test_plain_solve_T_matches_the_jax_solve_T(small, jax_small, name, precond, dtype):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    b, x0 = _first_solve(small[name])
    b, x0 = b.to(dtype), x0.to(dtype)
    dt = tpcg.prepare(small[name].system, dtype, precond=precond)
    dj = jpcg.prepare(jax_small[name].system, jd, precond=precond)
    tol = 1e-10
    x, k = tpcg.solve_T(dt.apply_T, dt.precondition_T(), b, x0, tol, 200)
    xj, kj = jpcg.solve_T(dj.apply_T, dj.precondition_T(), jnp.asarray(b.numpy()),
                          jnp.asarray(x0.numpy()), jnp.asarray(tol, jd), 200)
    xj = np.asarray(xj)
    err = np.abs(x.numpy() - xj).max() / np.abs(xj).max()
    if dtype == torch.float64:
        assert k == int(kj) and err <= F64_SOLVE_TOL[name]
        for sol in (x, torch.as_tensor(xj)):
            res = torch.linalg.norm(b - dt.apply(sol)) / torch.linalg.norm(b)
            assert res <= 2 * tol
    else:
        assert abs(k - int(kj)) <= max(2, 0.1 * int(kj)) and err <= F32_SOLVE_TOL[name]


def test_plain_solve_takes_a_jacobi_diagonal_and_stops_at_once(small):
    s = small["beam_pcg"]
    b, x0 = _first_solve(s)
    data = tpcg.prepare(s.system, torch.float64)
    b, x0 = b.double(), x0.double()
    x1, k1 = tpcg.solve(data.apply, data.diag(), b, x0, 1e-10, 200)
    x2, k2 = tpcg.solve_T(data.apply_T, data.precondition_T(), b, x0, 1e-10, 200)
    assert k1 == k2 > 0 and torch.allclose(x1, x2, rtol=1e-12, atol=1e-12)
    # an exact start takes no trip; max_iters caps the trips
    assert tpcg.solve(data.apply, data.diag(), b, x1, 1e-3, 200)[1] == 0
    assert tpcg.solve(data.apply, data.diag(), b, x0, 1e-10, 3)[1] == 3


def g_walk(data, b, x0, tol, max_iters):
    """Kernel G's solve in plain PyTorch as csrc/pcg.cu runs it: in the banded
    order of its plan (cuda_pcg.plan_of), b and x0 read through perm, the
    two-grid tables remapped, x written back through perm."""
    plan = cuda_pcg._build_plan(data)
    perm = plan.perm
    n = data.n

    def spmv(v):
        out = plan.diag[:, None] * v
        acc = torch.zeros_like(v)
        for d, o in enumerate(data.band_offsets):
            q = torch.arange(n) + o
            if data.band_circular:
                q = q % n
            ok = (q >= 0) & (q < n)
            acc[ok] += plan.bands[d][ok, None] * v[q[ok]]
        for k in range(plan.rest_cols.shape[0]):  # column-major
            acc += plan.rest_vals[k, :, None] * v[plan.rest_cols[k].long()]
        return out + acc

    inv_d = plan.inv_d[:, None]

    def precond(r):
        if plan.agg is None:
            return inv_d * r
        z = cuda_pcg.OMEGA * inv_d * r
        res = r - spmv(z)
        ext = torch.cat([res, res.new_zeros((1, 3))])
        rc = ext[plan.agg_gather.long()].sum(dim=1)
        z2 = z + (plan.coarse_inv @ rc)[plan.agg.long()]
        return z2 + cuda_pcg.OMEGA * inv_d * (r - spmv(z2))

    bb = b if perm is None else b[perm]
    xb = x0 if perm is None else x0[perm]
    xb, k = tpcg.solve(spmv, precond, bb, xb, tol, max_iters)
    out = torch.empty_like(xb)
    if perm is None:
        return xb, k
    out[perm] = xb
    return out, k


@pytest.mark.parametrize("fmt", ["auto", "bands", "ell"])
@pytest.mark.parametrize("precond", ["jacobi", "twogrid"])
@pytest.mark.parametrize("name", SMALL)
def test_the_kernel_plan_solves_what_solve_T_solves(small, name, precond, fmt):
    s = small[name]
    b, x0 = (t.double() for t in _first_solve(s))
    data = tpcg.prepare(s.system, torch.float64, precond=precond, spmv_format=fmt)
    x, k = g_walk(data, b, x0, 1e-10, 200)
    want, kw = tpcg.solve_T(data.apply_T, data.precondition_T(), b, x0, 1e-10, 200)
    err = (x - want).abs().max() / want.abs().max()
    if name == "bunny_pcg":  # the RCM order moves it: 141 trips against 143, 1.3e-7
        assert abs(k - kw) <= 2 and err <= chip_smoke.PCG_F64_TOL_BUNNY
    else:
        assert k == kw and err <= 1e-10


def test_pcg_solve_adds_its_trips_on_the_cpu(small):
    s = small["torus_pcg"]
    b, x0 = _first_solve(s)
    data = s._solve_data
    trips = torch.tensor([5], dtype=torch.int32)
    before = cuda_pcg.pcg_solve.launches
    x = cuda_pcg.pcg_solve(data, b, x0, 1e-6, 60, trips)
    want, k = tpcg.solve_T(data.apply_T, data.precondition_T(), b, x0, 1e-6, 60)
    assert torch.equal(x, want) and int(trips) == 5 + k and k > 0
    assert cuda_pcg.pcg_solve.launches == before


def test_tolerance_clamps_to_the_dtype_floor():
    for dtype, want in ((torch.float32, 64 * torch.finfo(torch.float32).eps), (torch.float64, 1e-6)):
        b = torch.ones((4, 3), dtype=dtype)
        tol2 = tpcg._tolerance(b, 1e-6 if dtype == torch.float64 else 1e-10, (b * b).sum())
        assert torch.isclose(tol2, torch.tensor(want * want * 12.0, dtype=dtype))
    assert jax.config.jax_enable_x64  # the JAX side of this file runs in float64 by default


def test_float32_bunny_solve_is_as_accurate_as_the_jax_package_s(small, jax_small):
    """The bunny's float32 solves part by 1e-2 of max |x| between the two
    packages (chip_smoke.PCG_STEP_TOL): each lands within its clamped
    tolerance's reach of the exact solution, the port's no further from it
    than the JAX package's (measured 1.4e-2 against 2.2e-2)."""
    s = small["bunny_pcg"]
    b, x0 = _first_solve(s)
    d64 = tpcg.prepare(s.system, torch.float64)
    exact, _ = tpcg.solve_T(d64.apply_T, d64.precondition_T(), b.double(), x0.double(), 1e-14,
                            5000)
    dt = tpcg.prepare(s.system, torch.float32)
    dj = jpcg.prepare(jax_small["bunny_pcg"].system, jnp.float32)
    x, _ = tpcg.solve_T(dt.apply_T, dt.precondition_T(), b, x0, 1e-10, 200)
    xj, _ = jpcg.solve_T(dj.apply_T, dj.precondition_T(), jnp.asarray(b.numpy()),
                         jnp.asarray(x0.numpy()), jnp.asarray(1e-10, jnp.float32), 200)
    scale = exact.abs().max().item()
    err = (x.double() - exact).abs().max().item() / scale
    err_j = np.abs(np.asarray(xj, np.float64) - exact.numpy()).max() / scale
    assert err <= 2 * err_j and err_j < 0.1
