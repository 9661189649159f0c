"""Uzawa's Schur trip (ops/cuda_uzawa.py, csrc/uzawa.cu) on the CPU:

- fixed_dot, the order of kernel M's four dots, bit for bit a numpy loop in
  the same order (each product in the run's dtype, element i to partial i
  mod 1,024 from +0 and the pairwise tree in float64, the sum rounded once) at
  lengths around the partials' count and at floor_uzawa67k's 2H;
- kernel L's full C^T as the kernel walks it (a vertex its slot's passive and
  dynamic own terms, then its face corners in table order) and its twin
  ct_plain, both torch.equal to constraints.Ct_apply, dense and not, with and
  without dynamic rows;
- kernel M's update as the kernel walks it (its q3 rows, each dot's partials
  by thread, the trees) torch.equal to its twin schur_trip_plain, and a trip
  after done leaving x, y, r, d, k and done as they were;
- uzawa.solve, through the wrappers' twins, against the JAX package's
  uzawa.solve: the floor scenes around the direct and the PCG inner, float64
  and float32, and the two stacked boxes past their first dynamic rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contact import _both, _hits, _landed, _rel
from test_torch_selfcollision_paths import stack_scene

from admm_elastic_tpu import solver as jsolver_mod
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.solver import _detect as j_detect
from admm_elastic_tpu.solver import _make_apply_Ainv
from admm_elastic_tpu.solvers import uzawa as juzawa
from admm_elastic_tpu_torch.collision import constraints as tcon
from admm_elastic_tpu_torch.ops import cuda_uzawa
from admm_elastic_tpu_torch.solvers import pcg as tpcg
from admm_elastic_tpu_torch.solvers import uzawa as tuzawa
from admm_elastic_tpu_torch.system import system as sysm

torch.set_num_threads(1)
F64 = torch.float64
PARTS = cuda_uzawa.PARTS


@pytest.fixture(autouse=True, scope="module")
def _default_svd_after_the_module():
    """_both sets the JAX package's Jacobi SVD (module state); the default
    goes back after the module, as in tests/test_torch_contact.py."""
    yield
    jprox.set_svd_impl("auto")


# --- the dots' order ---------------------------------------------------------------

def numpy_tree(part):
    """Kernel M's pairwise tree over the 1,024 float64 partials, one numpy
    scalar operation at a time: partial t plus partial t + 512, then + 256,
    ..., + 1."""
    part = list(part)
    half = PARTS // 2
    while half:
        part[:half] = [part[t] + part[t + half] for t in range(half)]
        half //= 2
    return part[0]


def numpy_dot(a, b):
    """sum(a * b) in kernel M's order, one numpy scalar operation at a time:
    each product in a's dtype, the partials and the tree in float64, the sum
    rounded to a's dtype."""
    part = np.zeros(PARTS, dtype=np.float64)
    for i in range(a.shape[0]):
        part[i % PARTS] = part[i % PARTS] + np.float64(a[i] * b[i])
    return a.dtype.type(numpy_tree(part))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 31232])
def test_fixed_dot_is_the_numpy_loop_in_its_order(n, dtype):
    """fixed_dot bit for bit the numpy loop, on values spread over 16
    decades with zeros, negative zeros and signs mixed, so that another
    order would round otherwise."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)).astype(dtype)
    b = rng.standard_normal(n).astype(dtype)
    a[rng.random(n) < 0.1] = 0.0
    b[rng.random(n) < 0.1] = -0.0
    got = cuda_uzawa.fixed_dot(torch.as_tensor(a), torch.as_tensor(b))
    want = numpy_dot(a, b)
    assert got.shape == () and got.dtype == torch.as_tensor(a).dtype
    assert got.numpy().tobytes() == np.asarray(want, dtype).tobytes()


# --- kernel L: the full C^T --------------------------------------------------------

def slot_of(hits, n):
    slots = torch.full((n,), -1, dtype=torch.int32)
    slots[hits.p_vidx] = torch.arange(hits.capacity, dtype=torch.int32)
    return slots


def l_walk(hits, ck, y, n, slots):
    """C^T y as uzawa_ct_kernel computes it, a vertex at a time."""
    h = hits.capacity
    out = torch.zeros((n, 3), dtype=y.dtype)
    for v in range(n):
        s = v if slots is None else int(slots[v])
        acc = torch.zeros(3, dtype=y.dtype)
        if s >= 0:
            cp = ck * (y[s] if hits.p_mask[s] else torch.zeros((), dtype=y.dtype))
            acc = cp * hits.p_normal[s]
            if hits.may_dyn:
                cd = ck * (y[h + s] if hits.d_mask[s] else torch.zeros((), dtype=y.dtype))
                acc = acc + cd * hits.d_normal[s]
        if hits.may_dyn:
            for e in range(int(hits.d_start[v]), int(hits.d_start[v + 1])):
                ident = int(hits.d_order[e])
                r = ident // 3
                yr = y[h + r] if hits.d_mask[r] else torch.zeros((), dtype=y.dtype)
                t = -(ck * yr) * hits.d_barys.reshape(-1)[ident]
                acc = acc + t * hits.d_normal[r]
        out[v] = acc
    return out


@pytest.mark.parametrize("may_dyn", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_ct_walk_and_twin_are_ct_apply(dense, may_dyn):
    """Kernel L's walk and its twin ct_plain torch.equal to Ct_apply on
    random deduped hits with their table, y with its inactive rows set (the
    masks must zero them), float64 and float32."""
    rng = np.random.default_rng(11 + 2 * dense + may_dyn)
    n = 40
    th, _ = _hits(rng, n, dense, may_dyn)
    for dtype in (F64, torch.float32):
        h = dataclasses.replace(th.dedup(), **{f: getattr(th, f).to(dtype) for f in (
            "p_normal", "p_point", "d_barys", "d_normal")})
        h = tcon.with_table(h, n)
        ck = torch.tensor(7.5, dtype=dtype)
        y = torch.as_tensor(rng.standard_normal(2 * h.capacity), dtype=dtype)
        want = tcon.Ct_apply(h, ck, y[:h.capacity], y[h.capacity:], n)
        slots = None if dense else slot_of(h, n)
        assert torch.equal(cuda_uzawa.ct_plain(h, ck, y, n), want)
        assert torch.equal(cuda_uzawa.ct_apply(h, ck, y, n, slots), want)
        assert torch.equal(l_walk(h, ck, y, n, slots), want)
        assert cuda_uzawa.ct_apply.launches == 0


# --- kernel M: the trip's update ---------------------------------------------------

def m_walk(hits, ck, q2, x, y, r, d, k, done, tiny, tol2, threads=PARTS):
    """schur_trip_kernel's update in plain PyTorch: q3 a row at a time by the
    kernel's formulas, each dot's partials as `threads` threads hold them
    (thread t the rows t, t + threads, ...), the pairwise tree; None where
    done is set (the kernel returns at once)."""
    if bool(done):
        return None
    h = hits.capacity
    zero = torch.zeros((), dtype=q2.dtype)
    q3 = torch.zeros(2 * h, dtype=q2.dtype)
    for i in range(2 * h):
        if i < h:
            if hits.p_mask[i]:
                nr, q = hits.p_normal[i], q2[hits.p_vidx[i]]
                q3[i] = ck * ((nr[0] * q[0] + nr[1] * q[1]) + nr[2] * q[2])
        elif hits.may_dyn and hits.d_mask[i - h]:
            rr = i - h
            b, f = hits.d_barys[rr], hits.d_face[rr]
            fp = (b[0] * q2[f[0]] + b[1] * q2[f[1]]) + b[2] * q2[f[2]]
            diff, nr = q2[hits.d_vidx[rr]] - fp, hits.d_normal[rr]
            q3[i] = ck * ((nr[0] * diff[0] + nr[1] * diff[1]) + nr[2] * diff[2])

    def tree(part):
        return torch.as_tensor(numpy_tree(part.numpy())).to(q2.dtype)

    def partials(a, b):
        part = torch.zeros(threads, dtype=torch.float64)
        for t in range(threads):
            for i in range(t, a.shape[0], threads):
                part[t] = part[t] + (a[i] * b[i]).double()
        return part

    denom, dr = tree(partials(d, q3)), tree(partials(d, r))
    bad = bool(torch.abs(denom) < tiny)
    alpha = zero if bad else dr / denom
    r_n = r - alpha * q3
    y_n = y + alpha * d
    x_n = x - alpha * q2
    rr_, rq = tree(partials(r_n, r_n)), tree(partials(r_n, q3))
    beta = zero if bad else rq / denom
    return (x_n, y_n, r_n, r_n - beta * d, k + 1,
            torch.tensor(bad or bool(rr_ < tol2)))


def trip_inputs(rng, n, dense, may_dyn, dtype):
    th, _ = _hits(rng, n, dense, may_dyn)
    h = dataclasses.replace(th.dedup(), **{f: getattr(th, f).to(dtype) for f in (
        "p_normal", "p_point", "d_barys", "d_normal")})
    h = tcon.with_table(h, n)
    m = 2 * h.capacity
    t = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=dtype)  # noqa: E731
    active = torch.cat([h.p_mask, h.d_mask])
    r = torch.where(active, t(m), 0.0)
    return h, torch.tensor(7.5, dtype=dtype), t(n, 3), t(n, 3), t(m), r, r + 0.25 * t(m)


@pytest.mark.parametrize("may_dyn", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_trip_walk_is_the_twin_and_done_keeps_the_state(dense, may_dyn):
    """Kernel M's walk torch.equal to schur_trip_plain in float64 and
    float32, on 1,100 vertices (2H past one row of partials where the set is
    dense); then, with done set, the twin (and the wrapper on the CPU)
    returns x, y, r, d, k and done bit for bit."""
    rng = np.random.default_rng(21 + 2 * dense + may_dyn)
    n = 1100
    for dtype, fi in ((F64, np.finfo(np.float64)), (torch.float32, np.finfo(np.float32))):
        hits, ck, q2, x, y, r, d = trip_inputs(rng, n, dense, may_dyn, dtype)
        tiny, tol2 = float(fi.tiny), float(fi.dtype.type(1e-3) ** 2)
        k = torch.tensor(3, dtype=torch.int32)
        done = torch.tensor(False)
        got = cuda_uzawa.schur_trip(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)
        want = m_walk(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int(got[4]) == 4 and cuda_uzawa.schur_trip.launches == 0
        done = torch.tensor(True)
        same = cuda_uzawa.schur_trip(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)
        for a, b in zip(same, (x, y, r, d, k, done)):
            assert torch.equal(a, b)
        assert m_walk(hits, ck, q2, x, y, r, d, k, done, tiny, tol2) is None


def test_a_bad_denominator_freezes_the_trip():
    """Where d.q3 is under tiny (q2 = 0: every row of q3 is 0), alpha and
    beta are 0: x, y and r keep their values, d becomes r, k counts the
    trip and done is set, in the twin and the walk alike."""
    rng = np.random.default_rng(5)
    hits, ck, q2, x, y, r, d = trip_inputs(rng, 60, True, True, F64)
    q2 = torch.zeros_like(q2)
    k, done = torch.tensor(0, dtype=torch.int32), torch.tensor(False)
    got = cuda_uzawa.schur_trip_plain(hits, ck, q2, x, y, r, d, k, done, 1e-300, 1e-20)
    want = m_walk(hits, ck, q2, x, y, r, d, k, done, 1e-300, 1e-20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0], x) and torch.equal(got[1], y) and torch.equal(got[2], r)
    assert torch.equal(got[3], r) and int(got[4]) == 1 and bool(got[5])


# --- uzawa.solve against the JAX package -------------------------------------------

@pytest.mark.parametrize("name", ["contact_uzawa_f64", "contact_uzawa_pcg_f64", "contact_uzawa",
                                  "contact_uzawa_pcg"])
def test_uzawa_solve_is_the_jax_package_s(name):
    """uzawa.solve through the trip's twins (fixed_dot's order) from a landed
    state on the hits of a position 5 cm into the floor, against the JAX
    package's (jnp.sum's order): float64 in the same trips with x and y
    within 1e-10 (tests/test_torch_contact.py), float32 within F32_X_TOL and
    F32_Y_TOL in the same trips."""
    port, jx = _both(name)
    dtype = port.state.x.dtype
    x0, target = (t.to(dtype) for t in _landed())
    hits = port._detect(target)
    jhits = j_detect(tuple(jx.obstacles), (), jnp.asarray(target.numpy()), jx._surf_inds_dev,
                     True, jx._dtype, True)
    assert np.array_equal(hits.p_mask.numpy(), np.asarray(jhits.p_mask))
    assert int(hits.p_mask.sum()) > 0
    b = tpcg.PCGData.apply(port._solve_data, target) if isinstance(
        port._solve_data, tpcg.PCGData) else sysm.A_mv(port.system, target)
    y0 = torch.zeros(2 * hits.capacity, dtype=dtype)
    s = port.m_settings
    x, y, it = tuzawa.solve(port._uzawa_Ainv, hits, port._contact.ck, b, x0, y0,
                            s.uzawa_max_iters, s.uzawa_tol)
    japply = jsolver_mod._make_apply_Ainv(jx.system, jx._solve_data, jx._params(),
                                          jx._refine_eff)
    xj, yj, itj = juzawa.solve(japply, jhits, jnp.asarray(jx._ck, jx._dtype),
                               jnp.asarray(b.numpy()), jnp.asarray(x0.numpy()),
                               jnp.asarray(y0.numpy()), s.uzawa_max_iters, s.uzawa_tol)
    x_tol, y_tol = (1e-10, 1e-10) if dtype == F64 else (F32_X_TOL, F32_Y_TOL)
    assert int(it) == int(itj) and int(it) > 1
    assert _rel(x.numpy(), xj) <= x_tol and _rel(y.numpy(), yj) <= y_tol


# float32 uzawa.solve against the JAX package's on the floor scenes, x
# relative to max |x| and y to max |y|, some 3-10 times the gaps this test
# measured on the CPU (x 6.0e-8 to 7.9e-8, y 2.3e-5 to 3.4e-5, in this order
# of the dots and in the parent's, torch.sum): the two packages' float32 A^-1
# applies and dots round otherwise.
F32_X_TOL, F32_Y_TOL = 5e-7, 1e-4


# --- the stacked boxes past their first dynamic rows ------------------------------

# The boxes' Schur solve is held in float64 at the first dynamic rows (step
# 9), over all its trips, where it converges: a step later (some 20 dynamic
# rows, the state depending on the port's own run) this test found the two
# packages' float64 solves 2.2e-7 of max |x| apart over 20 trips and 2.0e-4
# over 5: the rows' Schur system amplifies rounding there. In float32 it
# found them 7e-4 apart on the boxes in a solve of 2 trips, where the two
# packages' direct A^-1 applies round otherwise, which is not what this file
# tests; the float32 solves are the floor scenes'.
BOX_STATES = [(np.float64, 9)]


@pytest.fixture(scope="module")
def boxes_states():
    """The port's float64 boxes (tests/test_torch_selfcollision_paths.py's
    stack, Uzawa) after 9 steps: the first dynamic rows, a few, beside the
    floor's passive rows."""
    ts = stack_scene(2, np.float64, False)
    ts.run(9)
    return {9: ts.state.x.clone()}


@pytest.mark.parametrize("dtype,step", BOX_STATES)
def test_boxes_schur_solve_is_the_jax_package_s(boxes_states, dtype, step):
    """One Schur solve on the stacked boxes at their first dynamic rows, from
    the port's state after `step` steps, on the JAX package's rows there
    (passive and dynamic, deduped) taken into the port with their table: x
    and y in the same trips within 1e-10 of the JAX package's uzawa.solve
    (float64; see BOX_STATES). The query set is not every vertex, so
    the wrappers take slot_of, as on the card."""
    ts, js = stack_scene(2, dtype, False), stack_scene(2, dtype, True)
    x = boxes_states[step].numpy().astype(dtype)
    n = x.shape[0]
    jh = j_detect(tuple(js.obstacles), tuple(js.colliders), jnp.asarray(x), js._surf_inds_dev,
                  True, js._dtype, js._surf_dense).dedup()
    e = ts._contact.empty
    assert not e.dense
    th = tcon.with_table(dataclasses.replace(e, **{
        f: torch.as_tensor(np.array(getattr(jh, f))).to(getattr(e, f).dtype) for f in
        ("p_mask", "p_normal", "p_point", "d_mask", "d_face", "d_barys", "d_normal")}), n)
    assert int(th.d_mask.sum()) > 0
    ck = ts._contact.ck
    rng = np.random.default_rng(0)
    Aj = _make_apply_Ainv(js.system, js._solve_data, {}, js._refine_eff)
    b0 = (np.asarray(Aj(jnp.asarray(x))) + 1e-2 * rng.standard_normal(x.shape)).astype(dtype)
    y0 = np.zeros(2 * th.capacity, dtype=dtype)
    s = js.m_settings
    xj, yj, kj = juzawa.solve(lambda r, x0=None: Aj(r), jh, jnp.asarray(float(ck), x.dtype),
                              jnp.asarray(b0), jnp.asarray(x), jnp.asarray(y0),
                              s.uzawa_max_iters, s.uzawa_tol)
    xt, yt, kt = tuzawa.solve(ts._uzawa_Ainv, th, ck, torch.as_tensor(b0), torch.as_tensor(x),
                              torch.as_tensor(y0), s.uzawa_max_iters, s.uzawa_tol,
                              slot_of=ts._contact.slot_of)
    assert int(kj) == int(kt) > 1
    assert _rel(xt.numpy(), xj) <= 1e-10 and _rel(yt.numpy(), yj) <= 1e-10


def test_contiguous_hits_packs_a_floor_detection():
    """A Floor's detection hands its normals over as one row expanded, which
    the kernels cannot read: uzawa.solve packs the rows once a solve
    (contiguous_hits), and the packed rows are the same values."""
    port, _ = _both("contact_uzawa_f64")
    _, target = _landed()
    hits = port._detect(target)
    assert not all(getattr(hits, f).is_contiguous() for f in cuda_uzawa.ROW_FIELDS)
    packed = cuda_uzawa.contiguous_hits(hits)
    for f in cuda_uzawa.ROW_FIELDS:
        assert getattr(packed, f).is_contiguous()
        assert torch.equal(getattr(packed, f), getattr(hits, f))
