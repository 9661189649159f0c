"""Uzawa saddle-point solver (``linsolver=2``): CG on the contact Schur
complement.

A port of ``admm_elastic_tpu/solvers/uzawa.py`` ``solve`` (:41-125; the
reference's UzawaCG, src/UzawaCG.hpp:32-125):

    [ A  C^T ] [x]   [b]
    [ C  0   ] [y] = [c]

CG runs on S = C A^-1 C^T without forming it: each trip is a C^T apply, one
A^-1 apply (the prefactored direct solve, or an inner PCG solve, which is
kernel G on the card) and a C apply. Inactive rows have zero C rows and never
enter the Krylov space.

The trips exit on the device: a captured step cannot branch on the host, and
the installed PyTorch has no conditional graph node, so every one of the
``max_iters`` trips is in the graph and is predicated on the device flag
``done``. A trip computes as the JAX package's body does and then keeps its
results only where ``done`` is unset, so x, y, r and d stay bitwise what they
were once it is set; an inner PCG solve reads the flag and returns its guess
without a trip. This is the one mechanism: the eager loop, the capture's
warm-up step and the CPU run the same trips, and no trip reads the flag on the
host but the CPU's inner PCG solve.

On the card a trip is three launches (``ops/cuda_uzawa.py``): kernel L's
C^T d (``ct_apply``), the A^-1 apply and kernel M (``schur_trip``), which
forms C q2, the dots, alpha and beta and updates x, y, r, d, k and done in
place, or leaves them where done is set. On the CPU the same wrappers run
their plain twins. Every dot sums in one fixed order, its partials in
float64 (``_dot``, ``cuda_uzawa.fixed_dot``), on every device and in the
traced solve too; it is not the JAX package's order, so x parts from it by
rounding.

``solve_scenes`` is solve over S scenes of one mesh (scenario batching,
``parallel/batch.py``): the passive rows of ``alcg.scene_hits``, each scene
its own Schur CG and exit (done [S]), L's and M's scene forms
(``cuda_uzawa.ct_apply_scenes``, ``schur_trip_scenes``) around an A^-1 apply
that skips a done scene (G's scene form with done); scene i computes what
solve computes on its tensors, bit for bit. On the CPU its loop stops once
every scene is done (the trips after change nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.ops import cuda_uzawa
from admm_elastic_tpu_torch.solvers.pcg import _err_denom, trace_err, traced

_dot = cuda_uzawa.fixed_dot


def _limits(dtype, tol):
    """(the dtype's tiny, max(tol, 64 eps)^2 in the dtype), formed on the host
    (exact in it): the trip's bad denominator and an absolute bound on |r|^2,
    as the JAX package's."""
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    tol_c = max(fi.dtype.type(tol), fi.dtype.type(64) * fi.eps)
    return float(fi.tiny), float(tol_c * tol_c)


def solve(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, max_iters: int, tol, slot_of=None):
    """Returns (x, y, iters): iters an int32 tensor on b0's device, the Schur
    trips taken, at least 1 (as the JAX package reports them).

    apply_Ainv: (rhs [N, 3], x0 [N, 3] or None, done or None) -> A^-1 rhs; an
      iterative inner starts from x0 (0 where None) and skips its solve where
      the bool tensor done is set.
    hits: deduped constraint buffers with their table (constraints.with_table)
      where dynamic rows may be; y: [2H] warm-start multipliers, not written;
    slot_of: i32 [N] each vertex's query slot (-1 for none), which kernel L
      needs on the card where the query set is not every vertex.
    """
    n = b0.shape[0]
    dtype = b0.dtype
    dev = b0.device
    hits = cuda_uzawa.contiguous_hits(hits)

    def Ct(yv):
        return cuda_uzawa.ct_apply(hits, ck, yv, n, slot_of)

    cp, cd = con.C_rhs(hits, ck)
    c = torch.cat([cp, cd])
    active = torch.cat([hits.p_mask, hits.d_mask])
    # the previous ADMM iterate warm-starts the first apply; the Schur
    # directions start from 0 (INNER_WARM_START is off in the JAX package)
    x = apply_Ainv(b0 - Ct(y), x_guess, None)
    r = torch.where(active, torch.cat(con.C_apply(hits, ck, x)) - c, 0.0)
    # kernel M updates x, y, r and d in place on the card: y is the caller's,
    # and d starts as r
    d = r.clone()
    yv = y.clone()
    tiny, tol2 = _limits(dtype, tol)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(int(max_iters)):
        q2 = apply_Ainv(Ct(d), None, done)
        x, yv, r, d, k, done = cuda_uzawa.schur_trip(hits, ck, q2, x, yv, r, d, k, done, tiny,
                                                     tol2)
    return x, yv, torch.clamp_min(k, 1)


def solve_scenes(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, max_iters: int, tol,
                 slot_of=None):
    """solve over S scenes of one mesh (scenario batching, parallel/batch.py;
    jax.vmap of the JAX package's solve): hits of alcg.scene_hits (the passive
    rows [S, H], the query set shared), b0 and x_guess [S, N, 3], y [S, 2H];
    every scene runs its own Schur CG, to its own exit (done [S]), and
    returns (x, y, iters [S] int32, each at least 1). apply_Ainv: (rhs [S, N,
    3], x0 or None, done [S] or None) -> [S, N, 3], a scene whose done is set
    taking no inner trip. On the card L's and M's scene forms
    (cuda_uzawa.ct_apply_scenes, schur_trip_scenes); on the CPU their twins.
    Scene i computes what solve computes on scene i's tensors, bit for bit."""
    s_cnt, n = b0.shape[0], b0.shape[1]
    dtype = b0.dtype
    dev = b0.device
    hits = cuda_uzawa.contiguous_hits(hits)

    def Ct(yv):
        return cuda_uzawa.ct_apply_scenes(hits, ck, yv, n, slot_of)

    mask, normal = hits.p_mask, hits.p_normal
    cp = torch.where(mask, ck * con._dot3(normal, hits.p_point), 0.0)
    c = torch.cat([cp, torch.zeros_like(cp)], dim=1)
    active = torch.cat([mask, hits.d_mask], dim=1)
    x = apply_Ainv(b0 - Ct(y), x_guess, None)
    xp = x if hits.dense else x[:, hits.p_vidx]
    rp = torch.where(mask, ck * con._dot3(normal, xp), 0.0)
    r = torch.where(active, torch.cat([rp, torch.zeros_like(rp)], dim=1) - c, 0.0)
    d = r.clone()
    yv = y.clone()
    tiny, tol2 = _limits(dtype, tol)
    done = torch.zeros((s_cnt,), dtype=torch.bool, device=dev)
    k = torch.zeros((s_cnt,), dtype=torch.int32, device=dev)
    for _ in range(int(max_iters)):
        if dev.type == "cpu" and bool(done.all()):  # the rest change nothing: the CPU skips them
            break
        q2 = apply_Ainv(Ct(d), None, done)
        x, yv, r, d, k, done = cuda_uzawa.schur_trip_scenes(hits, ck, q2, x, yv, r, d, k, done,
                                                            tiny, tol2)
    return x, yv, torch.clamp_min(k, 1)


def solve_traced(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, n_iters: int, x_star=None,
                 err_denom=None):
    """Fixed-length Schur CG with a per-trip residual trace (the SolverLog
    tier; admm_elastic_tpu/solvers/uzawa.py:123-175): exactly n_iters trips,
    no exit test; where the denominator falls under the dtype's tiny the trip
    freezes (alpha = 0, beta = 0). Records res [n_iters] = ||C x_k - c|| on
    the active rows (the Schur residual) and err against x_star where given.
    apply_Ainv as in solve (the inner solve runs every trip).

    The JAX package's non-fused diagnostic, ported as plain PyTorch on every
    device around the port's A^-1 apply. Returns (x, y, {"res", "err"}).
    """
    n = b0.shape[0]
    h = hits.capacity
    tiny = torch.finfo(b0.dtype).tiny

    def C(x):
        rp, rd = con.C_apply(hits, ck, x)
        return torch.cat([rp, rd])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = torch.cat([cp, cd])
    active = torch.cat([hits.p_mask, hits.d_mask])
    err_denom = _err_denom(x_star, x_guess, err_denom)
    x = apply_Ainv(b0 - Ct(y), x_guess, None)
    r = torch.where(active, C(x) - c, 0.0)
    d, yv = r, y
    res, errs = [], []
    for _ in range(int(n_iters)):
        q2 = apply_Ainv(Ct(d), None, None)
        q3 = torch.where(active, C(q2), 0.0)
        denom = _dot(d, q3)
        bad = torch.abs(denom) < tiny
        safe = torch.where(bad, torch.ones_like(denom), denom)
        alpha = torch.where(bad, 0.0, _dot(d, r) / safe)
        x = x - alpha * q2
        yv = yv + alpha * d
        r = r - alpha * q3
        beta = torch.where(bad, 0.0, _dot(r, q3) / safe)
        d = r - beta * d
        res.append(torch.sqrt(_dot(r, r)))
        errs.append(trace_err(x_star, x, err_denom))
    return x, yv, traced(res, errs)
