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
results only where ``done`` is unset (``torch.where``), so x, y, r and d stay
bitwise what they were once it is set; an inner PCG solve reads the flag and
returns its guess without a trip. This is the one mechanism: the eager loop,
the capture's warm-up step and the CPU run the same trips, and no trip reads
the flag on the host but the CPU's inner PCG solve.
"""

from __future__ import annotations

import numpy as np
import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.solvers.pcg import _err_denom, trace_err, traced


def _dot(a, b):
    return torch.sum(a * b)


def solve(apply_Ainv, hits: con.Hits, ck, b0, x_guess, y, max_iters: int, tol):
    """Returns (x, y, iters): iters an int32 tensor on b0's device, the Schur
    trips taken, at least 1 (as the JAX package reports them).

    apply_Ainv: (rhs [N, 3], x0 [N, 3] or None, done or None) -> A^-1 rhs; an
      iterative inner starts from x0 (0 where None) and skips its solve where
      the bool tensor done is set.
    hits: deduped constraint buffers; y: [2H] warm-start multipliers.
    """
    n = b0.shape[0]
    dtype = b0.dtype
    h = hits.capacity
    dev = b0.device

    def C(x):
        rp, rd = con.C_apply(hits, ck, x)
        return torch.cat([rp, rd])

    def Ct(yv):
        return con.Ct_apply(hits, ck, yv[:h], yv[h:], n)

    cp, cd = con.C_rhs(hits, ck)
    c = torch.cat([cp, cd])
    active = torch.cat([hits.p_mask, hits.d_mask])
    # the previous ADMM iterate warm-starts the first apply; the Schur
    # directions start from 0 (INNER_WARM_START is off in the JAX package)
    x = apply_Ainv(b0 - Ct(y), x_guess, None)
    r = torch.where(active, C(x) - c, 0.0)
    d = r
    yv = y
    # max(tol, 64 eps)^2 in the dtype, formed on the host (exact in it): an
    # absolute bound on |r|^2, as the JAX package's
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    tiny = float(fi.tiny)
    tol_c = max(fi.dtype.type(tol), fi.dtype.type(64) * fi.eps)
    tol2 = float(tol_c * tol_c)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(int(max_iters)):
        q2 = apply_Ainv(Ct(d), None, done)
        q3 = torch.where(active, C(q2), 0.0)
        denom = _dot(d, q3)
        bad = torch.abs(denom) < tiny
        safe = torch.where(bad, torch.ones_like(denom), denom)
        alpha = torch.where(bad, torch.zeros_like(denom), _dot(d, r) / safe)
        x_n = x - alpha * q2
        y_n = yv + alpha * d
        r_n = r - alpha * q3
        small = _dot(r_n, r_n) < tol2
        beta = torch.where(bad, torch.zeros_like(denom), _dot(r_n, q3) / safe)
        d_n = r_n - beta * d
        go = ~done
        x = torch.where(go, x_n, x)
        yv = torch.where(go, y_n, yv)
        r = torch.where(go, r_n, r)
        d = torch.where(go, d_n, d)
        k = k + go.to(torch.int32)
        done = done | bad | small
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
