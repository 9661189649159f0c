"""Augmented-Lagrangian PCG contact solver (``linsolver=4``).

A port of ``admm_elastic_tpu/solvers/alcg.py`` (:46-127). One AL pass per
ADMM iteration on the same saddle-point problem as Uzawa's:

    (A + C^T C) x = b + C^T c - C^T y      (one PCG solve)
    y <- y + (C x - c)                      (the multiplier ascent)

C rows carry the ck scaling (collision/constraints.py), so the penalty
weight is ck^2 and the scaled ascent step is 1. The preconditioner is the
base one (Jacobi, or two-grid) with the penalty diagonal diag(C^T C) folded
into its (smoothing) diagonal; the two-grid coarse correction stays A's.

``solve`` runs the JAX package's two forms as plain PyTorch on the CPU: with
a dense surface, no dynamic rows and Jacobi, the lane-major ``solve_T`` on
A + pn pn^T (pn the masked ck-scaled normals); otherwise ``pcg.solve`` with
``constraints.CtC_apply`` and ``_penalty_precond``. On the card the PCG
solve is one launch of kernel G in its penalty form (``ops/cuda_pcg.py``),
which applies A + pn pn^T per vertex (pn scattered to [N, 3] where the surface
is not dense: the passive rows' C^T C is block-diagonal per vertex) with
the per-component Jacobi inverse 1 / (diag + diag(C^T C)); with dynamic rows
(self-collision) in its DYN form, which adds the dynamic rows' C^T C x, their
C x first and then each vertex's face-corner sum in table order
(``constraints.with_table``), in each apply (Jacobi only: with two-grid it
raises). ``solve_plain`` is the JAX forms on any device, the twin the card's
checks hold G to, and ``penalty_solve`` / ``penalty_solve_dyn`` G's own forms
as plain PyTorch.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.ops import cuda_pcg
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.solvers import pcg as pcg_mod

OMEGA = 0.7  # the two-grid smoother's damping


def _penalty_precond(pcg_data, A_hat, pen_diag):
    """The base preconditioner with the penalty diagonal folded into the
    Jacobi / smoothing diagonal ([N, 3] apply)."""
    inv_d = 1.0 / (pcg_data.diag()[:, None] + pen_diag)
    if pcg_data.agg is None:
        return lambda r: inv_d * r
    pcg_mod._check_fp32(pcg_data.coarse_inv)

    def precond(r):
        z = OMEGA * inv_d * r
        res = r - A_hat(z)
        rc = red.dt_gather(res, pcg_data.agg_gather)
        ec = torch.matmul(pcg_data.coarse_inv, rc)
        z = z + ec[pcg_data.agg]
        z = z + OMEGA * inv_d * (r - A_hat(z))
        return z

    return precond


def penalty_vectors(hits: con.Hits, ck, n: int):
    """pn [N, 3], the masked ck-scaled normals of the passive rows on their
    vertices (zero elsewhere), for a dense surface or by a permutation."""
    pn = torch.where(hits.p_mask, ck, 0.0)[:, None] * hits.p_normal
    if hits.dense:
        return pn
    out = torch.zeros((n, 3), dtype=pn.dtype, device=pn.device)
    return out.index_copy(0, hits.p_vidx, pn)


def penalty_solve(data, pn, pen_diag, b, x0, tol, max_iters: int):
    """Kernel G's penalty form as plain PyTorch: PCG on A + pn pn^T with the
    per-component Jacobi inverse 1 / (diag + pen_diag), lane-major for Jacobi
    (the JAX package's dense form), [N, 3] with the two-grid V-cycle of
    _penalty_precond. Returns (x, trips)."""
    if data.agg is None:
        pnT = pn.T

        def A_hat_T(xT):
            cx = pnT[0] * xT[0] + pnT[1] * xT[1] + pnT[2] * xT[2]
            return data.apply_T(xT) + pnT * cx[None, :]

        inv_dT = 1.0 / (data.diag()[None, :] + pen_diag.T)
        return pcg_mod.solve_T(A_hat_T, lambda r: inv_dT * r, b, x0, tol, max_iters)

    def A_hat(x):
        cx = pn[:, 0] * x[:, 0] + pn[:, 1] * x[:, 1] + pn[:, 2] * x[:, 2]
        return data.apply(x) + pn * cx[:, None]

    return pcg_mod.solve(A_hat, _penalty_precond(data, A_hat, pen_diag), b, x0, tol, max_iters)


def penalty_solve_dyn(data, pn, pen_diag, hits: con.Hits, ck, b, x0, tol, max_iters: int,
                      gather=con.dyn_gather):
    """Kernel G's DYN form as plain PyTorch: PCG on A + pn pn^T + C_d^T C_d
    (the dynamic rows' C and C^T, constraints.C_apply / Ct_dyn with gather),
    [N, 3], with the per-component Jacobi inverse 1 / (diag + pen_diag) (or
    the two-grid V-cycle of _penalty_precond). Returns (x, trips)."""
    n = b.shape[0]

    def A_hat(x):
        cx = pn[:, 0] * x[:, 0] + pn[:, 1] * x[:, 1] + pn[:, 2] * x[:, 2]
        rd = con.C_apply(hits, ck, x)[1]
        return (data.apply(x) + pn * cx[:, None]) + con.Ct_dyn(hits, ck, rd, n, gather)

    return pcg_mod.solve(A_hat, _penalty_precond(data, A_hat, pen_diag), b, x0, tol, max_iters)


def _ascent(hits, ck, x, c, y, active):
    rp, rd = con.C_apply(hits, ck, x)
    return torch.where(active, y + (torch.cat([rp, rd]) - c), 0.0)


def _setup(hits, ck, b, y, gather=con.dyn_gather):
    n = b.shape[0]
    h = hits.capacity
    cp, cd = con.C_rhs(hits, ck)
    c = torch.cat([cp, cd])
    cy = c - y
    b_hat = b + con.Ct_apply(hits, ck, cy[:h], cy[h:], n, gather)
    return (c, b_hat, con.CtC_diag(hits, ck, n, b.dtype, gather),
            torch.cat([hits.p_mask, hits.d_mask]))


def solve_plain(pcg_data, hits: con.Hits, ck, b, x0, y, tol, max_iters: int,
                gather=con.dyn_gather):
    """One AL pass as the JAX package runs it, plain PyTorch on any device
    (gather: constraints.dyn_gather_plain for the plain twin on the card).
    Returns (x, y, pcg trips)."""
    c, b_hat, pen_diag, active = _setup(hits, ck, b, y, gather)
    if hits.dense and not hits.may_dyn and pcg_data.agg is None:
        pn = penalty_vectors(hits, ck, b.shape[0])
        x, iters = penalty_solve(pcg_data, pn, pen_diag, b_hat, x0, tol, max_iters)
    else:
        def A_hat(x):
            return pcg_data.apply(x) + con.CtC_apply(hits, ck, x, gather)

        x, iters = pcg_mod.solve(A_hat, _penalty_precond(pcg_data, A_hat, pen_diag), b_hat,
                                 x0, tol, max_iters)
    return x, _ascent(hits, ck, x, c, y, active), iters


def solve(pcg_data, hits: con.Hits, ck, b, x0, y, tol, max_iters: int, trips, slot_of=None):
    """One AL pass: returns (x, y); the PCG trips are added to trips (an int32
    tensor of one element on b's device). On the CPU solve_plain; on the card
    kernel G's penalty form, its DYN form where colliders are registered
    (slot_of: each vertex's query slot, None for a dense surface)."""
    if b.device.type == "cpu":
        x, y_new, iters = solve_plain(pcg_data, hits, ck, b, x0, y, tol, max_iters)
        trips += iters
        return x, y_new
    c, b_hat, pen_diag, active = _setup(hits, ck, b, y)
    pn = penalty_vectors(hits, ck, b.shape[0])
    if hits.may_dyn:
        x = cuda_pcg.pcg_solve_dyn(pcg_data, b_hat, x0, tol, max_iters, trips, pn, pen_diag,
                                   hits, ck, slot_of)
    else:
        x = cuda_pcg.pcg_solve_penalty(pcg_data, b_hat, x0, tol, max_iters, trips, pn, pen_diag)
    return x, _ascent(hits, ck, x, c, y, active)


def solve_traced(pcg_data, hits: con.Hits, ck, b, x0, y, n_iters: int, x_star=None,
                 err_denom=None):
    """Fixed-length traced AL pass (the SolverLog tier;
    admm_elastic_tpu/solvers/alcg.py:130-157): pcg.solve_traced on
    A + C^T C with the penalty-folded preconditioner, then the multiplier
    ascent.

    The JAX package's non-fused diagnostic, ported as plain PyTorch on every
    device (kernel G's penalty form has no traced form). Returns
    (x, y, {"res", "err"}).
    """
    c, b_hat, pen_diag, active = _setup(hits, ck, b, y)

    def A_hat(x):
        return pcg_data.apply(x) + con.CtC_apply(hits, ck, x)

    x, tr = pcg_mod.solve_traced(A_hat, _penalty_precond(pcg_data, A_hat, pen_diag), b_hat, x0,
                                 n_iters, x_star=x_star, err_denom=err_denom)
    return x, _ascent(hits, ck, x, c, y, active), tr
