"""Nodal-constrained multicolour Gauss-Seidel (``linsolver=1``).

A port of ``admm_elastic_tpu/solvers/gs.py`` (:47-196; the reference's
src/NodalMultiColorGS.hpp): SOR sweeps over the colour classes of A, each
class updated at once from a padded ELL row sum, with the pins overriding
their vertices and the passive contacts re-detected per vertex at its
updated position and its update projected onto the contact's tangent plane
(Eq. 47 of the TVCG paper). Self-collision rows fold in as a penalty
A + C^T C, b + C^T c (``may_have_dyn``).

These are the plain versions. On the card a solve without dynamic rows is
one launch of kernel H (``ops/cuda_gs.py``, ``csrc/gs.cu``), held to
``solve`` here; ``solve`` tests its exit on the host after each sweep, as
the JAX package's ``lax.while_loop`` tests it on the device, so it runs on the
CPU and in the card's checks, never inside a captured step. Every row sum
and dot runs in a fixed order that the kernel repeats: the ELL row in column
order, the three components of a dot in order; a norm is torch.linalg.norm
(jnp.linalg.norm's order on the CPU), which the kernel sums in component
order (exact for a Floor's tangent basis, within rounding for a Sphere).
"""

from __future__ import annotations

import dataclasses

import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.collision.passive import detect_passive, norm3
from admm_elastic_tpu_torch.solvers.pcg import _err_denom, _tolerance, trace_err, traced


@dataclasses.dataclass(frozen=True)
class GSData:
    """The Gauss-Seidel operator (the JAX package's GSData,
    admm_elastic_tpu/solver.py:46-52): A's off-diagonal as a padded ELL, its
    diagonal, and the colour classes padded with N and their mask."""

    ell_cols: torch.Tensor  # i32 [N, K] (pad: column 0, value 0)
    ell_vals: torch.Tensor  # [N, K]
    diag: torch.Tensor  # [N]
    colors: torch.Tensor  # i32 [C, L]
    colors_mask: torch.Tensor  # bool [C, L]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _ortho_tangent(n):
    """Orthonormal tangent basis (u, v) of the contact plane
    (NodalMultiColorGS::orthoG, src/NodalMultiColorGS.hpp:152-160)."""
    cond = (n[..., 0] > 0.999)[..., None]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device).expand(n.shape)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device).expand(n.shape)
    not_n = torch.where(cond, ez, ex)
    u = _cross(not_n, n)
    u = u / torch.clamp_min(norm3(u), 1e-30)[..., None]
    v = _cross(n, u)
    v = v / torch.clamp_min(norm3(v), 1e-30)[..., None]
    return u, v


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2])[..., None]


def ell_offdiag_mv(ell_cols, ell_vals, x):
    """Off-diagonal part of A x from the padded ELL: [rows, 3], each row
    summed in column order from 0."""
    acc = torch.zeros((ell_cols.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    for k in range(ell_cols.shape[1]):
        acc = acc + ell_vals[:, k, None] * x[ell_cols[:, k].long()]
    return acc


def _sweep_setup(ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask, pin_target,
                 obstacles, hits: con.Hits, ck, omega, may_have_dyn: bool = True):
    """(color_update, residual2, b_eff) of the SOR sweeps. may_have_dyn=False
    (no dynamic collider is registered, so hits.d_mask is all False) drops
    the penalty terms."""
    n = diag.shape[0]
    dtype = b.dtype
    om = torch.as_tensor(omega, dtype=dtype, device=b.device)
    if may_have_dyn:
        has_dyn = hits.n_active() > 0
        pen_diag = torch.where(has_dyn, con.CtC_diag(hits, ck, n, dtype),
                               torch.zeros((n, 3), dtype=dtype, device=b.device))
        b_eff = b + con.Ct_c(hits, ck, n)
    else:
        pen_diag = None
        b_eff = b

    def color_update(ci, x):
        rows = colors[ci].long()  # padded with n
        m = colors_mask[ci]
        safe = torch.clamp_max(rows, n - 1)
        lux = ell_offdiag_mv(ell_cols[safe], ell_vals[safe], x)
        if may_have_dyn:
            aii = diag[safe][:, None] + pen_diag[safe]
            # the penalty's off-diagonal from the fresh x: true GS across colours
            ctc_x = con.CtC_apply(hits, ck, x)
            lux = lux + ctc_x[safe] - pen_diag[safe] * x[safe]
        else:
            aii = diag[safe][:, None]
        x_gs = (b_eff[safe] - lux) / aii
        x_new = (1.0 - om) * x[safe] + om * x_gs
        if obstacles:
            # re-detection at the updated position (src/NodalMultiColorGS.hpp:
            # 121-126), then the tangent-plane update, not over-relaxed
            # (:218-262)
            _, p, nrm, hit, _ = detect_passive(obstacles, x_new)
            delta = x_gs - p
            u, v = _ortho_tangent(nrm)
            x_con = u * _dot3(u, delta) + v * _dot3(v, delta) + p
            x_new = torch.where(hit[:, None], x_con, x_new)
        # pins have the last word (src/NodalMultiColorGS.hpp:110-117)
        x_new = torch.where(pin_mask[safe][:, None], pin_target[safe], x_new)
        x = x.clone()
        x[rows[m]] = x_new[m]
        return x

    def residual2(x):
        ax = diag[:, None] * x + ell_offdiag_mv(ell_cols, ell_vals, x)
        if may_have_dyn:
            ax = ax + con.CtC_apply(hits, ck, x)
        r = b_eff - ax
        return torch.sum(r * r)

    return color_update, residual2, b_eff


def solve(ell_cols, ell_vals, diag, colors, colors_mask, b, x0, pin_mask, pin_target,
          obstacles, hits: con.Hits, ck, omega, max_iters: int, tol,
          may_have_dyn: bool = True):
    """Constrained multicolour SOR sweeps until the residual |b - A x|^2 falls
    under max(tol, 64 eps)^2 max(|b|^2, tiny), at most max_iters. Returns
    (x, sweeps).

    colors: i32 [C, L] vertex ids per colour, padded with N; hits: the
    dynamic rows only (the passive contacts are the per-vertex projection).
    """
    color_update, residual2, b_eff = _sweep_setup(
        ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask, pin_target, obstacles,
        hits, ck, omega, may_have_dyn=may_have_dyn)
    tol2 = _tolerance(b, tol, torch.sum(b_eff * b_eff))
    x, k, done = x0, 0, False
    while not done and k < int(max_iters):
        for ci in range(colors.shape[0]):
            x = color_update(ci, x)
        done = bool(residual2(x) < tol2)
        k += 1
    return x, k


def solve_traced(ell_cols, ell_vals, diag, colors, colors_mask, b, x0, pin_mask, pin_target,
                 obstacles, hits: con.Hits, ck, omega, n_sweeps: int, x_star=None,
                 err_denom=None, may_have_dyn: bool = True):
    """Fixed-length SOR sweeps with a per-sweep residual trace (the SolverLog
    tier; admm_elastic_tpu/solvers/gs.py:199-229): exactly n_sweeps, no exit
    test, and after each sweep an extra residual pass, res [n_sweeps] =
    ||b_eff - (A + C^T C) x_k||, and err against x_star where given.

    The JAX package's non-fused diagnostic, ported as plain PyTorch on every
    device (kernel H has no traced form). Returns (x, {"res", "err"}).
    """
    color_update, residual2, _ = _sweep_setup(
        ell_cols, ell_vals, diag, colors, colors_mask, b, pin_mask, pin_target, obstacles,
        hits, ck, omega, may_have_dyn=may_have_dyn)
    err_denom = _err_denom(x_star, x0, err_denom)
    x, res, errs = x0, [], []
    for _ in range(int(n_sweeps)):
        for ci in range(colors.shape[0]):
            x = color_update(ci, x)
        res.append(torch.sqrt(residual2(x)))
        errs.append(trace_err(x_star, x, err_denom))
    return x, traced(res, errs)
