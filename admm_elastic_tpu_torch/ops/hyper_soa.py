"""Neo-Hookean prox on SoA tuples: signed SVD + projected Newton, in PyTorch.

A port of the neo-Hookean branch of ``admm_elastic_tpu/ops/hyper_soa.py``
(``_vgh_soa`` :24-49 and :119-133, ``newton_soa`` :136-180,
``prox_tet_hyper_tuple`` :183-199), with the same operations in the same
order. ``local_step_plain`` is the plain version of kernel A
(``csrc/local_step.cu``); ``ops/cuda_local_step.py`` uses it for CPU
tensors. The other models (linear, StVK, the Xu splines) raise.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.ops import soa
from admm_elastic_tpu_torch.ops.prox import TET_NEOHOOKEAN, check_model


def _vgh_nh(mu, lam, k, s0):
    """(value, grad, hess) of psi_NH(s) + k/2 |s - s0|^2 on vec3-tuples;
    hess returns the compact 6-tuple (h11, h22, h33, h12, h13, h23)."""
    big = torch.finfo(s0[0].dtype).max

    def psi(s):
        J = s[0] * s[1] * s[2]
        I1 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
        logI3 = torch.log(J * J)
        return 0.5 * mu * (I1 - logI3 - 3.0) + 0.125 * lam * logI3 * logI3

    def grad_psi(s):
        J = s[0] * s[1] * s[2]
        lj = lam * torch.log(J)
        return tuple(mu * (si - 1.0 / si) + lj / si for si in s)

    def hess_psi(s):
        J = s[0] * s[1] * s[2]
        logJ = torch.log(J)
        inv = tuple(1.0 / si for si in s)
        h_d = tuple(mu * (1.0 + iv * iv) + lam * (1.0 - logJ) * iv * iv for iv in inv)
        return (
            h_d[0], h_d[1], h_d[2],
            lam * inv[0] * inv[1], lam * inv[0] * inv[2], lam * inv[1] * inv[2],
        )

    def value(s):
        infeasible = (s[0] <= 0.0) | (s[1] <= 0.0) | (s[2] <= 0.0)
        quad = 0.5 * k * sum((si - s0i) * (si - s0i) for si, s0i in zip(s, s0))
        clamped = tuple(torch.clamp(si, min=1e-30) for si in s)
        return torch.where(infeasible, big, psi(clamped) + quad)

    def grad(s):
        g = grad_psi(s)
        return tuple(gi + k * (si - s0i) for gi, si, s0i in zip(g, s, s0))

    def hess(s):
        h = hess_psi(s)
        return (h[0] + k, h[1] + k, h[2] + k, h[3], h[4], h[5])

    return value, grad, hess


def newton_soa(value, grad, hess, s, n_iters: int, n_backtrack: int = 8,
               tol: float = 1e-6, floor: float = 1e-9):
    """Projected active-set Newton on vec3-tuples with Gershgorin damping
    and backtracking (the JAX package's ops/hyper_soa.newton_soa)."""
    for _ in range(n_iters):
        g = grad(s)
        h6 = hess(s)
        # Active set: coordinates pinned at the barrier with inward gradient.
        pinned = tuple((si <= floor * 10.0) & (gi > 0.0) for si, gi in zip(s, g))
        free = tuple(torch.where(p, 0.0, 1.0).to(si.dtype) for p, si in zip(pinned, s))
        g = tuple(gi * fi for gi, fi in zip(g, free))
        h11 = h6[0] * free[0] * free[0] + torch.where(pinned[0], 1.0, 0.0).to(s[0].dtype)
        h22 = h6[1] * free[1] * free[1] + torch.where(pinned[1], 1.0, 0.0).to(s[0].dtype)
        h33 = h6[2] * free[2] * free[2] + torch.where(pinned[2], 1.0, 0.0).to(s[0].dtype)
        h12 = h6[3] * free[0] * free[1]
        h13 = h6[4] * free[0] * free[2]
        h23 = h6[5] * free[1] * free[2]

        # Levenberg damping from the Gershgorin bound.
        r1 = h11 - torch.abs(h12) - torch.abs(h13)
        r2 = h22 - torch.abs(h12) - torch.abs(h23)
        r3 = h33 - torch.abs(h13) - torch.abs(h23)
        tau = torch.clamp(1e-6 - torch.minimum(torch.minimum(r1, r2), r3), min=0.0)
        d, det = soa.solve3x3_sym_soa((h11 + tau, h22 + tau, h33 + tau, h12, h13, h23), g)
        tiny = torch.tensor(1e-300, dtype=det.dtype, device=det.device)
        bad = torch.abs(det) < tiny
        d = tuple(torch.where(bad, gi, di) for gi, di in zip(g, d))

        f0 = value(s)
        best = s
        best_f = f0
        accepted = torch.zeros_like(f0, dtype=torch.bool)
        t = torch.ones_like(f0)
        for _ in range(n_backtrack):
            cand = tuple(torch.clamp(si - t * di, min=floor) for si, di in zip(s, d))
            fc = value(cand)
            take = (~accepted) & (fc < best_f)
            best = tuple(torch.where(take, ci, bi) for ci, bi in zip(cand, best))
            best_f = torch.where(take, fc, best_f)
            accepted = accepted | take
            t = t * 0.5

        gnorm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        step2 = sum((bi - si) * (bi - si) for bi, si in zip(best, s))
        converged = (gnorm2 < tol * tol) | (step2 < tol * tol)
        s = tuple(torch.where(converged, si, bi) for si, bi in zip(s, best))
    return s


def prox_tet_hyper_tuple(f, model: str, mu, lam, kappa, k, n_iters: int = 8,
                         sweeps: int = 8):
    """Hyperelastic prox on a 9-tuple of same-shape tensors (NH only)."""
    check_model(model)
    del kappa  # the spline compression term; neo-Hookean does not use it
    U, S, V = soa.signed_svd3_soa(f, sweeps=sweeps)
    s0 = S
    eps = 1e-6
    collapsed = (torch.abs(S[0]) < eps) & (torch.abs(S[1]) < eps) & (torch.abs(S[2]) < eps)
    S = tuple(torch.where(collapsed, eps, si) for si in S)
    S = (S[0], S[1], torch.abs(S[2]))

    value, grad, hess = _vgh_nh(mu, lam, k, s0)
    S_opt = newton_soa(value, grad, hess, S, n_iters=n_iters)
    return soa.compose_usv(U, S_opt, V)


def local_step_plain(dix, u, mu, lam, kappa, k, n_iters: int = 8,
                     model: str = TET_NEOHOOKEAN):
    """Fused tet local step on rows [9, T] (plain version of kernel A):
    v = D x + u, z = prox(v), u' = v - z. Returns (z, u')."""
    v = dix + u
    z = torch.stack(prox_tet_hyper_tuple(tuple(v[i] for i in range(9)), model,
                                         mu, lam, kappa, k, n_iters=n_iters), dim=0)
    return z, v - z
