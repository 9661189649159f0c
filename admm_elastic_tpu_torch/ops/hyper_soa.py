"""Hyperelastic prox on SoA tuples: signed SVD + projected Newton, in PyTorch.

A port of ``admm_elastic_tpu/ops/hyper_soa.py`` (``_vgh_soa`` :24-133,
``newton_soa`` :136-180, ``prox_tet_hyper_tuple`` :183-199) for all five
hyperelastic models (neo-Hookean, StVK and the three Xu splines), with the
same operations in the same order. ``local_step_plain`` is the plain
version of kernel A (``csrc/local_step.cu``) and ``prox_plain`` that of
kernels D and F (``csrc/prox.cu``); the wrappers in
``ops/cuda_local_step.py`` and ``ops/cuda_prox.py`` use them for CPU tensors.
"""

from __future__ import annotations

import torch

from admm_elastic_tpu_torch.materials import spline_d2fgh, spline_dfgh, spline_fgh
from admm_elastic_tpu_torch.ops import soa
from admm_elastic_tpu_torch.ops.prox import (SPLINE_KIND, TET_LINEAR, TET_NEOHOOKEAN,
                                             TET_STVK, check_model)


def _vgh_soa(model: str, mu, lam, kappa, k, s0):
    """(value, grad, hess) of psi_model(s) + k/2 |s - s0|^2 on vec3-tuples;
    hess returns the compact 6-tuple (h11, h22, h33, h12, h13, h23)."""
    big = torch.finfo(s0[0].dtype).max

    if model == TET_NEOHOOKEAN:
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

    elif model == TET_STVK:
        def psi(s):
            st = tuple(0.5 * (si * si - 1.0) for si in s)
            tr = st[0] + st[1] + st[2]
            return mu * (st[0] * st[0] + st[1] * st[1] + st[2] * st[2]) + 0.5 * lam * tr * tr

        def grad_psi(s):
            sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
            half = 0.5 * lam * (sum_s2 - 3.0)
            return tuple(mu * si * (si * si - 1.0) + half * si for si in s)

        def hess_psi(s):
            sum_s2 = s[0] * s[0] + s[1] * s[1] + s[2] * s[2]
            half = 0.5 * lam * (sum_s2 - 3.0)
            h_d = tuple(mu * (3.0 * si * si - 1.0) + half + lam * si * si for si in s)
            return (
                h_d[0], h_d[1], h_d[2],
                lam * s[0] * s[1], lam * s[0] * s[2], lam * s[1] * s[2],
            )

    elif model in SPLINE_KIND:
        kind = SPLINE_KIND[model]

        def psi(s):
            s1, s2, s3 = s
            J = torch.clamp(s1 * s2 * s3, min=1e-30)
            total = None
            for xi in (s1, s2, s3):
                fv, _, _ = spline_fgh(kind, xi, xi, J, mu, lam, kappa)
                total = fv if total is None else total + fv
            for pq in (s1 * s2, s2 * s3, s3 * s1):
                _, gv, _ = spline_fgh(kind, pq, pq, J, mu, lam, kappa)
                total = total + gv
            _, _, hv = spline_fgh(kind, J, J, J, mu, lam, kappa)
            return total + hv

        def grad_psi(s):
            s1, s2, s3 = s
            J = torch.clamp(s1 * s2 * s3, min=1e-30)
            df1, dg12, dh = spline_dfgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            df2, dg23, _ = spline_dfgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            df3, dg31, _ = spline_dfgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            return (
                df1 + dg12 * s2 + dg31 * s3 + dh * s2 * s3,
                df2 + dg23 * s3 + dg12 * s1 + dh * s3 * s1,
                df3 + dg31 * s1 + dg23 * s2 + dh * s1 * s2,
            )

        def hess_psi(s):
            s1, s2, s3 = s
            J = torch.clamp(s1 * s2 * s3, min=1e-30)
            _, dg12, dh = spline_dfgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            _, dg23, _ = spline_dfgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            _, dg31, _ = spline_dfgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            d2f1, d2g12, d2h = spline_d2fgh(kind, s1, s1 * s2, J, mu, lam, kappa)
            d2f2, d2g23, _ = spline_d2fgh(kind, s2, s2 * s3, J, mu, lam, kappa)
            d2f3, d2g31, _ = spline_d2fgh(kind, s3, s3 * s1, J, mu, lam, kappa)
            p23, p31, p12 = s2 * s3, s3 * s1, s1 * s2
            h11 = d2f1 + d2g12 * s2 * s2 + d2g31 * s3 * s3 + d2h * (p23 * p23)
            h22 = d2f2 + d2g23 * s3 * s3 + d2g12 * s1 * s1 + d2h * (p31 * p31)
            h33 = d2f3 + d2g31 * s1 * s1 + d2g23 * s2 * s2 + d2h * (p12 * p12)
            h12 = dg12 + d2g12 * s1 * s2 + d2h * p23 * p31 + dh * s3
            h13 = dg31 + d2g31 * s3 * s1 + d2h * p23 * p12 + dh * s2
            h23 = dg23 + d2g23 * s2 * s3 + d2h * p31 * p12 + dh * s1
            return (h11, h22, h33, h12, h13, h23)

    else:
        raise ValueError(f"unknown hyperelastic model {model!r}")

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
               tol: float = 1e-6, floor: float = 1e-9, trips: dict | None = None):
    """Projected active-set Newton on vec3-tuples with Gershgorin damping
    and backtracking (the JAX package's ops/hyper_soa.newton_soa).

    Every lane runs every trip of both loops, as the kernels do; a converged
    lane keeps its s. ``trips``, when given, receives what the data needed:
    ``gradients`` (lane-iterations up to and with the one that finds the lane
    converged), ``searches`` (those of them whose gradient is not already
    below tol, so that a line search has to run) and ``candidates`` (line-search
    candidates up to and with the first accepted one, all n_backtrack where
    none is). If it holds a list under ``lanes``, each trip appends its
    per-lane masks (live, search, tried), from which a caller can tell how
    many trips and candidates the slowest lane of a warp needs."""
    live = None
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
        tried = torch.zeros_like(f0)
        for _ in range(n_backtrack):
            cand = tuple(torch.clamp(si - t * di, min=floor) for si, di in zip(s, d))
            fc = value(cand)
            tried = tried + (~accepted).to(tried.dtype)
            take = (~accepted) & (fc < best_f)
            best = tuple(torch.where(take, ci, bi) for ci, bi in zip(cand, best))
            best_f = torch.where(take, fc, best_f)
            accepted = accepted | take
            t = t * 0.5

        gnorm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        step2 = sum((bi - si) * (bi - si) for bi, si in zip(best, s))
        converged = (gnorm2 < tol * tol) | (step2 < tol * tol)
        s = tuple(torch.where(converged, si, bi) for si, bi in zip(s, best))
        if trips is not None:
            live = torch.ones_like(converged) if live is None else live
            search = live & ~(gnorm2 < tol * tol)
            for key, n in (("gradients", live.sum()), ("searches", search.sum()),
                           ("candidates", (tried * search).sum())):
                trips[key] = trips.get(key, 0) + int(n)
            if "lanes" in trips:
                trips["lanes"].append((live, search, tried))
            live = live & ~converged
    return s


def prox_tet_hyper_tuple(f, model: str, mu, lam, kappa, k, n_iters: int = 8,
                         sweeps: int = 8, trips: dict | None = None):
    """Hyperelastic prox on a 9-tuple of same-shape tensors (``trips``: see
    newton_soa)."""
    U, S, V = soa.signed_svd3_soa(f, sweeps=sweeps)
    s0 = S
    eps = 1e-6
    collapsed = (torch.abs(S[0]) < eps) & (torch.abs(S[1]) < eps) & (torch.abs(S[2]) < eps)
    S = tuple(torch.where(collapsed, eps, si) for si in S)
    S = (S[0], S[1], torch.abs(S[2]))

    value, grad, hess = _vgh_soa(model, mu, lam, kappa, k, s0)
    S_opt = newton_soa(value, grad, hess, S, n_iters=n_iters, trips=trips)
    return soa.compose_usv(U, S_opt, V)


def _prox_tuple(f, model, mu, lam, kappa, k, n_iters):
    check_model(model)
    if model == TET_LINEAR:
        return soa.prox_tet_linear_tuple(f)
    return prox_tet_hyper_tuple(f, model, mu, lam, kappa, k, n_iters=n_iters)


def local_step_plain(dix, u, mu, lam, kappa, k, n_iters: int = 8,
                     model: str = TET_NEOHOOKEAN):
    """Fused tet local step on rows [9, T] (plain version of kernel A, any of
    the six models): v = D x + u, z = prox(v), u' = v - z. Returns (z, u')."""
    v = dix + u
    z = torch.stack(_prox_tuple(tuple(v[i] for i in range(9)), model, mu, lam, kappa, k,
                                n_iters), dim=0)
    return z, v - z


def scaled_params(mu, lam, kappa, scale):
    """The material of S scenes of stiffness scale [S] ([S, T] each): mu s,
    lam s, kappa s and the bulk lam s + (2/3) (mu s), as
    parallel/batch._scale_system and TetBatch form them."""
    s = scale[:, None]
    mu_s, lam_s = mu[None, :] * s, lam[None, :] * s
    return mu_s, lam_s, kappa[None, :] * s, lam_s + (2.0 / 3.0) * mu_s


def local_step_scenes_plain(dix, u, mu, lam, kappa, scale, n_iters: int = 8,
                            model: str = TET_NEOHOOKEAN):
    """local_step_plain over S scenes (plain version of kernel A's scene
    form): rows [S, 9, T], mu / lam / kappa [T], scale [S], each scene on
    its scaled material (scaled_params). Returns (z, u') [S, 9, T]."""
    s_cnt, _, t = dix.shape

    def lanes(a):  # [S, 9, T] -> [9, S * T]
        return a.permute(1, 0, 2).reshape(9, s_cnt * t)

    params = [p.reshape(-1) for p in scaled_params(mu, lam, kappa, scale)]
    z, uo = local_step_plain(lanes(dix), lanes(u), *params, n_iters=n_iters, model=model)
    return tuple(a.reshape(9, s_cnt, t).permute(1, 0, 2).contiguous() for a in (z, uo))


def prox_plain(zi, model: str, mu, lam, kappa, k, n_iters: int = 8):
    """Tet prox on [T, 3, 3] (plain version of kernels D and F)."""
    f = tuple(zi[:, r, c] for r in range(3) for c in range(3))
    out = _prox_tuple(f, model, mu, lam, kappa, k, n_iters)
    return torch.stack(out, dim=-1).reshape(zi.shape)
