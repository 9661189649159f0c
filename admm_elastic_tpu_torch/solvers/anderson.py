"""Safeguarded Anderson acceleration of the ADMM fixed point.

A port of ``admm_elastic_tpu/solvers/anderson.py``. The ADMM iteration
(local prox + global solve, src/Solver.cpp:80-102 in the reference) is
Douglas-Rachford splitting on the element-space variable v = D x + u: one
iteration maps

    z = prox(v);  u = v - z;  x = A^-1 b(z, u);  v' = D x + u = g(v).

Anderson acceleration (type II, window m) extrapolates v from the last m
fixed-point residuals f_i = g(v_i) - v_i, and takes the plain iterate
whenever the residual norm does not decrease (the safeguard of Peng, Deng,
Zhang, Liu, "Anderson Acceleration for Geometry Optimization and Physics
Simulation", 2018).

Every decision is a tensor on the device: the history is fixed-shape rolling
buffers, the slot write a one-hot ``torch.where`` on a device index, the
safeguard a ``torch.where``, and the m x m solve ``torch.linalg.solve_ex``
without its error check (``torch.linalg.solve`` reads its status on the
host). So ``update`` runs inside a captured step with no host read. The
[m, L] Gram matrix and right-hand side are matrix products, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AAState:
    """Rolling Anderson history (all fixed shapes; L = len(v))."""

    dv: torch.Tensor  # [m, L] differences v_{i+1} - v_i
    dg: torch.Tensor  # [m, L] differences g_{i+1} - g_i
    v_prev: torch.Tensor  # [L] previous v
    g_prev: torch.Tensor  # [L] previous g(v)
    count: torch.Tensor  # i32 0-d: valid history entries (<= m)
    prev_fnorm: torch.Tensor  # 0-d: ||f|| of the last accepted iterate


def init(m: int, v0: torch.Tensor) -> AAState:
    return AAState(
        dv=v0.new_zeros((m,) + tuple(v0.shape)),
        dg=v0.new_zeros((m,) + tuple(v0.shape)),
        v_prev=v0,
        g_prev=torch.zeros_like(v0),
        count=torch.zeros((), dtype=torch.int32, device=v0.device),
        prev_fnorm=torch.full((), torch.finfo(v0.dtype).max, dtype=v0.dtype, device=v0.device),
    )


def update(state: AAState, v: torch.Tensor, gv: torch.Tensor, safeguard: float = 1.0,
           reg: float = 1e-10):
    """One safeguarded AA step: returns (v_next, new_state, ||f||).

    v: the current iterate (the one gv was computed from); gv: g(v), the
    plain next iterate. safeguard: accept the acceleration only while
    ||f|| <= safeguard * the last accepted ||f||; on a violation the history
    (and the pending (v_prev, g_prev) pair) is dropped and the plain iterate
    taken. reg: Tikhonov regularisation of the m x m normal equations.
    """
    m = state.dv.shape[0]
    f = gv - v
    fnorm = torch.sqrt(torch.sum(f * f))

    ok = fnorm <= safeguard * state.prev_fnorm
    count = torch.where(ok, state.count, torch.zeros_like(state.count))

    have_prev = count > 0
    slots = torch.arange(m, device=v.device)
    slot = torch.remainder(torch.clamp_min(count - 1, 0), m)
    at_slot = (slots == slot)[:, None]
    dv = torch.where(have_prev, torch.where(at_slot, (v - state.v_prev)[None], state.dv), 0.0)
    dg = torch.where(have_prev, torch.where(at_slot, (gv - state.g_prev)[None], state.dg), 0.0)

    valid = (slots < torch.clamp_max(count, m))[:, None]
    df = (dg - dv) * valid  # [m, L]

    # Normal equations (df df^T + lam I) theta = df f; a masked slot gets an
    # identity row (theta = 0 there).
    gram = df @ df.T
    rhs = df @ f
    scale = torch.clamp_min(torch.trace(gram), 1.0)
    eye = torch.eye(m, dtype=v.dtype, device=v.device)
    mask_d = torch.where(valid[:, 0], 0.0, 1.0).to(v.dtype)
    gram = gram + (reg * scale) * eye + torch.diag(mask_d)
    # LU with partial pivoting (the JAX reference's LAPACK gesv on the CPU);
    # no status is read on the host, so a capture takes it
    theta = torch.linalg.solve_ex(gram, rhs[:, None], check_errors=False)[0][:, 0]

    v_acc = gv - theta @ (dg * valid)
    v_next = torch.where(have_prev & ok, v_acc, gv)

    new_state = AAState(
        dv=dv,
        dg=dg,
        v_prev=v,
        g_prev=gv,
        count=count + 1,
        prev_fnorm=torch.where(ok, fnorm, state.prev_fnorm),
    )
    return v_next, new_state, fnorm
