"""Preconditioned conjugate gradient for the global step (``linsolver=3``).

A port of ``admm_elastic_tpu/solvers/pcg.py``: ``PCGData``, ``prepare``, the
operator's ``diag``, ``apply``, ``apply_T``, ``off_apply`` and ``_banded_T``,
the Jacobi and two-grid preconditioners, and ``solve`` / ``solve_T`` as plain
PyTorch. A acts alike on the three coordinates, so the [N, 3] state is one
Krylov vector and every dot product sums over all of it. ``solve_T`` runs
the loop on lane-major [3, N] vectors, as the JAX package does.

These are the plain versions. On the card the step runs the whole solve as
one launch of kernel G (``ops/cuda_pcg.py``, ``csrc/pcg.cu``), held to
``solve_T`` here; ``solve_T`` reads ``done`` on the host to stop, as the JAX
package's ``lax.while_loop`` stops, so it runs on the CPU and in the card's
checks, never inside a captured step.

The operator: A = diag(masses + pins + stiffness) + off-diagonal stiffness,
the off-diagonal as constant bands in a banded vertex order (``ops/spmv.py``,
with an RCM permutation where the native order is not banded, and circular
bands on a ring) plus a thin rest-ELL, or as one ELL table
(``spmv_format="ell"``). The operator's functions take the JAX package's
stiffness ``scale`` (scenario batching, ``parallel/batch.py``): a number, or a
per-scene tensor [S] broadcast over a leading scene axis of the vectors; it
scales the stiffness diagonal, the bands and the ELL, never the pins'
diagonal (a scaled pin diagonal would settle pinned vertices near
target / scale). ``solve_T_scenes`` is ``solve_T`` over that scene axis with
each scene's own exit, the plain twin of kernel G's batched form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from admm_elastic_tpu_torch.ops import reduction as red


def _per_scene(scale, ndim: int):
    """scale as a factor of an array of ndim dimensions: a per-scene tensor
    [S] shaped [S, 1, ..., 1] (a leading scene axis), a number as it is."""
    if isinstance(scale, torch.Tensor) and scale.ndim == 1:
        return scale.reshape((-1,) + (1,) * (ndim - 1))
    return scale


@dataclasses.dataclass(frozen=True)
class PCGData:
    """Operator data of the PCG global step (the JAX package's PCGData).

    With bands the ELL holds only the rest (entries off the kept diagonals,
    K often 0); without, the whole off-diagonal. ``band_offsets`` and
    ``band_circular`` are host fields: the apply unrolls one shifted product
    per band.
    """

    ell_cols: torch.Tensor  # i32 [N, K] off-diagonal neighbour columns
    ell_vals: torch.Tensor  # [N, K] off-diagonal entries (pad 0)
    diag_mass: torch.Tensor  # [N] lumped masses
    diag_stiff: torch.Tensor  # [N] dt^2 D^T W^2 D element diagonal
    diag_pin: torch.Tensor  # [N] dt^2 w_pin^2 on pinned vertices
    agg: Optional[torch.Tensor] = None  # i32 [N] aggregate of each vertex (two-grid)
    agg_gather: Optional[torch.Tensor] = None  # i32 [C, Kc] P^T gather table (pad N)
    coarse_inv: Optional[torch.Tensor] = None  # [C, C] inverse of P^T A P
    bands: Optional[torch.Tensor] = None  # [D, N] A[i, i + off_d] in band order
    perm: Optional[torch.Tensor] = None  # i64 [N] RCM order: row i is vertex perm[i]
    iperm: Optional[torch.Tensor] = None  # i64 [N]
    band_offsets: Tuple[int, ...] = ()
    band_circular: bool = False  # offsets mod N, the apply wraps (ring lattices)

    @property
    def n(self) -> int:
        return self.diag_mass.shape[0]

    def diag(self, scale=None):
        """[N], or [S, N] for a per-scene scale."""
        d = self.diag_stiff if scale is None else _per_scene(scale, 2) * self.diag_stiff
        return self.diag_mass + self.diag_pin + d

    def precondition(self, scale=None, omega: float = 0.7):
        """M^-1 apply on [N, k] (or [S, N, k]): Jacobi, or with the coarse
        level attached a symmetric two-grid V-cycle (damped-Jacobi smooth,
        coarse correction, damped-Jacobi smooth)."""
        inv_d = (1.0 / self.diag(scale))[..., None]
        if self.agg is None:
            return lambda r: inv_d * r

        def apply_m(r):
            z = omega * inv_d * r
            res = r - self.apply(z, scale)
            rc = red.dt_gather(res, self.agg_gather)  # P^T res
            ec = torch.matmul(self.coarse_inv, rc)  # full FP32 (see _check_fp32)
            z = z + ec[..., self.agg, :]
            z = z + omega * inv_d * (r - self.apply(z, scale))
            return z

        _check_fp32(self.coarse_inv)
        return apply_m

    def apply(self, x, scale=None):
        """A x for x [N, k] (or [S, N, k] with a per-scene scale)."""
        off = self.off_apply(x, scale)
        return self.diag(scale)[..., None] * x + off

    def precondition_T(self, scale=None, omega: float = 0.7):
        """M^-1 apply on lane-major [k, N] (or [S, k, N]) vectors; the two-grid
        V-cycle keeps its [N, k] form behind transposes."""
        if self.agg is None:
            inv_d = (1.0 / self.diag(scale))[..., None, :]
            return lambda rT: inv_d * rT
        m = self.precondition(scale, omega)
        return lambda rT: m(rT.transpose(-1, -2)).transpose(-1, -2)

    def apply_T(self, xT, scale=None):
        """A x for lane-major xT [k, N] (or [S, k, N]): bands without a
        permutation or rest directly, the other forms through apply."""
        if self.bands is not None and self.perm is None and not self.ell_cols.shape[1]:
            off = self._banded_T(xT, scale)
            return self.diag(scale)[..., None, :] * xT + off
        return self.apply(xT.transpose(-1, -2), scale).transpose(-1, -2)

    def _banded_T(self, xT, scale=None):
        bands = self.bands if scale is None else _per_scene(scale, 3) * self.bands
        lo = max(-min(self.band_offsets), 0)
        hi = max(max(self.band_offsets), 0)
        n = xT.shape[-1]
        if self.band_circular:
            # x[(i + o) mod N] = xp[..., i + lo + o]
            xp = torch.cat([xT[..., n - lo:], xT, xT[..., :hi]], dim=-1)
        else:
            xp = torch.nn.functional.pad(xT, (lo, hi))
        acc = torch.zeros_like(xT)
        for i, o in enumerate(self.band_offsets):
            acc = acc + bands[..., i, None, :] * xp[..., lo + o:lo + o + n]
        return acc

    def off_apply(self, x, scale=None):
        """Off-diagonal apply: bands (+ the rest-ELL), or the ELL alone."""
        vals = self.ell_vals if scale is None else _per_scene(scale, 3) * self.ell_vals
        if self.bands is None:
            return torch.sum(vals[..., None] * x[..., self.ell_cols, :], dim=-2)
        xb = x if self.perm is None else x[..., self.perm, :]
        off = self._banded_T(xb.transpose(-1, -2), scale).transpose(-1, -2)
        if self.ell_cols.shape[1]:
            off = off + torch.sum(vals[..., None] * xb[..., self.ell_cols, :], dim=-2)
        return off if self.perm is None else off[..., self.iperm, :]


def _check_fp32(t: torch.Tensor) -> None:
    """The coarse matmul runs in full FP32 on the card, as the JAX package's
    (Precision.HIGHEST): TF32 must be off."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the two-grid preconditioner needs full-FP32 matmul: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _np64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def prepare(system, dtype: torch.dtype, precond: str = "jacobi", agg_size: int = 24,
            spmv_format: str = "auto", *, device=None) -> PCGData:
    """One-time operator assembly of A on the host (the JAX package's
    prepare), onto ``device`` (the system's unless given).

    precond in {"jacobi", "twogrid"}; spmv_format in {"auto", "bands", "ell"}:
    "auto" takes the bands where the kept diagonals (after RCM if needed)
    cover >= 90% of the off-diagonal nonzeros.
    """
    from admm_elastic_tpu_torch.ops import spmv
    from admm_elastic_tpu_torch.system import assembly

    device = system.masses.device if device is None else torch.device(device)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    ell_cols, ell_vals, diag = assembly.assemble_ell(system, dtype=np.float64)
    bands = perm = iperm = None
    band_offsets = ()
    band_circular = False
    if spmv_format in ("auto", "bands") and ell_cols.shape[1]:
        plan = spmv.plan_bands(ell_cols, ell_vals)
        if plan.offsets and (plan.coverage >= 0.9 or spmv_format == "bands"):
            band_offsets = plan.offsets
            band_circular = plan.circular
            bands = dev(plan.bands)
            ell_cols = plan.rest_cols
            ell_vals = plan.rest_vals
            if plan.perm is not None:
                perm = dev(plan.perm, torch.int64)
                iperm = dev(plan.iperm, torch.int64)
    elif spmv_format != "ell" and spmv_format not in ("auto", "bands"):
        raise ValueError(f"unknown spmv_format {spmv_format!r}")
    masses = _np64(system.masses)
    pin_diag = np.zeros_like(masses)
    if system.pins is not None:
        dt2 = system.dt * system.dt
        w2 = _np64(system.pins.weight) ** 2
        np.add.at(pin_diag, system.pins.idx.cpu().numpy(), dt2 * w2)
    agg = agg_gather = coarse_inv = None
    if precond == "twogrid":
        adj = assembly.vertex_adjacency(system)
        agg_np = assembly.greedy_aggregates(adj, target_size=agg_size)
        a_c = assembly.coarse_matrix(system, agg_np)
        d_c = np.sqrt(np.diag(a_c))
        s_c = 1.0 / d_c
        b_inv = np.linalg.inv(a_c * s_c[:, None] * s_c[None, :])
        agg = dev(agg_np, torch.int32)
        agg_gather = dev(red.build_gather_table(agg_np[:, None], int(agg_np.max()) + 1),
                         torch.int32)
        coarse_inv = dev(s_c[:, None] * b_inv * s_c[None, :])
    elif precond != "jacobi":
        raise ValueError(f"unknown pcg preconditioner {precond!r}")
    return PCGData(
        ell_cols=dev(ell_cols, torch.int32),
        ell_vals=dev(ell_vals),
        diag_mass=dev(masses),
        diag_stiff=dev(diag - masses - pin_diag),
        diag_pin=dev(pin_diag),
        agg=agg,
        agg_gather=agg_gather,
        coarse_inv=coarse_inv,
        bands=bands,
        perm=perm,
        iperm=iperm,
        band_offsets=tuple(int(o) for o in band_offsets),
        band_circular=bool(band_circular),
    )


def _tolerance(b: torch.Tensor, tol, b_norm2: torch.Tensor) -> torch.Tensor:
    """tol2 = max(tol, 64 eps)^2 * max(|b|^2, tiny) in b's dtype: the reference
    default 1e-10 is below float32 precision, so it clamps (in float64 the
    clamp is a no-op)."""
    fi = torch.finfo(b.dtype)
    t = torch.clamp_min(torch.as_tensor(tol, dtype=b.dtype, device=b.device), 64 * fi.eps)
    return t * t * torch.clamp_min(b_norm2, fi.tiny)


def _cg(A_mv, apply_m, b, x0, tol, max_iters: int):
    """The JAX package's while-loop, stopped on the host: (x, trips)."""
    tiny = torch.finfo(b.dtype).tiny

    def dot(a, c):
        return torch.sum(a * c)

    tol2 = _tolerance(b, tol, dot(b, b))
    r = b - A_mv(x0)
    z = apply_m(r)
    x, p, rz = x0, z, dot(r, z)
    done = bool(dot(r, r) < tol2)
    k = 0
    while not done and k < max_iters:
        Ap = A_mv(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom.abs() < tiny, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz.abs() < tiny, torch.ones_like(rz), rz)
        p = z + beta * p
        done = bool(dot(r, r) < tol2)
        rz = rz_new
        k += 1
    return x, k


def solve(A_mv, precond, b, x0, tol, max_iters: int):
    """Solve A x = b with preconditioned CG on [N, 3]. precond: an M^-1
    callable, or the [N] Jacobi diagonal. Returns (x, trips)."""
    if callable(precond):
        apply_m = precond
    else:
        inv_d = (1.0 / precond)[:, None]

        def apply_m(r):
            return inv_d * r

    return _cg(A_mv, apply_m, b, x0, tol, int(max_iters))


def solve_T(A_mv_T, precond_T, b, x0, tol, max_iters: int):
    """solve() with lane-major [k, N] internals (PCGData.apply_T /
    precondition_T); b, x0 and the returned x are [N, k]."""
    xT, k = _cg(A_mv_T, precond_T, b.T, x0.T, tol, int(max_iters))
    return xT.T.contiguous(), k


def solve_T_scenes(A_mv_T, precond_T, b, x0, tol, max_iters: int, done=None):
    """solve_T over a leading scene axis, each scene exiting on its own: b
    and x0 [S, N, k], A_mv_T and precond_T on [S, k, N]. A scene that is done
    keeps its carry (x, r, p, r.z, its trips) while the others go on: what
    jax.vmap of the JAX package's while_loop gives, a select on the batched
    predicate. done (bool [S] or None): a scene whose flag is set takes no
    trip and returns its x0 (Uzawa's predicated inner solve). The loop stops
    on the host once every scene is done or at max_iters. Returns (x [S, N,
    k], trips i32 [S]). The plain twin of kernel G's batched form
    (ops/cuda_pcg.pcg_solve_scenes)."""
    tiny = torch.finfo(b.dtype).tiny

    def dot(a, c):
        return torch.sum(a * c, dim=(1, 2))

    def keep(live, new, old):
        return torch.where(live.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

    bT = b.transpose(1, 2)
    x = x0.transpose(1, 2)
    tol2 = _tolerance(b, tol, dot(bT, bT))
    r = bT - A_mv_T(x)
    p = precond_T(r)
    rz = dot(r, p)
    done = dot(r, r) < tol2 if done is None else (dot(r, r) < tol2) | done
    trips = torch.zeros((b.shape[0],), dtype=torch.int32, device=b.device)
    for _ in range(int(max_iters)):
        if bool(done.all()):
            break
        live = ~done
        Ap = A_mv_T(p)
        denom = dot(p, Ap)
        alpha = rz / torch.where(denom.abs() < tiny, torch.ones_like(denom), denom)
        x_new = x + alpha[:, None, None] * p
        r_new = r - alpha[:, None, None] * Ap
        z = precond_T(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.where(rz.abs() < tiny, torch.ones_like(rz), rz)
        p_new = z + beta[:, None, None] * p
        x, r, p = keep(live, x_new, x), keep(live, r_new, r), keep(live, p_new, p)
        rz = keep(live, rz_new, rz)
        trips = trips + live.to(torch.int32)
        done = torch.where(live, dot(r, r) < tol2, done)
    return x.transpose(1, 2).contiguous(), trips


def _err_denom(x_star, x0, err_denom):
    """||x* - x0|| floored at the dtype's tiny: the error's normaliser where
    the caller gives none."""
    if x_star is None or err_denom is not None:
        return err_denom
    return torch.clamp_min(torch.linalg.norm(x_star - x0), torch.finfo(x0.dtype).tiny)


def trace_err(x_star, x, err_denom):
    """||x* - x|| / err_denom, or None without x_star."""
    return None if x_star is None else torch.linalg.norm(x_star - x) / err_denom


def traced(res, errs):
    """The trace dict of a solve_traced: res [n] and err [n] (None without
    x_star)."""
    return {"res": torch.stack(res) if res else torch.zeros((0,)),
            "err": torch.stack(errs) if errs and errs[0] is not None else None}


def solve_traced(A_mv, precond, b, x0, n_iters: int, x_star=None, err_denom=None):
    """Fixed-length PCG with a per-iteration residual trace (the SolverLog
    tier; admm_elastic_tpu/solvers/pcg.py:351-405): exactly n_iters trips, no
    early exit, and where a denominator falls under the dtype's tiny the step
    freezes (alpha = 0, beta = 0), so that the trace goes flat instead of NaN.
    Records res [n_iters] = ||b - A x_k|| (the recurrence's r) and, with
    x_star, err [n_iters] = ||x* - x_k|| / ||x* - x_0||.

    The JAX package's non-fused diagnostic, ported as plain PyTorch on every
    device: it has no kernel there either. Returns (x, {"res", "err"}).
    """
    if callable(precond):
        apply_m = precond
    else:
        inv_d = (1.0 / precond)[:, None]

        def apply_m(r):
            return inv_d * r

    def dot(a, c):
        return torch.sum(a * c)

    err_denom = _err_denom(x_star, x0, err_denom)
    tiny = torch.finfo(b.dtype).tiny
    r = b - A_mv(x0)
    z = apply_m(r)
    x, p, rz = x0, z, dot(r, z)
    res, errs = [], []
    for _ in range(int(n_iters)):
        Ap = A_mv(p)
        denom = dot(p, Ap)
        small = denom.abs() < tiny
        alpha = torch.where(small, 0.0, rz / torch.where(small, torch.ones_like(denom), denom))
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_m(r)
        rz_new = dot(r, z)
        flat = rz.abs() < tiny
        beta = torch.where(flat, 0.0, rz_new / torch.where(flat, torch.ones_like(rz), rz))
        p = z + beta * p
        rz = rz_new
        res.append(torch.sqrt(dot(r, r)))
        errs.append(trace_err(x_star, x, err_denom))
    return x, traced(res, errs)
