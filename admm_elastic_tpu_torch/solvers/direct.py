"""Prefactored direct solve (``admm_elastic_tpu/solvers/direct.py``).

A is component-decoupled, so ``prepare`` factors the N x N single-component
matrix once on the host in float64, in one of two modes:

- "inv": the inverse after Jacobi equilibration B = S A S,
  S = diag(A)^(-1/2). Each solve is one [N,N] @ [N,3] GEMM,
  x = S (B^-1 (S b)), through ``torch.matmul``: a plain large matrix
  product, which the JAX package also left outside Pallas. In float32 on
  CUDA it must run in full FP32, so ``solve`` raises if TF32 or a lower
  matmul precision is enabled. The TPU's bf16x3 precision tier is not
  carried over.
- "cho": the Cholesky factor L (``np.linalg.cholesky``). Each solve is two
  triangular solves, L y = b and L^T x = y, through
  ``torch.linalg.solve_triangular`` (the JAX package's
  ``jax.scipy.linalg.solve_triangular``, also outside Pallas).

``polish`` runs two Jacobi sweeps on the pin rows, restoring hard-pin
accuracy that the float32 inverse loses on those stiff rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DirectData:
    mat: torch.Tensor  # [N, N] (S A S)^-1 ("inv") or the Cholesky factor L ("cho")
    scale: torch.Tensor  # [N, 1] S = diag(A)^(-1/2) ("inv"; ones for "cho")
    pin_idx: Optional[torch.Tensor] = None  # i64 [P]
    pin_cols: Optional[torch.Tensor] = None  # i64 [P, K] off-diagonal columns
    pin_vals: Optional[torch.Tensor] = None  # [P, K]
    pin_diag: Optional[torch.Tensor] = None  # [P]
    mode: str = "inv"


def prepare(A_dense: np.ndarray, *, device, dtype: torch.dtype, mode: str = "inv",
            pin_rows=None) -> DirectData:
    """One-time factorization (host, float64)."""
    if mode not in ("inv", "cho"):
        raise ValueError(f"direct.prepare: unknown mode {mode!r}")
    pin_kw = {}
    if pin_rows is not None:
        pin_idx, pin_cols, pin_vals, pin_diag = pin_rows
        pin_kw = dict(
            pin_idx=torch.as_tensor(np.asarray(pin_idx, np.int64), device=device),
            pin_cols=torch.as_tensor(np.asarray(pin_cols, np.int64), device=device),
            pin_vals=torch.as_tensor(np.asarray(pin_vals, np.float64)).to(device, dtype),
            pin_diag=torch.as_tensor(np.asarray(pin_diag, np.float64)).to(device, dtype),
        )
    if mode == "cho":
        L = np.linalg.cholesky(A_dense)
        return DirectData(mat=torch.as_tensor(L).to(device, dtype),
                          scale=torch.ones((L.shape[0], 1), dtype=dtype, device=device),
                          mode="cho", **pin_kw)
    d = np.sqrt(np.diag(A_dense))
    s = 1.0 / d
    B = A_dense * s[:, None] * s[None, :]
    Binv = np.linalg.inv(B)
    return DirectData(
        mat=torch.as_tensor(Binv).to(device, dtype),
        scale=torch.as_tensor(s[:, None]).to(device, dtype),
        mode="inv",
        **pin_kw,
    )


def _check_fp32_matmul(t: torch.Tensor) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        return
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "direct.solve needs full-FP32 matmul: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def solve(data: DirectData, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for b [N, 3]."""
    _check_fp32_matmul(b)
    if data.mode == "cho":
        y = torch.linalg.solve_triangular(data.mat, b, upper=False)
        return torch.linalg.solve_triangular(data.mat.mT, y, upper=True)
    return data.scale * torch.matmul(data.mat, data.scale * b)


def polish(data: DirectData, x: torch.Tensor, b: torch.Tensor, sweeps: int = 2) -> torch.Tensor:
    """Jacobi sweeps on the pin rows of A x = b (no-op without pin data)."""
    if data.pin_idx is None:
        return x
    for _ in range(sweeps):
        off = torch.sum(data.pin_vals[:, :, None] * x[data.pin_cols], dim=1)
        x = x.index_copy(0, data.pin_idx, (b[data.pin_idx] - off) / data.pin_diag[:, None])
    return x
