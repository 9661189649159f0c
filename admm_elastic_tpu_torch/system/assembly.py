"""Host-side (numpy) assembly of the single-component global matrix.

A copy of ``_coo_entries``, ``assemble_dense`` and ``assemble_ell`` from
``admm_elastic_tpu/system/assembly.py``. The system's tensors are read
back in their run dtype and widened to float64, as the JAX package reads
its arrays, so A is the same bit for bit:

    A_hat[i, j] = m_i delta_ij + dt^2 sum_elements w^2 (Dlocal Dlocal^T)[a, b]
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _np64(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _coo_entries(system) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (rows, cols, vals) of dt^2 * D^T W^2 D in single-component form."""
    rows, cols, vals = [], [], []
    dt2 = system.dt * system.dt
    for b in system.tets:
        inds = b.inds.cpu().numpy()  # [T, k]
        Dl = _np64(b.Dlocal)  # [T, k, c]
        w2 = _np64(b.weight) ** 2  # [T]
        K = np.einsum("tac,tbc->tab", Dl, Dl) * (dt2 * w2)[:, None, None]  # [T,k,k]
        k = inds.shape[1]
        rows.append(np.repeat(inds, k, axis=1).reshape(-1))
        cols.append(np.tile(inds, (1, k)).reshape(-1))
        vals.append(K.reshape(-1))
    if system.pins is not None:
        idx = system.pins.idx.cpu().numpy()
        w2 = _np64(system.pins.weight) ** 2
        rows.append(idx)
        cols.append(idx)
        vals.append(dt2 * w2)
    if not rows:
        z = np.zeros((0,), dtype=np.int64)
        return z, z, np.zeros((0,), dtype=np.float64)
    r = np.concatenate(rows).astype(np.int64)
    c = np.concatenate(cols).astype(np.int64)
    v = np.concatenate(vals)
    # Exact zeros (the dead lanes' weight-0 entries) carry no coupling.
    keep = v != 0.0
    return r[keep], c[keep], v[keep]


def assemble_dense(system) -> np.ndarray:
    """Dense single-component A_hat [N, N] (f64), for the direct solver."""
    n = system.n_verts
    A = np.zeros((n, n), dtype=np.float64)
    rows, cols, vals = _coo_entries(system)
    np.add.at(A, (rows, cols), vals)
    A[np.arange(n), np.arange(n)] += _np64(system.masses)
    return A


def _dedup_coo(rows, cols, vals, n):
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    _, start = np.unique(key, return_index=True)
    sums = np.add.reduceat(vals, start) if len(vals) else vals
    return rows[start], cols[start], sums


def assemble_ell(system, dtype=np.float64):
    """Padded ELL of A_hat: (cols i32 [N,K], vals [N,K], diag [N]).

    Off-diagonal entries only; padding columns point at row 0 with value 0.
    diag includes masses.
    """
    n = system.n_verts
    rows, cols, vals = _coo_entries(system)
    rows, cols, vals = _dedup_coo(rows, cols, vals, n)
    diag = np.zeros((n,), dtype=np.float64)
    on_diag = rows == cols
    diag[rows[on_diag]] += vals[on_diag]
    diag += _np64(system.masses)

    rows, cols, vals = rows[~on_diag], cols[~on_diag], vals[~on_diag]
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    ell_cols = np.zeros((n, K), dtype=np.int32)
    ell_vals = np.zeros((n, K), dtype=np.float64)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    slot = np.arange(len(rows)) - np.concatenate(([0], np.cumsum(counts)))[rows]
    ell_cols[rows, slot] = cols
    ell_vals[rows, slot] = vals
    return ell_cols, ell_vals.astype(dtype), diag.astype(dtype)
