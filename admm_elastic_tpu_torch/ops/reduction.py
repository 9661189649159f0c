"""Matrix-free D and D^T of the gather element families and of the pins.

A copy, in plain PyTorch, of ``admm_elastic_tpu/ops/reduction.py:36-205``
(``build_gather_table``, ``dt_gather``, ``tet_Dx_rows``, ``tet_Dt_rows``,
``tri_Dx_rows``, ``tri_Dt_rows``, ``pin_Dx``, ``pin_Dt``), which the JAX
package also computes outside any Pallas kernel. A family whose mesh is no
verified lattice or regular sheet keeps its elements as they come
(``inds`` [T, arity], ``Dlocal`` [T, arity, c]):

    D x:   rows[r * c + k][t] = sum_j x[inds[t, j], r] * Dlocal[t, j, k]
    D^T G: per vertex, the sum of the (element, corner) contributions that
           the host-built gather table lists for it

D^T is a gather and a sum over the table's width: no scatter-add and no
float atomics, so a rollout is bitwise repeatable on every device. Pin
indices are unique, so the pins' D^T is an indexed copy into zeros.
"""

from __future__ import annotations

import numpy as np
import torch


def build_gather_table(inds: np.ndarray, n_verts: int) -> np.ndarray:
    """Vertex -> incident (element * arity + corner) table, padded.

    inds: [T, arity] global vertex indices. Returns i32 [N, K], K the largest
    vertex valence; pad entries point at T * arity (``dt_gather`` appends a
    zero row there). Bit-equal to the JAX package's table.
    """
    inds = np.asarray(inds)
    t, arity = inds.shape
    flat = inds.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    counts = np.bincount(flat, minlength=n_verts)
    k = int(counts.max()) if counts.size else 1
    starts = np.zeros(n_verts + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    table = np.full((n_verts, max(k, 1)), t * arity, dtype=np.int32)
    within = np.arange(sorted_v.shape[0], dtype=np.int64) - starts[sorted_v]
    table[sorted_v, within] = order.astype(np.int32)
    return table


def dt_gather(contrib: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """Per-vertex sum of per-corner contributions: [T*arity, 3] -> [N, 3]."""
    flat = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))], dim=0)
    return torch.sum(flat[gather_idx], dim=1)


def tet_Dx_rows(x: torch.Tensor, inds: torch.Tensor, Dlocal: torch.Tensor) -> torch.Tensor:
    """D x of a tet family as rows [9, T] (row-major F entries)."""
    x4 = x[inds]  # [T, 4, 3]
    rows = [sum(x4[:, j, r] * Dlocal[:, j, c] for j in range(4))
            for r in range(3) for c in range(3)]
    return torch.stack(rows, dim=0)


def tet_Dt_rows(G_rows: torch.Tensor, Dlocal: torch.Tensor,
                gather_idx: torch.Tensor) -> torch.Tensor:
    """D^T G of a tet family from rows [9, T] into [N, 3] (N = rows of the
    gather table)."""
    # contrib[t, j, r] = sum_c G[r, c][t] * Dlocal[t, j, c], j-major like inds
    contrib = torch.stack(
        [sum(G_rows[3 * r + c] * Dlocal[:, j, c] for c in range(3))
         for j in range(4) for r in range(3)], dim=1).reshape(-1, 3)
    return dt_gather(contrib, gather_idx)


def tri_Dx_rows(x: torch.Tensor, inds: torch.Tensor, Dlocal: torch.Tensor) -> torch.Tensor:
    """D x of a triangle family as rows [6, T] (row-major 3x2 entries)."""
    x3 = x[inds]  # [T, 3, 3]
    rows = [sum(x3[:, j, r] * Dlocal[:, j, c] for j in range(3))
            for r in range(3) for c in range(2)]
    return torch.stack(rows, dim=0)


def tri_Dt_rows(G_rows: torch.Tensor, Dlocal: torch.Tensor,
                gather_idx: torch.Tensor) -> torch.Tensor:
    """D^T G of a triangle family from rows [6, T] into [N, 3]."""
    contrib = torch.stack(
        [sum(G_rows[2 * r + c] * Dlocal[:, j, c] for c in range(2))
         for j in range(3) for r in range(3)], dim=1).reshape(-1, 3)
    return dt_gather(contrib, gather_idx)


def pin_Dx(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, 3] positions of the pinned vertices."""
    return x[idx]


def pin_Dt(G: torch.Tensor, idx: torch.Tensor, n_verts: int) -> torch.Tensor:
    """[P, 3] -> [N, 3], each row written once at its pinned vertex."""
    out = G.new_zeros((n_verts, 3))
    return out.index_copy_(0, idx, G)
