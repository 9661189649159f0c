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

Every function also takes a leading scene axis (x [S, N, 3], rows [S, r, T],
contributions [S, T * arity, 3]), as ``jax.vmap`` gives the JAX package's
scenario batches (``parallel/batch.py``); the scenes share the mesh. There
``dt_gather_scenes`` sums a vertex's entries one table column at a time, in
column order, so that a scene's sum does not depend on how many scenes the
batch holds.
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
    """Per-vertex sum of per-corner contributions: [T*arity, 3] -> [N, 3]
    ([S, ...] with a scene axis)."""
    if contrib.ndim == 3:
        return dt_gather_scenes(contrib, gather_idx)
    flat = torch.cat([contrib, contrib.new_zeros((1, contrib.shape[1]))], dim=0)
    return torch.sum(flat[gather_idx], dim=1)


def dt_gather_scenes(contrib: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """dt_gather over a leading scene axis, [S, T*arity, 3] -> [S, N, 3]: the
    table's columns added in order, ((c0 + c1) + c2) + ..."""
    flat = torch.cat([contrib, contrib.new_zeros((contrib.shape[0], 1, contrib.shape[2]))],
                     dim=1)
    out = flat[:, gather_idx[:, 0]]
    for k in range(1, gather_idx.shape[1]):
        out = out + flat[:, gather_idx[:, k]]
    return out


def tet_Dx_rows(x: torch.Tensor, inds: torch.Tensor, Dlocal: torch.Tensor) -> torch.Tensor:
    """D x of a tet family as rows [9, T] (row-major F entries); x [S, N, 3]
    gives [S, 9, T]."""
    x4 = x[..., inds, :]  # [..., T, 4, 3]
    rows = [sum(x4[..., j, r] * Dlocal[:, j, c] for j in range(4))
            for r in range(3) for c in range(3)]
    return torch.stack(rows, dim=-2)


def tet_Dt_rows(G_rows: torch.Tensor, Dlocal: torch.Tensor,
                gather_idx: torch.Tensor) -> torch.Tensor:
    """D^T G of a tet family from rows [9, T] into [N, 3] (N = rows of the
    gather table); rows [S, 9, T] give [S, N, 3]."""
    # contrib[t, j, r] = sum_c G[r, c][t] * Dlocal[t, j, c], j-major like inds
    contrib = torch.stack(
        [sum(G_rows[..., 3 * r + c, :] * Dlocal[:, j, c] for c in range(3))
         for j in range(4) for r in range(3)], dim=-1)
    return dt_gather(contrib.reshape(G_rows.shape[:-2] + (-1, 3)), gather_idx)


def tri_Dx_rows(x: torch.Tensor, inds: torch.Tensor, Dlocal: torch.Tensor) -> torch.Tensor:
    """D x of a triangle family as rows [6, T] (row-major 3x2 entries); x
    [S, N, 3] gives [S, 6, T]."""
    x3 = x[..., inds, :]  # [..., T, 3, 3]
    rows = [sum(x3[..., j, r] * Dlocal[:, j, c] for j in range(3))
            for r in range(3) for c in range(2)]
    return torch.stack(rows, dim=-2)


def tri_Dt_rows(G_rows: torch.Tensor, Dlocal: torch.Tensor,
                gather_idx: torch.Tensor) -> torch.Tensor:
    """D^T G of a triangle family from rows [6, T] into [N, 3] ([S, ...] with
    a scene axis)."""
    contrib = torch.stack(
        [sum(G_rows[..., 2 * r + c, :] * Dlocal[:, j, c] for c in range(2))
         for j in range(3) for r in range(3)], dim=-1)
    return dt_gather(contrib.reshape(G_rows.shape[:-2] + (-1, 3)), gather_idx)


def pin_Dx(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[P, 3] positions of the pinned vertices ([S, P, 3] of x [S, N, 3])."""
    return x[..., idx, :]


def pin_Dt(G: torch.Tensor, idx: torch.Tensor, n_verts: int) -> torch.Tensor:
    """[P, 3] -> [N, 3], each row written once at its pinned vertex ([S, ...]
    with a scene axis)."""
    out = G.new_zeros(G.shape[:-2] + (n_verts, 3))
    return out.index_copy_(out.ndim - 2, idx, G)
