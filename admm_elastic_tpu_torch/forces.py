"""Explicit (pre-ADMM) forces applied to velocities before prediction.

A port of ``admm_elastic_tpu/forces.py`` (reference src/ExplicitForce.{hpp,
cpp}): explicit forces project v before x_bar is computed
(src/Solver.cpp:53-54). ``WindForce`` is the Wejchert-Haumann (1991)
aerodynamics model per triangle, in three application orders:

- batched: every triangle reads the pre-kick velocities and each vertex sums
  the kicks of its incident triangles;
- colored: triangles greedily colored so that no color shares a vertex; colors
  apply in sequence, each as one batched update (Gauss-Seidel stability at
  ~8 batched steps);
- sequential: each triangle reads the velocities that the triangles before it
  have already kicked, in file order: the reference's single-threaded loop
  (src/ExplicitForce.cpp:55-104), the JAX package's scan over every triangle.
  On the card one launch of kernel I (``ops/cuda_wind.py``,
  ``csrc/wind_seq.cu``), which walks the triangles' level schedule
  (``cuda_wind.bake_schedule``, baked when the force is built: the scan's
  bits, a level's triangles in parallel); on the CPU its plain version.

The JAX package scatter-adds the per-triangle kicks. A scatter-add on a CUDA
device runs on atomics in an order that changes from run to run, so here
both orders are written without one: the batched order gathers, per vertex,
its incident (triangle, corner) kicks from a host-built table and adds them
in increasing triangle order (the order of a sequential scatter-add); a color
touches every vertex at most once, so it is a gather, an add and an indexed
copy. Rollouts stay bitwise repeatable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from admm_elastic_tpu_torch.ops import cuda_wind


class ExplicitForce:
    """Interface: project(dt, x, v, m) -> new v (x, v [N, 3]; the batched
    and coloured wind also [S, N, 3], a scenario batch's scenes at once)."""

    def project(self, dt, x, v, m):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class WindForce(ExplicitForce):
    """Wejchert-Haumann wind on a triangle list (see the module docstring).

    tris and direction are the JAX package's arrays; vert_slots and
    color_verts are derived on the host by ``wind_force_from_numpy`` (the
    latter from the JAX package's color_tris and color_mask). A sequential
    force bakes its level schedule when it is built (``__post_init__``, on
    every route: the host reads tris once, never inside a capture); one
    handed in is checked against tris, and a mismatch raises ValueError.
    """

    tris: torch.Tensor  # i64 [W, 3]
    direction: torch.Tensor  # [3]
    alpha_n: float = 1000.0  # normal coupling strength
    sequential: bool = False  # the reference's order: kernel I
    # Batched mode (None -> colored or sequential): per vertex its incident flat
    # (triangle*3 + corner) slots, increasing, padded with W*3 (a zero row):
    # i64 [N_touched_max + 1, K].
    vert_slots: Optional[torch.Tensor] = None
    # Colored mode: per color the valid triangles' vertex ids, i64 [L_c, 3].
    color_verts: Tuple[torch.Tensor, ...] = ()
    # Sequential mode: the triangles' level schedule, kernel I's walk.
    schedule: Optional[cuda_wind.WindSchedule] = None

    def __post_init__(self):
        if not self.sequential:
            return
        if self.schedule is None:
            object.__setattr__(self, "schedule", cuda_wind.bake_schedule(self.tris,
                                                                         self.tris.device))
        else:
            cuda_wind.check_schedule(self.schedule, self.tris)

    def _tri_force(self, dt, p, vv):
        curr_v = torch.mean(vv, dim=-2)
        v_r = curr_v - self.direction.to(vv.dtype)
        a = p[..., 1, :] - p[..., 0, :]
        bb = p[..., 2, :] - p[..., 0, :]
        n_raw = torch.linalg.cross(a, bb)
        n_len = torch.linalg.norm(n_raw, dim=-1)
        normal = n_raw / torch.clamp(n_len, min=1e-30)[..., None]
        area = 0.5 * n_len
        v_n = torch.sum(normal * v_r, dim=-1)
        force = (-self.alpha_n * area * v_n * torch.abs(v_n))[..., None] * normal
        return force * 0.33 * dt

    def project(self, dt, x, v, m):
        del m
        if self.sequential:
            return cuda_wind.wind_seq(self.tris, self.direction, self.alpha_n, dt, x, v,
                                      self.schedule)
        lead = v.shape[:-2]  # a scenario batch's scene axis, or none

        def kicks(force):  # [..., L, 3] -> [..., 3 L, 3]
            return force[..., None, :].expand(force.shape[:-1] + (3, 3)).reshape(lead + (-1, 3))

        if self.vert_slots is None:
            for tri in self.color_verts:  # [L_c, 3], vertex-disjoint
                force = self._tri_force(dt, x[..., tri, :], v[..., tri, :])
                flat = tri.reshape(-1)
                v = v.index_copy(-2, flat, v[..., flat, :] + kicks(force))
            return v
        force = self._tri_force(dt, x[..., self.tris, :], v[..., self.tris, :])  # [..., W, 3]
        # The same force goes to all three nodes (src/ExplicitForce.cpp:95-102).
        kick = kicks(force)
        kick = torch.cat([kick, kick.new_zeros(lead + (1, 3))], dim=-2)
        rows = self.vert_slots.shape[0]
        out = v[..., :rows, :]
        for k in range(self.vert_slots.shape[1]):
            out = out + kick[..., self.vert_slots[:, k], :]
        return torch.cat([out, v[..., rows:, :]], dim=-2)


def _color_triangles(tris: np.ndarray):
    """Greedy coloring of the triangle graph (edges = shared vertices).

    Host-side, one-time (topology is static). Returns ([C, L] i32 padded
    with W, [C, L] bool mask)."""
    w = len(tris)
    vert_tris: dict = {}
    for t, tri in enumerate(tris):
        for vtx in tri:
            vert_tris.setdefault(int(vtx), []).append(t)
    colors = -np.ones(w, dtype=np.int64)
    for t in range(w):
        used = set()
        for vtx in tris[t]:
            for u in vert_tris[int(vtx)]:
                if colors[u] >= 0:
                    used.add(int(colors[u]))
        c = 0
        while c in used:
            c += 1
        colors[t] = c
    n_colors = int(colors.max()) + 1 if w else 0
    groups = [np.where(colors == c)[0] for c in range(n_colors)]
    lmax = max((len(g) for g in groups), default=1)
    out = np.full((n_colors, lmax), w, dtype=np.int32)
    mask = np.zeros((n_colors, lmax), dtype=bool)
    for c, g in enumerate(groups):
        out[c, : len(g)] = g
        mask[c, : len(g)] = True
    return out, mask


def _vertex_slots(tris: np.ndarray) -> np.ndarray:
    """[max vertex id + 1, K] incident flat slots t*3 + corner per vertex, in
    increasing order, padded with W*3."""
    flat = tris.reshape(-1)
    rows = int(flat.max()) + 1 if flat.size else 0
    counts = np.bincount(flat, minlength=rows)
    k = int(counts.max()) if rows else 0
    out = np.full((rows, k), flat.size, dtype=np.int64)
    order = np.argsort(flat, kind="stable")
    start = np.concatenate(([0], np.cumsum(counts)))[flat[order]]
    out[flat[order], np.arange(flat.size) - start] = order
    return out


def wind_force_from_numpy(tris, direction, color_tris=None, color_mask=None, *, device,
                          dtype: torch.dtype, alpha_n: float = 1000.0,
                          sequential: bool = False) -> WindForce:
    """A WindForce on `device` from the JAX package's arrays (tris, direction
    and, for the colored order, color_tris and color_mask) and its flag
    sequential."""
    # np.array copies: arrays exported from JAX are read-only
    tris_np = np.array(tris, dtype=np.int64).reshape(-1, 3)
    if sequential:
        kw = dict(sequential=True)
    elif color_tris is not None:
        ct, cm = np.array(color_tris), np.array(color_mask, dtype=bool)
        kw = dict(color_verts=tuple(torch.as_tensor(tris_np[ct[c][cm[c]]], device=device)
                                    for c in range(ct.shape[0])))
    else:
        kw = dict(vert_slots=torch.as_tensor(_vertex_slots(tris_np), device=device))
    return WindForce(
        tris=torch.as_tensor(tris_np, device=device),
        direction=torch.as_tensor(np.array(direction, np.float64)).to(device, dtype),
        alpha_n=alpha_n, **kw)


def make_wind_force(tris: np.ndarray, direction=(0.0, 0.0, 0.0), *, device,
                    dtype: torch.dtype, sequential: bool = False,
                    colored: bool = False) -> WindForce:
    tris_np = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    color_tris = color_mask = None
    if colored and not sequential:
        color_tris, color_mask = _color_triangles(tris_np)
    return wind_force_from_numpy(tris_np, direction, color_tris, color_mask, device=device,
                                 dtype=dtype, sequential=sequential)
