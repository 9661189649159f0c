"""The assembled simulation system and its matrix-free operators.

A port of ``admm_elastic_tpu/system/system.py``: flat-stencil tet families
(any of the six models), flat-stencil cloth sheets, and pins as spring
energies. The per-family iterates come in the order tets, tris, pins.

  local step: z, u <- prox(D x + u)           (tets: kernels B then A;
                                               sheets: tri_Dx_rows then kernel E)
  rhs:        b = M x_bar + dt^2 D^T W^2 (z - u)  (tets: kernel C; sheets:
                                               tri_Dt_rows; pins by copy)
  A x = M x + dt^2 D^T W^2 D x                (the same with z = D x, u = 0)

z and u of a tet family are SoA rows [9, T], of a sheet rows [6, T], of the
pins [P, 3].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from admm_elastic_tpu_torch.ops import cuda_stencil
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.system.elements import PinBatch, TetBatch, TriBatch


@dataclasses.dataclass
class System:
    """Static (per-initialize) simulation system."""

    masses: torch.Tensor  # [N]
    tets: Tuple[TetBatch, ...]
    pins: Optional[PinBatch]  # pins as energies, or None
    dt: float  # A is assembled and prefactored for this dt
    tris: Tuple[TriBatch, ...] = ()  # cloth sheets; none in a tet-only scene

    @property
    def n_verts(self) -> int:
        return self.masses.shape[0]

    @property
    def dt2(self) -> float:
        return self.dt * self.dt


@dataclasses.dataclass
class SimState:
    """Dynamic state: positions and velocities (src/Solver.hpp:66-67)."""

    x: torch.Tensor  # [N, 3]
    v: torch.Tensor  # [N, 3]


def Dx(system: System, x):
    """D x as a list of per-family iterates: tet rows [9, T], sheet rows
    [6, T], then pins [P, 3]."""
    out = [cuda_stencil.tet_Dx_rows(x, b) for b in system.tets]
    out += [stencil_mod.tri_Dx_rows(x, b) for b in system.tris]
    if system.pins is not None:
        out.append(red.pin_Dx(x, system.pins.idx))
    return out


def zeros_like_Dx(system: System, dtype, device):
    """Zero per-family iterates of the shapes D x gives."""
    out = [torch.zeros((9, b.n), dtype=dtype, device=device) for b in system.tets]
    out += [torch.zeros((6, b.n), dtype=dtype, device=device) for b in system.tris]
    if system.pins is not None:
        out.append(torch.zeros((system.pins.n, 3), dtype=dtype, device=device))
    return out


def local_step(system: System, x, z_list, u_list, n_newton_iters: int = 8):
    """z_i = prox(D_i x + u_i); u_i += D_i x - z_i (src/EnergyTerm.hpp:130-140)."""
    dix_list = Dx(system, x)
    new_z, new_u = [], []
    for b, dix, u in zip(tuple(system.tets) + tuple(system.tris), dix_list, u_list):
        zi, ui = b.local_step_rows(dix, u, n_newton_iters)
        new_z.append(zi)
        new_u.append(ui)
    if system.pins is not None:
        dix, u = dix_list[-1], u_list[-1]
        zi = system.pins.prox(dix + u)
        new_z.append(zi)
        new_u.append(u + dix - zi)
    return new_z, new_u


def _elastic(system: System, z_list, u_list):
    """sum_f D_f^T W_f^2 (z_f - u_f) -> [N, 3] (no dt^2 factor)."""
    n = system.n_verts
    parts = [cuda_stencil.tet_rhs_rows(z, u, b, n)
             for b, z, u in zip(system.tets, z_list, u_list)]
    k = len(system.tets)
    for b, z, u in zip(system.tris, z_list[k:], u_list[k:]):
        w2 = (b.weight * b.weight)[None, :]
        parts.append(stencil_mod.tri_Dt_rows(w2 * (z - u), b, n))
    if system.pins is not None:
        w2 = (system.pins.weight * system.pins.weight)[:, None]
        parts.append(red.pin_Dt(w2 * (z_list[-1] - u_list[-1]), system.pins.idx, n))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def rhs(system: System, M_xbar, z_list, u_list):
    """b = M x_bar + dt^2 D^T W^2 (z - u) (src/Solver.cpp:98)."""
    return M_xbar + system.dt2 * _elastic(system, z_list, u_list)


def A_mv(system: System, x):
    """A x = M x + dt^2 D^T W^2 D x for x [N, 3]: the rhs operators with
    z = D x, u = 0."""
    dx = Dx(system, x)
    return system.masses[:, None] * x + system.dt2 * _elastic(
        system, dx, [torch.zeros_like(d) for d in dx])
