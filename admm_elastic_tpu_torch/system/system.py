"""The assembled simulation system and its matrix-free operators.

A port of ``admm_elastic_tpu/system/system.py:58-253``: tet families (any
of the six models) and cloth families, each a flat stencil or a gather family
(``system/elements.py``; the two may be mixed in one system), and pins as
spring energies. The per-family iterates come in the order tets, tris, pins.

  local step: z, u <- prox(D x + u)    stencil tets / sheets: kernel A / E's
                                       stencil entry, each lane computing its
                                       own D x; gather families: D x by
                                       gather, then A / E's rows entry; pins
                                       by gather
  rhs: b = M x_bar + dt^2 D^T W^2 (z - u)   stencil tets: kernel C; sheets:
                                       tri_Dt_rows; gather families: the
                                       gather-table D^T; pins by copy
  A x = M x + dt^2 D^T W^2 D x         the same with z = D x, u = 0

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


@dataclasses.dataclass(frozen=True)
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


@dataclasses.dataclass(frozen=True)
class SimState:
    """Dynamic state (the JAX package's SimState): positions and velocities
    (src/Solver.hpp:66-67), and the contact multipliers carried from one
    global solve to the next with the active constraint rows of the last one,
    which gate their warm start (src/UzawaCG.hpp:68-74; kept only where the
    active set is unchanged). y and prev_active have 2 H entries (H surface
    vertices), 0 where the scene has no collision object."""

    x: torch.Tensor  # [N, 3]
    v: torch.Tensor  # [N, 3]
    y: torch.Tensor  # [2 H] multipliers: passive rows, then dynamic rows
    prev_active: torch.Tensor  # bool [2 H]

    def clone(self) -> "SimState":
        return SimState(x=self.x.clone(), v=self.v.clone(), y=self.y.clone(),
                        prev_active=self.prev_active.clone())


def Dx(system: System, x):
    """D x as a list of per-family iterates: tet rows [9, T], sheet rows
    [6, T], then pins [P, 3]."""
    out = [cuda_stencil.tet_Dx_rows(x, b) if b.stencil is not None else b.Dx_rows(x)
           for b in system.tets]
    out += [stencil_mod.tri_Dx_rows(x, b) if b.stencil is not None else b.Dx_rows(x)
            for b in system.tris]
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


def flat(v_list):
    """The per-family iterates as one vector (the Anderson variable)."""
    return torch.cat([vi.reshape(-1) for vi in v_list])


def unflat(system: System, vec):
    """flat's inverse: views of vec in the shapes D x gives."""
    shapes = [(9, b.n) for b in system.tets] + [(6, b.n) for b in system.tris]
    if system.pins is not None:
        shapes.append((system.pins.n, 3))
    out, o = [], 0
    for shape in shapes:
        n = shape[0] * shape[1]
        out.append(vec[o:o + n].reshape(shape))
        o += n
    return out


def prox_split(system: System, v_list, n_newton_iters: int = 8):
    """z_i = prox(v_i), u_i = v_i - z_i per family: the Anderson iteration's
    local step (admm_elastic_tpu/solver.py:320-322). Tets and sheets take
    kernel A's and E's rows entries with u = 0, whose u' = (v + 0) - z is
    v - z bit for bit; the pins their prox."""
    new_z, new_u = [], []
    for b, v in zip(tuple(system.tets) + tuple(system.tris), v_list):
        zi, ui = b.local_step_rows(v, torch.zeros_like(v), n_newton_iters)
        new_z.append(zi)
        new_u.append(ui)
    if system.pins is not None:
        zi = system.pins.prox(v_list[-1])
        new_z.append(zi)
        new_u.append(v_list[-1] - zi)
    return new_z, new_u


def local_step(system: System, x, z_list, u_list, n_newton_iters: int = 8):
    """z_i = prox(D_i x + u_i); u_i += D_i x - z_i (src/EnergyTerm.hpp:130-140)."""
    new_z, new_u = [], []
    for b, u in zip(tuple(system.tets) + tuple(system.tris), u_list):
        zi, ui = b.local_step_x(x, u, n_newton_iters)
        new_z.append(zi)
        new_u.append(ui)
    if system.pins is not None:
        dix, u = red.pin_Dx(x, system.pins.idx), u_list[-1]
        zi = system.pins.prox(dix + u)
        new_z.append(zi)
        new_u.append(u + dix - zi)
    return new_z, new_u


def _elastic(system: System, z_list, u_list):
    """sum_f D_f^T W_f^2 (z_f - u_f) -> [N, 3] (no dt^2 factor)."""
    n = system.n_verts
    parts = []
    for b, z, u in zip(system.tets, z_list, u_list):
        if b.stencil is not None:
            parts.append(cuda_stencil.tet_rhs_rows(z, u, b, n))
        else:
            w2 = (b.weight * b.weight)[None, :]
            parts.append(red.tet_Dt_rows(w2 * (z - u), b.Dlocal, b.gather_idx))
    k = len(system.tets)
    for b, z, u in zip(system.tris, z_list[k:], u_list[k:]):
        w2 = (b.weight * b.weight)[None, :]
        if b.stencil is not None:
            parts.append(stencil_mod.tri_Dt_rows(w2 * (z - u), b, n))
        else:
            parts.append(red.tri_Dt_rows(w2 * (z - u), b.Dlocal, b.gather_idx))
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


def diag_A(system: System):
    """diag of the single-component N x N operator A (all 3 components
    equal): M + dt^2 diag(D^T W^2 D), plain PyTorch (index_add_)."""
    n = system.n_verts

    def scatter(weight2, Dlocal, inds):
        d = weight2[:, None] * (Dlocal * Dlocal).sum(dim=-1)
        out = torch.zeros((n,), dtype=Dlocal.dtype, device=Dlocal.device)
        return out.index_add_(0, inds.reshape(-1).long(), d.reshape(-1))

    d = system.masses
    for b in tuple(system.tets) + tuple(system.tris):
        d = d + system.dt2 * scatter(b.weight * b.weight, b.Dlocal, b.inds)
    if system.pins is not None:
        w2 = system.pins.weight ** 2
        d = d + system.dt2 * torch.zeros_like(d).index_add_(0, system.pins.idx, w2)
    return d


def total_energy(system: System, x):
    """The sum of the element energies at x [N, 3] (a debugging aid, the
    reference's EnergyTerm::energy wrappers, src/EnergyTerm.hpp:142-148):
    each family's D x rows taken to [T, 3, 3] or [T, 3, 2]."""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for b, dix in zip(tuple(system.tets) + tuple(system.tris), Dx(system, x)):
        cols = dix.shape[0] // 3
        total = total + b.energy(dix.T.reshape(-1, 3, cols)).sum()
    return total


def init_state(x, n_constraint_rows: int = 0) -> SimState:
    """The state at rest at x: v = 0, no multiplier, no active row."""
    x = torch.as_tensor(x)
    return SimState(x=x, v=torch.zeros_like(x),
                    y=torch.zeros((n_constraint_rows,), dtype=x.dtype, device=x.device),
                    prev_active=torch.zeros((n_constraint_rows,), dtype=torch.bool,
                                            device=x.device))
