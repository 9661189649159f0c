"""Element-family batches (dataclasses of tensors) and the host functions
that build them.

A port of ``admm_elastic_tpu/system/elements.py`` (``TetBatch``,
``build_tet_batch`` :294-373, ``TriBatch``, ``build_tri_batch`` :375-457,
``PinBatch``, ``build_pin_batch``). ``build_*`` compute on the host in float64
numpy, as the JAX package does, then place each field on ``device`` in
``dtype``; the arrays are the JAX package's bit for bit.

A family takes one of two layouts. A verified make_tet_blocks lattice or a
regular triangle sheet takes the flat stencil (slot-major lanes over cells,
``stencil`` and the ``st_*`` fields set): the local step's stencil entry
computes D x inside its launch. Any other mesh is a gather family: its
elements as they come, D x and D^T by gather (``ops/reduction.py``, through
the vertex -> corner table ``gather_idx`` that ``Solver.initialize``
attaches), and the local step's rows entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_prox, cuda_tri_local_step
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.ops.prox import (TET_LINEAR, check_model, energy_tet_hyper,
                                             energy_tet_linear, energy_tri, prox_pin)

# Selector matrices: rows are vertices, columns are rest-edge coordinates.
_S_TET = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)
_S_TRI = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


@dataclasses.dataclass(frozen=True)
class TetBatch:
    """A family of tets sharing one constitutive model: a flat stencil
    (slot-major lanes; ``stencil`` set) or a gather family (``gather_idx``).

    inds, Dlocal and vol serve host assembly and the gather D / D^T; the ADMM
    loop reads weight, the material rows and the st_* stencil fields. Dead
    lanes of a stencil have weight, vol and Dlocal 0 and live material
    parameters; a gather family has none.
    """

    inds: torch.Tensor  # i32 [T_cap, 4] global vertex indices
    Dlocal: torch.Tensor  # [T_cap, 4, 3]
    vol: torch.Tensor  # [T_cap]
    weight: torch.Tensor  # [T_cap] ADMM weight sqrt(k * vol)
    mu: torch.Tensor  # [T_cap]
    lam: torch.Tensor  # [T_cap]
    kappa: torch.Tensor  # [T_cap] spline compression stabiliser (0 unless spline)
    bulk: torch.Tensor  # [T_cap] lam + 2/3 mu, the prox's quad weight k
    st_dl: Optional[torch.Tensor] = None  # [5, 4, 3, cells] per-slot Dlocal rows
    st_par: Optional[torch.Tensor] = None  # [cells] 1.0 on even-parity cells
    st_dead: Optional[torch.Tensor] = None  # [cells] 1.0 on dead cells
    stencil: Optional[tuple] = None  # ops/stencil.StencilMeta of a stencil family
    model: str = "neohookean"
    n_live: Optional[int] = None  # real elements (excludes dead lanes)
    # A gather family's vertex -> (tet * 4 + corner) table, i32 [N, K]
    # (ops/reduction.build_gather_table), attached at Solver.initialize.
    gather_idx: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.inds.shape[0]

    @property
    def n_real(self) -> int:
        return self.n_live if self.n_live is not None else self.n

    def prox(self, zi, n_newton_iters: int = 8):
        """Prox of one batch. zi is SoA rows [9, T] (kernel A with u = 0) or
        [T, 3, 3] (kernel D, or F for the linear model)."""
        if zi.ndim == 2:
            z, _ = self.local_step_rows(zi, torch.zeros_like(zi), n_newton_iters)
            return z
        if self.model == TET_LINEAR:
            return cuda_prox.prox_tet_linear(zi)
        return cuda_prox.prox_tet_hyper(zi, self.model, self.mu, self.lam, self.kappa,
                                        self.bulk, n_iters=n_newton_iters)

    def local_step_rows(self, dix_rows, u_rows, n_newton_iters: int = 8):
        """z = prox(dix + u), u' = dix + u - z on rows [9, T] (kernel A)."""
        return cuda_local_step.local_step_tet_hyper(
            dix_rows, u_rows, self.mu, self.lam, self.kappa, self.bulk,
            n_iters=n_newton_iters, model=self.model)

    def Dx_rows(self, x):
        """D x as rows [9, T] of a gather family (plain PyTorch)."""
        return red.tet_Dx_rows(x, self.inds, self.Dlocal)

    def local_step_x(self, x, u_rows, n_newton_iters: int = 8):
        """z = prox(D x + u), u' = D x + u - z from x [N, 3]: a stencil family
        launches kernel A's stencil entry (each lane computes its own D x,
        kernel B's arithmetic), a gather family gathers D x and launches the
        rows entry."""
        if self.stencil is None:
            return self.local_step_rows(self.Dx_rows(x), u_rows, n_newton_iters)
        return cuda_local_step.local_step_tet_stencil(x, u_rows, self, n_newton_iters)

    def energy(self, F):
        """Per-element energies of F [T, 3, 3] (plain PyTorch; 0 on dead lanes)."""
        if self.model == TET_LINEAR:
            return energy_tet_linear(F, self.bulk, self.vol)
        return energy_tet_hyper(F, self.model, self.mu, self.lam, self.kappa, self.bulk,
                                self.vol)


@dataclasses.dataclass(frozen=True)
class TriBatch:
    """A family of triangle (cloth) elements: a regular sheet as a flat
    stencil (slot-major lanes over cells at vertex pitch; dead lanes have
    weight, area and Dlocal 0 and the family's limits), or any other triangle
    list as a gather family (``gather_idx``)."""

    inds: torch.Tensor  # i32 [T_cap, 3] global vertex indices
    Dlocal: torch.Tensor  # [T_cap, 3, 2]
    area: torch.Tensor  # [T_cap]
    weight: torch.Tensor  # [T_cap] ADMM weight sqrt(k * area)
    mu: torch.Tensor  # [T_cap]
    lam: torch.Tensor  # [T_cap]
    limit_min: torch.Tensor  # [T_cap]
    limit_max: torch.Tensor  # [T_cap]
    st_dl: Optional[torch.Tensor] = None  # [S, 3, 2, cells] per-slot Dlocal rows
    st_dead: Optional[torch.Tensor] = None  # [cells] 1.0 on dead cells
    stencil: Optional[tuple] = None  # ops/stencil.TriStencilMeta of a sheet
    model: str = "linear"
    n_live: Optional[int] = None  # real elements (excludes dead lanes)
    gather_idx: Optional[torch.Tensor] = None  # see TetBatch.gather_idx

    @property
    def n(self) -> int:
        return self.inds.shape[0]

    @property
    def n_real(self) -> int:
        return self.n_live if self.n_live is not None else self.n

    @property
    def bulk(self):
        return self.lam + (2.0 / 3.0) * self.mu

    def prox(self, zi, n_newton_iters: int = 8):
        """Prox of one sheet on SoA rows [6, T]: kernel E's rows entry with
        u = 0."""
        if zi.ndim != 2:
            raise ValueError(f"TriBatch.prox: rows [6, T] expected, got {tuple(zi.shape)}")
        z, _ = self.local_step_rows(zi, torch.zeros_like(zi), n_newton_iters)
        return z

    def local_step_rows(self, dix_rows, u_rows, n_newton_iters: int = 8):
        """Fused cloth local step on rows [6, T] (kernel E): (z, u')."""
        del n_newton_iters
        return cuda_tri_local_step.local_step_tri(dix_rows, u_rows, self.limit_min,
                                                  self.limit_max)

    def Dx_rows(self, x):
        """D x as rows [6, T] of a gather family (plain PyTorch)."""
        return red.tri_Dx_rows(x, self.inds, self.Dlocal)

    def local_step_x(self, x, u_rows, n_newton_iters: int = 8):
        """The cloth local step from x [N, 3]: (z, u'). A sheet launches
        kernel E's stencil entry (each lane computes its own D x), a gather
        family gathers D x and launches the rows entry."""
        if self.stencil is None:
            return self.local_step_rows(self.Dx_rows(x), u_rows)
        return cuda_tri_local_step.local_step_tri_stencil(x, u_rows, self)

    def energy(self, F):
        """Per-element energies of F [T, 3, 2] (plain PyTorch; 0 on dead lanes)."""
        return energy_tri(F, self.bulk, self.area)


@dataclasses.dataclass(frozen=True)
class PinBatch:
    """All pinnable vertices; targets and active flags change at run time."""

    idx: torch.Tensor  # i64 [P], unique
    target: torch.Tensor  # [P, 3]
    active: torch.Tensor  # bool [P]
    weight: torch.Tensor  # [P]

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    def prox(self, zi):
        return prox_pin(zi, self.target, self.active)


def build_tet_batch(verts: np.ndarray, tets: np.ndarray, lame: Lame, model: str,
                    *, device, dtype: torch.dtype, vertex_offset: int = 0,
                    kappa: float = 0.0, lattice_dims=None,
                    lattice_wrap: bool = False) -> TetBatch:
    """Build a TetBatch from rest vertices [V,3] and tets [T,4]: a flat
    stencil where ``lattice_dims`` names a lattice that verifies, else a
    gather family of the tets as given.

    ``lattice_wrap`` marks a ring lattice (``make_tet_torus``). Raises on
    inverted rest tets (src/TetEnergyTerm.cpp:42-44).
    """
    check_model(model)
    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tets = np.asarray(tets, dtype=np.int64).reshape(-1, 4)
    x4 = verts[tets]  # [T, 4, 3]
    edges = np.stack(
        [x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1
    )
    vol = np.linalg.det(edges) / 6.0
    if np.any(vol < 0):
        bad = int(np.argmax(vol < 0))
        raise ValueError(f"TetBatch: inverted initial tet at index {bad} (vol={vol[bad]})")
    edges_inv = np.linalg.inv(edges)
    Dlocal = np.einsum("jk,tkc->tjc", _S_TET, edges_inv)  # [T, 4, 3]
    weight = np.sqrt(lame.bulk_modulus() * vol)
    stencil = None
    if lattice_dims is not None:
        stencil = stencil_mod.verify_lattice(tets, lattice_dims, base=vertex_offset,
                                             wrap=lattice_wrap)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    def full(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    if stencil is None:
        t = tets.shape[0]
        mu, lam = full(lame.mu, t), full(lame.lam, t)
        return TetBatch(
            inds=dev(tets + vertex_offset, torch.int32),
            Dlocal=dev(Dlocal),
            vol=dev(vol),
            weight=dev(weight),
            mu=mu,
            lam=lam,
            kappa=full(kappa, t),
            bulk=lam + (2.0 / 3.0) * mu,
            model=model,
        )

    plan = stencil_mod.tet_flat_plan(stencil)
    t_cap = plan.t_cap
    mu, lam = full(lame.mu, t_cap), full(lame.lam, t_cap)
    return TetBatch(
        inds=dev(plan.spread_inds(tets, verts.shape[0], vertex_offset), torch.int32),
        Dlocal=dev(plan.take(Dlocal)),
        vol=dev(plan.take(vol)),
        weight=dev(plan.take(weight)),
        mu=mu,
        lam=lam,
        kappa=full(kappa, t_cap),
        bulk=lam + (2.0 / 3.0) * mu,
        st_dl=dev(plan.dl_rows(Dlocal)),
        st_par=dev(plan.par),
        st_dead=dev(plan.dead.astype(np.float64)),
        stencil=stencil,
        model=model,
        n_live=tets.shape[0],
    )


def build_tri_batch(verts: np.ndarray, tris: np.ndarray, lame: Lame, *, device,
                    dtype: torch.dtype, vertex_offset: int = 0,
                    detect_stencil: bool = True) -> TriBatch:
    """Build a TriBatch from rest vertices [V,3] and triangles [T,3]: a flat
    stencil where the list is a regular sheet (and detect_stencil), else a
    gather family of the triangles as given. Validates strain limits and rest
    orientation (src/TriEnergyTerm.cpp:29-51)."""
    if lame.limit_min > 1.0:
        raise ValueError("TriBatch: strain limit min should be -inf to 1")
    if lame.limit_max < 1.0:
        raise ValueError("TriBatch: strain limit max should be 1 to inf")

    verts = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    x3 = verts[tris]  # [T, 3, 3]
    e12 = x3[:, 1] - x3[:, 0]
    e13 = x3[:, 2] - x3[:, 0]
    n1 = e12 / np.linalg.norm(e12, axis=-1, keepdims=True)
    t2 = e13 - np.sum(e13 * n1, axis=-1, keepdims=True) * n1
    n2 = t2 / np.linalg.norm(t2, axis=-1, keepdims=True)
    basis = np.stack([n1, n2], axis=-1)  # [T, 3, 2]
    edges = np.stack([e12, e13], axis=-1)  # [T, 3, 2]
    rest2d = np.einsum("tjr,tjc->trc", basis, edges)  # [T, 2, 2]
    area = np.linalg.det(rest2d) / 2.0
    if np.any(area < 0):
        raise ValueError("TriBatch: inverted initial pose")
    rest_inv = np.linalg.inv(rest2d)
    Dlocal = np.einsum("jk,tkc->tjc", _S_TRI, rest_inv)  # [T, 3, 2]
    weight = np.sqrt(lame.bulk_modulus() * area)
    stencil = (stencil_mod.verify_tri_grid(tris, base=vertex_offset, n_local_verts=len(verts))
               if detect_stencil else None)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    def full(value, n):
        return torch.full((n,), value, dtype=dtype, device=device)

    if stencil is None:
        t = tris.shape[0]
        return TriBatch(
            inds=dev(tris + vertex_offset, torch.int32),
            Dlocal=dev(Dlocal),
            area=dev(area),
            weight=dev(weight),
            mu=full(lame.mu, t),
            lam=full(lame.lam, t),
            limit_min=full(lame.limit_min, t),
            limit_max=full(lame.limit_max, t),
            model="linear",
        )

    plan = stencil_mod.tri_flat_plan(tris, stencil)
    t_cap = plan.t_cap
    return TriBatch(
        inds=dev(plan.spread_inds(tris, len(verts), vertex_offset), torch.int32),
        Dlocal=dev(plan.take(Dlocal)),
        area=dev(plan.take(area)),
        weight=dev(plan.take(weight)),
        mu=full(lame.mu, t_cap),
        lam=full(lame.lam, t_cap),
        limit_min=full(lame.limit_min, t_cap),
        limit_max=full(lame.limit_max, t_cap),
        st_dl=dev(plan.dl_rows(Dlocal)),
        st_dead=dev(plan.dead.astype(np.float64)),
        stencil=stencil,
        model="linear",
        n_live=tris.shape[0],
    )


def build_pin_batch(inds: np.ndarray, targets: np.ndarray, *, device,
                    dtype: torch.dtype, active: Optional[np.ndarray] = None) -> PinBatch:
    inds = np.asarray(inds, dtype=np.int64).reshape(-1)
    if np.unique(inds).shape[0] != inds.shape[0]:
        raise ValueError("PinBatch: pin indices must be unique")
    targets = np.asarray(targets, dtype=np.float64).reshape(-1, 3)
    P = inds.shape[0]
    if active is None:
        active = np.ones((P,), dtype=bool)
    # "really strong rubber" pin weight (src/SpringEnergyTerm.hpp:47-51)
    w = np.sqrt(Lame.rubber().bulk_modulus() * 2.0)
    return PinBatch(
        idx=torch.as_tensor(inds, device=device),
        target=torch.as_tensor(targets).to(device=device, dtype=dtype),
        active=torch.as_tensor(np.asarray(active, dtype=bool), device=device),
        weight=torch.full((P,), w, dtype=dtype, device=device),
    )
