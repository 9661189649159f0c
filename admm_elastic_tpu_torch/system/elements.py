"""Element-family batches (dataclasses of tensors) and the host functions
that build them.

A port of the stencil branch of ``admm_elastic_tpu/system/elements.py``
(``TetBatch``, ``build_tet_batch`` :335-361, ``TriBatch``,
``build_tri_batch`` :375-444, ``PinBatch``, ``build_pin_batch``).
``build_*`` compute on the host in float64 numpy, as the JAX package does,
then place each field on ``device`` in ``dtype``; the arrays are the JAX
package's bit for bit.

Only verified make_tet_blocks lattices and regular triangle sheets run here
(the flat-stencil layout); a mesh that needs the gather D / D^T path raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_prox, cuda_tri_local_step
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.ops.prox import TET_LINEAR, check_model, prox_pin

# Selector matrices: rows are vertices, columns are rest-edge coordinates.
_S_TET = np.array(
    [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
)
_S_TRI = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


@dataclasses.dataclass
class TetBatch:
    """A flat-stencil family of tets sharing one constitutive model
    (slot-major lanes).

    inds, Dlocal and vol serve host assembly; the ADMM loop reads weight,
    the material rows and the st_* stencil fields. Dead lanes have weight,
    vol and Dlocal 0 and live material parameters.
    """

    inds: torch.Tensor  # i32 [T_cap, 4] global vertex indices
    Dlocal: torch.Tensor  # [T_cap, 4, 3]
    vol: torch.Tensor  # [T_cap]
    weight: torch.Tensor  # [T_cap] ADMM weight sqrt(k * vol)
    mu: torch.Tensor  # [T_cap]
    lam: torch.Tensor  # [T_cap]
    kappa: torch.Tensor  # [T_cap] spline compression stabiliser (0 unless spline)
    bulk: torch.Tensor  # [T_cap] lam + 2/3 mu, the prox's quad weight k
    st_dl: torch.Tensor  # [5, 4, 3, cells] per-slot Dlocal rows
    st_par: torch.Tensor  # [cells] 1.0 on even-parity cells
    st_dead: torch.Tensor  # [cells] 1.0 on dead cells
    stencil: tuple  # ops/stencil.StencilMeta
    model: str = "neohookean"
    n_live: Optional[int] = None  # real elements (excludes dead lanes)

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

    def local_step_x(self, x, u_rows, n_newton_iters: int = 8):
        """z = prox(D x + u), u' = D x + u - z from x [N, 3] (kernel A's stencil
        entry: each lane computes its own D x, kernel B's arithmetic)."""
        return cuda_local_step.local_step_tet_stencil(x, u_rows, self, n_newton_iters)


@dataclasses.dataclass
class TriBatch:
    """A flat-stencil family of triangle (cloth) elements: a regular sheet,
    slot-major lanes over cells at vertex pitch. Dead lanes have weight, area
    and Dlocal 0 and the family's limits."""

    inds: torch.Tensor  # i32 [T_cap, 3] global vertex indices
    Dlocal: torch.Tensor  # [T_cap, 3, 2]
    area: torch.Tensor  # [T_cap]
    weight: torch.Tensor  # [T_cap] ADMM weight sqrt(k * area)
    mu: torch.Tensor  # [T_cap]
    lam: torch.Tensor  # [T_cap]
    limit_min: torch.Tensor  # [T_cap]
    limit_max: torch.Tensor  # [T_cap]
    st_dl: torch.Tensor  # [S, 3, 2, cells] per-slot Dlocal rows
    st_dead: torch.Tensor  # [cells] 1.0 on dead cells
    stencil: tuple  # ops/stencil.TriStencilMeta
    model: str = "linear"
    n_live: Optional[int] = None  # real elements (excludes dead lanes)

    @property
    def n(self) -> int:
        return self.inds.shape[0]

    @property
    def n_real(self) -> int:
        return self.n_live if self.n_live is not None else self.n

    @property
    def bulk(self):
        return self.lam + (2.0 / 3.0) * self.mu

    def local_step_rows(self, dix_rows, u_rows, n_newton_iters: int = 8):
        """Fused cloth local step on rows [6, T] (kernel E): (z, u')."""
        del n_newton_iters
        return cuda_tri_local_step.local_step_tri(dix_rows, u_rows, self.limit_min,
                                                  self.limit_max)

    def local_step_x(self, x, u_rows, n_newton_iters: int = 8):
        """The cloth local step from x [N, 3] (kernel E's stencil entry: each
        lane computes its own D x): (z, u')."""
        del n_newton_iters
        return cuda_tri_local_step.local_step_tri_stencil(x, u_rows, self)


@dataclasses.dataclass
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
    """Build a flat-stencil TetBatch from rest vertices [V,3] and tets [T,4].

    Raises on inverted rest tets (src/TetEnergyTerm.cpp:42-44), and with
    NotImplementedError for what this package does not run yet.
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
    if lattice_wrap:
        raise NotImplementedError(
            "wrap (ring) lattices are not ported yet (ROADMAP Queue 1 item 6)")
    stencil = None
    if lattice_dims is not None:
        stencil = stencil_mod.verify_lattice(tets, lattice_dims, base=vertex_offset)
    if stencil is None:
        raise NotImplementedError(
            "only verified make_tet_blocks lattices run in this package; other "
            "meshes need the gather D / D^T path (ROADMAP Queue 1 item 5)")

    plan = stencil_mod.tet_flat_plan(stencil)
    t_cap = plan.t_cap

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    mu = torch.full((t_cap,), lame.mu, dtype=dtype, device=device)
    lam = torch.full((t_cap,), lame.lam, dtype=dtype, device=device)
    return TetBatch(
        inds=dev(plan.spread_inds(tets, verts.shape[0], vertex_offset), torch.int32),
        Dlocal=dev(plan.take(Dlocal)),
        vol=dev(plan.take(vol)),
        weight=dev(plan.take(weight)),
        mu=mu,
        lam=lam,
        kappa=torch.full((t_cap,), kappa, dtype=dtype, device=device),
        bulk=lam + (2.0 / 3.0) * mu,
        st_dl=dev(plan.dl_rows(Dlocal)),
        st_par=dev(plan.par),
        st_dead=dev(plan.dead.astype(np.float64)),
        stencil=stencil,
        model=model,
        n_live=tets.shape[0],
    )


def build_tri_batch(verts: np.ndarray, tris: np.ndarray, lame: Lame, *, device,
                    dtype: torch.dtype, vertex_offset: int = 0) -> TriBatch:
    """Build a flat-stencil TriBatch from rest vertices [V,3] and triangles
    [T,3]; validates strain limits and rest orientation
    (src/TriEnergyTerm.cpp:29-51). A triangle list that is not a regular
    sheet raises NotImplementedError."""
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
    stencil = stencil_mod.verify_tri_grid(tris, base=vertex_offset,
                                          n_local_verts=len(verts))
    if stencil is None:
        raise NotImplementedError(
            "only regular triangle sheets run in this package; other triangle "
            "meshes need the gather D / D^T path (ROADMAP Queue 1 item 5)")

    plan = stencil_mod.tri_flat_plan(tris, stencil)
    t_cap = plan.t_cap

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    def full(value):
        return torch.full((t_cap,), value, dtype=dtype, device=device)

    return TriBatch(
        inds=dev(plan.spread_inds(tris, len(verts), vertex_offset), torch.int32),
        Dlocal=dev(plan.take(Dlocal)),
        area=dev(plan.take(area)),
        weight=dev(plan.take(weight)),
        mu=full(lame.mu),
        lam=full(lame.lam),
        limit_min=full(lame.limit_min),
        limit_max=full(lame.limit_max),
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
