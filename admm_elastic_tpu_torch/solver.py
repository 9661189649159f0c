"""The Solver: scene staging, one-time initialize, and the timestep.

A port of ``admm_elastic_tpu/solver.py`` with the same API (``add_nodes``,
``add_tet_energies``, ``add_tri_energies``, ``add_explicit_force``,
``add_obstacle``, ``add_dynamic_collider``, ``set_pins``, ``initialize``,
``step``, ``run``, ``x`` / ``v``) and five global steps: ``linsolver=0``
(prefactored direct, ``direct_mode`` "inv" or "cho"; above
``direct_max_verts`` vertices served by two-grid PCG at
``pcg_tol = min(pcg_tol, 1e-10)``, as the JAX package does,
on a copy of the settings), ``1`` (multicolour Gauss-Seidel with the pins and
the obstacles in its sweeps), ``2`` (Uzawa: CG on the contact Schur
complement around a direct or PCG inner solve), ``3`` (PCG, Jacobi or
two-grid) and ``4`` (augmented-Lagrangian PCG). Contact is with the passive
obstacles of ``collision/passive``: ``Floor``, ``Sphere``, ``PassiveMeshSDF``
and ``PassiveMeshExact`` (``add_obstacle``; not with ``linsolver=0``), queried
at every vertex, or at ``surface_inds``, and self-collision with the
colliders of ``collision/dynamic`` (``add_dynamic_collider``; ``binding.add_tetmesh``
registers one for each mesh without NOSELFCOLLISION and appends its surface
vertices to ``surface_inds``). One timestep (src/Solver.cpp:35-109):

    v <- explicit forces(x, v);  v_y += dt g;  x_bar = x + dt v
    z = 0;  u = 0;  x' = x_bar
    repeat admm_iters:
        local:   z, u <- prox(D x' + u)                kernel A (tets), E (cloth)
        detect:  the deepest obstacle hit per surface vertex at x' (not for GS;
                 a mesh obstacle by kernel J) and the first collider's hit
                 (kernel K, one call over every collider; also for GS), the
                 dynamic rows' table by vertex
        global:  b = M x_bar + dt^2 D^T W^2 (z - u)    kernel C (stencil tets)
                 x' = A^-1 b: GEMM or two triangular solves, + pin-row polish
                 (direct); a PCG solve from x' (kernel G); the GS sweeps
                 from x' (kernel H, detecting per vertex, the dynamic rows
                 folded in as a penalty); Uzawa's Schur CG (C^T by kernel L),
                 y where the active rows are those of the last solve; one
                 AL-PCG solve from x' (kernel G's penalty form) and y's ascent
    v = (x' - x) / dt;  x = x'

Every tensor lives on the solver's ``device``, the CUDA card unless the
caller asks for ``"cpu"``; nothing falls back to another device.

With ``aa_window > 0`` the ADMM loop is Anderson-accelerated
(``solvers/anderson.py``): per iteration z = prox(v) by the rows entries of
A and E, the global solve, and g(v) = D x + u (kernel B on a lattice).

On the card, ``step()`` and ``run(n)`` replay one timestep captured as a CUDA
graph (the port of ``_run_core``, ``admm_elastic_tpu/solver.py:369-394``):
``run(n)`` replays it n times with no host synchronisation in between and one
at the end, ``step()`` once, so the two share numerics. The first of them
after ``initialize`` captures the graph; it reads and writes static buffers of
the state (x, v, the contact multipliers y and the last active rows). Each
call copies ``solver.state`` into them before its replays and out of them
after, into a new SimState: a state the caller keeps (``st0 =
solver.state``) is a snapshot that no later replay writes, as the JAX
package's immutable state is. The state, the
system and its batches are frozen dataclasses (as in the JAX package), so no
field can be swapped behind the graph's back; ``set_pins`` copies the targets
and active flags into the tensors the graph reads (the pin energies, and the
dense pin arrays of Gauss-Seidel); ``initialize``, ``load_arrays``,
``add_explicit_force``, ``add_obstacle`` and a change of a setting that the
step reads (``_graph_key``) capture it anew. A failed capture raises.
``run(0)`` captures without stepping. Every solve loop exits on the device:
kernels G and H test their own exit, and Uzawa's Schur trips are all in the
graph, each predicated on a device flag (``solvers/uzawa.py``). On the CPU
the steps run eagerly, one ``_step_core`` after the other. ``step()`` routes
``log_inner`` to ``step_logged`` (every global solve's traced form, the
curves in ``solver_log``) and ``verbose >= 2`` to ``step_profiled`` (the
phases timed): the JAX package's non-fused diagnostics, eager on every device.
``runtime_data().inner_iters`` after ``step()`` is that step's inner
iterations, as the JAX package reports them: ``admm_iters`` on the direct
path, else the sum of the GS sweeps, the Schur trips or the CG trips (a device
counter that the step writes, read once after it); after ``run(n)`` it is 0,
as there. ``runtime_data().collision_overflow`` after ``step()`` or
``run(n)`` says whether a fixed-capacity stage (a mesh obstacle's near-lane
compaction or deep fallback, a collider's cell capacity or HIT_CAP) dropped a
contact in any detection of the steps: a device flag that the detections set,
zeroed before the call's steps and read once after them, outside the graph (under Gauss-Seidel the
sweeps' own detections drop theirs silently, as in the JAX package). What
this package does not run raises NotImplementedError naming the ROADMAP item
that ports it.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from admm_elastic_tpu_torch import config as cfg
from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.collision import dynamic as dyn
from admm_elastic_tpu_torch.collision.dynamic import TetMeshCollider
from admm_elastic_tpu_torch.collision.passive import MESH, check_obstacle, pick_deepest
from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_dynamic, cuda_gs, cuda_obstacle, cuda_pcg
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.solvers import alcg as alcg_mod
from admm_elastic_tpu_torch.solvers import anderson as anderson_mod
from admm_elastic_tpu_torch.solvers import direct as direct_mod
from admm_elastic_tpu_torch.solvers import gs as gs_mod
from admm_elastic_tpu_torch.solvers import pcg as pcg_mod
from admm_elastic_tpu_torch.solvers import uzawa as uzawa_mod
from admm_elastic_tpu_torch.system import assembly
from admm_elastic_tpu_torch.system import elements as el
from admm_elastic_tpu_torch.system import system as sysm
from admm_elastic_tpu_torch.utils import logging as log_utils


GSData = gs_mod.GSData  # where the JAX package keeps it


@dataclasses.dataclass
class RuntimeData:
    """Per-step timing log (reference src/Solver.hpp:54-61). The phases
    (global, local, collision) are filled by step_profiled alone."""

    global_ms: float = 0.0
    local_ms: float = 0.0
    collision_ms: float = 0.0
    step_ms: float = 0.0
    inner_iters: int = 0
    # True if a fixed-capacity collision stage (a mesh obstacle's near-lane
    # compaction or deep fallback, a collider's cell capacity or HIT_CAP)
    # dropped a contact in the step(s) this record covers
    collision_overflow: bool = False

    def print(self, settings: Settings):
        it = max(settings.admm_iters, 1)
        print(f"\nTotal step: {self.step_ms}ms")
        print(f"Total global step: {self.global_ms}ms")
        print(f"Total local step: {self.local_ms}ms")
        print(f"Total collision update: {self.collision_ms}ms")
        print(f"ADMM Iters: {settings.admm_iters}")
        print(f"Avg Inner Iters: {self.inner_iters / it}")
        if self.collision_overflow:
            print("WARNING: collision buffers overflowed (contacts dropped)")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Solver(device={device!r}): CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Solver: unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # tensors report cuda:<index>; name the index so devices compare equal
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _check_settings(s: Settings) -> None:
    if s.linsolver not in (cfg.LDLT, cfg.NCMCGS, cfg.UZAWACG, cfg.PCG, cfg.ALPCG):
        raise ValueError(f"unknown linsolver {s.linsolver}")
    if s.uzawa_inner not in ("auto", "direct", "pcg"):
        raise ValueError(f"unknown uzawa_inner {s.uzawa_inner!r}")
    if s.direct_mode not in ("inv", "cho"):
        raise ValueError(f"direct_mode={s.direct_mode!r}: expected 'inv' or 'cho'")
    if s.unroll_admm:
        raise NotImplementedError(
            "unroll_admm is not ported (ROADMAP 'Do not port')")


_STATE_FIELDS = ("x", "v", "y", "prev_active")


def _versions(state) -> tuple:
    """The in-place versions of a state's tensors: a write through any of
    them (copy_, add_, ...) changes this."""
    return tuple(getattr(state, f)._version for f in _STATE_FIELDS)


def _surface(surface_inds, has_cobjs: bool, n: int):
    """The collision query set (i64 [H]) and whether it is every vertex in
    order: the explicit surface_inds, else every vertex where a collision
    object exists (src/Collider.hpp:158), else none."""
    if surface_inds:
        surf = np.unique(np.asarray(surface_inds, dtype=np.int64))
    elif has_cobjs:
        surf = np.arange(n, dtype=np.int64)
    else:
        surf = np.zeros((0,), dtype=np.int64)
    return surf, bool(surf.shape[0] == n and np.array_equal(surf, np.arange(n)))


def _uzawa_inner(s: Settings, n: int) -> str:
    """Uzawa's inner solve: "auto" is "direct" up to uzawa_dense_max_verts."""
    if s.uzawa_inner == "auto":
        return "direct" if n <= s.uzawa_dense_max_verts else "pcg"
    return s.uzawa_inner


@dataclasses.dataclass(frozen=True)
class _Contact:
    """What the contact steps read on the device, built at load_arrays."""

    ck: torch.Tensor  # 0-d, sqrt of the constraint weight, in the run dtype
    surf: torch.Tensor  # i64 [H] the query vertices
    dense: bool  # the query set is every vertex in order
    obstacles: tuple  # the obstacles on the device, in the run dtype
    # the self-collision colliders on the device, in the run dtype, as one table (kernel K),
    # None for none
    table: Optional[dyn.ColliderTable]
    slot_of: Optional[torch.Tensor]  # i32 [N]: each vertex's query slot, -1 for none
    # (None where the query set is dense)
    pin_mask: torch.Tensor  # bool [N] (Gauss-Seidel's pins), rewritten by set_pins
    pin_target: torch.Tensor  # [N, 3]
    empty: con.Hits  # no hit, no dynamic row
    gs_params: tuple  # cuda_gs.obstacle_params(obstacles) for kernel H, else None

    @property
    def colliders(self) -> tuple:
        return () if self.table is None else self.table.colliders


@dataclasses.dataclass
class _StepGraph:
    """One timestep captured as a CUDA graph."""

    key: tuple  # what the captured step was built from (Solver._graph_key)
    graph: "torch.cuda.CUDAGraph"
    state: sysm.SimState  # the static x, v, y, prev_active that each replay reads and writes
    # (never the solver's own state: each call copies in and out)
    reads: tuple  # the objects whose ids are in key, kept alive with the graph


class Solver:
    """Scene container and time-stepping loop (reference admm::Solver)."""

    def __init__(self, settings: Optional[Settings] = None, *, device="cuda"):
        """device: "cuda" (the default; raises where there is no CUDA device)
        or "cpu", which runs the kernels' plain PyTorch versions."""
        self.device = _resolve_device(device)
        self.m_settings = settings if settings is not None else Settings()
        self.initialized = False
        self._x_stage: List[np.ndarray] = []
        self._m_stage: List[np.ndarray] = []
        self._n_verts = 0
        self._tet_specs: List[Tuple] = []
        self._tri_specs: List[Tuple] = []
        self.ext_forces: List = []
        self._pins: Dict[int, np.ndarray] = {}
        # the collision query set; empty = every vertex where an obstacle exists
        # (src/Collider.hpp:158)
        self.surface_inds: List[int] = []
        self.obstacles: List = []
        self.colliders: List[TetMeshCollider] = []
        self.system: Optional[sysm.System] = None
        self.state: Optional[sysm.SimState] = None
        # DirectData (linsolver=0; 2 with the direct inner), GSData (1) or
        # PCGData (3, 4; 2 with the PCG inner; 0 above direct_max_verts)
        self._solve_data = None
        self.requested_linsolver = self.m_settings.linsolver
        self._inner = None  # int32 [1]: the current step's GS sweeps, Schur or CG trips
        # int32 [1]: set where a detection dropped a contact (mesh obstacles),
        # zeroed before each call's steps and read after them
        self._overflow = None
        self._contact = None  # _Contact: what the contact steps read, built at load_arrays
        self._dtype = cfg.resolve_dtype(self.m_settings)
        self._runtime = RuntimeData()
        self._graph: Optional[_StepGraph] = None
        # the snapshot _advance last handed out, with its tensors' versions:
        # while solver.state is it, unchanged, the graph's buffers hold it
        self._handed: Optional[tuple] = None
        self._kick_cache: Optional[tuple] = None
        # filled by step_logged; set .x_star before it for error curves
        # against a known solution (src/SolverLog.hpp:36-55)
        self.solver_log = log_utils.InnerLog(residuals=np.zeros((0, 0)))

    # -- staging API --------------------------------------------------------

    def add_nodes(self, x: np.ndarray, m: np.ndarray) -> int:
        """Append vertices; returns total vertex count (src/Solver.hpp:127-141)."""
        x = np.asarray(x, dtype=np.float64).reshape(-1, 3)
        m = np.asarray(m, dtype=np.float64).reshape(-1)
        if m.shape[0] == 3 * x.shape[0]:  # accept x3-scaled masses
            m = m.reshape(-1, 3)[:, 0]
        if m.shape[0] != x.shape[0]:
            raise ValueError("Solver::add_nodes: masses and vertices differ in count")
        self._x_stage.append(x)
        self._m_stage.append(m)
        self._n_verts += x.shape[0]
        return self._n_verts

    def add_tet_energies(self, verts, tets, lame: Lame, model: str = "linear",
                         vertex_offset: int = 0, kappa: float = 0.0,
                         lattice_dims=None, lattice_wrap: bool = False):
        """Register a tet element family; built at initialize."""
        self._tet_specs.append((np.asarray(verts, dtype=np.float64),
                                np.asarray(tets, dtype=np.int64), lame, model,
                                vertex_offset, kappa, lattice_dims, lattice_wrap))

    def add_tri_energies(self, verts, tris, lame: Lame, vertex_offset: int = 0):
        """Register a triangle (cloth) family (src/TriEnergyTerm.hpp:31-46)."""
        self._tri_specs.append((np.asarray(verts, dtype=np.float64),
                                np.asarray(tris, dtype=np.int64), lame, vertex_offset))

    def add_explicit_force(self, f):
        """Register an explicit force (forces.ExplicitForce), applied to v
        before every step's prediction."""
        self.ext_forces.append(f)
        self._graph = None

    def add_obstacle(self, obj):
        """Add a passive obstacle: collision/passive.Floor, Sphere,
        PassiveMeshSDF or PassiveMeshExact (anything else raises TypeError;
        convert.obstacle_from_numpy carries a JAX package obstacle over). After
        initialize it goes to the device in the run dtype at once, and the
        captured step is captured anew."""
        check_obstacle(obj)
        self.obstacles.append(obj)
        c = self._contact
        if c is not None:
            obstacles = c.obstacles + (obj.to(self.device, self._dtype),)
            self._contact = dataclasses.replace(
                c, obstacles=obstacles, gs_params=self._gs_params(obstacles))
        self._graph = None

    def add_dynamic_collider(self, obj: TetMeshCollider):
        """Add a self-collision collider (collision/dynamic.TetMeshCollider;
        anything else raises TypeError, convert.collider_from_numpy carries a
        JAX package one over). Its query vertices are surface_inds (set
        before initialize). After initialize it goes to the device in the run
        dtype at once, and the captured step is captured anew."""
        if not isinstance(obj, TetMeshCollider):
            raise TypeError(f"add_dynamic_collider takes a TetMeshCollider, not "
                            f"{type(obj).__name__} (convert.collider_from_numpy carries a JAX "
                            "package collider over)")
        self.colliders.append(obj)
        c = self._contact
        if c is not None:
            self._contact = dataclasses.replace(
                c, table=dyn.collider_table(c.colliders + (obj.to(self.device, self._dtype),)),
                empty=dataclasses.replace(c.empty, may_dyn=True))
        self._graph = None

    def set_pins(self, inds, points=None):
        """(Re)set the pin constraint set (src/Solver.cpp:113-157).

        Before initialize: defines the pinnable set. After initialize only
        the targets and active flags of the initial pin set may change; they
        are copied into the pin tensors in place, which a captured step reads.
        """
        inds = [int(i) for i in inds]
        pin_in_place = points is None or len(points) != len(inds)
        if pin_in_place and points is not None and len(points) > 0:
            raise ValueError("**Solver::set_pins Error: Bad input.")

        new_pins: Dict[int, np.ndarray] = {}
        x_now = None
        if pin_in_place and inds:
            if not (self.initialized or self._n_verts):
                raise ValueError("**Solver::set_pins Error: Bad input.")
            # x is read (on the card a copy to the host) only where the
            # targets are taken from it, not when the caller gives them
            x_now = self.x
        for k, idx in enumerate(inds):
            if pin_in_place:
                new_pins[idx] = np.asarray(x_now[idx], dtype=np.float64)
            else:
                new_pins[idx] = np.asarray(points[k], dtype=np.float64)
        self._pins = new_pins
        if not self.initialized:
            return

        pins = self.system.pins
        if self.m_settings.linsolver == cfg.NCMCGS:
            pass  # Gauss-Seidel's pins are the dense arrays alone
        elif pins is None or pins.n == 0:
            if new_pins:
                raise RuntimeError("**Solver::set_pins Error: Constraint not found.")
        else:
            lookup = {int(i): k for k, i in enumerate(pins.idx.cpu().numpy())}
            active = np.zeros((pins.n,), dtype=bool)
            target = pins.target.cpu().numpy().copy()
            for idx, p in new_pins.items():
                if idx not in lookup:
                    raise RuntimeError(
                        f"**Solver::set_pins Error: Constraint for {idx} not found.")
                k = lookup[idx]
                active[k] = True
                target[k] = p
            pins.target.copy_(torch.as_tensor(target))
            pins.active.copy_(torch.as_tensor(active))
        # the dense pin arrays (Gauss-Seidel's), rewritten in place for any
        # linsolver, as the JAX package rebuilds them
        mask, target = self._pin_arrays()
        self._contact.pin_mask.copy_(mask)
        self._contact.pin_target.copy_(target)

    def _pin_arrays(self):
        """The dense pin mask [N] and targets [N, 3] of the current pins (the
        JAX package's _rebuild_pin_arrays), on the host."""
        n = self._n_verts
        pm = np.zeros((n,), dtype=bool)
        pt = np.zeros((n, 3), dtype=np.float64)
        for idx, p in self._pins.items():
            pm[idx] = True
            pt[idx] = p
        return torch.as_tensor(pm), torch.as_tensor(pt).to(self._dtype)

    # -- state views -----------------------------------------------------------

    @property
    def x(self) -> np.ndarray:
        if self.state is not None:
            return self.state.x.cpu().numpy().copy()
        return np.concatenate(self._x_stage, axis=0) if self._x_stage else np.zeros((0, 3))

    @x.setter
    def x(self, value):
        """After initialize, the positions of the state (on the card copied
        into the captured step's buffer at the next run); before it, the
        staged positions, which replace those of add_nodes (the JAX package's
        Solver.x)."""
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self.state is not None:
            self.state = dataclasses.replace(
                self.state, x=torch.as_tensor(value).to(self.device, self._dtype))
        else:
            self._x_stage = [value]
            self._m_stage = [np.concatenate(self._m_stage)] if self._m_stage else []
            self._n_verts = value.shape[0]

    @property
    def v(self) -> np.ndarray:
        if self.state is not None:
            return self.state.v.cpu().numpy().copy()
        return np.zeros((self._n_verts, 3))

    @v.setter
    def v(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        self.state = dataclasses.replace(
            self.state, v=torch.as_tensor(value).to(self.device, self._dtype))

    @property
    def masses(self) -> np.ndarray:
        return np.concatenate(self._m_stage) if self._m_stage else np.zeros((0,))

    def settings(self) -> Settings:
        return self.m_settings

    def runtime_data(self) -> RuntimeData:
        return self._runtime

    # -- initialize -----------------------------------------------------------

    def initialize(self, settings: Optional[Settings] = None) -> bool:
        """Build the element batches and their gather tables, assemble A and
        factor it (src/Solver.cpp:167-261)."""
        if settings is not None:
            self.m_settings = settings
        s = self.m_settings
        # What the caller configured, before the size switch below.
        self.requested_linsolver = s.linsolver
        _check_settings(s)
        if s.timestep_s <= 0.0:
            print(f"\n**Solver Error: timestep set to {s.timestep_s}s, changing to 1/24s.")
            s.timestep_s = 1.0 / 24.0

        x_np = np.asarray(self.x, dtype=np.float64)
        m_np = self.masses
        n = x_np.shape[0]
        if n < 1 or m_np.shape[0] != n:
            print("\n**Solver Error: Problem with node data!")
            return False
        if s.linsolver == cfg.LDLT and (self.obstacles or self.colliders):
            # before the size switch: linsolver=0 takes no collision object at
            # any size (src/Solver.cpp:249-254); switching to PCG first would
            # drop the obstacles silently
            raise RuntimeError("**Solver::add_obstacle Error: No collisions with LDLT solver")
        if s.linsolver == cfg.LDLT and n > s.direct_max_verts:
            # A dense A^-1 would take N^2 memory here. Serve linsolver=0 by
            # two-grid PCG at the dtype's floor instead, on a copy of the
            # settings: the caller's object stays as it was.
            if s.verbose >= 1:
                print(f"**Solver::initialize: {n} verts exceeds "
                      f"direct_max_verts={s.direct_max_verts}; serving "
                      f"linsolver=0 via ELL-PCG (two-grid, tol 1e-10).")
            s = copy.copy(s)
            s.linsolver = cfg.PCG
            s.pcg_precond = "twogrid"
            s.pcg_tol = min(s.pcg_tol, 1e-10)
            self.m_settings = s
        self._n_verts = n
        dtype = cfg.resolve_dtype(s)
        self._dtype = dtype
        dev = self.device
        ls = s.linsolver

        tets = tuple(
            el.build_tet_batch(v, t, lame, model, device=dev, dtype=dtype,
                               vertex_offset=off, kappa=kap, lattice_dims=dims,
                               lattice_wrap=wrapf)
            for (v, t, lame, model, off, kap, dims, wrapf) in self._tet_specs
        )
        tris = tuple(
            el.build_tri_batch(v, t, lame, device=dev, dtype=dtype, vertex_offset=off)
            for (v, t, lame, off) in self._tri_specs
        )

        # Gather families get their vertex -> corner tables for D^T
        # (admm_elastic_tpu/solver.py:620-646); stencil families need none.
        def with_table(b):
            if b.stencil is not None:
                return b
            table = red.build_gather_table(b.inds.cpu().numpy(), n)
            return dataclasses.replace(b, gather_idx=torch.as_tensor(table, device=dev))

        tets = tuple(with_table(b) for b in tets)
        tris = tuple(with_table(b) for b in tris)
        # pins as energies, but for Gauss-Seidel, whose sweeps set them
        # (src/Solver.cpp:190-196)
        pins_batch = None
        if self._pins and ls != cfg.NCMCGS:
            idxs = np.array(sorted(self._pins.keys()), dtype=np.int64)
            tgts = np.stack([self._pins[int(i)] for i in idxs])
            pins_batch = el.build_pin_batch(idxs, tgts, device=dev, dtype=dtype)
        system = sysm.System(
            masses=torch.as_tensor(m_np).to(dev, dtype),
            tets=tets,
            tris=tris,
            pins=pins_batch,
            dt=float(s.timestep_s),
        )
        if ls in (cfg.PCG, cfg.ALPCG):
            solve_data = pcg_mod.prepare(system, dtype, precond=s.pcg_precond)
        elif ls == cfg.NCMCGS:
            np_dtype = np.float32 if dtype == torch.float32 else np.float64
            cols, vals, diag = assembly.assemble_ell(system, dtype=np_dtype)
            groups, gmask = assembly.color_groups(
                assembly.greedy_coloring(assembly.vertex_adjacency(system)))
            solve_data = gs_mod.GSData(
                ell_cols=torch.as_tensor(cols, device=dev),
                ell_vals=torch.as_tensor(vals, device=dev),
                diag=torch.as_tensor(diag, device=dev),
                colors=torch.as_tensor(groups, device=dev),
                colors_mask=torch.as_tensor(gmask, device=dev))
        elif ls == cfg.UZAWACG and _uzawa_inner(s, n) == "pcg":
            # the O(nnz) inner operator (the reference's SimplicialLDLT role,
            # src/LinearSolver.hpp:79-84); "auto" takes two-grid
            precond = "twogrid" if s.uzawa_inner == "auto" else s.pcg_precond
            solve_data = pcg_mod.prepare(system, dtype, precond=precond)
        else:
            pin_rows = None
            if pins_batch is not None:
                cols, vals, diag = assembly.assemble_ell(system, dtype=np.float64)
                idx = pins_batch.idx.cpu().numpy()
                pin_rows = (idx, cols[idx], vals[idx], diag[idx])
            solve_data = direct_mod.prepare(assembly.assemble_dense(system), device=dev,
                                            dtype=dtype, mode=s.direct_mode,
                                            pin_rows=pin_rows)
        cap = 2 * _surface(self.surface_inds, self._has_cobjs(), n)[0].shape[0]
        state = sysm.SimState(
            x=torch.as_tensor(x_np).to(dev, dtype),
            v=torch.zeros((n, 3), dtype=dtype, device=dev),
            y=torch.zeros((cap,), dtype=dtype, device=dev),
            prev_active=torch.zeros((cap,), dtype=torch.bool, device=dev),
        )
        self.load_arrays(system, solve_data, state)
        if s.verbose >= 1:
            n_terms = (sum(b.n_real for b in tets) + sum(b.n_real for b in tris)
                       + (pins_batch.n if pins_batch else 0))
            print(f"{n} nodes, {n_terms} energy terms")
        return True

    def load_arrays(self, system: sysm.System, solve_data, state: sysm.SimState) -> None:
        """Install a built system, global-step data (a DirectData for the
        direct solve and Uzawa's direct inner, a GSData for Gauss-Seidel, a
        PCGData for PCG, AL-PCG and Uzawa's PCG inner; the settings' linsolver
        must take it) and state, from ``initialize`` or from ``convert.py``;
        places the obstacles, the contact weight, the query set and the dense
        pin arrays on the device, and marks the solver initialized."""
        ls = self.m_settings.linsolver
        takes = {cfg.LDLT: (direct_mod.DirectData,), cfg.NCMCGS: (gs_mod.GSData,),
                 cfg.UZAWACG: (direct_mod.DirectData, pcg_mod.PCGData),
                 cfg.PCG: (pcg_mod.PCGData,), cfg.ALPCG: (pcg_mod.PCGData,)}
        if not isinstance(solve_data, takes.get(ls, ())):
            raise ValueError(f"Solver.load_arrays: {type(solve_data).__name__} for "
                             f"linsolver={ls}")
        if ls == cfg.LDLT and self._has_cobjs():
            raise RuntimeError("**Solver::add_obstacle Error: No collisions with LDLT solver")
        pcg = isinstance(solve_data, pcg_mod.PCGData)
        lead = (solve_data.diag_mass if pcg else solve_data.diag
                if isinstance(solve_data, gs_mod.GSData) else solve_data.mat)
        for t in [system.masses, lead, state.x, state.v, state.y]:
            if t.device != self.device:
                raise ValueError(f"Solver.load_arrays: tensor on {t.device}, "
                                 f"solver on {self.device}")
        n = state.x.shape[0]
        self._dtype = state.x.dtype
        self._n_verts = n
        contact = self._contact_of(system, n)
        rows = (2 * contact.surf.shape[0],)
        if state.y.shape != rows or state.prev_active.shape != rows:
            raise ValueError(f"Solver.load_arrays: y / prev_active of {tuple(state.y.shape)} / "
                             f"{tuple(state.prev_active.shape)} for "
                             f"{contact.surf.shape[0]} query vertices")
        if self.device.type == "cuda" and pcg:  # the kernel's tables, before any capture
            cuda_pcg.plan_of(solve_data)
        self._inner = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._overflow = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self._contact = contact
        self.system = system
        self._solve_data = solve_data
        self.state = state
        self._graph = None
        self.initialized = True

    def _has_cobjs(self) -> bool:
        """Whether a collision object (an obstacle or a collider) exists: then
        the default query set is every vertex (the JAX package's has_cobjs)."""
        return bool(self.obstacles or self.colliders)

    def _contact_of(self, system: sysm.System, n: int) -> "_Contact":
        """What the contact steps read, on the device (the JAX package's
        initialize, admm_elastic_tpu/solver.py:657-684): the constraint weight
        ck (3 x the stiffest element weight for the penalty-type modes GS and
        AL-PCG, src/Solver.cpp:235; 1 for Uzawa, :239; constraint_w if set),
        kept as sqrt(ck) (rows are scaled by sqrt(w),
        src/ConstraintSet.hpp:70); the query set; the obstacles; the dense
        pin arrays."""
        s = self.m_settings
        dev, dtype = self.device, self._dtype
        weights = [b.weight.detach().cpu().numpy() for b in system.tets + system.tris]
        max_w = max((float(w.max()) for w in weights if w.size), default=1.0)
        ck = max_w * 3.0 if s.linsolver in (cfg.NCMCGS, cfg.ALPCG) else 1.0
        if s.constraint_w > 0.0:
            ck = s.constraint_w
        surf, dense = _surface(self.surface_inds, self._has_cobjs(), n)
        mask, target = self._pin_arrays()
        surf_dev = torch.as_tensor(surf, device=dev)
        obstacles = tuple(o.to(dev, dtype) for o in self.obstacles)
        colliders = tuple(c.to(dev, dtype) for c in self.colliders)
        slot_of = None
        if not dense:
            slots = np.full((n,), -1, dtype=np.int32)
            slots[surf] = np.arange(surf.shape[0], dtype=np.int32)
            slot_of = torch.as_tensor(slots, device=dev)
        return _Contact(
            ck=torch.tensor(float(np.sqrt(max(0.0, ck))), dtype=dtype, device=dev),
            surf=surf_dev, dense=dense, obstacles=obstacles,
            table=dyn.collider_table(colliders) if colliders else None, slot_of=slot_of,
            pin_mask=mask.to(dev), pin_target=target.to(dev),
            empty=con.empty_hits(surf_dev, dtype, dense=dense, may_dyn=bool(self.colliders)),
            gs_params=self._gs_params(obstacles))

    def _gs_params(self, obstacles):
        """Kernel H's obstacle parameters, read to the host here, outside any
        capture (Gauss-Seidel on the card only)."""
        if self.m_settings.linsolver != cfg.NCMCGS or self.device.type != "cuda":
            return None
        return cuda_gs.obstacle_params(obstacles)

    # -- what the batched step reads (parallel/batch.py) ------------------------

    @property
    def _surf_inds_dev(self) -> torch.Tensor:
        """The collision query set on the device (i64 [H])."""
        return self._contact.surf

    @property
    def _surf_dense(self) -> bool:
        """Whether the query set is every vertex in order."""
        return self._contact.dense

    @property
    def _ck(self) -> torch.Tensor:
        """sqrt of the constraint weight, 0-d in the run dtype."""
        return self._contact.ck

    # -- stepping --------------------------------------------------------------

    @property
    def _refine_eff(self) -> int:
        """Iterative-refinement passes: an unpinned float32 "inv" system takes
        at least one, since the float32 inverse's error on its near-rigid
        modes grows through v = (x' - x)/dt (the JAX package's
        Solver._refine_eff)."""
        s = self.m_settings
        if (isinstance(self._solve_data, direct_mod.DirectData)
                and self._solve_data.mode == "inv" and self._dtype == torch.float32
                and (self.system.pins is None or self.system.pins.n == 0)):
            return max(s.refine_passes, 1)
        return s.refine_passes

    def _kick(self) -> torch.Tensor:
        """The gravity kick dt g as a tensor on the device, made once per
        (dt, gravity): the step reads it, and no step copies from the host."""
        key = (self.system.dt, self.m_settings.gravity, self._dtype)
        if self._kick_cache is None or self._kick_cache[0] != key:
            dt, g, dtype = key
            kick = torch.tensor(dt, dtype=dtype) * torch.tensor(g, dtype=dtype)
            self._kick_cache = (key, kick.to(self.device))
        return self._kick_cache[1]

    def _apply_Ainv(self, b):
        system, data = self.system, self._solve_data
        x = direct_mod.solve(data, b)
        for _ in range(self._refine_eff):
            x = x + direct_mod.solve(data, b - sysm.A_mv(system, x))
        return direct_mod.polish(data, x, b)

    def _uzawa_Ainv(self, rhs, x0, done):
        """Uzawa's A^-1 apply: the direct solve (x0 and done unread), or an
        inner PCG solve to uzawa_inner_tol from x0 (0 where None) that takes no
        trip where done is set (kernel G on the card; its trips are not the
        step's inner iterations, admm_elastic_tpu/solver.py:148-157, and are
        not counted)."""
        data = self._solve_data
        if not isinstance(data, pcg_mod.PCGData):
            return self._apply_Ainv(rhs)
        s = self.m_settings
        return cuda_pcg.pcg_solve(data, rhs, torch.zeros_like(rhs) if x0 is None else x0,
                                  s.uzawa_inner_tol, s.uzawa_inner_iters, None, done=done)

    def _detect(self, x, with_passive: bool = True) -> con.Hits:
        """The hits at x of every query vertex (the JAX package's _detect,
        admm_elastic_tpu/solver.py:91-132): with_passive, the first obstacle
        of least distance, a mesh obstacle through cuda_obstacle.mesh_detect
        (kernel J on the card); the first collider's hit per vertex through
        cuda_dynamic.dyn_detect over the collider table (kernel K on the card,
        one call whatever the number of colliders; the callers list the
        rows' corners by vertex, constraints.with_table). Overflows go to the
        solver's device flag."""
        c = self._contact
        if c.surf.shape[0] == 0:
            return c.empty
        hits = c.empty
        xs = x if c.dense else x[c.surf]
        if c.obstacles and with_passive:
            found, mask = [], None
            for o in c.obstacles:
                if isinstance(o, MESH):
                    dx, point, normal, mask = cuda_obstacle.mesh_detect(o, xs, self._overflow)
                    found.append((dx, point, normal))
                else:
                    found.append(o.signed_distance(xs))
            dx, point, normal = pick_deepest(found)
            if len(found) > 1 or mask is None:
                mask = dx < 0.0
            hits = dataclasses.replace(hits, p_mask=mask, p_normal=normal, p_point=point)
        if c.colliders:
            h = c.surf.shape[0]
            rows = (torch.zeros((h,), dtype=torch.bool, device=x.device),
                    torch.zeros((h, 3), dtype=torch.int64, device=x.device),
                    torch.zeros((h, 3), dtype=x.dtype, device=x.device),
                    torch.zeros((h, 3), dtype=x.dtype, device=x.device))
            rows = cuda_dynamic.dyn_detect(c.table, x, xs, c.surf, rows, self._overflow)
            d_mask, d_face, d_barys, d_normal = rows
            hits = dataclasses.replace(hits, d_mask=d_mask, d_face=d_face, d_barys=d_barys,
                                       d_normal=d_normal)
        return hits

    def _global(self, b, curr_x, y, n_prev, hits=None):
        """One global solve with the configured mode (src/Solver.cpp:98-99),
        from curr_x: returns (x, y, the active rows). The inner iterations go
        to the step's counter. hits: the contact solvers' detection at curr_x
        where the caller made it (step_profiled's collision phase), else made
        here."""
        s = self.m_settings
        ls = s.linsolver
        c = self._contact
        if ls == cfg.NCMCGS:
            # the passive contacts are the sweeps' own per-vertex projection;
            # the dynamic rows fold in as a penalty (kernel H's DYN form)
            if c.colliders:
                if hits is None:
                    hits = self._detect(curr_x, with_passive=False)
                x = cuda_gs.gs_solve_dyn(
                    self._solve_data, b, curr_x, c.pin_mask, c.pin_target, c.obstacles,
                    s.gs_omega, s.gs_max_iters, s.gs_tol, self._inner,
                    con.with_table(hits, b.shape[0]), c.ck, c.slot_of, params=c.gs_params)
                return x, y, n_prev
            x = cuda_gs.gs_solve(self._solve_data, b, curr_x, c.pin_mask, c.pin_target,
                                 c.obstacles, s.gs_omega, s.gs_max_iters, s.gs_tol, self._inner,
                                 params=c.gs_params)
            return x, y, n_prev
        if ls in (cfg.UZAWACG, cfg.ALPCG):
            hits, y, act = self._contact_rows(curr_x, y, n_prev, hits)
            if ls == cfg.UZAWACG:
                x, y, it = uzawa_mod.solve(self._uzawa_Ainv, hits, c.ck, b, curr_x, y,
                                           s.uzawa_max_iters, s.uzawa_tol, slot_of=c.slot_of)
                self._inner += it
            else:
                x, y = alcg_mod.solve(self._solve_data, hits, c.ck, b, curr_x, y, s.pcg_tol,
                                      s.pcg_max_iters, self._inner, slot_of=c.slot_of)
            return x, y, act
        if isinstance(self._solve_data, pcg_mod.PCGData):
            return (cuda_pcg.pcg_solve(self._solve_data, b, curr_x, s.pcg_tol, s.pcg_max_iters,
                                       self._inner), y, n_prev)
        return self._apply_Ainv(b), y, n_prev

    def _contact_rows(self, curr_x, y, n_prev, hits=None):
        """The contact solvers' hits at curr_x (detected here where None),
        deduped (a vertex with a passive row keeps no dynamic row) with their
        table, their active rows, and y kept only where the active SET is that
        of the last solve (system.SimState; stricter than the reference's
        count gate)."""
        if hits is None:
            hits = self._detect(curr_x)
        hits = con.with_table(hits.dedup(), curr_x.shape[0])
        act = torch.cat([hits.p_mask, hits.d_mask])
        return hits, torch.where(torch.all(act == n_prev), y, torch.zeros_like(y)), act

    def _global_traced(self, b, curr_x, y, n_prev, n_inner: int, x_star, err_denom):
        """step_logged's global solve: the configured mode's fixed-length
        traced form (solvers/*.solve_traced; the direct solve's residual
        repeated n_inner times). Returns (x, y, the active rows, res [n_inner],
        err [n_inner] or None)."""
        s = self.m_settings
        ls = s.linsolver
        c, data = self._contact, self._solve_data
        kw = dict(x_star=x_star, err_denom=err_denom)
        if ls == cfg.NCMCGS:
            hits = (con.with_table(self._detect(curr_x, with_passive=False), curr_x.shape[0])
                    if c.colliders else c.empty)
            x, tr = gs_mod.solve_traced(data.ell_cols, data.ell_vals, data.diag, data.colors,
                                        data.colors_mask, b, curr_x, c.pin_mask, c.pin_target,
                                        c.obstacles, hits, c.ck, s.gs_omega, n_inner,
                                        may_have_dyn=bool(c.colliders), **kw)
        elif ls in (cfg.UZAWACG, cfg.ALPCG):
            hits, y, n_prev = self._contact_rows(curr_x, y, n_prev)
            if ls == cfg.UZAWACG:
                x, y, tr = uzawa_mod.solve_traced(self._uzawa_Ainv, hits, c.ck, b, curr_x, y,
                                                  n_inner, **kw)
            else:
                x, y, tr = alcg_mod.solve_traced(data, hits, c.ck, b, curr_x, y, n_inner, **kw)
        elif isinstance(data, pcg_mod.PCGData):
            x, tr = pcg_mod.solve_traced(data.apply, data.precondition(), b, curr_x, n_inner,
                                         **kw)
        else:
            x = self._apply_Ainv(b)
            err = pcg_mod.trace_err(x_star, x, err_denom)
            tr = {"res": torch.linalg.norm(b - sysm.A_mv(self.system, x)).expand(n_inner),
                  "err": None if err is None else err.expand(n_inner)}
        return x, y, n_prev, tr["res"], tr["err"]

    def _predict(self, state: sysm.SimState):
        """Explicit forces, then the gravity kick (src/Solver.cpp:53-59):
        (x_bar, M x_bar). The forces act on a copy of v (every force returns a
        new tensor), which the kick then writes in place."""
        system = self.system
        v = state.v.clone()
        for f in self.ext_forces:
            v = f.project(system.dt, state.x, v, system.masses)
        v[:, 1] += self._kick()
        x_bar = state.x + system.dt * v
        return x_bar, system.masses[:, None] * x_bar

    def _new_state(self, state: sysm.SimState, x, y, n_prev) -> sysm.SimState:
        return sysm.SimState(x=x, v=(x - state.x) * (1.0 / self.system.dt), y=y,
                             prev_active=n_prev)

    def _step_core(self, state: sysm.SimState) -> sysm.SimState:
        s = self.m_settings
        system = self.system
        x_bar, M_xbar = self._predict(state)
        y, n_prev = state.y, state.prev_active
        if s.linsolver != cfg.LDLT:
            self._inner.zero_()
        if s.aa_window > 0:
            x, y, n_prev = self._admm_anderson(x_bar, M_xbar, y, n_prev)
            return self._new_state(state, x, y, n_prev)
        z = sysm.zeros_like_Dx(system, self._dtype, self.device)
        u = [torch.zeros_like(zi) for zi in z]
        x = x_bar
        for _ in range(s.admm_iters):
            z, u = sysm.local_step(system, x, z, u, s.prox_newton_iters)
            b = sysm.rhs(system, M_xbar, z, u)
            x, y, n_prev = self._global(b, x, y, n_prev)
        return self._new_state(state, x, y, n_prev)

    def _admm_anderson(self, x_bar, M_xbar, y, n_prev):
        """The ADMM loop as the Douglas-Rachford map v -> g(v) on v = D x + u
        with safeguarded type-II Anderson extrapolation (solvers/anderson.py;
        admm_elastic_tpu/solver.py:298-343): from v0 = D x_bar, per iteration
        z = prox(v) and u = v - z per family (system.prox_split: kernel A's
        and E's rows entries with u = 0), the global solve from the last x,
        g(v) = D x + u (kernel B standalone on a lattice), then the update.
        Every decision stays on the device, and the history is fresh each
        step. Returns (x, y, the active rows)."""
        s = self.m_settings
        system = self.system
        v = sysm.flat(sysm.Dx(system, x_bar))
        aa = anderson_mod.init(s.aa_window, v)
        x = x_bar
        for _ in range(s.admm_iters):
            z, u = sysm.prox_split(system, sysm.unflat(system, v), s.prox_newton_iters)
            b = sysm.rhs(system, M_xbar, z, u)
            x, y, n_prev = self._global(b, x, y, n_prev)
            gv = sysm.flat([d + ui for d, ui in zip(sysm.Dx(system, x), u)])
            v, aa, _ = anderson_mod.update(aa, v, gv, safeguard=s.aa_safeguard)
        return x, y, n_prev

    def _graph_reads(self) -> tuple:
        """The objects a captured step reads, and a mesh obstacle's tables,
        whose addresses kernels H and J hold, and the colliders."""
        tables = tuple(getattr(o, f.name) for o in self._contact.obstacles if isinstance(o, MESH)
                       for f in dataclasses.fields(o)
                       if isinstance(getattr(o, f.name), torch.Tensor))
        return ((self.system, self._solve_data) + tuple(self.ext_forces)
                + self._contact.obstacles + tables + self._contact.colliders
                + ((self._contact.table,) if self._contact.table is not None else ()))

    def _graph_key(self) -> tuple:
        s = self.m_settings
        return (s.admm_iters, s.prox_newton_iters, self._refine_eff, s.timestep_s, s.gravity,
                s.pcg_tol, s.pcg_max_iters, s.pcg_precond, s.gs_max_iters, s.gs_tol,
                s.gs_omega, s.uzawa_max_iters, s.uzawa_tol, s.uzawa_inner_tol,
                s.uzawa_inner_iters, s.constraint_w, s.aa_window, s.aa_safeguard,
                tuple(self.surface_inds), tuple(id(o) for o in self._graph_reads()))

    def _capture(self, key) -> _StepGraph:
        """Capture one timestep into a CUDA graph that reads and writes static
        copies of x, v, y and prev_active. A warm-up step on a side stream first builds the
        kernel library, sets kernel C's shared-memory attribute and fills the
        allocator (its result is dropped). The kernel wrappers count their
        calls in the warm-up step and in the capture; a replay runs the
        captured kernels without them."""
        dev = self.device
        static = self.state.clone()
        self._kick()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step_core(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self._step_core(static)
                for f in _STATE_FIELDS:
                    getattr(static, f).copy_(getattr(out, f))
        except Exception as e:
            raise RuntimeError("Solver: capturing the timestep as a CUDA graph failed") from e
        return _StepGraph(key=key, graph=graph, state=static, reads=self._graph_reads())

    def _step_graph(self) -> _StepGraph:
        """The captured step for the current settings, captured anew where
        they changed, with the solver's state copied into its buffers unless
        it is the snapshot that the last _advance took from them, untouched
        (the buffers then hold it already)."""
        key = self._graph_key()
        handed = self._handed
        if self._graph is None or self._graph.key != key:
            self._graph = None  # release the old graph's memory first
            self._graph = self._capture(key)
            handed = None
        g = self._graph
        if handed is None or handed[0] is not self.state or handed[1] != _versions(self.state):
            for f in _STATE_FIELDS:
                getattr(g.state, f).copy_(getattr(self.state, f))
        return g

    def _advance(self, n_steps: int) -> None:
        """n_steps timesteps: graph replays on the card, eager on the CPU.
        On the card the state goes into the graph's buffers before the
        replays and out of them after, into a new SimState: a state the
        caller keeps is a snapshot that no later replay writes (a device
        copy of x, v, y and prev_active per call, two where the caller
        assigned another state or changed one in place)."""
        if self.device.type == "cpu":
            self._run_eager(n_steps)
            return
        g = self._step_graph()
        self._clear_overflow()
        for _ in range(n_steps):
            g.graph.replay()
        self.state = g.state.clone()
        self._handed = (self.state, _versions(self.state))
        torch.cuda.synchronize(self.device)

    def _run_eager(self, n_steps: int) -> None:
        """n_steps timesteps as eager PyTorch, one _step_core after the other:
        the CPU's path, and on the card what a captured step is held to."""
        state = self.state
        self._clear_overflow()
        for _ in range(n_steps):
            state = self._step_core(state)
        self.state = state
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """Advance one timestep (src/Solver.cpp:35-109). log_inner routes to
        step_logged and verbose >= 2 to step_profiled, as in the JAX
        package; else the captured step on the card, eager on the CPU."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        if s.log_inner:
            return self.step_logged()
        if s.verbose >= 2:
            return self.step_profiled()
        if s.verbose > 0:
            print(f"\nSimulating with dt: {s.timestep_s}s...", end="", flush=True)
        t0 = time.perf_counter()
        self._advance(1)
        step_ms = (time.perf_counter() - t0) * 1e3
        direct = s.linsolver == cfg.LDLT
        self._runtime = RuntimeData(
            step_ms=step_ms, inner_iters=s.admm_iters if direct else int(self._inner.item()),
            collision_overflow=self._dropped())
        if self._runtime.collision_overflow and s.verbose >= 0:
            print("**Solver::step Warning: collision capacity overflow — "
                  "contacts were dropped this step (raise HIT_CAP/cell_cap).")
        if s.verbose > 0:
            self._runtime.print(s)

    def _flagged(self) -> bool:
        """Whether a mesh obstacle or a collider is placed: only their
        detections set the overflow flag, so only then is the flag zeroed and
        read."""
        c = self._contact
        return bool(c.colliders) or any(isinstance(o, MESH) for o in c.obstacles)

    def _clear_overflow(self) -> None:
        if self._flagged():
            self._overflow.zero_()

    def _dropped(self) -> bool:
        """Whether a detection since the flag was zeroed dropped a contact
        (reads the device flag, a synchronisation, where a mesh obstacle or a
        collider is placed)."""
        return self._flagged() and bool(self._overflow.item())

    def step_profiled(self) -> RuntimeData:
        """One timestep with per-phase wall-clock timings (local, collision,
        global) in RuntimeData, like the reference's per-step print
        (src/Solver.hpp:54-61, src/Solver.cpp:83-100;
        admm_elastic_tpu/solver.py:881-985).

        The JAX package's non-fused diagnostic, ported as such: the phases run
        eagerly (on the card not captured), each ended by a device
        synchronisation, through the functions of _step_core in its order
        (the local step's kernels; the obstacle detection; the rhs and the
        direct solve, or kernel G or H), so the state it leaves is that of
        _run_eager(1) bit for bit. Slower than step(); for profiling only.
        """
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        if s.aa_window > 0:
            raise ValueError(
                "step_profiled does not implement Anderson acceleration; set aa_window=0 or "
                "verbose<=1 (profiled numerics would silently differ from the fused path "
                "otherwise).")
        system, ls = self.system, s.linsolver
        rt = RuntimeData()
        t_all = time.perf_counter()
        state = self.state
        x_bar, M_xbar = self._predict(state)
        y, n_prev = state.y, state.prev_active
        if ls != cfg.LDLT:
            self._inner.zero_()
        self._clear_overflow()
        z = sysm.zeros_like_Dx(system, self._dtype, self.device)
        u = [torch.zeros_like(zi) for zi in z]
        x = x_bar
        for _ in range(s.admm_iters):
            t = time.perf_counter()
            z, u = sysm.local_step(system, x, z, u, s.prox_newton_iters)
            self._sync()
            rt.local_ms += (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            hits = (self._detect(x, with_passive=ls != cfg.NCMCGS)
                    if ls != cfg.NCMCGS or self._contact.colliders else None)
            self._sync()
            rt.collision_ms += (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            b = sysm.rhs(system, M_xbar, z, u)
            x, y, n_prev = self._global(b, x, y, n_prev, hits)
            self._sync()
            rt.global_ms += (time.perf_counter() - t) * 1e3
        self.state = self._new_state(state, x, y, n_prev)
        rt.inner_iters = s.admm_iters if ls == cfg.LDLT else int(self._inner.item())
        rt.collision_overflow = self._dropped()
        rt.step_ms = (time.perf_counter() - t_all) * 1e3
        self._runtime = rt
        if s.verbose > 0:
            rt.print(s)
        return rt

    def step_logged(self) -> log_utils.InnerLog:
        """One timestep recording the per-inner-iteration residual curve of
        every global solve (SolverLog parity, src/SolverLog.hpp:36-64;
        admm_elastic_tpu/solver.py:987-1118): each global solve runs its
        fixed-length traced form (no early exit; solvers/*.solve_traced), so
        the curves are [admm_iters, n_inner], n_inner = log_inner_iters or the
        active solver's max iterations (1 for the direct solve). Set
        ``solver.solver_log.x_star`` beforehand to also record the error
        against a known solution, normalised by the distance before the step.
        Results land in ``solver.solver_log`` (utils/logging.InnerLog), whose
        final_r is the last trip of the last solve.

        The JAX package's non-fused diagnostic, ported as such: plain PyTorch,
        eager on every device (on the card not captured); the traced solves'
        x follows another path than the step's solves, as there.
        """
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        if s.aa_window > 0:
            raise ValueError("step_logged does not implement Anderson acceleration; "
                             "set aa_window=0.")
        system, dtype = self.system, self._dtype
        n_inner = s.log_inner_iters or {
            cfg.LDLT: 1, cfg.NCMCGS: s.gs_max_iters, cfg.UZAWACG: s.uzawa_max_iters,
            cfg.PCG: s.pcg_max_iters, cfg.ALPCG: s.pcg_max_iters}[s.linsolver]
        state = self.state
        x_star_np = getattr(self.solver_log, "x_star", None)
        x_star = err_denom = None
        if x_star_np is not None and np.shape(x_star_np) == tuple(state.x.shape):
            x_star = torch.as_tensor(np.asarray(x_star_np, np.float64)).to(self.device, dtype)
            # the reference's SolverLog normalises by the iterate at the first
            # recorded inner iteration of the run (src/SolverLog.hpp:42-47)
            err_denom = torch.clamp_min(torch.linalg.norm(x_star - state.x),
                                        torch.finfo(dtype).tiny)
        x_bar, M_xbar = self._predict(state)
        y, n_prev = state.y, state.prev_active
        self._clear_overflow()
        z = sysm.zeros_like_Dx(system, dtype, self.device)
        u = [torch.zeros_like(zi) for zi in z]
        x = x_bar
        res_rows, err_rows = [], []
        for _ in range(s.admm_iters):
            z, u = sysm.local_step(system, x, z, u, s.prox_newton_iters)
            b = sysm.rhs(system, M_xbar, z, u)
            x, y, n_prev, res, err = self._global_traced(b, x, y, n_prev, n_inner, x_star,
                                                         err_denom)
            res_rows.append(res.cpu().numpy())
            err_rows.append(None if err is None else err.cpu().numpy())
        self.state = self._new_state(state, x, y, n_prev)
        self._runtime = RuntimeData(collision_overflow=self._dropped())
        if self._runtime.collision_overflow:
            print("**Solver::step_logged Warning: collision capacity overflow — contacts were "
                  "dropped this step (raise HIT_CAP/cell_cap).")
        self.solver_log = log_utils.InnerLog(
            residuals=np.stack(res_rows) if res_rows else np.zeros((0, n_inner)),
            errors=np.stack(err_rows) if x_star is not None and err_rows else None,
            final_r=float(res_rows[-1][-1]) if res_rows and n_inner else 0.0,
            x_star=x_star_np)
        return self.solver_log

    def run(self, n_steps: int):
        """Advance n_steps with no host sync between steps (log_inner and
        verbose are not read, as in the JAX package)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        t0 = time.perf_counter()
        self._advance(n_steps)
        self._runtime = RuntimeData(
            step_ms=(time.perf_counter() - t0) * 1e3 / max(n_steps, 1),
            collision_overflow=self._dropped())
        if self._runtime.collision_overflow:
            print("**Solver::run Warning: collision capacity overflow — contacts were dropped "
                  "during the rollout (raise HIT_CAP/cell_cap).")
