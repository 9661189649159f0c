"""The Solver: scene staging, one-time initialize, and the timestep.

A port of the ``linsolver=0`` / ``direct_mode="inv"`` path of
``admm_elastic_tpu/solver.py``, with the same API (``add_nodes``,
``add_tet_energies``, ``add_tri_energies``, ``add_explicit_force``,
``set_pins``, ``initialize``, ``step``, ``run``, ``x`` / ``v``). One
timestep (src/Solver.cpp:35-109):

    v <- explicit forces(x, v);  v_y += dt g;  x_bar = x + dt v
    z = 0;  u = 0;  x' = x_bar
    repeat admm_iters:
        local:  z, u <- prox(D x' + u)                 kernels B, A (tets), E (cloth)
        global: b = M x_bar + dt^2 D^T W^2 (z - u)     kernel C (tets)
                x' = A^-1 b (GEMM) + pin-row polish
    v = (x' - x) / dt;  x = x'

Every tensor lives on the solver's ``device``, the CUDA card unless the
caller asks for ``"cpu"``; nothing falls back to another device. ``run(n)`` is a Python loop over ``step``.
What this slice does not run raises NotImplementedError naming the
ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from admm_elastic_tpu_torch import config as cfg
from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.solvers import direct as direct_mod
from admm_elastic_tpu_torch.system import assembly
from admm_elastic_tpu_torch.system import elements as el
from admm_elastic_tpu_torch.system import system as sysm


@dataclasses.dataclass
class RuntimeData:
    """Per-step timing log (reference src/Solver.hpp:54-61)."""

    step_ms: float = 0.0
    inner_iters: int = 0

    def print(self, settings: Settings):
        print(f"\nTotal step: {self.step_ms}ms")
        print(f"ADMM Iters: {settings.admm_iters}")


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
    if s.linsolver != cfg.LDLT:
        raise NotImplementedError(
            f"linsolver={s.linsolver} is not ported yet; only 0 (prefactored "
            "direct) runs (ROADMAP Queue 1 items 6 and 8)")
    if s.direct_mode != "inv":
        raise NotImplementedError(
            f"direct_mode={s.direct_mode!r} is not ported yet; only 'inv' runs "
            "(ROADMAP Queue 1 item 5)")
    if s.aa_window > 0:
        raise NotImplementedError(
            "Anderson acceleration (aa_window > 0) is not ported yet "
            "(ROADMAP Queue 1 item 11)")
    if s.unroll_admm:
        raise NotImplementedError(
            "unroll_admm is not ported (ROADMAP 'Do not port')")
    if s.log_inner or s.verbose >= 2:
        raise NotImplementedError(
            "step_logged / step_profiled (log_inner, verbose >= 2) are not "
            "ported yet (ROADMAP Queue 1 item 11)")


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
        self.system: Optional[sysm.System] = None
        self.state: Optional[sysm.SimState] = None
        self._solve_data: Optional[direct_mod.DirectData] = None
        self._dtype = cfg.resolve_dtype(self.m_settings)
        self._runtime = RuntimeData()

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

    def add_obstacle(self, obj):
        raise NotImplementedError(
            "obstacles are not ported yet, and linsolver=0 takes none "
            "(ROADMAP Queue 1 item 8)")

    def add_dynamic_collider(self, obj):
        raise NotImplementedError(
            "dynamic colliders (self-collision) are not ported yet "
            "(ROADMAP Queue 1 item 10)")

    def set_pins(self, inds, points=None):
        """(Re)set the pin constraint set (src/Solver.cpp:113-157).

        Before initialize: defines the pinnable set. After initialize only
        the targets and active flags of the initial pin set may change.
        """
        inds = [int(i) for i in inds]
        pin_in_place = points is None or len(points) != len(inds)
        if pin_in_place and points is not None and len(points) > 0:
            raise ValueError("**Solver::set_pins Error: Bad input.")

        new_pins: Dict[int, np.ndarray] = {}
        x_now = self.x if self.initialized or self._n_verts else None
        for k, idx in enumerate(inds):
            if pin_in_place:
                if x_now is None:
                    raise ValueError("**Solver::set_pins Error: Bad input.")
                new_pins[idx] = np.asarray(x_now[idx], dtype=np.float64)
            else:
                new_pins[idx] = np.asarray(points[k], dtype=np.float64)
        self._pins = new_pins
        if not self.initialized:
            return

        pins = self.system.pins
        if pins is None or pins.n == 0:
            if new_pins:
                raise RuntimeError("**Solver::set_pins Error: Constraint not found.")
            return
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
        self.system.pins = dataclasses.replace(
            pins,
            target=torch.as_tensor(target).to(self.device, pins.target.dtype),
            active=torch.as_tensor(active, device=self.device),
        )

    # -- state views -----------------------------------------------------------

    @property
    def x(self) -> np.ndarray:
        if self.state is not None:
            return self.state.x.cpu().numpy().copy()
        return np.concatenate(self._x_stage, axis=0) if self._x_stage else np.zeros((0, 3))

    @x.setter
    def x(self, value):
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if self.state is None:
            raise RuntimeError("Solver.x: set positions after initialize()")
        self.state = dataclasses.replace(
            self.state, x=torch.as_tensor(value).to(self.device, self._dtype))

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
        """Build the element batches, assemble A, invert it (src/Solver.cpp:167-261)."""
        if settings is not None:
            self.m_settings = settings
        s = self.m_settings
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
        if n > s.direct_max_verts:
            raise NotImplementedError(
                f"{n} vertices exceed direct_max_verts={s.direct_max_verts}; the "
                "JAX package then serves linsolver=0 through ELL-PCG, which is "
                "not ported yet (ROADMAP Queue 1 item 6)")
        self._n_verts = n
        dtype = cfg.resolve_dtype(s)
        self._dtype = dtype
        dev = self.device

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
        pins_batch = None
        if self._pins:
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
        pin_rows = None
        if pins_batch is not None:
            cols, vals, diag = assembly.assemble_ell(system, dtype=np.float64)
            idx = pins_batch.idx.cpu().numpy()
            pin_rows = (idx, cols[idx], vals[idx], diag[idx])
        solve_data = direct_mod.prepare(assembly.assemble_dense(system), device=dev,
                                        dtype=dtype, mode=s.direct_mode, pin_rows=pin_rows)
        state = sysm.SimState(
            x=torch.as_tensor(x_np).to(dev, dtype),
            v=torch.zeros((n, 3), dtype=dtype, device=dev),
        )
        self.load_arrays(system, solve_data, state)
        if s.verbose >= 1:
            n_terms = (sum(b.n_real for b in tets) + sum(b.n_real for b in tris)
                       + (pins_batch.n if pins_batch else 0))
            print(f"{n} nodes, {n_terms} energy terms")
        return True

    def load_arrays(self, system: sysm.System, direct: direct_mod.DirectData,
                    state: sysm.SimState) -> None:
        """Install a built system, direct-solve data and state (from
        ``initialize`` or from ``convert.py``); marks the solver initialized."""
        for t in [system.masses, direct.mat, state.x, state.v]:
            if t.device != self.device:
                raise ValueError(f"Solver.load_arrays: tensor on {t.device}, "
                                 f"solver on {self.device}")
        self.system = system
        self._solve_data = direct
        self.state = state
        self._dtype = state.x.dtype
        self._n_verts = state.x.shape[0]
        self.initialized = True

    # -- stepping --------------------------------------------------------------

    @property
    def _refine_eff(self) -> int:
        """Iterative-refinement passes: an unpinned float32 system takes at
        least one, since the float32 inverse's error on its near-rigid modes
        grows through v = (x' - x)/dt (the JAX package's Solver._refine_eff)."""
        s = self.m_settings
        if self._dtype == torch.float32 and (self.system.pins is None
                                             or self.system.pins.n == 0):
            return max(s.refine_passes, 1)
        return s.refine_passes

    def _apply_Ainv(self, b):
        system, data = self.system, self._solve_data
        x = direct_mod.solve(data, b)
        for _ in range(self._refine_eff):
            x = x + direct_mod.solve(data, b - sysm.A_mv(system, x))
        return direct_mod.polish(data, x, b)

    def _step_core(self, state: sysm.SimState) -> sysm.SimState:
        s = self.m_settings
        system = self.system
        dt = system.dt
        x0 = state.x
        # Explicit forces, then the gravity kick (src/Solver.cpp:53-59).
        v = state.v
        for f in self.ext_forces:
            v = f.project(dt, x0, v, system.masses)
        kick = (torch.tensor(dt, dtype=self._dtype, device=self.device)
                * torch.tensor(s.gravity, dtype=self._dtype, device=self.device))
        v = v.clone()
        v[:, 1] += kick
        x_bar = x0 + dt * v
        M_xbar = system.masses[:, None] * x_bar
        z = sysm.zeros_like_Dx(system, self._dtype, self.device)
        u = [torch.zeros_like(zi) for zi in z]
        curr_x = x_bar
        for _ in range(s.admm_iters):
            z, u = sysm.local_step(system, curr_x, z, u, s.prox_newton_iters)
            b = sysm.rhs(system, M_xbar, z, u)
            curr_x = self._apply_Ainv(b)
        return sysm.SimState(x=curr_x, v=(curr_x - x0) * (1.0 / dt))

    def step(self):
        """Advance one timestep (src/Solver.cpp:35-109)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        if s.verbose > 0:
            print(f"\nSimulating with dt: {s.timestep_s}s...", end="", flush=True)
        t0 = time.perf_counter()
        self.state = self._step_core(self.state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._runtime = RuntimeData(step_ms=(time.perf_counter() - t0) * 1e3,
                                    inner_iters=s.admm_iters)
        if s.verbose > 0:
            self._runtime.print(s)

    def run(self, n_steps: int):
        """Advance n_steps with no host sync between steps."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        t0 = time.perf_counter()
        state = self.state
        for _ in range(n_steps):
            state = self._step_core(state)
        self.state = state
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._runtime = RuntimeData(
            step_ms=(time.perf_counter() - t0) * 1e3 / max(n_steps, 1),
            inner_iters=s.admm_iters * n_steps)
