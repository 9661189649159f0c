"""The Solver: scene staging, one-time initialize, and the timestep.

A port of the ``linsolver=0`` (prefactored direct, ``direct_mode`` "inv" or
"cho") and ``linsolver=3`` (PCG, Jacobi or two-grid) paths of
``admm_elastic_tpu/solver.py``, with the same API (``add_nodes``,
``add_tet_energies``, ``add_tri_energies``, ``add_explicit_force``,
``set_pins``, ``initialize``, ``step``, ``run``, ``x`` / ``v``). Above
``direct_max_verts`` vertices ``linsolver=0`` is served by two-grid PCG at
``pcg_tol = min(pcg_tol, 1e-10)``, as the JAX package does, on a copy of the
settings. One timestep (src/Solver.cpp:35-109):

    v <- explicit forces(x, v);  v_y += dt g;  x_bar = x + dt v
    z = 0;  u = 0;  x' = x_bar
    repeat admm_iters:
        local:  z, u <- prox(D x' + u)                 kernel A (tets), E (cloth)
        global: b = M x_bar + dt^2 D^T W^2 (z - u)     kernel C (stencil tets)
                x' = A^-1 b: GEMM or two triangular solves, + pin-row
                polish (direct), or a PCG solve from x' (kernel G)
    v = (x' - x) / dt;  x = x'

Every tensor lives on the solver's ``device``, the CUDA card unless the
caller asks for ``"cpu"``; nothing falls back to another device.

On the card, ``step()`` and ``run(n)`` replay one timestep captured as a CUDA
graph (the port of ``_run_core``, ``admm_elastic_tpu/solver.py:369-394``):
``run(n)`` replays it n times with no host synchronisation in between and one
at the end, ``step()`` once, so the two share numerics. The first of them
after ``initialize`` captures the graph; it reads and writes static ``x`` and
``v`` buffers. A new ``x`` or ``v`` (the setters, or a new ``state``) is
copied into those buffers at the next call; the state, the system and its
batches are frozen dataclasses (as in the JAX package), so no field can be
swapped behind the graph's back; ``set_pins`` copies the targets
and active flags into the tensors the graph reads; ``initialize``,
``load_arrays``, ``add_explicit_force`` and a change of ``admm_iters``,
``prox_newton_iters``, ``refine_passes``, ``timestep_s``, ``gravity``,
``pcg_tol``, ``pcg_max_iters`` or ``pcg_precond`` capture it anew. A failed capture raises. ``run(0)`` captures without
stepping. On the CPU the steps run eagerly, one ``_step_core`` after the
other. ``runtime_data().inner_iters`` after ``step()`` is that step's inner
iterations, as the JAX package reports them: ``admm_iters`` on the direct
path, the sum of the CG trips on PCG (a device counter that the step writes,
read once after it); after ``run(n)`` it is 0, as there. What this package
does not run raises NotImplementedError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from admm_elastic_tpu_torch import config as cfg
from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import cuda_pcg
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.solvers import direct as direct_mod
from admm_elastic_tpu_torch.solvers import pcg as pcg_mod
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
        print(f"Avg Inner Iters: {self.inner_iters / max(settings.admm_iters, 1)}")


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
    if s.linsolver in (cfg.NCMCGS, cfg.UZAWACG, cfg.ALPCG):
        raise NotImplementedError(
            f"linsolver={s.linsolver} is not ported yet; 0 (prefactored direct) and "
            "3 (PCG) run (ROADMAP Queue 1 item 8)")
    if s.linsolver not in (cfg.LDLT, cfg.PCG):
        raise ValueError(f"unknown linsolver {s.linsolver}")
    if s.direct_mode not in ("inv", "cho"):
        raise ValueError(f"direct_mode={s.direct_mode!r}: expected 'inv' or 'cho'")
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


@dataclasses.dataclass
class _StepGraph:
    """One timestep captured as a CUDA graph."""

    key: tuple  # what the captured step was built from (Solver._graph_key)
    graph: "torch.cuda.CUDAGraph"
    state: sysm.SimState  # the static x and v that each replay reads and writes
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
        self.system: Optional[sysm.System] = None
        self.state: Optional[sysm.SimState] = None
        # DirectData (linsolver=0) or PCGData (linsolver=3, or 0 above
        # direct_max_verts)
        self._solve_data = None
        self.requested_linsolver = self.m_settings.linsolver
        self._inner = None  # int32 [1]: the current step's CG trips (PCG)
        self._dtype = cfg.resolve_dtype(self.m_settings)
        self._runtime = RuntimeData()
        self._graph: Optional[_StepGraph] = None
        self._kick_cache: Optional[tuple] = None

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
        the targets and active flags of the initial pin set may change; they
        are copied into the pin tensors in place, which a captured step reads.
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
        pins.target.copy_(torch.as_tensor(target))
        pins.active.copy_(torch.as_tensor(active))

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
        if s.linsolver == cfg.LDLT and n > s.direct_max_verts:
            # A dense A^-1 would take N^2 memory here. Serve linsolver=0 by
            # two-grid PCG at the dtype's floor instead, on a copy of the
            # settings: the caller's object stays as it was. (Obstacles, which
            # linsolver=0 forbids at every size, cannot be added yet.)
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
        if s.linsolver == cfg.PCG:
            solve_data = pcg_mod.prepare(system, dtype, precond=s.pcg_precond)
        else:
            pin_rows = None
            if pins_batch is not None:
                cols, vals, diag = assembly.assemble_ell(system, dtype=np.float64)
                idx = pins_batch.idx.cpu().numpy()
                pin_rows = (idx, cols[idx], vals[idx], diag[idx])
            solve_data = direct_mod.prepare(assembly.assemble_dense(system), device=dev,
                                            dtype=dtype, mode=s.direct_mode,
                                            pin_rows=pin_rows)
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

    def load_arrays(self, system: sysm.System, solve_data, state: sysm.SimState) -> None:
        """Install a built system, global-step data (a DirectData for the
        direct solve, a PCGData for PCG; the settings' linsolver must name
        the same) and state, from ``initialize`` or from ``convert.py``; marks
        the solver initialized."""
        pcg = isinstance(solve_data, pcg_mod.PCGData)
        if pcg != (self.m_settings.linsolver == cfg.PCG):
            raise ValueError(f"Solver.load_arrays: {type(solve_data).__name__} for "
                             f"linsolver={self.m_settings.linsolver}")
        lead = solve_data.diag_mass if pcg else solve_data.mat
        for t in [system.masses, lead, state.x, state.v]:
            if t.device != self.device:
                raise ValueError(f"Solver.load_arrays: tensor on {t.device}, "
                                 f"solver on {self.device}")
        if pcg and self.device.type == "cuda":
            cuda_pcg.plan_of(solve_data)  # the kernel's tables, before any capture
        self._inner = torch.zeros((1,), dtype=torch.int32, device=self.device)
        self.system = system
        self._solve_data = solve_data
        self.state = state
        self._dtype = state.x.dtype
        self._n_verts = state.x.shape[0]
        self._graph = None
        self.initialized = True

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

    def _global(self, b, curr_x):
        """The global step: the direct solve, or PCG from curr_x (kernel G on
        the card), whose trips go to the step's counter."""
        if isinstance(self._solve_data, pcg_mod.PCGData):
            s = self.m_settings
            return cuda_pcg.pcg_solve(self._solve_data, b, curr_x, s.pcg_tol,
                                      s.pcg_max_iters, self._inner)
        return self._apply_Ainv(b)

    def _step_core(self, state: sysm.SimState) -> sysm.SimState:
        s = self.m_settings
        system = self.system
        dt = system.dt
        x0 = state.x
        # Explicit forces, then the gravity kick (src/Solver.cpp:53-59).
        v = state.v
        for f in self.ext_forces:
            v = f.project(dt, x0, v, system.masses)
        v = v.clone()
        v[:, 1] += self._kick()
        x_bar = x0 + dt * v
        M_xbar = system.masses[:, None] * x_bar
        z = sysm.zeros_like_Dx(system, self._dtype, self.device)
        u = [torch.zeros_like(zi) for zi in z]
        curr_x = x_bar
        if isinstance(self._solve_data, pcg_mod.PCGData):
            self._inner.zero_()
        for _ in range(s.admm_iters):
            z, u = sysm.local_step(system, curr_x, z, u, s.prox_newton_iters)
            b = sysm.rhs(system, M_xbar, z, u)
            curr_x = self._global(b, curr_x)
        return sysm.SimState(x=curr_x, v=(curr_x - x0) * (1.0 / dt))

    def _graph_reads(self) -> tuple:
        return (self.system, self._solve_data) + tuple(self.ext_forces)

    def _graph_key(self) -> tuple:
        s = self.m_settings
        return (s.admm_iters, s.prox_newton_iters, self._refine_eff, s.timestep_s, s.gravity,
                s.pcg_tol, s.pcg_max_iters, s.pcg_precond,
                tuple(id(o) for o in self._graph_reads()))

    def _capture(self, key) -> _StepGraph:
        """Capture one timestep into a CUDA graph that reads and writes static
        copies of x and v. A warm-up step on a side stream first builds the
        kernel library, sets kernel C's shared-memory attribute and fills the
        allocator (its result is dropped). The kernel wrappers count their
        calls in the warm-up step and in the capture; a replay runs the
        captured kernels without them."""
        dev = self.device
        static = sysm.SimState(x=self.state.x.clone(), v=self.state.v.clone())
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
                static.x.copy_(out.x)
                static.v.copy_(out.v)
        except Exception as e:
            raise RuntimeError("Solver: capturing the timestep as a CUDA graph failed") from e
        return _StepGraph(key=key, graph=graph, state=static, reads=self._graph_reads())

    def _step_graph(self) -> _StepGraph:
        """The captured step for the current settings, captured anew where
        they changed, with the solver's state copied into its buffers where
        it was set since."""
        key = self._graph_key()
        if self._graph is None or self._graph.key != key:
            self._graph = None  # release the old graph's memory first
            self._graph = self._capture(key)
        g = self._graph
        if self.state.x is not g.state.x or self.state.v is not g.state.v:
            g.state.x.copy_(self.state.x)
            g.state.v.copy_(self.state.v)
            self.state = g.state
        return g

    def _advance(self, n_steps: int) -> None:
        """n_steps timesteps: graph replays on the card, eager on the CPU."""
        if self.device.type == "cpu":
            self._run_eager(n_steps)
            return
        g = self._step_graph()
        for _ in range(n_steps):
            g.graph.replay()
        torch.cuda.synchronize(self.device)

    def _run_eager(self, n_steps: int) -> None:
        """n_steps timesteps as eager PyTorch, one _step_core after the other:
        the CPU's path, and on the card what a captured step is held to."""
        state = self.state
        for _ in range(n_steps):
            state = self._step_core(state)
        self.state = state
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self):
        """Advance one timestep (src/Solver.cpp:35-109)."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        if s.verbose > 0:
            print(f"\nSimulating with dt: {s.timestep_s}s...", end="", flush=True)
        t0 = time.perf_counter()
        self._advance(1)
        step_ms = (time.perf_counter() - t0) * 1e3
        pcg = isinstance(self._solve_data, pcg_mod.PCGData)
        self._runtime = RuntimeData(
            step_ms=step_ms, inner_iters=int(self._inner.item()) if pcg else s.admm_iters)
        if s.verbose > 0:
            self._runtime.print(s)

    def run(self, n_steps: int):
        """Advance n_steps with no host sync between steps."""
        if not self.initialized:
            raise RuntimeError("call initialize() first")
        s = self.m_settings
        _check_settings(s)
        t0 = time.perf_counter()
        self._advance(n_steps)
        self._runtime = RuntimeData(
            step_ms=(time.perf_counter() - t0) * 1e3 / max(n_steps, 1))
