"""Scenario batching: S scenes of one mesh stepped together.

A port of ``admm_elastic_tpu/parallel/batch.py``. The JAX package batches a
parameter sweep with ``jax.vmap`` over its step and shards it over a device
mesh; on one card the scene axis lives in the kernels instead:

- the local step is kernel A's (tets) and E's (cloth) scene form, one launch
  for every scene's lanes, each scene's material scaled by its stiffness
  scale s in the kernel (mu s, lam s, kappa s, bulk lam s + 2/3 mu s); a
  cloth gather family runs E's rows entry as it is on the S * T lanes;
- the rhs is kernel C's scene form on a lattice (W^2 = (w sqrt(s))^2), the
  gather D^T with a leading scene axis elsewhere, the pins' D^T as they are;
- the global solve is kernel G's scene form: one thread-block cluster a scene,
  every scene to its own exit (one GRID launch a scene where one cluster
  cannot hold the mesh), A(s) = M + pins + s (D^T W^2 D), the pins unscaled,
  with AL-PCG's penalty rows per scene (ck s^(1/4)) for ``linsolver=4``;
- Uzawa (``linsolver=2``, ck unscaled) runs every scene's Schur CG to its own
  exit: kernel L's scene form for C^T d, G's scene form as the A^-1 apply to
  uzawa_inner_tol (a scene whose ``done`` is set takes no inner trip), and
  M's scene form for the trip's update (``solvers/uzawa.solve_scenes``);
- a mesh obstacle's detection is kernel J's scene form: each scene's near
  lanes and deep fallback compacted on their own, its overflow its own.

Per-scene material sweeps reuse one topology: the ADMM weights scale as
w' = w sqrt(stiffness_scale) (w^2 = k V, src/TetEnergyTerm.cpp:47), so a
stiffness sweep is a per-scene rescale of the weights, and the PCG operator's
stiffness part (diagonal, bands, ELL) a per-scene factor.

On the card the batched step is one CUDA graph per batch size S, captured at
the first call of that size (a warm-up step first builds the kernels and
their plans); a call copies the batch into the graph's buffers, replays it,
and copies the result out, with no read to the host. The sticky per-scene
overflow flag is ORed on the device. On the CPU (a solver built with
``device="cpu"``) the step runs eagerly through the kernels' plain versions.
Nothing falls back from one to the other: a kernel that fails to build or
launch raises.

A batched or coloured wind acts on every scene at once in plain PyTorch. What needs
another kernel family with a scene axis, or more than one card, raises
NotImplementedError naming ROADMAP Queue 1 item 12b: colliders, the
sequential wind, the two-grid preconditioner with ``uses_sweep=False``, and a
mesh of more than one device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from admm_elastic_tpu_torch import config as cfg
from admm_elastic_tpu_torch.collision.passive import MESH, pick_deepest
from admm_elastic_tpu_torch.ops import (cuda_local_step, cuda_obstacle, cuda_pcg, cuda_stencil,
                                        cuda_tri_local_step)
from admm_elastic_tpu_torch.ops import reduction as red
from admm_elastic_tpu_torch.ops import stencil as stencil_mod
from admm_elastic_tpu_torch.solvers import alcg as alcg_mod
from admm_elastic_tpu_torch.solvers import pcg as pcg_mod
from admm_elastic_tpu_torch.solvers import uzawa as uzawa_mod
from admm_elastic_tpu_torch.system import elements as el
from admm_elastic_tpu_torch.system import system as sysm

ITEM_12B = "ROADMAP Queue 1 item 12b"
DEBLOAT_PADDING = 0.15  # stencil padding above which the batch rebuilds gather families


def _deferred(what: str) -> NotImplementedError:
    return NotImplementedError(f"make_batched_step: {what} in a batch is not ported yet "
                               f"({ITEM_12B})")


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """A (scene, shard) grid of devices (the JAX package's Mesh of two axes)."""

    devices: np.ndarray  # [n_scene, n_shard] of torch.device
    axis_names: tuple = ("scene", "shard")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_sim_mesh(n_scene: Optional[int] = None, n_shard: int = 1, devices=None) -> SimMesh:
    """Build a (scene, shard) device mesh (defaults: all devices on scene):
    the CUDA devices, and RuntimeError where there is none (a CPU mesh is
    asked for by naming its devices)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_sim_mesh: no CUDA device; pass devices= to build a mesh "
                               "of other devices")
    devices = np.asarray(list(devices), dtype=object)
    if n_scene is None:
        n_scene = len(devices) // n_shard
    return SimMesh(devices=devices.reshape(n_scene, n_shard))


def _scale_system(system: sysm.System, scale) -> sysm.System:
    """Scale all element stiffnesses by ``scale`` (a number or a 0-d tensor):
    weights by sqrt(scale), mu, lam and kappa by scale, a tet family's bulk
    lam s + (2/3) mu s (the JAX package's bulk property). The pins stay."""
    scale = torch.as_tensor(scale, dtype=system.masses.dtype, device=system.masses.device)
    sq = torch.sqrt(scale)

    def tet(b):
        mu, lam = b.mu * scale, b.lam * scale
        return dataclasses.replace(b, weight=b.weight * sq, mu=mu, lam=lam,
                                   kappa=b.kappa * scale, bulk=lam + (2.0 / 3.0) * mu)

    tets = tuple(tet(b) for b in system.tets)
    tris = tuple(dataclasses.replace(b, weight=b.weight * sq, mu=b.mu * scale,
                                     lam=b.lam * scale) for b in system.tris)
    return dataclasses.replace(system, tets=tets, tris=tris)


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """Per-scene dynamic state + sweep parameters. All leading dim S."""

    x: torch.Tensor  # [S, N, 3]
    v: torch.Tensor  # [S, N, 3]
    y: torch.Tensor  # [S, H2]
    prev_active: torch.Tensor  # bool [S, H2] previous active constraint rows
    stiffness_scale: torch.Tensor  # [S]
    gravity: torch.Tensor  # [S]
    # Sticky per-scene collision-capacity flag (ORed every step): a scene
    # that ever dropped a contact stays flagged for the whole rollout.
    overflow: torch.Tensor  # bool [S]

    @property
    def n_scenes(self) -> int:
        return self.x.shape[0]


FIELDS = tuple(f.name for f in dataclasses.fields(ScenarioBatch))


def make_scenario_batch(solver, n_scenes: int, stiffness_scale=None, gravity=None,
                        jitter: float = 0.0, seed: int = 0) -> ScenarioBatch:
    """Replicate the solver's state S times, optionally jittered by
    jitter * N(0, 1) from torch.Generator(seed) (which cannot draw
    jax.random's numbers: carry a JAX batch over with
    convert.scenario_batch_from_numpy)."""
    st = solver.state
    dtype, dev = st.x.dtype, st.x.device
    x = st.x.expand((n_scenes,) + st.x.shape).clone()
    if jitter > 0.0:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        x = x + jitter * torch.randn(x.shape, generator=gen, dtype=dtype).to(dev)
    if stiffness_scale is None:
        stiffness_scale = torch.ones((n_scenes,), dtype=dtype)
    if gravity is None:
        gravity = torch.full((n_scenes,), solver.m_settings.gravity, dtype=dtype)

    def vec(a):
        return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a).to(
            device=dev, dtype=dtype).reshape(n_scenes)

    return ScenarioBatch(
        x=x,
        v=torch.zeros_like(x),
        y=st.y.expand((n_scenes,) + st.y.shape).clone(),
        prev_active=st.prev_active.expand((n_scenes,) + st.prev_active.shape).clone(),
        stiffness_scale=vec(stiffness_scale),
        gravity=vec(gravity),
        overflow=torch.zeros((n_scenes,), dtype=torch.bool, device=dev),
    )


def _padding(system: sysm.System) -> float:
    """The share of the element lanes that are stencil padding."""
    t_cap = sum(b.n for b in system.tets) + sum(b.n for b in system.tris)
    t_live = sum(b.n_real for b in system.tets) + sum(b.n_real for b in system.tris)
    return 0.0 if t_cap == 0 else (t_cap - t_live) / t_cap


def _debloat_for_throughput(solver, system):
    """Rebuild gather-path element batches when stencil padding is heavy.

    The flat stencil pads dead lanes (ops/stencil.py): irrelevant for one
    latency-bound scene, but in a batch the local step runs every scene's
    lanes and pays the padding directly. Above 15 % padding (the JAX
    package's rule) the families are rebuilt as gather families, with the
    same ``build_gather_table``; else the system is returned as it is.
    """
    if _padding(system) <= DEBLOAT_PADDING:
        return system
    n = system.n_verts
    dev, dtype = system.masses.device, solver._dtype

    def with_table(b):  # the table of the family's own (offset) indices
        table = red.build_gather_table(b.inds.cpu().numpy(), n)
        return dataclasses.replace(b, gather_idx=torch.as_tensor(table, device=dev))

    tets = tuple(
        with_table(el.build_tet_batch(v, t, lame, model, device=dev, dtype=dtype,
                                      vertex_offset=off, kappa=kap, lattice_dims=None))
        for (v, t, lame, model, off, kap, _, _) in solver._tet_specs)
    tris = tuple(
        with_table(el.build_tri_batch(v, t, lame, device=dev, dtype=dtype, vertex_offset=off,
                                      detect_stencil=False))
        for (v, t, lame, off) in solver._tri_specs)
    return dataclasses.replace(system, tets=tets, tris=tris)


class BatchedStep:
    """ScenarioBatch -> ScenarioBatch, one timestep of every scene (see the
    module docstring). ``eager(batch)`` runs the step op by op on any device:
    on the card what the graph is held to. ``trips`` [S] holds each scene's
    CG trips of the last step (Uzawa: its Schur trips; int32, on the
    device)."""

    def __init__(self, solver, system, pcg: pcg_mod.PCGData, ls: int, donate: bool):
        s = solver.m_settings
        c = solver._contact
        self.device = solver.device
        self.dtype = solver._dtype
        self.system = system
        self.pcg = pcg
        self.ls = ls
        self.donate = donate
        self.admm_iters = s.admm_iters
        self.prox_iters = s.prox_newton_iters
        self.tol = s.pcg_tol
        self.max_iters = s.pcg_max_iters
        self.uzawa = (s.uzawa_max_iters, s.uzawa_tol, s.uzawa_inner_tol, s.uzawa_inner_iters)
        self.slot_of = c.slot_of
        self.forces = tuple(solver.ext_forces)
        self.ck = solver._ck
        self.obstacles = c.obstacles
        self.surf = solver._surf_inds_dev
        self.dense = solver._surf_dense
        self.trips = None
        self._graphs: dict = {}

    # -- the step, op by op -------------------------------------------------

    def _local(self, x, z_list, u_list, scale):
        system = self.system
        new_z, new_u = [], []
        for b, u in zip(system.tets, u_list):
            if b.stencil is not None:
                z, u = cuda_local_step.local_step_tet_stencil_scenes(x, u, b, scale,
                                                                     self.prox_iters)
            else:
                z, u = cuda_local_step.local_step_tet_hyper_scenes(
                    red.tet_Dx_rows(x, b.inds, b.Dlocal), u, b.mu, b.lam, b.kappa, scale,
                    n_iters=self.prox_iters, model=b.model)
            new_z.append(z)
            new_u.append(u)
        for b, u in zip(system.tris, u_list[len(system.tets):]):
            if b.stencil is not None:
                z, u = cuda_tri_local_step.local_step_tri_stencil_scenes(x, u, b)
            else:
                z, u = cuda_tri_local_step.local_step_tri_over_scenes(
                    red.tri_Dx_rows(x, b.inds, b.Dlocal), u, b.limit_min, b.limit_max)
            new_z.append(z)
            new_u.append(u)
        if system.pins is not None:
            dix, u = red.pin_Dx(x, system.pins.idx), u_list[-1]
            z = system.pins.prox(dix + u)
            new_z.append(z)
            new_u.append(u + dix - z)
        return new_z, new_u

    def _rhs(self, M_xbar, z_list, u_list, sq):
        system = self.system
        n = system.n_verts
        parts = []
        k = len(system.tets)
        for i, b in enumerate(system.tets + system.tris):
            z, u = z_list[i], u_list[i]
            if i < k and b.stencil is not None:
                parts.append(cuda_stencil.tet_rhs_rows_scenes(z, u, b, n, sq))
                continue
            ws = b.weight[None, :] * sq[:, None]
            g = (ws * ws)[:, None, :] * (z - u)
            if i < k:
                parts.append(red.tet_Dt_rows(g, b.Dlocal, b.gather_idx))
            elif b.stencil is not None:
                parts.append(stencil_mod.tri_Dt_rows(g, b, n))
            else:
                parts.append(red.tri_Dt_rows(g, b.Dlocal, b.gather_idx))
        if system.pins is not None:
            w2 = (system.pins.weight * system.pins.weight)[:, None]
            parts.append(red.pin_Dt(w2 * (z_list[-1] - u_list[-1]), system.pins.idx, n))
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return M_xbar + system.dt2 * out

    def _detect(self, x):
        """The passive hits of every scene at x [S, N, 3]: the first obstacle
        of least distance at each query vertex, a mesh obstacle through
        kernel J's scene form; each scene's overflow in the hits."""
        xs = x if self.dense else x[:, self.surf]
        found, mask, ovf = [], None, None
        for o in self.obstacles:
            if isinstance(o, MESH):
                if ovf is None:
                    ovf = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
                dx, point, normal, mask = cuda_obstacle.mesh_detect_scenes(o, xs.contiguous(), ovf)
                found.append((dx, point, normal))
            else:
                found.append(o.signed_distance(xs))
        dx, point, normal = pick_deepest(found)
        if len(found) > 1 or mask is None:
            mask = dx < 0.0
        return alcg_mod.scene_hits(mask, normal, point, self.surf, self.dense,
                                   overflow=None if ovf is None else ovf != 0)

    def _uzawa(self, hits, b, x, y, n_prev, scale, diag, trips):
        """One Uzawa solve of every scene (solvers/uzawa.solve_scenes): the
        hits deduped, y kept per scene where its active set is the last
        solve's, the A^-1 apply G's scene form to uzawa_inner_tol from x
        first and from 0 after, a done scene skipping it; each scene's Schur
        trips added to trips. Returns (x, y, the active rows)."""
        max_iters, tol, inner_tol, inner_iters = self.uzawa

        def ainv(rhs, x0, done):
            return cuda_pcg.pcg_solve_scenes(self.pcg, rhs,
                                             torch.zeros_like(rhs) if x0 is None else x0,
                                             inner_tol, inner_iters, None, scale, diag=diag,
                                             done=done)

        if hits is None:  # no query vertex or obstacle: one inner solve (the JAX one trip)
            trips += 1
            return ainv(b, x, None), y, n_prev
        hits = hits.dedup()
        act = torch.cat([hits.p_mask, hits.d_mask], dim=1)
        y = torch.where(torch.all(act == n_prev, dim=1)[:, None], y, torch.zeros_like(y))
        x, y, k = uzawa_mod.solve_scenes(ainv, hits, self.ck, b, x, y, max_iters, tol,
                                         self.slot_of)
        trips += k
        return x, y, act

    def core(self, x0, v0, y, n_prev, scale, gravity, trips):
        """One step of every scene: (x, v, y, prev_active, overflow [S])."""
        system = self.system
        dt = system.dt
        trips.zero_()
        v = v0.clone()
        for f in self.forces:  # the batched or coloured wind, every scene at once (plain)
            v = f.project(dt, x0, v, system.masses)
        v[:, :, 1] += dt * gravity[:, None]
        x_bar = x0 + dt * v
        M_xbar = system.masses[None, :, None] * x_bar
        s_cnt = x0.shape[0]
        shapes = ([(9, b.n) for b in system.tets] + [(6, b.n) for b in system.tris]
                  + ([(system.pins.n, 3)] if system.pins is not None else []))
        z = [x0.new_zeros((s_cnt,) + sh) for sh in shapes]
        u = [torch.zeros_like(zi) for zi in z]
        sq = torch.sqrt(scale)
        diag = cuda_pcg.scaled_diag(self.pcg, scale) if x0.device.type == "cuda" else None
        ck = self.ck * scale ** 0.25 if self.ls == cfg.ALPCG else None
        overflow = torch.zeros((s_cnt,), dtype=torch.bool, device=x0.device)
        x = x_bar
        for _ in range(self.admm_iters):
            z, u = self._local(x, z, u, scale)
            hits = (self._detect(x) if self.ls != cfg.PCG and self.surf.shape[0]
                    and self.obstacles else None)
            b = self._rhs(M_xbar, z, u, sq)
            if self.ls == cfg.UZAWACG:
                x, y, n_prev = self._uzawa(hits, b, x, y, n_prev, scale, diag, trips)
                if hits is not None:
                    overflow = overflow | hits.overflow
                continue
            if self.ls == cfg.PCG or hits is None:
                x = cuda_pcg.pcg_solve_scenes(self.pcg, b, x, self.tol, self.max_iters, trips,
                                              scale, diag=diag)
                continue
            act = torch.cat([hits.p_mask, hits.d_mask], dim=1)
            y = torch.where(torch.all(act == n_prev, dim=1)[:, None], y, torch.zeros_like(y))
            x, y = alcg_mod.solve_scenes(self.pcg, hits, ck, b, x, y, self.tol, self.max_iters,
                                         trips, scale, diag=diag)
            n_prev = act
            overflow = overflow | hits.overflow
        return x, (x - x0) * (1.0 / dt), y, n_prev, overflow

    # -- calls -------------------------------------------------------------------

    def _check(self, batch: ScenarioBatch) -> None:
        if batch.x.device != self.device or batch.x.dtype != self.dtype:
            raise ValueError(f"make_batched_step: batch on {batch.x.device}/{batch.x.dtype}, "
                             f"step built for {self.device}/{self.dtype}")
        if tuple(batch.x.shape[1:]) != (self.system.n_verts, 3):
            raise ValueError(f"make_batched_step: batch x of {tuple(batch.x.shape)} for "
                             f"{self.system.n_verts} vertices")

    def eager(self, batch: ScenarioBatch) -> ScenarioBatch:
        """The step as eager PyTorch (the CPU's path; on the card what the
        graph is held to)."""
        self._check(batch)
        s_cnt = batch.n_scenes
        if self.trips is None or self.trips.shape[0] != s_cnt:
            self.trips = torch.zeros((s_cnt,), dtype=torch.int32, device=self.device)
        x, v, y, na, ovf = self.core(batch.x, batch.v, batch.y, batch.prev_active,
                                     batch.stiffness_scale, batch.gravity, self.trips)
        return dataclasses.replace(batch, x=x, v=v, y=y, prev_active=na,
                                   overflow=batch.overflow | ovf)

    def _capture(self, batch: ScenarioBatch) -> tuple:
        """The graph of one step for batches of this size: static copies of
        the batch's fields and trips, a warm-up step on a side stream first."""
        dev = self.device
        static = {f: getattr(batch, f).clone() for f in FIELDS}
        trips = torch.zeros((batch.n_scenes,), dtype=torch.int32, device=dev)

        def run():
            x, v, y, na, ovf = self.core(static["x"], static["v"], static["y"],
                                         static["prev_active"], static["stiffness_scale"],
                                         static["gravity"], trips)
            for f, t in (("x", x), ("v", v), ("y", y), ("prev_active", na)):
                static[f].copy_(t)
            static["overflow"].logical_or_(ovf)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.core(static["x"], static["v"], static["y"], static["prev_active"],
                      static["stiffness_scale"], static["gravity"], trips)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                run()
        except Exception as e:
            raise RuntimeError("make_batched_step: capturing the batched step as a CUDA graph "
                               "failed") from e
        return graph, static, trips

    def __call__(self, batch: ScenarioBatch) -> ScenarioBatch:
        if self.device.type == "cpu":
            return self.eager(batch)
        self._check(batch)
        s_cnt = batch.n_scenes
        if s_cnt not in self._graphs:
            self._graphs[s_cnt] = self._capture(batch)
        graph, static, trips = self._graphs[s_cnt]
        for f in FIELDS:
            static[f].copy_(getattr(batch, f))
        graph.replay()
        self.trips = trips
        if self.donate:  # the step writes into the donated batch
            for f in FIELDS:
                getattr(batch, f).copy_(static[f])
            return dataclasses.replace(batch)
        return ScenarioBatch(**{f: static[f].clone() for f in FIELDS})


def make_batched_step(solver, mesh: Optional[SimMesh] = None, donate: bool = True,
                      linsolver: Optional[int] = None,
                      uses_sweep: bool = True) -> BatchedStep:
    """Build the batched step over a ScenarioBatch of the solver's scene.

    Runs the solver's configured global mode (or an explicit ``linsolver``
    override) on the PCG operator: PCG (ls=3), AL-PCG hard contact (ls=4) or
    Uzawa with the sparse inner (ls=2, whatever ``uzawa_inner`` says, as the
    JAX package's batch), with any of Floor, Sphere, PassiveMeshSDF and
    PassiveMeshExact. The dense and GS modes (ls=0/1) have no
    per-scene-scalable operator and raise ValueError; colliders, the
    sequential wind, two-grid with ``uses_sweep=False`` and a mesh of several
    devices raise NotImplementedError (item 12b).
    A swept batch takes the Jacobi preconditioner, whose diagonal follows
    each scene's scale (a two-grid coarse inverse is built for one operator):
    with ``uses_sweep`` and a two-grid solver it warns and switches.
    ``donate``: the step may write the result into the batch it is given.
    ``mesh``: None, or a mesh of the solver's one device.
    """
    ls = solver.m_settings.linsolver if linsolver is None else linsolver
    if ls not in (cfg.PCG, cfg.ALPCG, cfg.UZAWACG):
        raise ValueError(
            f"make_batched_step supports linsolver 3 (PCG), 4 (AL-PCG) and "
            f"2 (Uzawa, sparse inner); got {ls}. Re-initialize with one of "
            f"those or pass linsolver= explicitly.")
    if mesh is not None and (mesh.devices.size != 1
                             or torch.device(mesh.devices.flat[0]) != solver.device):
        raise _deferred(f"a mesh of {mesh.devices.size} devices {dict(mesh.shape)}")
    if solver.colliders:
        raise _deferred("self-collision (kernels K and L per scene)")
    if any(getattr(f, "sequential", False) for f in solver.ext_forces):
        raise _deferred("the sequential wind (kernel I per scene)")
    precond = solver.m_settings.pcg_precond
    if uses_sweep and precond != "jacobi":
        warnings.warn(
            "make_batched_step uses the Jacobi preconditioner for swept "
            "scenes (the two-grid coarse inverse cannot follow a per-scene "
            "stiffness rescale); pass uses_sweep=False if every scene's "
            "stiffness_scale is 1.0.", stacklevel=2)
        precond = "jacobi"
    if precond != "jacobi":
        raise _deferred("the two-grid preconditioner (uses_sweep=False)")
    system = _debloat_for_throughput(solver, solver.system)
    pcg = pcg_mod.prepare(system, solver._dtype, precond=precond)
    if solver.device.type == "cuda":
        cuda_pcg.plan_of(pcg)  # the kernel's tables, before any capture
    return BatchedStep(solver, system, pcg, ls, donate)
