"""Wrapper of kernel H (``csrc/gs.cu``): the whole nodal-constrained
Gauss-Seidel solve in one launch, in place of the JAX package's jnp loop
(``admm_elastic_tpu/solvers/gs.py:147-196``; ``gs_solve_dyn`` with dynamic
rows), which has no Pallas kernel.

``gs_solve(data, b, x0, pin_mask, pin_target, obstacles, omega, max_iters,
tol, sweeps, params=None, form=None, group=None)`` runs the SOR sweeps of
``data`` (a ``solvers.gs.GSData``) from x0 with the dense pin arrays and the
obstacles (``Floor``, ``Sphere``, ``PassiveMeshSDF``, ``PassiveMeshExact``;
at most 8) until the residual test holds or max_iters sweeps, and adds the
sweeps to ``sweeps`` (an int32 tensor of one element on the
device). Dispatch is by the tensors' device: CPU tensors take the plain
version (``solvers/gs.solve``, which stops on the host); CUDA tensors launch
the kernel, and a build or launch failure raises. ``gs_solve.launches``
counts kernel launches.

The kernel has two forms (``csrc/gs.cu``): SHARED, x in the block's shared
memory for the whole solve, where it fits; GLOBAL, x in global memory, for
any N. ``h_form`` chooses by N, the dtype and the card's shared memory; a
caller may ask for one (``form=``), and SHARED where x does not fit raises.
Either runs a block of 512 threads, or of 1,024 where a colour is wider
than 512 rows (``h_wide``).

The analytic obstacles reach the kernel by value, as ``params`` =
``obstacle_params(obstacles)``, which reads them to the host (a
synchronisation, which a capture refuses): a captured step passes the
parameters that the solver read at ``initialize``; where ``params`` is None
the wrapper reads them itself. A mesh obstacle reaches it by the addresses of
its tables (``cuda_obstacle.mesh_desc``, no synchronisation), which the
obstacle keeps alive; a solve with one takes a scratch of 20 values and three
ints per colour slot. The exact walk takes a group of threads per evaluated
slot (``cuda_obstacle.j_group`` over the block's threads); ``group`` forces
one, for tests and measurements, and changes no bit of x.

``gs_solve_dyn(..., hits, ck, slot_of, ...)`` is the solve with the
self-collision rows folded in as a penalty (the JAX package's
``may_have_dyn``): hits carry the dynamic rows and their table
(``constraints.with_table``; no passive row: the obstacles are the sweeps'
own), slot_of each vertex's row (None where the query set is every vertex).
The wrapper forms b + C^T c and the penalty diagonal where(n_active > 0,
diag(C^T C), 0) as the plain version does (kernel L), and launches H's DYN
form, which takes the analytic obstacles and raises with a mesh obstacle. On
the CPU the plain ``solvers/gs.solve`` with ``may_have_dyn``. Its own
``launches`` counts it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.collision.passive import MESH, Floor, PassiveMeshSDF, Sphere
from admm_elastic_tpu_torch.ops import _build, cuda_dynamic, cuda_obstacle
from admm_elastic_tpu_torch.solvers import gs as gs_mod

MAX_OBSTACLES = 8  # csrc/gs.cu kMaxObstacles
FLOOR, SPHERE = 0, 1  # csrc/gs.cu enum Kind
FORMS = ("global", "shared")
# the kernel's static shared memory, at most (csrc/gs.cu: lane_sum's 17 values,
# block_rank's 32 ints)
STATIC_SMEM = 17 * 8 + 32 * 4
SLOT_SCRATCH = 20  # csrc/gs.cu kSlot
SLOT_INTS = 3  # csrc/gs.cu iscratch: flags, the fallback's slots, the evaluated slots
GROUPS = (1, 2, 4, 8, 16, 32)  # the exact walk's threads a slot (csrc/gs.cu Args.group)
LANES = 512  # csrc/gs.cu kLanes: a colour wider than this takes the WIDE block


def h_wide(width: int) -> bool:
    """Whether kernel H runs its WIDE block (1,024 threads, the ELL read per
    colour slot) for colours of at most width rows: where a colour is wider
    than the 512-thread block (PERF.md: 576.8 against 885.0 us on floor_gs5k's
    558-row colours, 229.1 against 214.4 on sphere_gs's 20)."""
    return width > LANES


def h_form(n: int, itemsize: int, smem_optin: int, want=None) -> str:
    """The form kernel H takes for n vertices: "shared" where x ([n, 3] of
    itemsize bytes) fits smem_optin bytes of shared memory beside the
    kernel's own, else "global". want asks for one; "shared" where x does
    not fit raises ValueError."""
    if want not in (None,) + FORMS:
        raise ValueError(f"gs_solve: form {want!r}, expected one of {FORMS}")
    fits = n * 3 * itemsize + STATIC_SMEM <= smem_optin
    if want == "shared" and not fits:
        raise ValueError(f"gs_solve: x of {n} vertices in {itemsize}-byte values does not fit "
                         f"{smem_optin} bytes of shared memory")
    return want or ("shared" if fits else "global")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The ELL of a GSData in the two layouts kernel H's WIDE block reads: per
    colour and column-major (the passes: a warp's loads of one entry
    coalesce), and column-major in the vertex order (the residual). The
    512-thread block reads the ELL by row and takes no plan."""

    ccols: torch.Tensor  # i32 [C, K, L]: entry k of colour c's slot i (pad: column 0, value 0)
    cvals: torch.Tensor  # [C, K, L]
    tcols: torch.Tensor  # i32 [K, N]
    tvals: torch.Tensor  # [K, N]


def build_plan(data: gs_mod.GSData) -> KernelPlan:
    """The kernel's layouts of data's ELL (the same values, moved)."""
    n = data.ell_cols.shape[0]
    rows = data.colors.long().clamp(max=max(n - 1, 0))  # pad slots read row N-1, never used
    return KernelPlan(ccols=data.ell_cols[rows].permute(0, 2, 1).contiguous(),
                      cvals=data.ell_vals[rows].permute(0, 2, 1).contiguous(),
                      tcols=data.ell_cols.T.contiguous(), tvals=data.ell_vals.T.contiguous())


_PLANS: dict = {}  # id(GSData) -> (weakref to it, KernelPlan)


def plan_of(data: gs_mod.GSData) -> KernelPlan:
    """build_plan of data, built on first use and kept while data lives.
    Build it before a capture: it moves tensors on the device."""
    hit = _PLANS.get(id(data))
    if hit is not None and hit[0]() is data:
        return hit[1]
    for key in [k for k, (ref, _) in _PLANS.items() if ref() is None]:
        del _PLANS[key]
    plan = build_plan(data)
    _PLANS[id(data)] = (weakref.ref(data), plan)
    return plan


_OPTIN: list = []  # the card's shared memory a block may take, read once


def form_of(n: int, dtype: torch.dtype, want=None) -> str:
    """h_form on the current card."""
    if not _OPTIN:
        _OPTIN.append(int(_build.library().admm_smem_optin()))
    return h_form(n, torch.empty((), dtype=dtype).element_size(), _OPTIN[0], want)


def obstacle_params(obstacles):
    """(kinds, params) of the obstacles as kernel H takes them: Floor (y),
    Sphere (centre, radius), a mesh obstacle (its kind and capture_cells; its
    tables go by address)."""
    if len(obstacles) > MAX_OBSTACLES:
        raise ValueError(f"gs_solve: at most {MAX_OBSTACLES} obstacles, got {len(obstacles)}")
    kinds, par = [], []
    for o in obstacles:
        if isinstance(o, Floor):
            kinds.append(FLOOR)
            par += [float(o.y), 0.0, 0.0, 0.0]
        elif isinstance(o, Sphere):
            kinds.append(SPHERE)
            par += [float(c) for c in o.center.reshape(3).tolist()] + [float(o.rad)]
        elif isinstance(o, MESH):
            kinds.append(cuda_obstacle.MESH_SDF if isinstance(o, PassiveMeshSDF)
                         else cuda_obstacle.MESH_EXACT)
            par += [float(getattr(o, "capture_cells", 0.0)), 0.0, 0.0, 0.0]
        else:
            raise TypeError(f"kernel H takes Floor, Sphere, PassiveMeshSDF and "
                            f"PassiveMeshExact, not {type(o).__name__}")
    return tuple(kinds), (ctypes.c_double * max(len(par), 1))(*par)


def gs_solve(data: gs_mod.GSData, b: torch.Tensor, x0: torch.Tensor, pin_mask: torch.Tensor,
             pin_target: torch.Tensor, obstacles, omega: float, max_iters: int, tol: float,
             sweeps: torch.Tensor, params=None, form=None, group=None) -> torch.Tensor:
    """x after the constrained SOR sweeps from x0; the sweeps are added to
    sweeps. params: obstacle_params(obstacles), read here where None. form:
    the kernel's form ("global", "shared"; None: h_form's choice); group: the
    exact walk's threads a slot (None: the rule's, per pass)."""
    if b.device.type == "cpu":
        x, k = gs_mod.solve(data.ell_cols, data.ell_vals, data.diag, data.colors,
                            data.colors_mask, b, x0, pin_mask, pin_target, obstacles, None, None,
                            omega, max_iters, tol, may_have_dyn=False)
        sweeps += k
        return x
    out = _launch(data, b, x0, pin_mask, pin_target, obstacles, omega, max_iters, tol, sweeps,
                  params, form=form, group=group)
    gs_solve.launches += 1
    return out


def gs_solve_dyn(data: gs_mod.GSData, b: torch.Tensor, x0: torch.Tensor, pin_mask: torch.Tensor,
                 pin_target: torch.Tensor, obstacles, omega: float, max_iters: int, tol: float,
                 sweeps: torch.Tensor, hits: con.Hits, ck: torch.Tensor, slot_of, params=None,
                 form=None) -> torch.Tensor:
    """gs_solve with the dynamic rows of hits (their table built) folded in
    as a penalty; slot_of: i32 [N] each vertex's row, or None (dense)."""
    if b.device.type == "cpu":
        x, k = gs_mod.solve(data.ell_cols, data.ell_vals, data.diag, data.colors,
                            data.colors_mask, b, x0, pin_mask, pin_target, obstacles, hits, ck,
                            omega, max_iters, tol, may_have_dyn=True)
        sweeps += k
        return x
    if any(isinstance(o, MESH) for o in obstacles):
        raise NotImplementedError("gs_solve_dyn: kernel H's DYN form takes Floor and Sphere "
                                  "obstacles; a mesh obstacle with self-collision under "
                                  "Gauss-Seidel is not ported (ROADMAP Queue 2)")
    n = b.shape[0]
    if hits.d_order is None:
        hits = con.with_table(hits, n)
    pen = torch.where(hits.n_active() > 0, con.CtC_diag(hits, ck, n, b.dtype),
                      torch.zeros((n, 3), dtype=b.dtype, device=b.device))
    b_eff = b + con.Ct_c(hits, ck, n)
    out = _launch(data, b_eff, x0, pin_mask, pin_target, obstacles, omega, max_iters, tol, sweeps,
                  params, form=form, dyn=(hits, ck, slot_of, pen))
    gs_solve_dyn.launches += 1
    return out


def _launch(data, b, x0, pin_mask, pin_target, obstacles, omega, max_iters, tol, sweeps, params,
            lib=None, form=None, group=None, dyn=None):
    """Launch kernel H from ``lib`` (the port's library, or an anatomy build
    of the same source: chip_smoke.floor_library, tools/g_h_anatomy.py) in
    ``form`` (None: form_of's choice), in the block h_wide chooses; dyn:
    (hits, ck, slot_of, pen) for the DYN form."""
    n, k = data.ell_cols.shape
    sfx = _build.cuda_args("gs_solve", b, (
        ("b", b, (n, 3)), ("x0", x0, (n, 3)), ("diag", data.diag, (n,)),
        ("ell_vals", data.ell_vals, (n, k)), ("pin_target", pin_target, (n, 3))))
    for name, t, dtype, shape in (("ell_cols", data.ell_cols, torch.int32, (n, k)),
                                  ("colors", data.colors, torch.int32, data.colors.shape),
                                  ("pin_mask", pin_mask, torch.bool, (n,)),
                                  ("sweeps", sweeps, torch.int32, (1,))):
        if (t.device != b.device or t.dtype != dtype or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous()):
            raise ValueError(f"gs_solve: {name} must be a contiguous {dtype} tensor of shape "
                             f"{tuple(shape)} on {b.device}")
    kinds, par = obstacle_params(obstacles) if params is None else params
    n_colors, width = data.colors.shape
    wide = h_wide(width)
    plan = plan_of(data) if wide else None  # the 512-thread block reads the ELL by row
    out = torch.empty_like(b)
    mesh_ints, mesh_ptrs, scratch = [], [], [None, None]
    for o in list(obstacles) + [None] * (MAX_OBSTACLES - len(obstacles)):
        if isinstance(o, MESH):
            i, p, _ = cuda_obstacle.mesh_desc(o, b.device, b.dtype)
        else:
            i, p = [0] * cuda_obstacle.MESH_INTS, [None] * cuda_obstacle.MESH_PTRS
        mesh_ints += i
        mesh_ptrs += p
    if any(isinstance(o, MESH) for o in obstacles):
        scratch = [torch.empty((width, SLOT_SCRATCH), dtype=b.dtype, device=b.device),
                   torch.empty((SLOT_INTS * width,), dtype=torch.int32, device=b.device)]
    dyn_ptrs, h = [None] * 11, 0
    if dyn is not None:
        hits, ck, slot_of, pen = dyn
        h = int(hits.d_mask.shape[0])
        _build.cuda_args("gs_solve_dyn", b, (("pen", pen, (n, 3)),))
        dyn_ptrs = cuda_dynamic.rows_ptrs("gs_solve_dyn", hits, ck, slot_of, b) + [
            pen, torch.empty((max(h, 1),), dtype=b.dtype, device=b.device)]
    ptrs = [data.ell_cols, data.ell_vals] + (
        [plan.ccols, plan.cvals, plan.tcols, plan.tvals] if wide else [None] * 4) + [
        data.diag, data.colors, b, x0, out, pin_mask, pin_target, sweeps] + scratch + mesh_ptrs + (
        dyn_ptrs)
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(*cuda_obstacle.addresses(ptrs))
    shared = form_of(n, b.dtype, form) == "shared"
    if group not in (None,) + GROUPS:
        raise ValueError(f"gs_solve: group {group!r}, expected one of {GROUPS}")
    bits = int(shared) | 2 * int(wide) | (group or 0) << 2
    head = [n, k, n_colors, width, int(max_iters), bits, len(kinds),
            *kinds] + [0] * (MAX_OBSTACLES - len(kinds))
    ints = (ctypes.c_int * (len(head) + len(mesh_ints) + 1))(*head, *mesh_ints, h)
    fn = getattr(lib or _build.library(), f"admm_gs_solve_{sfx}")
    with torch.cuda.device(b.device):
        rc = fn(ptr_arr, ints, par, float(omega), float(tol),
                torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(rc, "gs_solve")
    return out


gs_solve.launches = 0
gs_solve_dyn.launches = 0
