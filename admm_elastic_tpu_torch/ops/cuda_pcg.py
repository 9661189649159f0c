"""Wrapper of kernel G (``csrc/pcg.cu``): the whole PCG global solve in one
launch, in place of the JAX package's jnp ``solve_T`` loop
(``admm_elastic_tpu/solvers/pcg.py:304-348``), which has no Pallas kernel.

``pcg_solve(data, b, x0, tol, max_iters, trips)`` solves A x = b from the
warm start x0 ([N, 3] each) with the operator and preconditioner of ``data``
(a ``solvers.pcg.PCGData``) and adds the trips it took to ``trips`` (an int32
tensor of one element, on the device; None counts nothing). With ``done`` (a bool tensor of one
element) it takes no trip and returns x0 where the flag is set: Uzawa's
predicated Schur trips. ``pcg_solve_penalty(data, b, x0, tol, max_iters,
trips, pn, pen_diag)`` is G's penalty form (pn and pen_diag [N, 3], vertex
order): (A + pn pn^T) x = b with the per-component Jacobi inverse
1 / (diag + pen_diag), AL-PCG's solve (``solvers/alcg.py``), in place of the
JAX package's jnp loop there (``alcg.py:73-127``). ``pcg_solve_dyn(...,
pn, pen_diag, hits, ck, slot_of)`` is its DYN form, with the self-collision
rows of hits (their table built, ``constraints.with_table``) added to each
apply, A + pn pn^T + C_d^T C_d, pen_diag their diagonal too (Jacobi only: a
two-grid PCGData raises). Dispatch is by the
tensors' device: CPU tensors take the plain version (``solvers/pcg.solve_T``,
or ``solvers/alcg.penalty_solve`` or ``penalty_solve_dyn``, which stop on the
host); CUDA tensors
launch the kernel, and a build or launch failure raises. Each wrapper's
``launches`` counts its kernel launches.

The kernel has two forms (``csrc/pcg.cu``): CLUSTER, one thread-block
cluster of at most 16 blocks of 512 threads with the solve's vectors in the
blocks' shared memory, chosen where at most 11 blocks cover the problem and
its rows have no rest-ELL; GRID, a cooperative grid of persistent blocks with
the vectors in global memory, for any N. ``g_form`` chooses, by N, the dtype
and the card's cluster and shared-memory budget; a caller may ask for one
(``form=``), and a form that cannot take the shape raises.

The kernel works in the banded vertex order: where ``data`` carries an RCM
permutation, ``plan_of`` keeps the diagonal, its inverse and the two-grid
tables in that order (built once per ``PCGData`` on the device, before any
capture), and the kernel reads b and x0 and writes x through the
permutation. The same plan holds the kernel's scratch and its grid barrier,
so solves that share a ``PCGData`` run one after the other on one stream,
as a solver's steps do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Optional

import torch

from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.solvers import pcg as pcg_mod

OMEGA = 0.7  # the two-grid smoother's damping (PCGData.precondition)
BLOCK = 256  # vertices per chunk of csrc/pcg.cu (kGroup)
SLOTS = 4  # partial-sum slots of csrc/pcg.cu (kSlots)
MAX_BANDS = 64  # csrc/pcg.cu kMaxBands
CLUSTER_VECS = 8  # the vectors a CLUSTER block keeps (csrc/pcg.cu enum Vec)
CLUSTER_SHIFTS = (8, 9)  # blocks of 256 or 512 threads, one vertex a thread
CLUSTER_MAX = 16  # the largest cluster the card may take (non-portable size)
CLUSTER_CHOSEN = 11  # the most blocks with which g_form chooses the CLUSTER form
CLUSTER_STATIC_SMEM = (16 + 8) * 3 * 8  # the kernel's static shared memory, at most
FORMS = ("grid", "cluster")


def cluster_smem(shift: int, itemsize: int) -> int:
    """The dynamic shared memory of a CLUSTER block of 2^shift threads:
    each vector's span and the span's partial sums (csrc/pcg.cu
    cluster_smem)."""
    return ((CLUSTER_VECS << shift) * 3 + SLOTS * (1 << (shift - 8))) * itemsize


def _cluster_fit(n: int, itemsize: int, max_blocks: int, smem_optin: int) -> Optional[tuple]:
    """("cluster", blocks, shift): the smallest blocks (2^shift threads) with
    which one cluster of at most max_blocks blocks covers n and a block's
    vectors fit smem_optin bytes of shared memory; None where none does."""
    chunks = -(-n // BLOCK)
    for shift in CLUSTER_SHIFTS:
        blocks = -(-chunks // (1 << (shift - 8)))
        if (blocks <= max_blocks
                and cluster_smem(shift, itemsize) + CLUSTER_STATIC_SMEM <= smem_optin):
            return ("cluster", blocks, shift)
    return None


def g_form(n: int, itemsize: int, n_bands: int, k_rest: int, max_cluster: int, smem_optin: int,
           want: Optional[str] = None) -> tuple:
    """The form kernel G takes for n vertices with n_bands bands and a
    rest-ELL of k_rest columns: ("cluster", blocks, shift) (_cluster_fit)
    where one cluster of at most CLUSTER_CHOSEN blocks (and at most
    max_cluster) covers n and the rows have no rest-ELL, else ("grid", 0, 0).
    The CLUSTER form won where it was measured at 1, 2 and 11 blocks and lost
    at 16, and on the bunny's rest-ELL, whose random columns read across the
    cluster (PERF.md). want ("grid" or "cluster") asks for one: the CLUSTER
    form takes up to min(max_cluster, CLUSTER_MAX) blocks. A form that cannot
    take the shape, and more than MAX_BANDS bands in any form, raise
    ValueError."""
    if n_bands > MAX_BANDS:
        raise ValueError(f"pcg_solve: {n_bands} bands, kernel G takes at most {MAX_BANDS}")
    if want not in (None,) + FORMS:
        raise ValueError(f"pcg_solve: form {want!r}, expected one of {FORMS}")
    if want == "grid":
        return ("grid", 0, 0)
    if want == "cluster":
        fit = _cluster_fit(n, itemsize, min(max_cluster, CLUSTER_MAX), smem_optin)
        if fit is None:
            raise ValueError(f"pcg_solve: {n} vertices in {itemsize}-byte values fit no cluster "
                             f"of at most {max_cluster} blocks in {smem_optin} bytes of shared "
                             "memory")
        return fit
    fit = None if k_rest > 0 else _cluster_fit(n, itemsize, min(max_cluster, CLUSTER_CHOSEN),
                                                  smem_optin)
    return fit or ("grid", 0, 0)


_BUDGET: dict = {}  # itemsize -> (max_cluster, smem_optin) of the current card


def card_budget(itemsize: int) -> tuple:
    """(the largest cluster of the CLUSTER form's largest blocks, with their
    shared memory, that the card can hold; the shared memory a block may
    take), read once."""
    if itemsize not in _BUDGET:
        lib = _build.library()
        optin = int(lib.admm_smem_optin())
        smem = cluster_smem(CLUSTER_SHIFTS[-1], itemsize)
        threads = 1 << CLUSTER_SHIFTS[-1]
        size = next((c for c in (16, 8, 4, 2)
                     if lib.admm_cluster_capacity(c, threads, smem) >= 1), 1)
        _BUDGET[itemsize] = (size, optin)
    return _BUDGET[itemsize]


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """What kernel G reads besides b and x0, in the banded vertex order, and
    its scratch."""

    diag: torch.Tensor  # [N]
    inv_d: torch.Tensor  # [N] 1 / diag, as the plain Jacobi computes it
    bands: Optional[torch.Tensor]  # [D, N]
    rest_cols: torch.Tensor  # i32 [K, N]: the rest-ELL column-major (a warp's reads coalesce)
    rest_vals: torch.Tensor  # [K, N]
    perm: Optional[torch.Tensor]  # i64 [N]
    agg: Optional[torch.Tensor]  # i32 [N]
    agg_gather: Optional[torch.Tensor]  # i32 [C, Kc], banded-order vertices, pad N
    coarse_inv: Optional[torch.Tensor]  # [C, C]
    scratch: tuple  # X, R, P, Z, AP, Z2, RES, P2 [N, 3]; RC, EC [C, 3]; parts [SLOTS, chunks]
    barrier: torch.Tensor  # i32 [64]: the grid barrier (csrc/pcg.cu struct Barrier)
    offs: object  # ctypes int array of the band offsets
    ints: tuple  # n, k_rest, n_bands, circular, k_agg, n_coarse


_PLANS: dict = {}  # id(PCGData) -> (weakref to it, KernelPlan)


def _build_plan(data: pcg_mod.PCGData) -> KernelPlan:
    n = data.n
    dev, dtype = data.diag_mass.device, data.diag_mass.dtype
    diag = data.diag()
    inv_d = 1.0 / diag
    perm = data.perm
    agg, agg_gather = data.agg, data.agg_gather
    if perm is not None:
        diag, inv_d = diag[perm], inv_d[perm]
        if agg is not None:
            agg = agg[perm]
            ext = torch.cat([data.iperm, torch.full((1,), n, dtype=torch.int64, device=dev)])
            agg_gather = ext[agg_gather.long()].to(torch.int32)
    n_coarse = 0 if data.coarse_inv is None else data.coarse_inv.shape[0]

    def vec(rows):
        return torch.zeros((max(rows, 1), 3), dtype=dtype, device=dev)

    chunks = -(-n // BLOCK)
    scratch = tuple(vec(n) for _ in range(8)) + (vec(n_coarse), vec(n_coarse),
                                                  torch.zeros((SLOTS, max(chunks, 1)),
                                                              dtype=dtype, device=dev))
    offs = data.band_offsets
    return KernelPlan(
        diag=diag.contiguous(), inv_d=inv_d.contiguous(),
        bands=None if data.bands is None else data.bands.contiguous(),
        rest_cols=data.ell_cols.to(torch.int32).T.contiguous(),
        rest_vals=data.ell_vals.T.contiguous(),
        perm=None if perm is None else perm.to(torch.int64).contiguous(),
        agg=None if agg is None else agg.to(torch.int32).contiguous(),
        agg_gather=None if agg_gather is None else agg_gather.to(torch.int32).contiguous(),
        coarse_inv=None if data.coarse_inv is None else data.coarse_inv.contiguous(),
        scratch=scratch,
        barrier=torch.zeros((64,), dtype=torch.int32, device=dev),
        offs=(ctypes.c_int * max(len(offs), 1))(*offs),
        ints=(n, data.ell_cols.shape[1], len(offs), int(data.band_circular),
              0 if agg_gather is None else agg_gather.shape[1], n_coarse),
    )


def plan_of(data: pcg_mod.PCGData) -> KernelPlan:
    """The kernel's plan of ``data``, built on first use and kept while
    ``data`` lives. Build it before a capture: it copies to the device."""
    hit = _PLANS.get(id(data))
    if hit is not None and hit[0]() is data:
        return hit[1]
    for key in [k for k, (ref, _) in _PLANS.items() if ref() is None]:
        del _PLANS[key]
    plan = _build_plan(data)
    _PLANS[id(data)] = (weakref.ref(data), plan)
    return plan


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def pcg_solve(data: pcg_mod.PCGData, b: torch.Tensor, x0: torch.Tensor, tol: float,
              max_iters: int, trips: Optional[torch.Tensor],
              done: Optional[torch.Tensor] = None, form: Optional[str] = None) -> torch.Tensor:
    """x with A x = b to the relative tolerance tol (clamped to 64 eps), from
    x0, in at most max_iters trips; the trips taken are added to trips
    (unless None). Where done is set, x0 and no trip. form: the kernel's
    form ("grid", "cluster"; None: g_form's choice)."""
    if b.device.type == "cpu":
        if done is not None and bool(done):
            return x0.clone()
        x, k = pcg_mod.solve_T(data.apply_T, data.precondition_T(), b, x0, tol, max_iters)
        if trips is not None:
            trips += k
        return x
    out = _launch(data, b, x0, tol, max_iters, trips, None, done, form=form)
    pcg_solve.launches += 1
    return out


def pcg_solve_penalty(data: pcg_mod.PCGData, b: torch.Tensor, x0: torch.Tensor, tol: float,
                      max_iters: int, trips: torch.Tensor, pn: torch.Tensor,
                      pen_diag: torch.Tensor, form: Optional[str] = None) -> torch.Tensor:
    """pcg_solve on A + pn pn^T with the Jacobi (or smoothing) diagonal
    diag + pen_diag per component."""
    if b.device.type == "cpu":
        from admm_elastic_tpu_torch.solvers.alcg import penalty_solve

        x, k = penalty_solve(data, pn, pen_diag, b, x0, tol, max_iters)
        trips += k
        return x
    out = _launch(data, b, x0, tol, max_iters, trips, (pn, pen_diag), None, form=form)
    pcg_solve_penalty.launches += 1
    return out


def pcg_solve_dyn(data: pcg_mod.PCGData, b: torch.Tensor, x0: torch.Tensor, tol: float,
                  max_iters: int, trips: torch.Tensor, pn: torch.Tensor, pen_diag: torch.Tensor,
                  hits, ck: torch.Tensor, slot_of: Optional[torch.Tensor],
                  form: Optional[str] = None) -> torch.Tensor:
    """pcg_solve_penalty with the dynamic rows of hits added to A (slot_of:
    i32 [N] each vertex's row, None where the query set is every vertex)."""
    from admm_elastic_tpu_torch.collision import constraints as con

    if b.device.type == "cpu":
        from admm_elastic_tpu_torch.solvers.alcg import penalty_solve_dyn

        x, k = penalty_solve_dyn(data, pn, pen_diag, hits, ck, b, x0, tol, max_iters)
        trips += k
        return x
    if data.agg is not None:
        raise NotImplementedError("pcg_solve_dyn: kernel G's DYN form takes the Jacobi "
                                  "preconditioner; two-grid with self-collision rows is not "
                                  "ported to the card (ROADMAP Queue 2)")
    if hits.d_order is None:
        hits = con.with_table(hits, data.n)
    out = _launch(data, b, x0, tol, max_iters, trips, (pn, pen_diag), None, form=form,
                  dyn=(hits, ck, slot_of))
    pcg_solve_dyn.launches += 1
    return out


def form_of(data: pcg_mod.PCGData, dtype: torch.dtype, form: Optional[str] = None) -> tuple:
    """g_form for data's system in dtype on the current card."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return g_form(data.n, itemsize, len(data.band_offsets), data.ell_cols.shape[1],
                  *card_budget(itemsize), want=form)


def _launch(data, b, x0, tol, max_iters, trips, penalty, done, lib=None, grid=0, form=None,
            dyn=None):
    """Launch kernel G from ``lib`` (the port's library, or a variant of
    tools/g_h_anatomy.py's) in ``form`` (None: form_of's choice); the GRID
    form on at most ``grid`` blocks (0: as many as can be resident); dyn:
    (hits, ck, slot_of) for the DYN form (with penalty)."""
    n = data.n
    fields = [("b", b, (n, 3)), ("x0", x0, (n, 3)), ("diag_mass", data.diag_mass, (n,))]
    if penalty is not None:
        fields += [("pn", penalty[0], (n, 3)), ("pen_diag", penalty[1], (n, 3))]
    sfx = _build.cuda_args("pcg_solve", b, fields)
    if trips is not None and (trips.device != b.device or trips.dtype != torch.int32
                              or trips.numel() != 1):
        raise ValueError("pcg_solve: trips must be one int32 element on b's device")
    if done is not None and (done.device != b.device or done.dtype != torch.bool
                             or done.numel() != 1):
        raise ValueError("pcg_solve: done must be one bool element on b's device")
    plan = plan_of(data)
    pn = inv3 = None
    if penalty is not None:
        pn, pen_diag = penalty
        if plan.perm is not None:
            pn, pen_diag = pn[plan.perm], pen_diag[plan.perm]
        # as the plain Jacobi forms it: 1 / (diag + diag(C^T C)) per component
        inv3 = (1.0 / (plan.diag[:, None] + pen_diag)).contiguous()
        pn = pn.contiguous()
    dyn_ptrs, h = [None] * 11, 0
    if dyn is not None:
        from admm_elastic_tpu_torch.ops import cuda_dynamic

        hits, ck, slot_of = dyn
        h = int(hits.d_mask.shape[0])
        iperm = None if plan.perm is None else data.iperm.to(torch.int64).contiguous()
        dyn_ptrs = cuda_dynamic.rows_ptrs("pcg_solve_dyn", hits, ck, slot_of, b) + [
            iperm, torch.empty((max(h, 1),), dtype=b.dtype, device=b.device)]
    out = torch.empty_like(b)
    ptrs = ([b, x0, out, plan.perm, plan.diag, plan.inv_d, plan.bands, plan.rest_cols,
             plan.rest_vals, plan.agg, plan.agg_gather, plan.coarse_inv] + list(plan.scratch)
            + [plan.barrier, trips, pn, inv3, done] + dyn_ptrs)
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(*[_ptr(t) for t in ptrs])
    kind, blocks, shift = form_of(data, b.dtype, form)
    ints = (ctypes.c_int * 12)(*plan.ints, int(max_iters), int(grid), FORMS.index(kind), blocks,
                               shift, h)
    fn = getattr(lib or _build.library(), f"admm_pcg_solve_{sfx}")
    with torch.cuda.device(b.device):
        rc = fn(ptr_arr, ints, plan.offs, float(tol), OMEGA,
                torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(rc, "pcg_solve" if penalty is None else
                 "pcg_solve_penalty" if dyn is None else "pcg_solve_dyn")
    return out


def grid_of(n: int, dtype: torch.dtype) -> int:
    """The number of blocks kernel G's GRID form runs for n vertices on the
    current card."""
    sfx = "f32" if dtype == torch.float32 else "f64"
    return int(getattr(_build.library(), f"admm_pcg_grid_{sfx}")(int(n)))


def blocks_of(data: pcg_mod.PCGData, dtype: torch.dtype, form: Optional[str] = None) -> tuple:
    """(form, blocks, threads a block) of kernel G on data's system."""
    kind, blocks, shift = form_of(data, dtype, form)
    if kind == "grid":
        return kind, grid_of(data.n, dtype), BLOCK
    return kind, blocks, 1 << shift


pcg_solve.launches = 0
pcg_solve_penalty.launches = 0
pcg_solve_dyn.launches = 0
