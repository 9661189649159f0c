"""Wrappers of kernel K (a collider's self-collision detection) and kernel L
(the dynamic rows' face-corner sums), ``csrc/self_collision.cu`` and
``csrc/dyn_rows.cuh``. Neither has a Pallas original: K replaces the JAX
package's jnp ``detect_dynamic`` (``admm_elastic_tpu/collision/dynamic.py:196-316``)
and the merge across colliders of its ``_detect``; L replaces the
``.at[d_face].add`` scatters of ``constraints.py`` (:146-147, 167-172) by a
gather with no float atomics.

``dyn_detect(collider, x, xs, surf, rows, flag)`` detects the query vertices
surf (at xs = x[surf]) against one collider at the positions x and takes its
hits into rows = (d_mask, d_face, d_barys, d_normal) where a vertex has none
yet; a dropped contact (a hash-grid cell's capacity, HIT_CAP) sets the int32
flag (one element). It returns the rows: on the card the same tensors,
written in place; on the CPU new ones from the plain version
(``collision/dynamic.detect_dynamic`` and ``merge``). Above
``dynamic.BROADPHASE_MIN_TETS`` tets the hash-grid candidates come from the
plain ``_broad_phase_candidates`` (torch.argsort(stable=True) and
torch.searchsorted, on the device) and the kernel walks them.

``dyn_gather(hits, base, mode, ck, yd)`` is ``base`` [N, 3] plus every
vertex's face-corner terms, C^T yd (``constraints.CT``) or diag(C^T C)
(``constraints.DIAG``), in the table order of ``constraints.with_table``: kernel
L on CUDA tensors, bit for bit its plain twin ``constraints.gather_plain``.

Dispatch is by the tensors' device; on the card a build or launch failure
raises. Each wrapper's ``launches`` counts its calls that launch the kernel
(K is four launches on the stream per call: frames, point in tet, rank,
nearest face; torch.profiler names its third ``dyn_rank_kernel``).
"""

from __future__ import annotations

import ctypes

import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.collision import dynamic as dyn
from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops.cuda_obstacle import addresses

FRAME = 13  # csrc/self_collision.cu kFrame


def _check(name, t, dtype, shape, dev):
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def rows_ptrs(name, hits: con.Hits, ck, slot_of, lead):
    """The dynamic rows as csrc/dyn_rows.cuh's DynRows takes them, checked
    against lead (a CUDA tensor [N, 3] of the run dtype): [mask, vidx, face,
    barys, normal, ck, order, start] and slot_of (None where the query set is
    every vertex), for kernels H's and G's DYN forms."""
    n, h = int(lead.shape[0]), int(hits.d_mask.shape[0])
    _build.cuda_args(name, lead, (("d_barys", hits.d_barys, (h, 3)),
                                  ("d_normal", hits.d_normal, (h, 3)), ("ck", ck.reshape(1), (1,))))
    dev = lead.device
    for field, t, dtype, shape in (("d_mask", hits.d_mask, torch.bool, (h,)),
                                   ("d_vidx", hits.d_vidx, torch.int64, (h,)),
                                   ("d_face", hits.d_face, torch.int64, (h, 3)),
                                   ("d_order", hits.d_order, torch.int64, (3 * h,)),
                                   ("d_start", hits.d_start, torch.int64, (n + 1,))):
        _check(f"{name}: {field}", t, dtype, shape, dev)
    if slot_of is not None:
        _check(f"{name}: slot_of", slot_of, torch.int32, (n,), dev)
    return [hits.d_mask, hits.d_vidx, hits.d_face, hits.d_barys, hits.d_normal, ck,
            hits.d_order, hits.d_start, slot_of]


def detect_plain(collider, x, xs, surf, rows, flag):
    """Kernel K's plain twin: detect_dynamic, merged into rows; the overflow
    ORed into flag in place. Returns the new rows."""
    rows, ovf = dyn.merge(rows, dyn.detect_dynamic(collider, x, xs, surf))
    flag.bitwise_or_(ovf.to(torch.int32))
    return rows


def dyn_detect(collider, x, xs, surf, rows, flag):
    """Kernel K: collider's hits of the query vertices surf merged into rows
    (see the module docstring). Returns the rows."""
    if x.device.type == "cpu":
        return detect_plain(collider, x, xs, surf, rows, flag)
    dev = x.device
    sfx = _build.cuda_args("dyn_detect", x, (("rest_verts", collider.rest_verts,
                                              tuple(collider.rest_verts.shape)),))
    d_mask, d_face, d_barys, d_normal = rows
    h = int(surf.shape[0])
    t = collider.n_tets
    f = int(collider.faces.shape[0])
    _check("dyn_detect: tets", collider.tets, torch.int32, (t, 4), dev)
    _check("dyn_detect: faces", collider.faces, torch.int32, (f, 3), dev)
    _check("dyn_detect: surf", surf, torch.int64, (h,), dev)
    _check("dyn_detect: d_mask", d_mask, torch.bool, (h,), dev)
    _check("dyn_detect: d_face", d_face, torch.int64, (h, 3), dev)
    _check("dyn_detect: d_barys", d_barys, x.dtype, (h, 3), dev)
    _check("dyn_detect: d_normal", d_normal, x.dtype, (h, 3), dev)
    _check("dyn_detect: flag", flag, torch.int32, (1,), dev)
    cand, width = None, 0
    if t > dyn.BROADPHASE_MIN_TETS:
        cand, over = dyn._broad_phase_candidates(x[collider.tets.long()], xs, collider.cell_cap)
        flag.bitwise_or_(torch.any(over).to(torch.int32))
        cand = cand.to(torch.int32).contiguous()
        width = int(cand.shape[1])
    hit_cap = int(dyn.HIT_CAP)
    cap = max(min(h, hit_cap), 1)
    frames = torch.empty((max(t, 1), FRAME), dtype=x.dtype, device=dev)
    qtet = torch.empty((max(h, 1),), dtype=torch.int32, device=dev)
    qbary = torch.empty((max(h, 1), 4), dtype=x.dtype, device=dev)
    hit_list = torch.empty((cap,), dtype=torch.int32, device=dev)
    count = torch.empty((1,), dtype=torch.int32, device=dev)
    ptrs = [x, collider.tets, collider.rest_verts, collider.faces, surf, cand, frames, qtet,
            qbary, hit_list, count, d_mask, d_face, d_barys, d_normal, flag]
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(*addresses(ptrs))
    ints = (ctypes.c_int * 6)(t, f, h, width, hit_cap, int(collider.vert_offset))
    fn = getattr(_build.library(), f"admm_dyn_detect_{sfx}")
    with torch.cuda.device(dev):
        rc = fn(ptr_arr, ints, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dyn_detect")
    dyn_detect.launches += 1
    return rows


def dyn_gather(hits: con.Hits, base: torch.Tensor, mode: int, ck: torch.Tensor, yd=None):
    """Kernel L: base plus each vertex's face-corner terms of mode in table
    order (hits must carry their table, constraints.with_table)."""
    if base.device.type == "cpu":
        return con.dyn_gather_plain(hits, base, mode, ck, yd)
    n, h = int(base.shape[0]), int(hits.d_mask.shape[0])
    sfx = _build.cuda_args("dyn_gather", base, (("yd", yd, (h,)),) if mode == con.CT else ())
    out = torch.empty_like(base)
    ptrs = rows_ptrs("dyn_gather", hits, ck, None, base)[:8] + [
        base, yd if mode == con.CT else None, out]
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(*addresses(ptrs))
    ints = (ctypes.c_int * 3)(n, h, int(mode))
    fn = getattr(_build.library(), f"admm_dyn_gather_{sfx}")
    with torch.cuda.device(base.device):
        rc = fn(ptr_arr, ints, torch.cuda.current_stream(base.device).cuda_stream)
    _build.check(rc, "dyn_gather")
    dyn_gather.launches += 1
    return out


dyn_detect.launches = 0
dyn_gather.launches = 0
