"""Wrapper of kernel I (``csrc/wind_seq.cu``): the sequential wind in one
launch, in place of the JAX package's ``lax.scan`` over the triangles
(``admm_elastic_tpu/forces.py:76-84``), which has no Pallas kernel.

``wind_seq(tris, direction, alpha_n, dt, x, v, schedule)`` applies the
triangles ``tris`` (i64 [W, 3]) in file order: each computes its
Wejchert-Haumann force from x and from the velocities that the triangles
before it have already kicked, and adds it to its three vertices; returns the
new v. Dispatch is by the tensors' device: CPU tensors take the plain version
``wind_seq_plain`` (the scan); CUDA tensors launch the kernel, and a build or
launch failure raises. ``wind_seq.launches`` counts kernel launches; the
kernel also counts its own launches on the device (``device_launches``),
graph replays included, which torch.profiler does not record reliably for it.

The kernel walks the triangles' level schedule (``bake_schedule``, baked
once per triangle list on the host, ``WindSchedule``): level(t) = 1 + the
largest level of an earlier triangle that shares a vertex with t. No two
triangles of a level share a vertex, each vertex receives its triangles'
kicks in file order, and each triangle reads the v the scan gives it, so the
levels one after another give the scan's bits (``wind_seq_levels_plain`` is
that walk in plain PyTorch). ``i_form`` chooses the kernel's form (SHARED or
GLOBAL: ``csrc/wind_seq.cu``) from N, W, the dtype and the card's shared
memory; a caller may ask for one (``form=``), and SHARED where it does not
fit raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from admm_elastic_tpu_torch.ops import _build

FORMS = ("shared", "global")
_FORM_CODE = {f: i for i, f in enumerate(FORMS)}
THREADS = 512  # csrc/wind_seq.cu kThreads
_COUNTERS = {}  # device -> int32 [1], the kernel's launches on that device


@dataclasses.dataclass(frozen=True)
class WindSchedule:
    """The level schedule of a triangle list (``bake_schedule``): the
    triangle ids by level, file order within a level, and each level's first
    slot, on the triangles' device; the level count, the widest level and the
    vertices the list needs (its largest id + 1) as Python ints."""

    order: torch.Tensor  # i32 [W]
    offsets: torch.Tensor  # i32 [n_levels + 1]
    n_levels: int
    widest: int
    n_verts: int


def triangle_levels(tris) -> np.ndarray:
    """level(t) = 1 + the largest level of an earlier triangle that shares a
    vertex with t (0 where none does), for tris [W, 3] in file order; a
    triangle's repeated vertex counts once. i64 [W]."""
    tris = np.asarray(tris, dtype=np.int64).reshape(-1, 3)
    if tris.size and tris.min() < 0:
        raise ValueError("wind schedule: a negative vertex id")
    last = {}  # vertex -> the level of its last triangle so far
    levels = np.empty(len(tris), dtype=np.int64)
    for t, (a, b, c) in enumerate(tris.tolist()):
        lv = max(last.get(a, -1), last.get(b, -1), last.get(c, -1)) + 1
        levels[t] = last[a] = last[b] = last[c] = lv
    return levels


def bake_schedule(tris, device) -> WindSchedule:
    """The level schedule of tris ([W, 3], numpy or a tensor, read on the
    host) with its tensors on device."""
    tris = np.asarray(torch.as_tensor(tris).detach().cpu(), dtype=np.int64).reshape(-1, 3)
    if len(tris) >= 2 ** 31:
        raise ValueError(f"wind schedule: {len(tris)} triangles do not fit int32 slots")
    levels = triangle_levels(tris)
    order = np.argsort(levels, kind="stable")
    counts = np.bincount(levels) if len(levels) else np.zeros(0, np.int64)
    offsets = np.concatenate(([0], np.cumsum(counts)))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=device)

    return WindSchedule(order=i32(order), offsets=i32(offsets), n_levels=len(counts),
                        widest=int(counts.max()) if len(counts) else 0,
                        n_verts=int(tris.max()) + 1 if tris.size else 0)


def check_schedule(schedule: WindSchedule, tris) -> None:
    """Raise ValueError unless schedule is tris's own (bake_schedule's, on
    tris's device); reads both on the host."""
    want = bake_schedule(tris, "cpu")
    dev = torch.as_tensor(tris).device
    if not isinstance(schedule, WindSchedule):
        raise ValueError(f"wind schedule: {type(schedule).__name__} is no WindSchedule")
    if any(t.device != dev for t in (schedule.order, schedule.offsets)):
        raise ValueError(f"wind schedule: on {schedule.order.device}, the triangles on {dev}")
    same = ((schedule.n_levels, schedule.widest, schedule.n_verts)
            == (want.n_levels, want.widest, want.n_verts)
            and all(getattr(schedule, k).dtype == torch.int32
                    and torch.equal(getattr(schedule, k).cpu(), getattr(want, k))
                    for k in ("order", "offsets")))
    if not same:
        raise ValueError("wind schedule: it does not describe this triangle list")


def _counter(device):
    """The device's launch counter of kernel I, made at the first launch (the
    warm-up step before any capture)."""
    if device not in _COUNTERS:
        _COUNTERS[device] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _COUNTERS[device]


def device_launches(device) -> int:
    """Kernel I's launches on the device so far, as it counted them (reads the
    card: not inside a capture)."""
    return int(_COUNTERS[device].item()) if device in _COUNTERS else 0


def staged_bytes(n: int, w: int, itemsize: int) -> int:
    """The SHARED form's shared memory: v [n, 3], each slot's geometry
    [w, 4] of itemsize bytes and its ids [w, 3] of 4 bytes."""
    return (3 * n + 4 * w) * itemsize + 3 * w * 4


def walkers(widest: int) -> int:
    """The threads of kernel I's block that walk the levels: the widest level
    rounded up to warps, one warp at least, the block at most (a wider level
    loops)."""
    return min(THREADS, max(32, -(-widest // 32) * 32))


def i_form(n: int, w: int, itemsize: int, smem_optin: int, want=None) -> str:
    """The form kernel I takes for w triangles on n vertices in itemsize-byte
    values, with smem_optin bytes of shared memory a block: "shared" where v,
    the geometry and the ids fit (staged_bytes), else "global". want asks for
    one; "shared" where they do not fit raises ValueError."""
    if want not in (None,) + FORMS:
        raise ValueError(f"wind_seq: form {want!r}, expected one of {FORMS}")
    fits = staged_bytes(n, w, itemsize) <= smem_optin
    if want == "shared" and not fits:
        raise ValueError(f"wind_seq: v of {n} vertices and {w} triangles in {itemsize}-byte "
                         f"values does not fit {smem_optin} bytes of shared memory")
    return want or ("shared" if fits else "global")


def wind_force_plain(dt, alpha_n: float, p, w, direction, three):
    """Triangles' Wejchert-Haumann forces (the port's WindForce._tri_force)
    with every sum written out in the order kernel I takes: p, w [..., 3, 3]
    (corner, component), direction [3], three the 0-d tensor 3 -> [..., 3].
    The mean divides by a tensor, not a Python number: PyTorch on a CUDA
    device multiplies by the reciprocal of a Python divisor."""
    v_r = (w[..., 0, :] + w[..., 1, :] + w[..., 2, :]) / three - direction
    a, b = p[..., 1, :] - p[..., 0, :], p[..., 2, :] - p[..., 0, :]
    n = a.roll(-1, -1) * b.roll(1, -1) - a.roll(1, -1) * b.roll(-1, -1)  # a x b
    sq = n * n
    n_len = torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])
    normal = n / torch.clamp(n_len, min=1e-30)[..., None]
    area = 0.5 * n_len
    nv = normal * v_r
    v_n = nv[..., 0] + nv[..., 1] + nv[..., 2]
    s = -alpha_n * area * v_n * torch.abs(v_n)
    return s[..., None] * normal * 0.33 * dt


def wind_seq_plain(tris, direction, alpha_n: float, dt, x, v):
    """Kernel I's plain version: a loop over the triangles in PyTorch, one
    wind_force_plain then the three adds per triangle (some 37 operations a
    triangle, none reading the host). On the card every operation is
    IEEE-rounded, as the kernel's; PyTorch's CPU square root is not on every
    host (on one with AVX-512, one scalar in some 150 an ulp off), so the
    kernel is held to this function on the card. A triangle with a repeated
    vertex has no area and adds a zero force, once or twice alike."""
    out = v.clone()
    d = direction.to(v.dtype)
    three = torch.full((), 3.0, dtype=v.dtype, device=v.device)
    idx = tris.to(v.device)
    for t in range(idx.shape[0]):
        tri = idx[t]
        out[tri] = out[tri] + wind_force_plain(dt, alpha_n, x[tri], out[tri], d, three)
    return out


def wind_seq_levels_plain(schedule: WindSchedule, tris, direction, alpha_n: float, dt, x, v):
    """The kernel's walk in plain PyTorch: the levels of schedule in order,
    each a batched gather of its triangles' x and v, wind_force_plain's
    operations in the same order, and an index_copy of w + force. The same
    bits as wind_seq_plain wherever every operation rounds alike (on the
    card); the tests run it on the CPU, where no path takes it."""
    out = v.clone()
    d = direction.to(v.dtype)
    three = torch.full((), 3.0, dtype=v.dtype, device=v.device)
    idx = tris.to(v.device)
    order = schedule.order.to(device=v.device, dtype=torch.int64)
    offs = schedule.offsets.tolist()
    for lo, hi in zip(offs[:-1], offs[1:]):
        tri = idx[order[lo:hi]]  # [L, 3], vertex-disjoint across triangles
        w = out[tri]
        new = w + wind_force_plain(dt, alpha_n, x[tri], w, d, three)[:, None, :]
        out = out.index_copy(0, tri.reshape(-1), new.reshape(-1, 3))
    return out


def wind_seq(tris, direction, alpha_n: float, dt, x, v, schedule=None, form=None, lib=None):
    """v after the sequential wind of the triangles tris (see the module
    docstring): x, v [N, 3]; schedule tris's WindSchedule (required on the
    card). lib: a variant build of the kernel library (a measurement's; the
    port launches the library's own)."""
    if x.device.type == "cpu":
        return wind_seq_plain(tris, direction, alpha_n, dt, x, v)
    n, w = x.shape[0], tris.shape[0]
    d = direction.to(x.dtype).contiguous()
    sfx = _build.cuda_args("wind_seq", x, (("x", x, (n, 3)), ("v", v, (n, 3)),
                                           ("direction", d, (3,))))
    if tris.dtype != torch.int64 or tris.device != x.device or not tris.is_contiguous():
        raise ValueError(f"wind_seq: tris is {tris.device}/{tris.dtype}, expected a contiguous "
                         f"int64 tensor on {x.device}")
    if not isinstance(schedule, WindSchedule):
        raise ValueError("wind_seq: no level schedule (bake_schedule) for the triangles")
    if (tuple(schedule.order.shape) != (w,)
            or tuple(schedule.offsets.shape) != (schedule.n_levels + 1,)
            or any(t.dtype != torch.int32 or t.device != x.device or not t.is_contiguous()
                   for t in (schedule.order, schedule.offsets))):
        raise ValueError(f"wind_seq: the schedule does not describe {w} triangles on {x.device}")
    if schedule.n_verts > n:
        raise ValueError(f"wind_seq: the triangles name vertex {schedule.n_verts - 1} of {n}")
    lib = lib or _build.library()
    optin = _build.library().admm_smem_optin()
    f = i_form(n, w, x.element_size(), optin, form)
    out = torch.empty_like(v)
    scratch = (None, None)
    if f == "global":
        scratch = (torch.empty((w, 4), dtype=x.dtype, device=x.device),
                   torch.empty((w, 3), dtype=torch.int32, device=x.device))
    ptrs = (ctypes.c_uint64 * 10)(
        tris.data_ptr(), schedule.order.data_ptr(), schedule.offsets.data_ptr(), x.data_ptr(),
        v.data_ptr(), d.data_ptr(), out.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in scratch), _counter(x.device).data_ptr())
    ints = (ctypes.c_int * 5)(n, w, schedule.n_levels, _FORM_CODE[f], walkers(schedule.widest))
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"admm_wind_seq_{sfx}")(
            ptrs, ints, -float(alpha_n), float(dt),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "wind_seq")
    wind_seq.launches += 1
    return out


wind_seq.launches = 0
