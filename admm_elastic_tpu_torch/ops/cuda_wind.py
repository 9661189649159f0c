"""Wrapper of kernel I (``csrc/wind_seq.cu``): the sequential wind in one
launch, in place of the JAX package's ``lax.scan`` over the triangles
(``admm_elastic_tpu/forces.py:76-84``), which has no Pallas kernel.

``wind_seq(tris, direction, alpha_n, dt, x, v)`` walks the triangles
``tris`` (i64 [W, 3]) in order: each computes its Wejchert-Haumann force from
x and from the velocities that the triangles before it have already kicked,
and adds it to its three vertices; returns the new v. Dispatch is by the
tensors' device: CPU tensors take the plain version ``wind_seq_plain``; CUDA
tensors launch the kernel, and a build or launch failure raises.
``wind_seq.launches`` counts kernel launches; the kernel also counts its own
launches on the device (``device_launches``), graph replays included, which
torch.profiler does not record reliably for it.

The kernel has two forms: SHARED, v in the block's shared memory for the
whole walk, where it fits; GLOBAL, v in global memory, for any N. ``i_form``
chooses by N, the dtype and the card's shared memory; a caller may ask for
one (``form=``), and SHARED where v does not fit raises.
"""

from __future__ import annotations

import ctypes

import torch

from admm_elastic_tpu_torch.ops import _build

FORMS = ("global", "shared")
_COUNTERS = {}  # device -> int32 [1], the kernel's launches on that device


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


def i_form(n: int, itemsize: int, smem_optin: int, want=None) -> str:
    """The form kernel I takes for n vertices: "shared" where v ([n, 3] of
    itemsize bytes) fits smem_optin bytes of shared memory, else "global".
    want asks for one; "shared" where v does not fit raises ValueError."""
    if want not in (None,) + FORMS:
        raise ValueError(f"wind_seq: form {want!r}, expected one of {FORMS}")
    fits = n * 3 * itemsize <= smem_optin
    if want == "shared" and not fits:
        raise ValueError(f"wind_seq: v of {n} vertices in {itemsize}-byte values does not fit "
                         f"{smem_optin} bytes of shared memory")
    return want or ("shared" if fits else "global")


def wind_force_plain(dt, alpha_n: float, p, w, direction, three):
    """One triangle's Wejchert-Haumann force (the port's WindForce._tri_force
    on one triangle) with every sum written out in the order kernel I takes:
    p, w [3, 3] (corner, component), direction [3], three the 0-d tensor 3
    -> [3]. The mean divides by a tensor, not a Python number: PyTorch on a
    CUDA device multiplies by the reciprocal of a Python divisor."""
    v_r = (w[0] + w[1] + w[2]) / three - direction
    a, b = p[1] - p[0], p[2] - p[0]
    n = a.roll(-1) * b.roll(1) - a.roll(1) * b.roll(-1)  # a x b
    sq = n * n
    n_len = torch.sqrt(sq[0] + sq[1] + sq[2])
    normal = n / torch.clamp(n_len, min=1e-30)
    area = 0.5 * n_len
    nv = normal * v_r
    v_n = nv[0] + nv[1] + nv[2]
    s = -alpha_n * area * v_n * torch.abs(v_n)
    return s * normal * 0.33 * dt


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


def wind_seq(tris, direction, alpha_n: float, dt, x, v, form=None, lib=None):
    """v after the sequential wind of the triangles tris (see the module
    docstring): x, v [N, 3]. lib: a variant build of the kernel library (a
    measurement's; the port launches the library's own)."""
    if x.device.type == "cpu":
        return wind_seq_plain(tris, direction, alpha_n, dt, x, v)
    n = x.shape[0]
    d = direction.to(x.dtype).contiguous()
    sfx = _build.cuda_args("wind_seq", x, (("x", x, (n, 3)), ("v", v, (n, 3)),
                                           ("direction", d, (3,))))
    if tris.dtype != torch.int64 or tris.device != x.device or not tris.is_contiguous():
        raise ValueError(f"wind_seq: tris is {tris.device}/{tris.dtype}, expected a contiguous "
                         f"int64 tensor on {x.device}")
    lib = lib or _build.library()
    f = i_form(n, x.element_size(), _build.library().admm_smem_optin(), form)
    out = torch.empty_like(v)
    ptrs = (ctypes.c_uint64 * 6)(tris.data_ptr(), x.data_ptr(), v.data_ptr(), d.data_ptr(),
                                 out.data_ptr(), _counter(x.device).data_ptr())
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"admm_wind_seq_{sfx}")(
            ptrs, n, tris.shape[0], -float(alpha_n), float(dt), int(f == "shared"),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "wind_seq")
    wind_seq.launches += 1
    return out


wind_seq.launches = 0
