"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers, so a build takes
seconds). Each translation unit of ``UNITS`` compiles to an object file, all
of them started together; the per-lane kernels are built once per precision:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -Xptxas -v [-DADMM_REAL=float -DADMM_SFX=f32] -c csrc/<unit>.cu -o <unit>.o
    nvcc -shared -o build/kernels/libadmm_kernels_<hash>.so *.o

The library lands in ``build/kernels/`` at the root of the checkout and is
named by a hash of the sources and flags, so a changed source rebuilds on
first use. Nothing here runs at import: ``library()`` builds and loads on
the first call, and raises if nvcc is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_PRECISIONS = (("f32", "float"), ("f64", "double"))
# (source, precision suffix or None): stencil.cu, pcg.cu, gs.cu, wind_seq.cu,
# obstacle.cu and self_collision.cu hold both precisions themselves.
UNITS = tuple([("stencil.cu", None), ("pcg.cu", None), ("gs.cu", None), ("wind_seq.cu", None),
               ("obstacle.cu", None), ("self_collision.cu", None)]
              + [(src, sfx) for src in ("local_step.cu", "prox.cu", "tri_local_step.cu")
                 for sfx, _ in _PRECISIONS])

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # dix, u, mu, lam, kappa, k, z, uo, n, model, n_iters, sweeps, stream
    "admm_local_step": [_P] * 8 + [_I, _I, _I, _I, _P],
    # x, dl, par, dead, u, mu, lam, kappa, k, z, uo, base, n_vblock, cells, geom, model,
    # n_iters, sweeps, stream
    "admm_local_step_stencil": [_P] * 11 + [_I, _I, _I, _P, _I, _I, _I, _P],
    # zi, mu, lam, kappa, k, out, n, model, n_iters, sweeps, stream
    "admm_prox_tet_hyper": [_P] * 6 + [_I, _I, _I, _I, _P],
    # zi, out, n, sweeps, stream
    "admm_prox_tet_linear": [_P, _P, _I, _I, _P],
    # dix, u, limit_min, limit_max, z, uo, n, stream
    "admm_tri_local_step": [_P] * 6 + [_I, _P],
    # x, dl, dead, u, limit_min, limit_max, z, uo, base, cells, n_slots, geom, stream
    "admm_tri_local_step_stencil": [_P] * 8 + [_I, _I, _I, _P, _P],
    # x, dl, par, dead, out, base, n_vblock, cells, geom, stream
    "admm_tet_dx": [_P] * 5 + [_I, _I, _I, _P, _P],
    # z, u, w, dl, par, out, n_verts, base, n_vblock, cells, match, tile, halo, stream
    "admm_tet_rhs": [_P] * 6 + [_I, _I, _I, _I, _P, _I, _I, _P],
    # ptrs, ints, offs, tol, omega, stream
    "admm_pcg_solve": [_P, _P, _P, _D, _D, _P],
    # n
    "admm_pcg_grid": [_I],
    # ptrs, ints, par, omega, tol, stream
    "admm_gs_solve": [_P, _P, _P, _D, _D, _P],
    # ptrs, ints, neg_alpha, dt, stream
    "admm_wind_seq": [_P, _P, _D, _D, _P],
    # ptrs, ints, capture_cells, stream
    "admm_mesh_detect": [_P, _P, _D, _P],
    # ptrs, ints, stream
    "admm_dyn_detect": [_P, _P, _P],
    "admm_dyn_gather": [_P, _P, _P],
}
_PLAIN_SIGNATURES = {  # one function for both precisions
    "admm_empty_launch": [_P],  # stream
    "admm_pcg_barrier_loop": [_I, _I, _P, _P],  # grid, iters, barrier, stream
    "admm_cluster_barrier_loop": [_I, _I, _I, _I, _P],  # cluster, threads, smem, iters, stream
    "admm_cluster_capacity": [_I, _I, _I],  # cluster, threads, smem
    "admm_smem_optin": [],
    "admm_mesh_blocks": [_I],  # f64
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(units=UNITS, defines=()) -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS + tuple(defines)) + repr(units)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(units=UNITS, defines=()) -> Path:
    """Compile the units of csrc/ in parallel and link them, unless a library
    of the same hash exists; returns its path. The build time of each unit and
    its ptxas report (registers, spills) go to a .log beside the library.
    units and defines (extra -D flags) make a variant library, such as
    tools/g_h_anatomy.py's."""
    so = BUILD_DIR / f"libadmm_kernels_{_digest(units, defines)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src, sfx in units:
        obj = BUILD_DIR / f"{tag}.{Path(src).stem}{'_' + sfx if sfx else ''}.o"
        defs = list(defines)
        if sfx:
            defs += [f"-DADMM_REAL={dict(_PRECISIONS)[sfx]}", f"-DADMM_SFX={sfx}"]
        cmd = [nvcc, *NVCC_FLAGS, *defs, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {obj.name}: rc {proc.returncode}, done {time.perf_counter() - t0:.1f} s "
                   f"after start\n{out}")
        if proc.returncode != 0:
            failed.append(f"{obj.name}:\n{out[-3000:]}")
    objs = [str(obj) for obj, _ in procs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                                  capture_output=True, text=True)
            log.append(f"== link: rc {link.returncode}\n{link.stdout}{link.stderr}")
            if link.returncode != 0:
                failed.append(f"link:\n{link.stderr[-3000:]}")
        so.with_suffix(".log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return so


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        for suffix, _ in _PRECISIONS:
            fn = getattr(lib, f"{name}_{suffix}", None)
            if fn is not None:
                fn.argtypes = args
                fn.restype = ctypes.c_int
    for name, args in _PLAIN_SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build())
        return _lib


def variant(units, defines) -> ctypes.CDLL:
    """A library of the named units built with extra -D flags (a
    measurement's variant; the port itself loads library())."""
    return _load(build(tuple(units), tuple(defines)))


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")


def cuda_args(name: str, lead, fields) -> str:
    """Check what a kernel is handed and return its precision suffix.

    lead must be a float32 / float64 CUDA tensor; every (field name, tensor,
    shape) of fields must be contiguous, of that shape, on lead's device and
    in lead's dtype: the kernels take raw pointers.
    """
    if lead.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {lead.device}")
    if lead.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported dtype {lead.dtype}")
    for fname, t, shape in fields:
        if t.device != lead.device or t.dtype != lead.dtype:
            raise ValueError(f"{name}: {fname} is {t.device}/{t.dtype}, "
                             f"expected {lead.device}/{lead.dtype}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: {fname} has shape {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()}), expected {tuple(shape)}")
    return "f32" if lead.dtype == torch.float32 else "f64"
