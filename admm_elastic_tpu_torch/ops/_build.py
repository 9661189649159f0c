"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The sources compile into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/libadmm_kernels_<hash>.so csrc/*.cu

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
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dix, u, mu, lam, kappa, k, z, uo, n, n_iters, sweeps, stream
    "admm_local_step": [_P] * 8 + [_I, _I, _I, _P],
    # x, dl, par, dead, out, base, n_vblock, cells, geom, stream
    "admm_tet_dx": [_P] * 5 + [_I, _I, _I, _P, _P],
    # z, u, w, dl, par, out, n_verts, base, n_vblock, cells, geom, stream
    "admm_tet_rhs": [_P] * 6 + [_I, _I, _I, _I, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu unless a library of the same hash exists; returns
    its path. The ptxas report (registers, spills) goes to a .log beside it."""
    so = BUILD_DIR / f"libadmm_kernels_{_digest()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                for suffix in ("f32", "f64"):
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {rc}")
