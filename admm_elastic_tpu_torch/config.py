"""Solver settings (the JAX package's config).

The fields and defaults are those of ``admm_elastic_tpu.config.Settings``
so that one settings object reads the same in both packages. Every global
step of the JAX package runs in this package: the prefactored direct solve
(``linsolver=LDLT``) in both of its modes, ``direct_mode="inv"`` (a GEMM on
the stored inverse) and ``"cho"`` (two triangular solves on the Cholesky
factor), PCG (``linsolver=PCG``, ``pcg_precond`` "jacobi" or "twogrid"),
which also serves ``LDLT`` above ``direct_max_verts`` vertices, and the
contact solvers: multicolour Gauss-Seidel (``NCMCGS``), Uzawa (``UZAWACG``,
its inner solve ``uzawa_inner``) and AL-PCG (``ALPCG``), each also with
Anderson acceleration (``aa_window``) and in the logged (``log_inner``) and
profiled (``verbose >= 2``) steps. ``unroll_admm`` raises
``NotImplementedError``. ``parse_args`` and ``help`` are the reference's
command line (src/Solver.cpp:273-307), as the JAX package reads it.

``dtype=None`` means float32 here. The JAX package follows
``jax_enable_x64`` instead; this package changes no global default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Linear solver ids (reference: src/Solver.hpp:47, `-ls <int>`)
LDLT = 0  # prefactored direct solve (no collisions allowed)
NCMCGS = 1  # nodal-constrained multicolor Gauss-Seidel
UZAWACG = 2  # Uzawa saddle-point CG
PCG = 3  # matrix-free Jacobi-preconditioned CG
ALPCG = 4  # augmented-Lagrangian PCG hard contact


@dataclasses.dataclass
class Settings:
    """Simulation settings; defaults match the reference (src/Solver.hpp:48-49)."""

    timestep_s: float = 1.0 / 24.0  # -dt
    verbose: int = 1  # -v
    admm_iters: int = 10  # -it
    gravity: float = -9.8  # -g
    linsolver: int = LDLT  # -ls
    constraint_w: float = -1.0  # -ck (-1 = auto)

    # None -> float32; np.float32/np.float64 or torch.float32/torch.float64.
    dtype: Optional[object] = None
    gs_max_iters: int = 30
    gs_tol: float = 1e-10
    gs_omega: float = 1.9
    uzawa_max_iters: int = 20
    uzawa_tol: float = 1e-10
    uzawa_inner: str = "auto"
    uzawa_dense_max_verts: int = 8192
    # Above this vertex count linsolver=0 is served by two-grid PCG at
    # pcg_tol = min(pcg_tol, 1e-10), as in the JAX package.
    direct_max_verts: int = 12000
    uzawa_inner_tol: float = 1e-8
    uzawa_inner_iters: int = 200
    pcg_max_iters: int = 200
    pcg_tol: float = 1e-10
    pcg_precond: str = "jacobi"
    # "inv" = the Jacobi-equilibrated inverse applied as one GEMM per solve;
    # "cho" = two triangular solves on the Cholesky factor.
    direct_mode: str = "inv"
    # Newton iterations of the hyperelastic prox (src/TetEnergyTerm.cpp:133).
    prox_newton_iters: int = 8
    aa_window: int = 0
    aa_safeguard: float = 1.0
    log_inner: bool = False
    log_inner_iters: int = 0
    unroll_admm: bool = False
    # Iterative-refinement passes after each direct solve (see
    # Solver._refine_eff: unpinned float32 systems take at least one).
    refine_passes: int = 0

    def parse_args(self, argv) -> bool:
        """Parse CLI flags; returns True if -help was requested.

        Same contract as the reference parser (src/Solver.cpp:273-307).
        """
        i = 0
        args = list(argv)
        n = len(args)
        known = ("-dt", "-v", "-it", "-g", "-ls", "-ck")
        while i < n:
            a = args[i]
            if a in ("-help", "--help", "-h"):
                self.help()
                return True
            if a in known:
                if i + 1 >= n:
                    # A trailing flag with no value is an input error, not
                    # something to swallow silently.
                    raise ValueError(
                        f"**Settings::parse_args Error: flag {a} needs a value."
                    )
                val = args[i + 1]
                if a == "-dt":
                    self.timestep_s = float(val)
                elif a == "-v":
                    self.verbose = int(val)
                elif a == "-it":
                    self.admm_iters = int(val)
                elif a == "-g":
                    self.gravity = float(val)
                elif a == "-ls":
                    self.linsolver = int(val)
                elif a == "-ck":
                    self.constraint_w = float(val)
                i += 1
            i += 1
        return False

    @staticmethod
    def help():
        print(
            "\n==========================================\nArgs:\n"
            "\t-dt: time step (s)\n"
            "\t-v: verbosity (higher -> show more)\n"
            "\t-it: # admm iters\n"
            "\t-g: gravity (m/s^2)\n"
            "\t-ls: linear solver (0=direct, 1=NCMCGS, 2=UzawaCG, 3=PCG, 4=AL-PCG contact)\n"
            "\t-ck: constraint weights (-1 = auto)\n"
            "=========================================="
        )


_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def resolve_dtype(settings: Settings) -> torch.dtype:
    """The torch dtype the settings ask for: float32 unless stated."""
    d = settings.dtype
    if d is None:
        return torch.float32
    if isinstance(d, torch.dtype):
        if d not in (torch.float32, torch.float64):
            raise ValueError(f"unsupported dtype {d}")
        return d
    nd = np.dtype(d)
    if nd not in _DTYPES:
        raise ValueError(f"unsupported dtype {nd}")
    return _DTYPES[nd]
