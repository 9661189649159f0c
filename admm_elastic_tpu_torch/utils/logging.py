"""Convergence instrumentation (the reference's SolverLog, src/SolverLog.hpp).

A port of ``admm_elastic_tpu/utils/logging.py``, host code on numpy. The
reference's opt-in tracer records, per inner iteration, the normalised error
against a known solution x_star and the wall clock, and the final residual
||Ax - b||. ``Solver.step_logged`` runs each global solve once with a fixed
iteration budget and records the whole trace as a tensor
(``solvers/*.solve_traced``), so tracing costs one extra solve rather than a
host synchronisation per inner iteration.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SolverLog:
    """Host-side collector with the reference's semantics."""

    x_star: np.ndarray | None = None
    errors: List[float] = dataclasses.field(default_factory=list)
    runtimes: List[float] = dataclasses.field(default_factory=list)
    final_r: float = 0.0
    _x0: np.ndarray | None = None

    def reset(self):
        self.errors = []
        self.runtimes = []
        self._x0 = None

    def add(self, x: np.ndarray, elapsed_ms: float = 0.0):
        if self.x_star is None or np.shape(self.x_star) != np.shape(x):
            return
        if not self.errors:
            self._x0 = np.array(x)
        numer = float(np.linalg.norm(self.x_star - x))
        denom = float(np.linalg.norm(self.x_star - self._x0))
        self.errors.append(numer / max(denom, 1e-300))
        self.runtimes.append(elapsed_ms)

    def finalize(self, A_mv, x, b):
        if self.x_star is None or np.shape(self.x_star) != np.shape(x):
            return
        self.final_r = float(np.linalg.norm(np.asarray(A_mv(x)) - np.asarray(b)))


@dataclasses.dataclass
class InnerLog:
    """Per-inner-iteration convergence curves of one step (the SolverLog tier).

    One row per ADMM iteration (= one global solve), as the reference's
    per-solve SolverLog records (src/SolverLog.hpp:36-60, hooked at
    src/NodalMultiColorGS.hpp:61,135,144 and src/UzawaCG.hpp:59,112,122).
    Residual per solver: direct ||b - A x||; PCG ||b - A x_k||; GS
    ||b_eff - (A + C^T C) x_k|| per sweep; Uzawa ||C x_k - c|| (the Schur
    residual); AL-PCG ||b_hat - (A + C^T C) x_k||.
    """

    residuals: np.ndarray  # [admm_iters, n_inner]
    errors: "np.ndarray | None" = None  # same shape, against x_star (if set)
    # The residual at the last inner iteration of the last solve, in the
    # active mode's residual definition above (not always ||A x - b||).
    final_r: float = 0.0
    x_star: "np.ndarray | None" = None  # set by the user before stepping


def admm_error_trace(solver, x_star: np.ndarray, n_steps: int = 1) -> np.ndarray:
    """Run the step and record the normalised error against x_star after
    each number of ADMM iterations from 1 to admm_iters.

    The reference's known-solution re-run workflow (src/SolverLog.hpp:36-55)
    at the ADMM-iteration granularity: run once to convergence to get x_star,
    then re-run calling this. Each run starts from the same kept
    ``solver.state`` (a snapshot that no later step writes), and the solver
    ends one full step past it.
    """
    errors = []
    x0 = np.array(solver.x)
    denom = max(float(np.linalg.norm(x_star - x0)), 1e-300)
    saved_iters = solver.m_settings.admm_iters
    saved_verbose = solver.m_settings.verbose
    solver.m_settings.verbose = 0
    try:
        state0 = solver.state
        for it in range(1, saved_iters + 1):
            solver.state = state0
            solver.m_settings.admm_iters = it
            solver.step()
            errors.append(float(np.linalg.norm(x_star - solver.x)) / denom)
        solver.state = state0
        solver.m_settings.admm_iters = saved_iters
        solver.step()
    finally:
        solver.m_settings.admm_iters = saved_iters
        solver.m_settings.verbose = saved_verbose
    return np.asarray(errors)
