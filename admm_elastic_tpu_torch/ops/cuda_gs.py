"""Wrapper of kernel H (``csrc/gs.cu``): the whole nodal-constrained
Gauss-Seidel solve in one launch, in place of the JAX package's jnp loop
(``admm_elastic_tpu/solvers/gs.py:147-196``, no dynamic rows), which has no
Pallas kernel.

``gs_solve(data, b, x0, pin_mask, pin_target, obstacles, omega, max_iters,
tol, sweeps, params=None)`` runs the SOR sweeps of ``data`` (a ``solvers.gs.GSData``) from
x0 with the dense pin arrays and the analytic obstacles (``Floor``,
``Sphere``; at most 8) until the residual test holds or max_iters sweeps,
and adds the sweeps to ``sweeps`` (an int32 tensor of one element on the
device). Dispatch is by the tensors' device: CPU tensors take the plain
version (``solvers/gs.solve``, which stops on the host); CUDA tensors launch
the kernel, and a build or launch failure raises. ``gs_solve.launches``
counts kernel launches.

The obstacles reach the kernel by value, as ``params`` =
``obstacle_params(obstacles)``, which reads them to the host (a
synchronisation, which a capture refuses): a captured step passes the
parameters that the solver read at ``initialize``; where ``params`` is None
the wrapper reads them itself.
"""

from __future__ import annotations

import ctypes

import torch

from admm_elastic_tpu_torch.collision.passive import Floor, Sphere
from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.solvers import gs as gs_mod

MAX_OBSTACLES = 8  # csrc/gs.cu kMaxObstacles
FLOOR, SPHERE = 0, 1  # csrc/gs.cu enum Kind


def obstacle_params(obstacles):
    """(kinds, params) of the obstacles as kernel H takes them: Floor (y),
    Sphere (centre, radius)."""
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
        else:
            raise NotImplementedError(f"kernel H takes Floor and Sphere, not {type(o).__name__}")
    return tuple(kinds), (ctypes.c_double * max(len(par), 1))(*par)


def gs_solve(data: gs_mod.GSData, b: torch.Tensor, x0: torch.Tensor, pin_mask: torch.Tensor,
             pin_target: torch.Tensor, obstacles, omega: float, max_iters: int, tol: float,
             sweeps: torch.Tensor, params=None) -> torch.Tensor:
    """x after the constrained SOR sweeps from x0; the sweeps are added to
    sweeps. params: obstacle_params(obstacles), read here where None."""
    if b.device.type == "cpu":
        x, k = gs_mod.solve(data.ell_cols, data.ell_vals, data.diag, data.colors,
                            data.colors_mask, b, x0, pin_mask, pin_target, obstacles, None, None,
                            omega, max_iters, tol, may_have_dyn=False)
        sweeps += k
        return x
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
    out = torch.empty_like(b)
    ptrs = [data.ell_cols, data.ell_vals, data.diag, data.colors, b, x0, out, pin_mask,
            pin_target, sweeps]
    ptr_arr = (ctypes.c_uint64 * len(ptrs))(*[t.data_ptr() for t in ptrs])
    n_colors, width = data.colors.shape
    ints = (ctypes.c_int * (6 + MAX_OBSTACLES))(n, k, n_colors, width, int(max_iters),
                                                len(kinds), *kinds)
    fn = getattr(_build.library(), f"admm_gs_solve_{sfx}")
    with torch.cuda.device(b.device):
        rc = fn(ptr_arr, ints, par, float(omega), float(tol),
                torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(rc, "gs_solve")
    gs_solve.launches += 1
    return out


gs_solve.launches = 0
