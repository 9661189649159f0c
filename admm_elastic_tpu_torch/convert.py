"""Build the port's system, direct-solve data and state from numpy arrays.

The JAX package's ``System``, ``DirectData`` and ``SimState`` flatten to
plain numpy arrays (``np.asarray`` on each field); these functions turn
such dicts into this package's dataclasses on ``device`` in ``dtype``, so
both packages can step from the same arrays (``Solver.load_arrays``).

``system_from_numpy`` reads::

    {"masses": [N], "dt": float,
     "tets": [{"inds", "Dlocal", "vol", "weight", "mu", "lam", "kappa",
               "st_dl", "st_par", "st_dead", "stencil": meta tuple,
               "model": str, "n_live": int}, ...],
     "pins": None or {"idx", "target", "active", "weight"}}

``direct_from_numpy`` reads ``mat``, ``scale`` and the optional
``pin_idx``, ``pin_cols``, ``pin_vals``, ``pin_diag``.
"""

from __future__ import annotations

import numpy as np
import torch

from admm_elastic_tpu_torch.ops.prox import check_model
from admm_elastic_tpu_torch.solvers.direct import DirectData
from admm_elastic_tpu_torch.system.elements import PinBatch, TetBatch
from admm_elastic_tpu_torch.system.system import SimState, System


def _f(a, device, dtype):
    # np.array copies: arrays exported from JAX are read-only
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _i(a, device, dtype=torch.int64):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _meta(meta):
    """A stencil meta as hashable nested tuples."""
    base, X, Y, Z, pe, po, wrap = meta
    return (int(base), int(X), int(Y), int(Z),
            tuple(tuple(int(v) for v in r) for r in pe),
            tuple(tuple(int(v) for v in r) for r in po), bool(wrap))


def tet_batch_from_numpy(d: dict, *, device, dtype: torch.dtype) -> TetBatch:
    check_model(d["model"])
    mu = _f(d["mu"], device, dtype)
    lam = _f(d["lam"], device, dtype)
    return TetBatch(
        inds=_i(d["inds"], device, torch.int32),
        Dlocal=_f(d["Dlocal"], device, dtype),
        vol=_f(d["vol"], device, dtype),
        weight=_f(d["weight"], device, dtype),
        mu=mu,
        lam=lam,
        kappa=_f(d["kappa"], device, dtype),
        bulk=lam + (2.0 / 3.0) * mu,
        st_dl=_f(d["st_dl"], device, dtype),
        st_par=_f(d["st_par"], device, dtype),
        st_dead=_f(d["st_dead"], device, dtype),
        stencil=_meta(d["stencil"]),
        model=d["model"],
        n_live=d.get("n_live"),
    )


def system_from_numpy(d: dict, *, device, dtype: torch.dtype) -> System:
    pins = None
    if d.get("pins") is not None:
        p = d["pins"]
        pins = PinBatch(
            idx=_i(p["idx"], device),
            target=_f(p["target"], device, dtype),
            active=_i(p["active"], device, torch.bool),
            weight=_f(p["weight"], device, dtype),
        )
    return System(
        masses=_f(d["masses"], device, dtype),
        tets=tuple(tet_batch_from_numpy(t, device=device, dtype=dtype) for t in d["tets"]),
        pins=pins,
        dt=float(d["dt"]),
    )


def direct_from_numpy(d: dict, *, device, dtype: torch.dtype) -> DirectData:
    kw = {}
    if d.get("pin_idx") is not None:
        kw = dict(
            pin_idx=_i(d["pin_idx"], device),
            pin_cols=_i(d["pin_cols"], device),
            pin_vals=_f(d["pin_vals"], device, dtype),
            pin_diag=_f(d["pin_diag"], device, dtype),
        )
    return DirectData(mat=_f(d["mat"], device, dtype),
                      scale=_f(np.reshape(d["scale"], (-1, 1)), device, dtype), **kw)


def state_from_numpy(x, v, *, device, dtype: torch.dtype) -> SimState:
    return SimState(x=_f(np.reshape(x, (-1, 3)), device, dtype),
                    v=_f(np.reshape(v, (-1, 3)), device, dtype))
