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
     "tris": [{"inds", "Dlocal", "area", "weight", "mu", "lam", "limit_min",
               "limit_max", "st_dl", "st_dead", "stencil": meta tuple,
               "n_live": int}, ...]  (optional),
     "pins": None or {"idx", "target", "active", "weight"}}

A gather family (no stencil) has ``stencil`` None, no ``st_*`` fields (or
None) and its ``gather_idx`` table in their place.
``direct_from_numpy`` reads ``mat``, ``scale``, the optional ``mode``
("inv" unless given) and the optional ``pin_idx``, ``pin_cols``,
``pin_vals``, ``pin_diag``.
``pcg_from_numpy`` reads a PCGData's ``ell_cols``, ``ell_vals``,
``diag_mass``, ``diag_stiff``, ``diag_pin``, the optional (None where absent)
``agg``, ``agg_gather``, ``coarse_inv``, ``bands``, ``perm``, ``iperm``, and
``band_offsets`` and ``band_circular``.
``wind_force_from_numpy`` reads a WindForce's ``tris``, ``direction``, the
optional ``alpha_n`` and ``sequential`` and, for the colored order,
``color_tris`` and ``color_mask``.
``gs_from_numpy`` reads a GSData's ``ell_cols``, ``ell_vals``, ``diag``,
``colors`` and ``colors_mask``; ``obstacle_from_numpy`` a Floor's ``y``, a
Sphere's ``center`` and ``rad``, a PassiveMeshSDF's ``vals4``, ``minv``,
``origin``, ``h`` with its meta ``dims`` and ``near_lanes``, or a
PassiveMeshExact's ``tri_abc``, ``nrm``, ``face_table``, ``face_count``,
``tet_count``, ``origin``, ``h`` with ``dims``, ``capture_cells``,
``fallback_lanes`` and ``near_lanes`` (the JAX dataclasses' data and meta
fields; the kind named by ``kind``); ``collider_from_numpy`` a
TetMeshCollider's ``tets``, ``rest_verts``, ``faces``, ``vert_offset`` and
``cell_cap``; ``state_from_numpy`` takes the state's ``y`` and ``prev_active``
where the scene has contact rows (size 0 where they are None).
"""

from __future__ import annotations

import numpy as np
import torch

from admm_elastic_tpu_torch.collision.dynamic import TetMeshCollider
from admm_elastic_tpu_torch.collision.passive import (Floor, PassiveMeshExact, PassiveMeshSDF,
                                                       Sphere)
from admm_elastic_tpu_torch.forces import WindForce
from admm_elastic_tpu_torch.forces import wind_force_from_numpy as _wind_force
from admm_elastic_tpu_torch.ops.prox import check_model
from admm_elastic_tpu_torch.solvers.direct import DirectData
from admm_elastic_tpu_torch.solvers.gs import GSData
from admm_elastic_tpu_torch.solvers.pcg import PCGData
from admm_elastic_tpu_torch.system.elements import PinBatch, TetBatch, TriBatch
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


def _layout(d: dict, fields, device, dtype) -> dict:
    """The stencil fields of a stencil family, or the gather table of a gather
    family."""
    if d.get("stencil") is None:
        return dict(gather_idx=_i(d["gather_idx"], device, torch.int32))
    return {f: _f(d[f], device, dtype) for f in fields}


def tet_batch_from_numpy(d: dict, *, device, dtype: torch.dtype) -> TetBatch:
    check_model(d["model"])
    mu = _f(d["mu"], device, dtype)
    lam = _f(d["lam"], device, dtype)
    stencil = None if d.get("stencil") is None else _meta(d["stencil"])
    return TetBatch(
        inds=_i(d["inds"], device, torch.int32),
        Dlocal=_f(d["Dlocal"], device, dtype),
        vol=_f(d["vol"], device, dtype),
        weight=_f(d["weight"], device, dtype),
        mu=mu,
        lam=lam,
        kappa=_f(d["kappa"], device, dtype),
        bulk=lam + (2.0 / 3.0) * mu,
        stencil=stencil,
        model=d["model"],
        n_live=d.get("n_live"),
        **_layout(d, ("st_dl", "st_par", "st_dead"), device, dtype),
    )


def tri_batch_from_numpy(d: dict, *, device, dtype: torch.dtype) -> TriBatch:
    stencil = None
    if d.get("stencil") is not None:
        base, g0, g1, pats = d["stencil"]
        stencil = (int(base), int(g0), int(g1), tuple(tuple(int(v) for v in r) for r in pats))
    fields = {f: _f(d[f], device, dtype) for f in (
        "Dlocal", "area", "weight", "mu", "lam", "limit_min", "limit_max")}
    return TriBatch(
        inds=_i(d["inds"], device, torch.int32),
        stencil=stencil,
        model="linear",
        n_live=d.get("n_live"),
        **fields,
        **_layout(d, ("st_dl", "st_dead"), device, dtype),
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
        tris=tuple(tri_batch_from_numpy(t, device=device, dtype=dtype)
                   for t in d.get("tris", ())),
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
                      scale=_f(np.reshape(d["scale"], (-1, 1)), device, dtype),
                      mode=str(d.get("mode", "inv")), **kw)


def pcg_from_numpy(d: dict, *, device, dtype: torch.dtype) -> PCGData:
    def opt(name, conv, *args):
        return None if d.get(name) is None else conv(d[name], device, *args)

    return PCGData(
        ell_cols=_i(d["ell_cols"], device, torch.int32),
        ell_vals=_f(d["ell_vals"], device, dtype),
        diag_mass=_f(d["diag_mass"], device, dtype),
        diag_stiff=_f(d["diag_stiff"], device, dtype),
        diag_pin=_f(d["diag_pin"], device, dtype),
        agg=opt("agg", _i, torch.int32),
        agg_gather=opt("agg_gather", _i, torch.int32),
        coarse_inv=opt("coarse_inv", _f, dtype),
        bands=opt("bands", _f, dtype),
        perm=opt("perm", _i),
        iperm=opt("iperm", _i),
        band_offsets=tuple(int(o) for o in d.get("band_offsets", ())),
        band_circular=bool(d.get("band_circular", False)),
    )


def state_from_numpy(x, v, y=None, prev_active=None, *, device,
                     dtype: torch.dtype) -> SimState:
    y = np.zeros((0,)) if y is None else y
    prev_active = np.zeros((0,), dtype=bool) if prev_active is None else prev_active
    return SimState(x=_f(np.reshape(x, (-1, 3)), device, dtype),
                    v=_f(np.reshape(v, (-1, 3)), device, dtype),
                    y=_f(np.reshape(y, (-1,)), device, dtype),
                    prev_active=_i(np.reshape(prev_active, (-1,)), device, torch.bool))


def gs_from_numpy(d: dict, *, device, dtype: torch.dtype) -> GSData:
    return GSData(ell_cols=_i(d["ell_cols"], device, torch.int32),
                  ell_vals=_f(d["ell_vals"], device, dtype),
                  diag=_f(d["diag"], device, dtype),
                  colors=_i(d["colors"], device, torch.int32),
                  colors_mask=_i(d["colors_mask"], device, torch.bool))


def obstacle_from_numpy(d: dict):
    """An obstacle from its arrays: the geometry float64, as the obstacles
    hold numbers (the solver rounds it to its dtype at initialize), the
    integer tables in their own dtypes."""
    f64 = lambda k: np.asarray(d[k], dtype=np.float64)  # noqa: E731
    if d["kind"] == "Floor":
        return Floor(y=f64("y"))
    if d["kind"] == "Sphere":
        return Sphere(center=f64("center"), rad=f64("rad"))
    if d["kind"] == "PassiveMeshSDF":
        return PassiveMeshSDF(vals4=f64("vals4"), minv=f64("minv"), origin=f64("origin"),
                              h=f64("h"), dims=tuple(int(v) for v in d["dims"]),
                              near_lanes=int(d.get("near_lanes", 0)))
    if d["kind"] == "PassiveMeshExact":
        return PassiveMeshExact(
            tri_abc=f64("tri_abc"), nrm=f64("nrm"), face_table=np.asarray(d["face_table"]),
            face_count=np.asarray(d["face_count"], dtype=np.int32),
            tet_count=np.asarray(d["tet_count"], dtype=np.int8), origin=f64("origin"),
            h=f64("h"), dims=tuple(int(v) for v in d["dims"]),
            capture_cells=float(d.get("capture_cells", 2.0)),
            fallback_lanes=int(d.get("fallback_lanes", 128)),
            near_lanes=int(d.get("near_lanes", 0)))
    raise ValueError(f"obstacle_from_numpy: unknown kind {d['kind']!r}")


def collider_from_numpy(d: dict) -> TetMeshCollider:
    """A self-collision collider from its arrays: the rest vertices in their
    own float dtype (the solver rounds them to its dtype at initialize), the
    tets (global) and faces (local) int32."""
    rest = np.array(d["rest_verts"])
    return TetMeshCollider(tets=torch.as_tensor(np.array(d["tets"], dtype=np.int32)),
                           rest_verts=torch.as_tensor(rest),
                           faces=torch.as_tensor(np.array(d["faces"], dtype=np.int32)),
                           vert_offset=int(d["vert_offset"]),
                           cell_cap=int(d.get("cell_cap", 24)))


def wind_force_from_numpy(d: dict, *, device, dtype: torch.dtype) -> WindForce:
    return _wind_force(d["tris"], d["direction"], d.get("color_tris"), d.get("color_mask"),
                       device=device, dtype=dtype, alpha_n=float(d.get("alpha_n", 1000.0)),
                       sequential=bool(d.get("sequential", False)))
