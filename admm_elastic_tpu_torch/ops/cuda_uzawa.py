"""Wrappers of Uzawa's Schur trip on the card, ``csrc/uzawa.cu``: kernel L's
full C^T in one launch (``ct_apply``) and kernel M, a trip's update in one
launch (``schur_trip``). Neither has a Pallas original: together they replace
the plain PyTorch of a trip of ``solvers/uzawa.py`` (the port of the jnp body
of ``admm_elastic_tpu/solvers/uzawa.py:41-125``) around its A^-1 apply.

``ct_apply(hits, ck, y, n_verts, slot_of)`` is C^T [y[:H]; y[H:]] -> [N, 3],
bit for bit ``constraints.Ct_apply`` (its plain twin ``ct_plain``); slot_of
(i32 [N], each vertex's query slot, -1 for none) is needed on the card where
the query set is not every vertex.

``schur_trip(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)`` is one trip's
update from q2 = A^-1 C^T d (``schur_trip_plain``, the twin): q3 = C q2 on
the active rows, the four dots (``fixed_dot``), alpha and beta, x, y, r and d,
the trips taken k and the exit flag done, all left as they were where done is
set. On the card x, y, r, d, k and done are updated in place and returned; on
the CPU the twin returns new tensors.

``fixed_dot`` sums a * b in the order kernel M does: each product in the
tensors' dtype, element i to partial i mod PARTS, added in index order from
+0, then a pairwise tree over the PARTS partials (partial t plus partial t +
512, then + 256, ..., + 1); the partials and the tree in float64, the sum
rounded to the dtype once. A float32 run's dots are then all but exact, which
the Schur CG's alpha and beta want; a float64 run's are summed in its own
type.
The order depends on the length alone, so the CPU, the card's eager loop,
its graph and the traced solve compute one sum.

Scene forms (scenario batching, ``parallel/batch.py``; ``solvers/uzawa.
solve_scenes``): ``ct_apply_scenes`` and ``schur_trip_scenes`` take the
passive rows of S scenes on a shared query set (``solvers/alcg.scene_hits``:
mask [S, H], normal [S, H, 3]) and y, r, d [S, 2H], q2 and x [S, N, 3], k
and done [S]; scene i is bit for bit the single-scene launch on scene i's
tensors (``scene_of``), and a scene's done freezes it alone. L's is one
launch, a scene on the grid's y; M's one cooperative launch of teams of
blocks (``scene_teams``), each team on its own barrier taking its scenes in
turn, so any S runs on a grid the card holds at once. Their twins
``ct_plain_scenes`` and ``schur_trip_plain_scenes`` (its dots by
``fixed_dot_scenes``) are bit for bit the single-scene twins scene by scene.
Dynamic rows in a batch raise (ROADMAP Queue 1 item 12b).

Dispatch is by the tensors' device: CPU tensors take the plain twins, CUDA
tensors the kernels, and a build or launch failure raises. Each wrapper's
``launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from admm_elastic_tpu_torch.collision import constraints as con
from admm_elastic_tpu_torch.ops import _build
from admm_elastic_tpu_torch.ops.cuda_dynamic import _check
from admm_elastic_tpu_torch.ops.cuda_obstacle import BARRIER_INTS, addresses

PARTS = 1024  # csrc/uzawa.cu kParts: the dots' partials, M's threads a block


def fixed_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) as a 0-d tensor, in the fixed order of the module docstring.
    The zeros that pad the last row of partials change no bit: a partial that
    starts from +0 is never -0, and x + 0 is x for every other x."""
    prod = (a * b).reshape(-1)
    n = prod.numel()
    acc = torch.zeros((PARTS,), dtype=torch.float64, device=prod.device)
    rows = -(-n // PARTS)
    if rows:
        padded = torch.cat([prod, prod.new_zeros((rows * PARTS - n,))]).reshape(rows, PARTS)
        for j in range(rows):
            acc = acc + padded[j].double()
    while acc.numel() > 1:
        half = acc.numel() // 2
        acc = acc[:half] + acc[half:]
    return acc.to(prod.dtype).reshape(())


def fixed_dot_scenes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fixed_dot of each scene: a, b [S, ...] -> [S], scene i's sum in the
    order fixed_dot takes on a[i], b[i] (the same float64 additions, made
    for every scene at once)."""
    s_cnt = a.shape[0]
    prod = (a * b).reshape(s_cnt, -1)
    n = prod.shape[1]
    acc = torch.zeros((s_cnt, PARTS), dtype=torch.float64, device=prod.device)
    rows = -(-n // PARTS)
    if rows:
        padded = torch.cat([prod, prod.new_zeros((s_cnt, rows * PARTS - n))], dim=1)
        padded = padded.reshape(s_cnt, rows, PARTS)
        for j in range(rows):
            acc = acc + padded[:, j].double()
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc.to(prod.dtype).reshape(s_cnt)


def _passive_only(name, hits: con.Hits) -> None:
    if hits.may_dyn:
        raise ValueError(f"{name}: dynamic rows in a batch are not ported (ROADMAP Queue 1 "
                         "item 12b)")


def scene_of(hits: con.Hits, i: int) -> con.Hits:
    """Scene i's rows of hits with a leading scene axis (solvers/alcg.
    scene_hits: the passive rows [S, H], the query set shared) as the hits
    of one scene."""
    _passive_only("scene_of", hits)
    return dataclasses.replace(
        hits, p_mask=hits.p_mask[i], p_normal=hits.p_normal[i], p_point=hits.p_point[i],
        d_mask=hits.d_mask[i], d_face=hits.d_face[i], d_barys=hits.d_barys[i],
        d_normal=hits.d_normal[i], overflow=hits.overflow[i])


def ct_plain(hits: con.Hits, ck, y, n_verts: int) -> torch.Tensor:
    """Kernel L's full C^T twin: constraints.Ct_apply with the plain gather."""
    h = hits.capacity
    return con.Ct_apply(hits, ck, y[:h], y[h:], n_verts, gather=con.dyn_gather_plain)


def schur_trip_plain(hits: con.Hits, ck, q2, x, y, r, d, k, done, tiny: float, tol2: float):
    """Kernel M's twin: the trip body of solvers/uzawa.py on q2 = A^-1 C^T d
    with fixed_dot. Returns the new (x, y, r, d, k, done)."""
    rp, rd = con.C_apply(hits, ck, q2)
    q3 = torch.where(torch.cat([hits.p_mask, hits.d_mask]), torch.cat([rp, rd]), 0.0)
    denom = fixed_dot(d, q3)
    bad = torch.abs(denom) < tiny
    safe = torch.where(bad, torch.ones_like(denom), denom)
    alpha = torch.where(bad, torch.zeros_like(denom), fixed_dot(d, r) / safe)
    x_n = x - alpha * q2
    y_n = y + alpha * d
    r_n = r - alpha * q3
    small = fixed_dot(r_n, r_n) < tol2
    beta = torch.where(bad, torch.zeros_like(denom), fixed_dot(r_n, q3) / safe)
    d_n = r_n - beta * d
    go = ~done
    return (torch.where(go, x_n, x), torch.where(go, y_n, y), torch.where(go, r_n, r),
            torch.where(go, d_n, d), k + go.to(torch.int32), done | bad | small)


def ct_plain_scenes(hits: con.Hits, ck, y, n_verts: int) -> torch.Tensor:
    """L's scene form's twin: C^T of each scene's passive rows (hits of
    alcg.scene_hits) on y [S, 2H] -> [S, N, 3]; scene i bit for bit ct_plain
    on scene_of(hits, i) and y[i] (the same elementwise operations)."""
    _passive_only("ct_plain_scenes", hits)
    h = hits.p_mask.shape[1]
    yp = torch.where(hits.p_mask, y[:, :h], 0.0)
    p_part = (ck * yp)[..., None] * hits.p_normal
    if hits.dense:
        return p_part
    out = p_part.new_zeros((y.shape[0], n_verts, 3))
    return out.index_copy(1, hits.p_vidx, p_part)


def schur_trip_plain_scenes(hits: con.Hits, ck, q2, x, y, r, d, k, done, tiny: float,
                            tol2: float):
    """M's scene form's twin: schur_trip_plain of every scene at once (q2, x
    [S, N, 3], y, r, d [S, 2H], k and done [S]; the passive rows of
    alcg.scene_hits), the dots by fixed_dot_scenes: scene i bit for bit
    schur_trip_plain on its tensors. Returns the new (x, y, r, d, k, done)."""
    _passive_only("schur_trip_plain_scenes", hits)
    mask = hits.p_mask
    q2p = q2 if hits.dense else q2[:, hits.p_vidx]
    rp = torch.where(mask, ck * con._dot3(hits.p_normal, q2p), 0.0)
    q3 = torch.where(torch.cat([mask, hits.d_mask], dim=1),
                     torch.cat([rp, torch.zeros_like(rp)], dim=1), 0.0)
    denom = fixed_dot_scenes(d, q3)
    bad = torch.abs(denom) < tiny
    safe = torch.where(bad, torch.ones_like(denom), denom)
    alpha = torch.where(bad, torch.zeros_like(denom), fixed_dot_scenes(d, r) / safe)
    x_n = x - alpha[:, None, None] * q2
    y_n = y + alpha[:, None] * d
    r_n = r - alpha[:, None] * q3
    small = fixed_dot_scenes(r_n, r_n) < tol2
    beta = torch.where(bad, torch.zeros_like(denom), fixed_dot_scenes(r_n, q3) / safe)
    d_n = r_n - beta[:, None] * d
    go = ~done
    g1, g2 = go[:, None], go[:, None, None]
    return (torch.where(g2, x_n, x), torch.where(g1, y_n, y), torch.where(g1, r_n, r),
            torch.where(g1, d_n, d), k + go.to(torch.int32), done | bad | small)


ROW_FIELDS = ("p_mask", "p_vidx", "p_normal", "d_mask", "d_vidx", "d_face", "d_barys",
              "d_normal")


def contiguous_hits(hits: con.Hits) -> con.Hits:
    """hits with the fields the kernels read made contiguous (a detection
    may hand over a view: a Floor's normals are one row expanded), once a
    solve and not once a launch."""
    return dataclasses.replace(hits, **{f: getattr(hits, f).contiguous() for f in ROW_FIELDS})


def _rows(name, hits: con.Hits, ck, lead, n: int):
    """The rows as csrc/uzawa.cu rows_of takes them (the slot left null),
    checked against lead (a CUDA tensor of the run dtype); returns (pointers,
    suffix)."""
    h = hits.capacity
    sfx = _build.cuda_args(name, lead, (("p_normal", hits.p_normal, (h, 3)),
                                        ("d_barys", hits.d_barys, (h, 3)),
                                        ("d_normal", hits.d_normal, (h, 3)),
                                        ("ck", ck.reshape(1), (1,))))
    dev = lead.device
    fields = [("p_mask", hits.p_mask, torch.bool, (h,)), ("p_vidx", hits.p_vidx, torch.int64, (h,)),
              ("d_mask", hits.d_mask, torch.bool, (h,)), ("d_vidx", hits.d_vidx, torch.int64, (h,)),
              ("d_face", hits.d_face, torch.int64, (h, 3))]
    if hits.may_dyn:
        if hits.d_order is None:
            raise ValueError(f"{name}: dynamic rows without their table (constraints.with_table)")
        fields += [("d_order", hits.d_order, torch.int64, (3 * h,)),
                   ("d_start", hits.d_start, torch.int64, (n + 1,))]
    for field, t, dtype, shape in fields:
        _check(f"{name}: {field}", t, dtype, shape, dev)
    order, start = (hits.d_order, hits.d_start) if hits.may_dyn else (None, None)
    return [hits.p_mask, hits.p_vidx, hits.p_normal, hits.d_mask, hits.d_vidx, hits.d_face,
            hits.d_barys, hits.d_normal, ck, order, start, None], sfx


def ct_apply(hits: con.Hits, ck: torch.Tensor, y: torch.Tensor, n_verts: int,
             slot_of=None) -> torch.Tensor:
    """Kernel L: C^T [y[:H]; y[H:]] -> [N, 3] (see the module docstring)."""
    if y.device.type == "cpu":
        return ct_plain(hits, ck, y, n_verts)
    h = hits.capacity
    _check("ct_apply: y", y, y.dtype, (2 * h,), y.device)
    ptrs, sfx = _rows("ct_apply", hits, ck, y, n_verts)
    if hits.dense:
        if h != n_verts:
            raise ValueError(f"ct_apply: a dense query set of {h} rows for {n_verts} vertices")
    elif slot_of is None:
        raise ValueError("ct_apply: the query set is not every vertex: slot_of is needed")
    else:
        _check("ct_apply: slot_of", slot_of, torch.int32, (n_verts,), y.device)
        ptrs[-1] = slot_of
    out = torch.empty((n_verts, 3), dtype=y.dtype, device=y.device)
    ptr_arr = (ctypes.c_uint64 * (len(ptrs) + 2))(*addresses(ptrs + [y, out]))
    ints = (ctypes.c_int * 3)(n_verts, h, int(hits.may_dyn))
    fn = getattr(_build.library(), f"admm_uzawa_ct_{sfx}")
    with torch.cuda.device(y.device):
        rc = fn(ptr_arr, ints, torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "ct_apply")
    ct_apply.launches += 1
    return out


_MAX_BLOCKS: dict = {}  # (device, dtype) -> the most blocks of M's grid at once
_BARRIERS: dict = {}  # device -> M's grid barrier


def max_blocks(device, dtype) -> int:
    key = (device, dtype)
    if key not in _MAX_BLOCKS:
        with torch.cuda.device(device):
            got = int(_build.library().admm_schur_blocks(int(dtype == torch.float64)))
        if got <= 0:
            raise RuntimeError(f"schur_trip: the card holds no block of M's grid (cudaError "
                               f"{-got})")
        _MAX_BLOCKS[key] = got
    return _MAX_BLOCKS[key]


def _barrier(device):
    if device not in _BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("schur_trip: call it once on this device before a capture "
                               "(its grid barrier is allocated on the first call)")
        _BARRIERS[device] = torch.zeros((BARRIER_INTS,), dtype=torch.int32, device=device)
    return _BARRIERS[device]


def m_blocks(n: int, h: int, most: int) -> int:
    """M's blocks: a thread a row or an element of x, at most most."""
    return max(1, min(most, -(-max(2 * h, 3 * n) // PARTS)))


def schur_trip(hits: con.Hits, ck: torch.Tensor, q2, x, y, r, d, k, done, tiny: float,
               tol2: float, lib=None, blocks=None):
    """Kernel M: one Schur trip's update (see the module docstring). Returns
    (x, y, r, d, k, done): on the card the tensors handed in, updated in place.
    lib: a measurement's variant library (_build.variant), else the port's;
    blocks caps its cooperative grid (the bits do not depend on it)."""
    if q2.device.type == "cpu":
        return schur_trip_plain(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)
    n, h = int(q2.shape[0]), hits.capacity
    dev = q2.device
    _build.cuda_args("schur_trip", q2, (("q2", q2, (n, 3)), ("x", x, (n, 3)), ("y", y, (2 * h,)),
                                        ("r", r, (2 * h,)), ("d", d, (2 * h,))))
    _check("schur_trip: k", k, torch.int32, (), dev)
    _check("schur_trip: done", done, torch.bool, (), dev)
    ptrs, sfx = _rows("schur_trip", hits, ck, q2, n)
    if blocks is not None and blocks < 1:
        raise ValueError(f"schur_trip: blocks {blocks} < 1")
    grid = m_blocks(n, h, min(max_blocks(dev, q2.dtype), blocks or 1 << 30))
    scratch = torch.empty((4 * 2 * h,), dtype=q2.dtype, device=dev)  # q3, then [3, 2H]
    ptr_arr = (ctypes.c_uint64 * (len(ptrs) + 10))(*addresses(
        ptrs + [q2, x, y, r, d, scratch[:2 * h], k, done, scratch[2 * h:], _barrier(dev)]))
    ints = (ctypes.c_int * 4)(n, h, int(hits.may_dyn), grid)
    fn = getattr(lib or _build.library(), f"admm_schur_trip_{sfx}")
    with torch.cuda.device(dev):
        rc = fn(ptr_arr, ints, float(tiny), float(tol2), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "schur_trip")
    schur_trip.launches += 1
    return x, y, r, d, k, done


def _scene_rows(name, hits: con.Hits, ck, lead, s_cnt: int):
    """The passive rows of S scenes as csrc/uzawa.cu rows_of takes them
    (mask and normal [S, H], the query set shared; the dynamic fields
    unread), checked against lead; returns (pointers, suffix)."""
    _passive_only(name, hits)
    h = hits.p_mask.shape[1]
    sfx = _build.cuda_args(name, lead, (("p_normal", hits.p_normal, (s_cnt, h, 3)),
                                        ("ck", ck.reshape(1), (1,))))
    dev = lead.device
    _check(f"{name}: p_mask", hits.p_mask, torch.bool, (s_cnt, h), dev)
    _check(f"{name}: p_vidx", hits.p_vidx, torch.int64, (h,), dev)
    return [hits.p_mask, hits.p_vidx, hits.p_normal] + [None] * 5 + [ck, None, None, None], sfx


def ct_apply_scenes(hits: con.Hits, ck: torch.Tensor, y: torch.Tensor, n_verts: int,
                    slot_of=None) -> torch.Tensor:
    """Kernel L's scene form: C^T of each scene's passive rows (hits of
    alcg.scene_hits) on y [S, 2H] -> [S, N, 3], one launch; scene i bit for
    bit ct_apply on its rows. Twin: ct_plain_scenes."""
    if y.device.type == "cpu":
        return ct_plain_scenes(hits, ck, y, n_verts)
    s_cnt, h = int(y.shape[0]), hits.p_mask.shape[1]
    _check("ct_apply_scenes: y", y, y.dtype, (s_cnt, 2 * h), y.device)
    ptrs, sfx = _scene_rows("ct_apply_scenes", hits, ck, y, s_cnt)
    if hits.dense:
        if h != n_verts:
            raise ValueError(f"ct_apply_scenes: a dense query set of {h} rows for {n_verts} "
                             "vertices")
    elif slot_of is None:
        raise ValueError("ct_apply_scenes: the query set is not every vertex: slot_of is needed")
    else:
        _check("ct_apply_scenes: slot_of", slot_of, torch.int32, (n_verts,), y.device)
        ptrs[-1] = slot_of
    out = torch.empty((s_cnt, n_verts, 3), dtype=y.dtype, device=y.device)
    ptr_arr = (ctypes.c_uint64 * (len(ptrs) + 2))(*addresses(ptrs + [y, out]))
    ints = (ctypes.c_int * 3)(n_verts, h, s_cnt)
    fn = getattr(_build.library(), f"admm_uzawa_ct_scenes_{sfx}")
    with torch.cuda.device(y.device):
        rc = fn(ptr_arr, ints, torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(rc, "ct_apply_scenes")
    ct_apply_scenes.launches += 1
    return out


_SCENE_BLOCKS: dict = {}  # (device, dtype) -> the most blocks of M's scene form at once
_SCENE_BARRIERS: dict = {}  # device -> M's scene form's team barriers


def scene_max_blocks(device, dtype) -> int:
    key = (device, dtype)
    if key not in _SCENE_BLOCKS:
        with torch.cuda.device(device):
            got = int(_build.library().admm_schur_scene_blocks(int(dtype == torch.float64)))
        if got <= 0:
            raise RuntimeError(f"schur_trip_scenes: the card holds no block of M's scene form "
                               f"(cudaError {-got})")
        _SCENE_BLOCKS[key] = got
    return _SCENE_BLOCKS[key]


def _scene_barriers(device, teams: int):
    """M's scene form's team barriers (BARRIER_INTS ints each): one buffer a
    device, as many as its largest grid has teams, allocated on the first
    call, outside any capture."""
    if device not in _SCENE_BARRIERS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("schur_trip_scenes: call it once on this device before a capture "
                               "(its team barriers are allocated on the first call)")
        most = max(scene_max_blocks(device, torch.float32),
                   scene_max_blocks(device, torch.float64))
        _SCENE_BARRIERS[device] = torch.zeros((most * BARRIER_INTS,), dtype=torch.int32,
                                              device=device)
    return _SCENE_BARRIERS[device][:teams * BARRIER_INTS]


def scene_teams(s_cnt: int, per_scene: int, most: int) -> tuple:
    """(teams, blocks a team) of a scene form over S scenes: a team a scene
    up to the most blocks the card holds at once, the blocks a team
    per_scene (the single-scene grid) or fewer, so that teams x blocks <=
    most; a team takes its scenes in turn."""
    teams = max(1, min(s_cnt, most))
    return teams, max(1, min(per_scene, most // teams))


def schur_trip_scenes(hits: con.Hits, ck: torch.Tensor, q2, x, y, r, d, k, done, tiny: float,
                      tol2: float):
    """Kernel M's scene form: each scene's trip update (see schur_trip) in one
    cooperative launch of teams of blocks (scene_teams),
    q2, x [S, N, 3], y, r, d [S, 2H], k and done [S] updated in place and
    returned; scene i bit for bit schur_trip on its tensors, frozen by its own
    done. Twin: schur_trip_plain_scenes."""
    if q2.device.type == "cpu":
        return schur_trip_plain_scenes(hits, ck, q2, x, y, r, d, k, done, tiny, tol2)
    s_cnt, n, h = int(q2.shape[0]), int(q2.shape[1]), hits.p_mask.shape[1]
    dev = q2.device
    _build.cuda_args("schur_trip_scenes", q2, (
        ("q2", q2, (s_cnt, n, 3)), ("x", x, (s_cnt, n, 3)), ("y", y, (s_cnt, 2 * h)),
        ("r", r, (s_cnt, 2 * h)), ("d", d, (s_cnt, 2 * h))))
    _check("schur_trip_scenes: k", k, torch.int32, (s_cnt,), dev)
    _check("schur_trip_scenes: done", done, torch.bool, (s_cnt,), dev)
    ptrs, sfx = _scene_rows("schur_trip_scenes", hits, ck, q2, s_cnt)
    most = scene_max_blocks(dev, q2.dtype)
    teams, bps = scene_teams(s_cnt, m_blocks(n, h, most), most)
    q3 = torch.empty((s_cnt, 2 * h), dtype=q2.dtype, device=dev)
    prod = torch.empty((s_cnt, 3, 2 * h), dtype=q2.dtype, device=dev)  # two products and r
    ptr_arr = (ctypes.c_uint64 * (len(ptrs) + 10))(*addresses(
        ptrs + [q2, x, y, r, d, q3, k, done, prod, _scene_barriers(dev, teams)]))
    ints = (ctypes.c_int * 5)(n, h, s_cnt, teams, bps)
    fn = getattr(_build.library(), f"admm_schur_trip_scenes_{sfx}")
    with torch.cuda.device(dev):
        rc = fn(ptr_arr, ints, float(tiny), float(tol2), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "schur_trip_scenes")
    schur_trip_scenes.launches += 1
    return x, y, r, d, k, done


ct_apply.launches = 0
schur_trip.launches = 0
ct_apply_scenes.launches = 0
schur_trip_scenes.launches = 0
