"""Dynamic (self) collision: query vertices against a deforming tet mesh.

A port of ``admm_elastic_tpu/collision/dynamic.py`` (:26-316; the reference's
TetMeshCollision, src/DynamicObject.hpp:33-119). Per query vertex:

1. point-in-tet at the current pose, skipping the tets that hold the query
   vertex; the winner is the lowest tet index (all tets below
   ``BROADPHASE_MIN_TETS``, else the hash-grid candidates of
   ``_broad_phase_candidates``);
2. the hit point mapped to the rest pose by its barycentrics;
3. the hits compacted in query order to ``HIT_CAP`` (``hit_overflow`` beyond);
4. the nearest rest-pose surface triangle (Ericson's closest point), skipping
   the faces that hold the query vertex; the first of least distance;
5. the face (global ids), its closest point's barycentrics, the rest face's
   normal and dx = -distance.

``detect_dynamic`` is the plain version, in PyTorch on any device, every sum
written out in the order that kernel K (``csrc/self_collision.cu``,
``ops/cuda_dynamic.dyn_detect``) repeats: the kernel is bitwise this on the
card. ``merge`` takes a collider's hits into the solver's dynamic rows as the
JAX package's ``_detect`` does (admm_elastic_tpu/solver.py:112-130): the first
collider's hit per vertex, the overflows ORed. ``BROADPHASE_MIN_TETS``,
``HIT_CAP`` and ``CELL_CAP`` are read at call time, so a test may set them.
The collider's arrays are numpy-built and go to the solver's device and dtype
at ``initialize`` (``TetMeshCollider.to``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admm_elastic_tpu_torch.ops.soa import det3, inv3

BROADPHASE_MIN_TETS = 32768
CELL_CAP = 24
HIT_CAP = 2048
_HASH = (73856093, 19349663, 83492791)  # Teschner et al. spatial hashing
QUERY_CHUNK = 256  # queries per pass of the plain point-in-tet (bounds its memory)


@dataclasses.dataclass(frozen=True)
class TetMeshCollider:
    """Self-collision object for one tet mesh placed in the global DOF array."""

    tets: torch.Tensor  # i32 [T, 4] GLOBAL vertex indices
    rest_verts: torch.Tensor  # [V, 3] local rest positions
    faces: torch.Tensor  # i32 [F, 3] LOCAL surface face indices (rest winding)
    vert_offset: int  # global index of local vertex 0
    # per-cell candidate capacity of the hash-grid broad phase (_rest_cell_cap)
    cell_cap: int = CELL_CAP

    @property
    def n_tets(self) -> int:
        return self.tets.shape[0]

    def to(self, device, dtype) -> "TetMeshCollider":
        """On device, the rest vertices in dtype."""
        return dataclasses.replace(self, tets=self.tets.to(device),
                                   rest_verts=self.rest_verts.to(device=device, dtype=dtype),
                                   faces=self.faces.to(device))


def _rest_cell_cap(rest_verts: np.ndarray, tets: np.ndarray) -> int:
    """3x the max rest-pose tet-center count per grid cell, in [16, 64]
    (the JAX package's numpy, int64 keys)."""
    x4 = rest_verts[tets]
    ext = (x4.max(axis=1) - x4.min(axis=1)).max()
    if ext <= 0:
        return CELL_CAP
    centers = x4.mean(axis=1)
    cells = np.floor((centers - centers.min(axis=0)) / ext).astype(np.int64)
    key = (cells[:, 0] * 73856093) ^ (cells[:, 1] * 19349663) ^ (cells[:, 2] * 83492791)
    _, counts = np.unique(key, return_counts=True)
    return int(np.clip(3 * counts.max(), 16, 64))


def make_tet_mesh_collider(rest_verts, tets, faces, vert_offset: int,
                           dtype=torch.float64) -> TetMeshCollider:
    """The collider of a tet mesh whose local vertex 0 is global vertex
    vert_offset; faces local. dtype (torch or numpy) of the rest vertices,
    float64 as in the JAX package; a solver takes it to its own dtype."""
    rest_np = np.asarray(rest_verts, dtype=np.float64)
    tets_np = np.asarray(tets, dtype=np.int64)
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    return TetMeshCollider(
        cell_cap=_rest_cell_cap(rest_np, tets_np),
        tets=torch.as_tensor(tets_np + int(vert_offset)).to(torch.int32),
        rest_verts=torch.as_tensor(rest_np).to(dtype),
        faces=torch.as_tensor(np.asarray(faces, dtype=np.int64)).to(torch.int32),
        vert_offset=int(vert_offset),
    )


def _dot(a, b):
    """a . b over the last axis of 3, in component order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _norm(a):
    """|a| as sqrt of the component sum in order."""
    return torch.sqrt(_dot(a, a))


def _nonzero(d):
    """d, or 1 where |d| < 1e-30 (the JAX package's division guards)."""
    return torch.where(torch.abs(d) < 1e-30, 1.0, d)


def _closest_point_triangle(p, a, b, c):
    """Closest point on triangle abc to p (Ericson; shapes broadcast):
    (closest [..., 3], bary [..., 3])."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = _nonzero((va + vb) + vc)
    v = vb / denom
    w = vc / denom
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t_ab = d1 / _nonzero(d1 - d3)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t_ac = d2 / _nonzero(d2 - d6)
    d43, d56 = d4 - d3, d5 - d6
    on_bc = (va <= 0) & (d43 >= 0) & (d56 >= 0)
    t_bc = d43 / _nonzero(d43 + d56)
    zero, one = torch.zeros_like(v), torch.ones_like(v)
    v = torch.where(on_bc, 1.0 - t_bc, v)
    w = torch.where(on_bc, t_bc, w)
    v = torch.where(on_ac, zero, v)
    w = torch.where(on_ac, torch.clamp(t_ac, 0.0, 1.0), w)
    v = torch.where(on_ab, torch.clamp(t_ab, 0.0, 1.0), v)
    w = torch.where(on_ab, zero, w)
    v = torch.where(in_c, zero, v)
    w = torch.where(in_c, one, w)
    v = torch.where(in_b, one, v)
    w = torch.where(in_b, zero, w)
    v = torch.where(in_a, zero, v)
    w = torch.where(in_a, zero, w)
    v = torch.clamp(v, 0.0, 1.0)
    w = torch.minimum(torch.clamp_min(w, 0.0), torch.clamp_min(1.0 - v, 0.0))
    closest = (a + v[..., None] * ab) + w[..., None] * ac
    bary = torch.stack([(1.0 - v) - w, v, w], dim=-1)
    return closest, bary


def _cell_keys(c):
    """The int32 hash of integer cells [..., 3] (wrapping, as jnp int32)."""
    return (c[..., 0] * _HASH[0]) ^ (c[..., 1] * _HASH[1]) ^ (c[..., 2] * _HASH[2])


def _broad_phase_candidates(x4, query_pts, cap: int = CELL_CAP):
    """Hash-grid candidates: (i64 [H, 27 cap] tet ids, T the miss pad; bool
    [H] overflow). The cell is the largest tet extent, so a tet holding a
    point has its centre within one cell of it and the 27 cells around the
    point's are exhaustive; a cell holding more than cap centres overflows
    (the slot past the window still matches its key). The key sort is
    stable, as jnp.argsort."""
    t = x4.shape[0]
    dev = x4.device
    centers = torch.mean(x4, dim=1)
    lo = torch.amin(x4, dim=(0, 1))
    ext = torch.amax(x4, dim=1) - torch.amin(x4, dim=1)
    cell = torch.clamp_min(torch.amax(ext), 1e-12)
    inv_cell = 1.0 / cell
    keys = _cell_keys(torch.floor((centers - lo) * inv_cell).to(torch.int32))
    order = torch.argsort(keys, stable=True)
    keys_sorted = keys[order]
    qc = torch.floor((query_pts - lo) * inv_cell).to(torch.int32)
    r = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(27, 3)
    nb_keys = _cell_keys(qc[:, None, :] + offs[None])  # [H, 27]
    start = torch.searchsorted(keys_sorted, nb_keys.reshape(-1)).reshape(nb_keys.shape)
    sl = start[..., None] + torch.arange(cap, device=dev)
    sl_c = torch.clamp_max(sl, t - 1)
    match = (keys_sorted[sl_c] == nb_keys[..., None]) & (sl < t)
    cand = torch.where(match, order[sl_c], t)
    past = torch.clamp_max(start + cap, t - 1)
    over = torch.any((keys_sorted[past] == nb_keys) & (start + cap < t), dim=-1)
    return cand.reshape(query_pts.shape[0], -1), over


def tet_frames(collider: TetMeshCollider, x):
    """Each tet's inverse edge matrix [T, 3, 3], first corner [T, 3] and
    guard (|det| > 1e-30) at the positions x [N, 3], the identity where the
    guard fails."""
    x4 = x[collider.tets.long()]
    e = torch.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], dim=-1)
    safe = torch.abs(det3(e)) > 1e-30
    eye = torch.eye(3, dtype=e.dtype, device=e.device)
    return x4, inv3(torch.where(safe[:, None, None], e, eye)), x4[:, 0], safe


def _bary4(einv, base, q):
    """The barycentrics (b0, b1, b2, b3) of q in tets (broadcast): b = einv
    (q - base) by rows in component order, b0 = 1 - ((b1 + b2) + b3)."""
    d = q - base
    b = [(einv[..., i, 0] * d[..., 0] + einv[..., i, 1] * d[..., 1]) + einv[..., i, 2] * d[..., 2]
         for i in range(3)]
    return torch.stack([1.0 - ((b[0] + b[1]) + b[2]), b[0], b[1], b[2]], dim=-1)


def point_in_tet(collider: TetMeshCollider, x, query_pts, query_vidx, cand=None):
    """(hit [H], hit_tet [H] i64, bary4 [H, 4]): the lowest tet that holds
    each query point and not the query vertex, over every tet (cand None)
    or over the candidate rows cand [H, C] (T the pad)."""
    _, einv, base, safe = tet_frames(collider, x)
    tets = collider.tets.long()
    t_total = tets.shape[0]
    hits, tet_ids, barys = [], [], []
    for lo in range(0, query_pts.shape[0], QUERY_CHUNK):
        q = query_pts[lo:lo + QUERY_CHUNK]
        qv = query_vidx[lo:lo + QUERY_CHUNK].long()
        if cand is None:
            ids = torch.arange(t_total, device=x.device).expand(q.shape[0], t_total)
            real = torch.ones_like(ids, dtype=torch.bool)
        else:
            c = cand[lo:lo + QUERY_CHUNK]
            real = c < t_total
            ids = torch.clamp_max(c, t_total - 1)
        b4 = _bary4(einv[ids], base[ids], q[:, None, :])
        inside = torch.all(b4 >= 0.0, dim=-1) & safe[ids] & real
        inside &= ~torch.any(tets[ids] == qv[:, None, None], dim=-1)
        pick = torch.amin(torch.where(inside, ids, t_total), dim=-1)  # the lowest tet id
        slot = torch.argmin(torch.where(inside, ids, t_total), dim=-1)
        hits.append(pick < t_total)
        tet_ids.append(torch.clamp_max(pick, t_total - 1))
        barys.append(b4[torch.arange(q.shape[0], device=x.device), slot])
    if not hits:
        z = query_pts.new_zeros((0,))
        return z.to(torch.bool), z.to(torch.int64), query_pts.new_zeros((0, 4))
    return torch.cat(hits), torch.cat(tet_ids), torch.cat(barys)


def nearest_face(collider: TetMeshCollider, rest_x, local_q):
    """(face index [K], bary [K, 3], distance [K]) of the nearest rest
    surface triangle to each rest point, the faces holding the local query
    vertex at the dtype's max: the first of least distance (argmin)."""
    faces = collider.faces.long()
    rv = collider.rest_verts
    fa, fb, fc = rv[faces[:, 0]], rv[faces[:, 1]], rv[faces[:, 2]]
    big = torch.finfo(rest_x.dtype).max
    idx, bar, dist = [], [], []
    for lo in range(0, rest_x.shape[0], QUERY_CHUNK):
        p = rest_x[lo:lo + QUERY_CHUNK]
        closest, bary = _closest_point_triangle(p[:, None, :], fa[None], fb[None], fc[None])
        d = _norm(closest - p[:, None, :])
        has_q = torch.any(faces[None] == local_q[lo:lo + QUERY_CHUNK, None, None], dim=-1)
        d = torch.where(has_q, big, d)
        f = torch.argmin(d, dim=-1)
        rows = torch.arange(p.shape[0], device=p.device)
        idx.append(f)
        bar.append(bary[rows, f])
        dist.append(d[rows, f])
    if not idx:
        return (torch.zeros((0,), dtype=torch.int64, device=rest_x.device),
                rest_x.new_zeros((0, 3)), rest_x.new_zeros((0,)))
    return torch.cat(idx), torch.cat(bar), torch.cat(dist)


def face_normals(collider: TetMeshCollider, face_idx):
    """The rest normals of the faces face_idx, over max(|n|, 1e-30)."""
    rv = collider.rest_verts
    f = collider.faces.long()[face_idx]
    n = _cross(rv[f[:, 1]] - rv[f[:, 0]], rv[f[:, 2]] - rv[f[:, 0]])
    return n / torch.clamp_min(_norm(n), 1e-30)[:, None]


def detect_dynamic(collider: TetMeshCollider, x, query_pts, query_vidx):
    """Detect self-collisions of the query vertices against one tet mesh.

    x: [N, 3] all current positions; query_pts: [H, 3] the query vertices'
    positions; query_vidx: [H] their global indices. Returns dict(mask [H],
    face [H, 3] global, barys [H, 3], normal [H, 3], dx [H], broad_overflow
    [H], hit_overflow []); face, barys and normal are 0 and dx the dtype's max
    off the mask.
    """
    tets = collider.tets.long()
    t_total = tets.shape[0]
    h_total = query_pts.shape[0]
    dev, dtype = x.device, x.dtype
    if t_total > BROADPHASE_MIN_TETS:
        cand, broad_overflow = _broad_phase_candidates(x[tets], query_pts, collider.cell_cap)
    else:
        cand, broad_overflow = None, torch.zeros((h_total,), dtype=torch.bool, device=dev)
    hit_any, hit_tet, bary4 = point_in_tet(collider, x, query_pts, query_vidx, cand)
    # the hits in query order, at most HIT_CAP; those beyond lose their hit
    hc = min(h_total, HIT_CAP)
    rank = torch.cumsum(hit_any.to(torch.int64), 0) - 1
    in_cap = hit_any & (rank < hc)
    hit_overflow = torch.sum(hit_any) > hc
    sel = torch.nonzero(in_cap).reshape(-1)  # a host read: the plain version only
    rest4 = collider.rest_verts[tets[hit_tet[sel]] - collider.vert_offset]  # [K, 4, 3]
    b = bary4[sel]
    rest_x = (((b[:, 0, None] * rest4[:, 0] + b[:, 1, None] * rest4[:, 1])
               + b[:, 2, None] * rest4[:, 2]) + b[:, 3, None] * rest4[:, 3])
    f, near_bary, near_d = nearest_face(collider, rest_x,
                                        query_vidx.long()[sel] - collider.vert_offset)
    big = torch.finfo(dtype).max
    face = torch.zeros((h_total, 3), dtype=torch.int64, device=dev)
    face[sel] = collider.faces.long()[f] + collider.vert_offset
    barys = torch.zeros((h_total, 3), dtype=dtype, device=dev)
    barys[sel] = near_bary
    normal = torch.zeros((h_total, 3), dtype=dtype, device=dev)
    normal[sel] = face_normals(collider, f)
    dx = torch.full((h_total,), big, dtype=dtype, device=dev)
    dx[sel] = -near_d
    return dict(mask=in_cap, face=face, barys=barys, normal=normal, dx=dx,
                broad_overflow=broad_overflow, hit_overflow=hit_overflow)


def merge(rows, res):
    """A collider's detection into the dynamic rows (d_mask, d_face, d_barys,
    d_normal): its hit where the vertex has none yet (the first collider's
    hit per vertex). Returns the new rows and the detection's overflow (a
    cell capacity or HIT_CAP) as a bool scalar."""
    d_mask, d_face, d_barys, d_normal = rows
    take = res["mask"] & ~d_mask
    out = (d_mask | res["mask"], torch.where(take[:, None], res["face"], d_face),
           torch.where(take[:, None], res["barys"], d_barys),
           torch.where(take[:, None], res["normal"], d_normal))
    return out, torch.any(res["broad_overflow"]) | res["hit_overflow"]
