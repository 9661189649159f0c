"""Passive obstacles as batched signed-distance evaluations.

A port of ``admm_elastic_tpu/collision/passive.py``: the analytic ``Floor``
and ``Sphere`` (:36-73; the reference's src/PassiveObject.hpp:32-64), the
mesh obstacles ``PassiveMeshSDF`` (a voxel SDF, :74-235) and
``PassiveMeshExact`` (the exact closest feature over a grid of candidate
triangles with a brute-force deep fallback, :238-666), Ericson's closest
point ``_pt_tri_closest`` (:669-715), ``detect_passive`` (:718-750) and the
numpy bake helpers (:753-818), copied. ``signed_distance(x)`` takes x
[..., 3] and returns (dx [...], point [..., 3], normal [..., 3]): dx < 0 is
penetration, point the surface projection and normal the outward contact
normal; a mesh obstacle's ``signed_distance_with_overflow`` adds the flag of
its fixed-capacity stages (near-lane compaction, the deep fallback).

The obstacles are frozen dataclasses of tensors. A Python number or a numpy
array is held as a float64 tensor, so that the solver's ``to(device, dtype)``
at ``initialize`` rounds it once, as the JAX package's ``astype`` at each use
does. A mesh obstacle keeps its integer tables as built, and its SDF's
``minv`` in float64: only its sign is read.

The mesh obstacles' methods here are the plain versions. On the card a
solver's detection runs them as kernel J (``ops/cuda_obstacle.py``) and its
Gauss-Seidel sweeps inside kernel H; both take the same steps in the same
order as the code below: the 8 SDF corners summed in corner order, every dot
product and norm in component order, the first candidate of least distance,
and the near lanes and the fallback lanes compacted in lane order (a stable
sort of the mask, as ``jax.lax.top_k`` orders a 0/1 mask).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from admm_elastic_tpu_torch.geometry.mesh import surface_faces_from_tets

BIG = 1e30  # a no-hit lane's distance (the JAX package's `big`)
FALLBACK_CHUNK = 64  # the deep fallback's lanes per brute-force pass over the soup


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.array(v, dtype=np.float64))


def _table(v) -> torch.Tensor:
    """An integer table as a tensor of its own dtype."""
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.array(v))


def norm3(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis: torch.linalg.norm, whose float64 result on the
    CPU is jnp.linalg.norm's bit for bit."""
    return torch.linalg.norm(d, dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, summed in component order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _unit(n: torch.Tensor) -> torch.Tensor:
    """n / max(|n|, 1e-30), the norm summed in component order."""
    return n / torch.clamp_min(torch.sqrt(dot3(n, n)), 1e-30)[..., None]


def _each_scene(fn, x):
    """fn(x[i]) of each scene of x [S, V, 3], its outputs stacked: a scene's
    compaction, fallback and overflow its own, as jax.vmap of the JAX
    package's method gives them (flattening the scenes together would pick
    the first K lanes of the whole batch)."""
    outs = [fn(x[i]) for i in range(x.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def _first_k(mask: torch.Tensor, k: int) -> torch.Tensor:
    """The lanes of jax.lax.top_k(mask, k) on a 0/1 mask: the set lanes in
    lane order, then the others in lane order, k in all."""
    return torch.argsort((~mask).to(torch.int8), stable=True)[:k]


@dataclasses.dataclass(frozen=True)
class Floor:
    """y-plane floor (src/PassiveObject.hpp:32-45)."""

    y: torch.Tensor  # scalar
    # the normal (0, 1, 0) on y's device, made once: a step captured as a CUDA
    # graph copies nothing from the host
    unit_y: torch.Tensor = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        y = _tensor(self.y)
        object.__setattr__(self, "y", y)
        object.__setattr__(self, "unit_y", torch.tensor([0.0, 1.0, 0.0], dtype=y.dtype,
                                                        device=y.device))

    def to(self, device, dtype) -> "Floor":
        return Floor(y=self.y.to(device=device, dtype=dtype))

    def signed_distance(self, x):
        dx = x[..., 1] - self.y
        point = torch.stack([x[..., 0], self.y.expand(x[..., 1].shape), x[..., 2]], dim=-1)
        # a constant broadcast, as the JAX package writes it
        normal = self.unit_y.to(x.dtype).expand(x.shape)
        return dx, point, normal


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Analytic sphere obstacle (src/PassiveObject.hpp:48-64)."""

    center: torch.Tensor  # [3]
    rad: torch.Tensor  # scalar

    def __post_init__(self):
        object.__setattr__(self, "center", _tensor(self.center))
        object.__setattr__(self, "rad", _tensor(self.rad))

    def to(self, device, dtype) -> "Sphere":
        return Sphere(center=self.center.to(device=device, dtype=dtype),
                      rad=self.rad.to(device=device, dtype=dtype))

    def signed_distance(self, x):
        dir_ = x - self.center
        dist = norm3(dir_)
        dx = dist - self.rad
        n = dir_ / torch.clamp_min(dist, 1e-30)[..., None]
        point = self.center + n * self.rad
        return dx, point, n


@dataclasses.dataclass(frozen=True)
class PassiveMeshSDF:
    """Voxel-grid SDF obstacle (the JAX package's PassiveMeshSDF).

    ``vals4`` [Gx*Gy*Gz, 4] holds (sdf, d/dx, d/dy, d/dz) at every lattice
    node; a query blends the 8 corner rows of its cell trilinearly, and its
    normal is the blended gradient, normalised. The projection point is
    x - dx * normal. ``minv[b]`` is the least value over the 8 corners of the
    cube based at node b (+inf where b cannot be a base): the blend is a
    convex combination of them, so a cell with minv >= 0 cannot hold a
    contact. With ``near_lanes`` = K (0 < K < lanes) only the first K lanes
    whose cell has minv < 0 are blended; every other lane reports no hit
    (dx = 1e30, a zero point and normal), and more than K such lanes set the
    overflow.
    """

    vals4: torch.Tensor  # [G, 4] packed (value, grad xyz) per node
    minv: torch.Tensor  # [G] float64
    origin: torch.Tensor  # [3]
    h: torch.Tensor  # scalar spacing
    dims: tuple  # (Gx, Gy, Gz)
    near_lanes: int = 0

    def __post_init__(self):
        for f in ("vals4", "minv", "origin", "h"):
            object.__setattr__(self, f, _tensor(getattr(self, f)))
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "near_lanes", int(self.near_lanes))

    def to(self, device, dtype) -> "PassiveMeshSDF":
        """On device, vals4, origin and h rounded to dtype once; minv stays
        float64 (a tiny negative value would round to -0 in float32)."""
        return dataclasses.replace(
            self, vals4=self.vals4.to(device=device, dtype=dtype),
            minv=self.minv.to(device=device, dtype=torch.float64),
            origin=self.origin.to(device=device, dtype=dtype),
            h=self.h.to(device=device, dtype=dtype))

    def signed_distance(self, x):
        dx, point, normal, _ = self.signed_distance_with_overflow(x)
        return dx, point, normal

    def cells(self, p):
        """(base [V] flat node ids, f [V, 3] in-cell fractions) of the lanes p
        [V, 3]: u = clip((p - origin) / h, 0, dims - 1.000001), the bound in
        p's dtype; a NaN lane takes cell 0 and keeps its NaN fractions."""
        dtype = p.dtype
        gx, gy, gz = self.dims
        top = (torch.tensor(self.dims, dtype=dtype, device=p.device)
               - torch.tensor(1.000001, dtype=dtype, device=p.device))
        u = (p - self.origin.to(dtype)) / self.h.to(dtype)
        u = torch.minimum(torch.clamp_min(u, 0.0), top)
        fl = torch.floor(u)
        i0 = torch.where(torch.isnan(fl), 0.0, fl).to(torch.int64)
        f = u - i0.to(dtype)
        base = (i0[:, 0] * gy + i0[:, 1]) * gz + i0[:, 2]
        return base, f

    def signed_distance_with_overflow(self, x, scenes: bool = False):
        """signed_distance plus the overflow flag (a 0-d bool): more near
        lanes than near_lanes. scenes: x [S, V, 3] is S scenes, each
        compacted on its own; the flag is then [S]."""
        if scenes:
            return _each_scene(self.signed_distance_with_overflow, x)
        dtype = x.dtype
        lead = x.shape[:-1]
        p = x.reshape(-1, 3)
        base, f = self.cells(p)
        k_near = self.near_lanes
        if 0 < k_near < p.shape[0]:
            near = self.minv[base] < 0
            sel = _first_k(near, k_near)
            sel_mask = near[sel]
            dx_k, n_k = self._blend(base[sel], f[sel], dtype)
            dx = torch.full((p.shape[0],), BIG, dtype=dtype, device=p.device)
            dx[sel] = torch.where(sel_mask, dx_k, BIG)
            n = torch.zeros_like(p)
            n[sel] = torch.where(sel_mask[:, None], n_k, 0.0)
            overflow = near.sum() > k_near
        else:
            dx, n = self._blend(base, f, dtype)
            overflow = torch.zeros((), dtype=torch.bool, device=p.device)
        point = p - dx[:, None] * n
        # a far compacted lane's point is garbage (dx = 1e30): zero it
        point = torch.where((dx < 1e29)[:, None], point, 0.0)
        return dx.reshape(lead), point.reshape(lead + (3,)), n.reshape(lead + (3,)), overflow

    def _blend(self, base, f, dtype):
        """The trilinear blend of the 8 corner rows of each lane's cell (dk
        fastest), summed in corner order: base [V], f [V, 3] -> (dx [V],
        unit normal [V, 3])."""
        gx, gy, gz = self.dims
        vals4 = self.vals4.to(dtype)
        last = vals4.shape[0] - 1
        wx = (1.0 - f[:, 0], f[:, 0])
        wy = (1.0 - f[:, 1], f[:, 1])
        wz = (1.0 - f[:, 2], f[:, 2])
        vals = None
        for di in (0, 1):
            for dj in (0, 1):
                for dk in (0, 1):
                    w = wx[di] * wy[dj] * wz[dk]
                    # a corner past the last node is clamped to it, as an XLA gather
                    # clamps (float32 can round dims - 1.000001 up to dims - 1)
                    row = torch.clamp_max(base + ((di * gy + dj) * gz + dk), last)
                    term = w[:, None] * vals4[row]
                    vals = term if vals is None else vals + term
        return vals[:, 0], _unit(vals[:, 1:])

    @staticmethod
    def from_grid(grid: np.ndarray, origin, h, near_lanes: int = 0):
        """Pack a raw [Gx, Gy, Gz] value grid: bake node gradients by
        central differences (one-sided at the boundary) into vals4."""
        grid = np.asarray(grid, dtype=np.float64)
        h = float(h)
        grad = np.stack(np.gradient(grid, h), axis=-1)  # [Gx, Gy, Gz, 3]
        vals4 = np.concatenate([grid[..., None], grad], axis=-1)
        # per-base-node cube minimum; bases on the +1 border are never indexed
        minv = np.full(grid.shape, np.inf)
        minv[:-1, :-1, :-1] = np.minimum.reduce([
            grid[di:di + grid.shape[0] - 1,
                 dj:dj + grid.shape[1] - 1,
                 dk:dk + grid.shape[2] - 1]
            for di in (0, 1) for dj in (0, 1) for dk in (0, 1)])
        return PassiveMeshSDF(
            vals4=vals4.reshape(-1, 4), minv=minv.reshape(-1),
            origin=np.asarray(origin, dtype=np.float64), h=np.asarray(h),
            dims=tuple(int(d) for d in grid.shape), near_lanes=int(near_lanes))

    @staticmethod
    def from_tet_mesh(verts: np.ndarray, tets: np.ndarray, resolution: int = 48, pad: float = 0.1,
                      near_lanes: int = 0):
        """A voxel SDF of a closed tet mesh (numpy): inside = in any tet,
        magnitude = the distance to the surface triangle soup."""
        verts = np.asarray(verts, dtype=np.float64)
        tets = np.asarray(tets, dtype=np.int64)
        lo = verts.min(axis=0) - pad
        hi = verts.max(axis=0) + pad
        h = float((hi - lo).max()) / (resolution - 1)
        dims = np.maximum(((hi - lo) / h).astype(int) + 2, 2)
        axes = [lo[i] + np.arange(dims[i]) * h for i in range(3)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)

        inside = _points_in_tets_np(pts, verts, tets)
        faces = surface_faces_from_tets(tets)
        dist = _point_tri_distance_np(pts, verts, faces)
        sdf = np.where(inside, -dist, dist).reshape(tuple(dims))
        return PassiveMeshSDF.from_grid(sdf, lo, h, near_lanes=near_lanes)


@dataclasses.dataclass(frozen=True)
class PassiveMeshExact:
    """Exact mesh-obstacle narrow phase (the JAX package's PassiveMeshExact;
    the reference's PassiveMesh, src/PassiveObject.hpp:67-107).

    A uniform grid lists, per cell, the surface triangles within
    ``capture_cells`` cells of it (``face_table`` / ``face_count``) and
    whether a tet overlaps it (``tet_count``). A query takes Ericson's
    closest point over its cell's candidates, the first of least distance;
    its normal is the angle-weighted pseudonormal of the closest feature
    (``nrm`` rows: face, vertex a/b/c, edge ab/bc/ca), and it is inside where
    (p - closest) . normal < 0 in a tet-occupied cell. A lane in an occupied
    cell with no candidate, or whose nearest candidate lies beyond the
    capture radius, takes the deep fallback: the first ``fallback_lanes``
    such lanes in lane order get the first least over every surface
    triangle; the others report no hit and set the overflow. With
    ``near_lanes`` = K (0 < K < lanes) only the first K lanes in an occupied
    cell are evaluated; every other lane reports no hit (dx = 1e30, zero
    point and normal), and more than K such lanes set the overflow.
    """

    tri_abc: torch.Tensor  # [F, 3, 3] corners a, b, c
    nrm: torch.Tensor  # [F, 7, 3] pseudonormals: face, vertex a/b/c, edge ab/bc/ca
    face_table: torch.Tensor  # [C, Kf] int16 (int32 where F >= 32768)
    face_count: torch.Tensor  # [C] int32
    tet_count: torch.Tensor  # [C] int8 occupancy (0/1)
    origin: torch.Tensor  # [3]
    h: torch.Tensor  # scalar cell size
    dims: tuple  # (Gx, Gy, Gz)
    capture_cells: float = 2.0
    fallback_lanes: int = 128
    near_lanes: int = 0

    def __post_init__(self):
        for f in ("tri_abc", "nrm", "origin", "h"):
            object.__setattr__(self, f, _tensor(getattr(self, f)))
        for f in ("face_table", "face_count", "tet_count"):
            object.__setattr__(self, f, _table(getattr(self, f)))
        object.__setattr__(self, "dims", tuple(int(d) for d in self.dims))
        object.__setattr__(self, "capture_cells", float(self.capture_cells))
        object.__setattr__(self, "fallback_lanes", int(self.fallback_lanes))
        object.__setattr__(self, "near_lanes", int(self.near_lanes))

    def to(self, device, dtype) -> "PassiveMeshExact":
        """On device, the geometry rounded to dtype once, the tables as they
        are."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device=device, dtype=dtype)
                     for f in ("tri_abc", "nrm", "origin", "h")},
            **{f: getattr(self, f).to(device=device)
               for f in ("face_table", "face_count", "tet_count")})

    def signed_distance(self, x):
        dx, point, normal, _ = self.signed_distance_with_overflow(x)
        return dx, point, normal

    def cells(self, p):
        """(cid [V] flat cell ids, clipped into the grid; in_grid [V]) of the
        lanes p [V, 3]. The cell index is clamped as a float before it is
        made an integer, so a lane far outside (or NaN) is out of the grid."""
        dtype = p.dtype
        dims_f = torch.tensor(self.dims, dtype=dtype, device=p.device)
        fl = torch.floor((p - self.origin.to(dtype)) / self.h.to(dtype))
        in_grid = torch.all((fl >= 0) & (fl < dims_f), dim=-1)
        ci = torch.where(torch.isnan(fl), 0.0, torch.minimum(torch.clamp_min(fl, 0.0),
                                                             dims_f - 1)).to(torch.int64)
        cid = (ci[:, 0] * self.dims[1] + ci[:, 1]) * self.dims[2] + ci[:, 2]
        return cid, in_grid

    def signed_distance_with_overflow(self, x, scenes: bool = False):
        """signed_distance plus the overflow flag (a 0-d bool): more near
        lanes than near_lanes, or more deep lanes than fallback_lanes.
        scenes: x [S, V, 3] is S scenes, each compacted and served by the
        fallback on its own; the flag is then [S]."""
        if scenes:
            return _each_scene(self.signed_distance_with_overflow, x)
        dtype = x.dtype
        lead = x.shape[:-1]
        p = x.reshape(-1, 3)
        cid, in_grid = self.cells(p)
        k_near = self.near_lanes
        if 0 < k_near < p.shape[0]:
            near = in_grid & (self.tet_count[cid] > 0)
            sel = _first_k(near, k_near)
            sel_mask = near[sel]
            dx_k, cl_k, n_k, fb_ovf = self._narrow(p[sel], cid[sel], sel_mask, dtype)
            dx = torch.full((p.shape[0],), BIG, dtype=dtype, device=p.device)
            dx[sel] = torch.where(sel_mask, dx_k, BIG)
            cl = torch.zeros_like(p)
            cl[sel] = torch.where(sel_mask[:, None], cl_k, 0.0)
            n = torch.zeros_like(p)
            n[sel] = torch.where(sel_mask[:, None], n_k, 0.0)
            overflow = (near.sum() > k_near) | fb_ovf
        else:
            dx, cl, n, overflow = self._narrow(p, cid, in_grid, dtype)
        return dx.reshape(lead), cl.reshape(lead + (3,)), n.reshape(lead + (3,)), overflow

    def _closest_over(self, p, abc, fmask, fids=None):
        """The closest feature over candidate triangles: abc [V, K, 3, 3]
        their corners, fmask [V, K], fids [V, K] their soup rows (None: the K
        axis is the soup). Returns (dist [V], closest [V, 3], unit normal
        [V, 3], any_face [V]): the first candidate of least squared
        distance, its closest point computed again on its own corners, and
        the pseudonormal of its region (Ericson's clamp, eps 1e-5)."""
        dtype = p.dtype
        closest, _, _ = _pt_tri_closest(p[:, None, :], abc[..., 0, :], abc[..., 1, :],
                                        abc[..., 2, :])
        dd = p[:, None, :] - closest
        d2 = torch.where(fmask, dot3(dd, dd), BIG)
        j = torch.argmin(d2, dim=1)  # the first least
        dist = torch.sqrt(torch.clamp_min(d2.gather(1, j[:, None])[:, 0], 0.0))
        any_face = torch.any(fmask, dim=1)
        fid_s = j if fids is None else fids.gather(1, j[:, None])[:, 0]
        abc_s = self.tri_abc.to(dtype)[fid_s]
        cl, v_s, w_s = _pt_tri_closest(p, abc_s[:, 0, :], abc_s[:, 1, :], abc_s[:, 2, :])
        eps = 1e-5
        one_m = 1.0 - torch.tensor(eps, dtype=dtype)  # 1 - eps in the dtype
        u_s = 1.0 - v_s - w_s
        # region codes of the nrm rows: 0 face, 1-3 vertex a/b/c, 4-6 edge
        # ab/bc/ca, overridden in this order
        idx = torch.zeros_like(fid_s)
        idx = torch.where(u_s <= eps, 5, idx)
        idx = torch.where(v_s <= eps, 6, idx)
        idx = torch.where(w_s <= eps, 4, idx)
        idx = torch.where(w_s >= one_m, 3, idx)
        idx = torch.where(v_s >= one_m, 2, idx)
        idx = torch.where((v_s <= eps) & (w_s <= eps), 1, idx)
        n = self.nrm.to(dtype).reshape(-1, 3)[fid_s * 7 + idx]
        return dist, cl, _unit(n), any_face

    def _narrow(self, p, cid, valid, dtype):
        """The exact narrow phase over the lanes p [V, 3] in cells cid, where
        valid ones may report candidates: (dx, closest, normal, fallback
        overflow)."""
        kf = self.face_table.shape[1]
        fids = self.face_table[cid].to(torch.int64)  # [V, Kf]
        fmask = (torch.arange(kf, device=p.device)[None, :]
                 < self.face_count[cid][:, None]) & valid[:, None]
        dist, cl, n, any_face = self._closest_over(p, self.tri_abc.to(dtype)[fids], fmask,
                                                   fids=fids)
        near_tet = self.tet_count[cid] > 0
        capture = torch.tensor(self.capture_cells, dtype=dtype, device=p.device) * self.h.to(dtype)
        need_fb = valid & near_tet & (~any_face | (dist > capture))
        unresolved = need_fb
        k_fb = min(self.fallback_lanes, p.shape[0])
        n_tris = self.tri_abc.shape[0]
        if k_fb > 0 and n_tris > 0 and bool(need_fb.any()):
            # the first k_fb deep lanes in lane order, each against the whole
            # soup (the JAX package runs the pass on every call, masked: the
            # lanes it leaves unchanged are those this skips)
            sel = _first_k(need_fb, k_fb)
            served = sel[need_fb[sel]]
            abc_all = self.tri_abc.to(dtype)
            for s in range(0, served.shape[0], FALLBACK_CHUNK):
                lanes = served[s:s + FALLBACK_CHUNK]
                m = lanes.shape[0]
                d_f, c_f, n_f, _ = self._closest_over(
                    p[lanes], abc_all[None].expand(m, n_tris, 3, 3),
                    torch.ones((m, n_tris), dtype=torch.bool, device=p.device))
                dist[lanes], cl[lanes], n[lanes] = d_f, c_f, n_f
                any_face[lanes] = True
            unresolved = need_fb.clone()
            unresolved[served] = False
        fb_overflow = torch.any(unresolved)
        any_face = any_face & ~unresolved
        # the sign after the fallback; the occupancy gate proves outside
        inside = (dot3(p - cl, n) < 0) & any_face & near_tet
        sgn = torch.where(inside, -1.0, 1.0).to(dtype)
        dx = torch.where(any_face, sgn * dist, BIG)
        return dx, cl, n, fb_overflow

    @staticmethod
    def from_tet_mesh(verts: np.ndarray, tets: np.ndarray, cells: int = 32,
                      capture_cells: float = 2.0, fallback_lanes: int = 128,
                      near_lanes: int = 0):
        """Bake the candidate grid of a closed tet mesh (numpy): ``cells``
        grid cells along the longest AABB axis; every cell lists the surface
        triangles within ``capture_cells * h`` of it and whether a tet
        overlaps it."""
        verts = np.asarray(verts, dtype=np.float64)
        tets = np.asarray(tets, dtype=np.int64).copy()
        # outward winding: orient every tet positively first
        x4 = verts[tets]
        vols = np.linalg.det(
            np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
        )
        neg = vols < 0
        tets[neg] = tets[neg][:, [1, 0, 2, 3]]

        faces = surface_faces_from_tets(tets)
        a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        raw = np.cross(b - a, c - a)
        nf = raw / np.maximum(np.linalg.norm(raw, axis=-1, keepdims=True), 1e-300)

        # angle-weighted vertex pseudonormals
        acc = np.zeros_like(verts)
        corners = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
        for k, (i0, i1, i2) in enumerate(corners):
            e1 = verts[faces[:, i1]] - verts[faces[:, i0]]
            e2 = verts[faces[:, i2]] - verts[faces[:, i0]]
            cosang = (e1 * e2).sum(-1) / np.maximum(
                np.linalg.norm(e1, axis=-1) * np.linalg.norm(e2, axis=-1), 1e-300)
            ang = np.arccos(np.clip(cosang, -1.0, 1.0))
            np.add.at(acc, faces[:, i0], ang[:, None] * nf)
        vn = acc / np.maximum(np.linalg.norm(acc, axis=-1, keepdims=True), 1e-300)
        n_vert = vn[faces]  # [F, 3, 3]

        # edge pseudonormals: the sum of the two adjacent face normals
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
        ekey = np.sort(edges, axis=1)
        uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        eacc = np.zeros((len(uniq), 3))
        np.add.at(eacc, inv, np.tile(nf, (3, 1)))
        en = eacc / np.maximum(np.linalg.norm(eacc, axis=-1, keepdims=True), 1e-300)
        n_edge = en[inv].reshape(3, len(faces), 3).transpose(1, 0, 2)  # ab, bc, ca

        ext = verts.max(axis=0) - verts.min(axis=0)
        h = float(ext.max()) / cells
        capture = capture_cells * h
        lo = verts.min(axis=0) - capture - 0.5 * h
        hi = verts.max(axis=0) + capture + 0.5 * h
        dims = tuple(int(d) for d in np.ceil((hi - lo) / h).astype(int) + 1)
        ncell = dims[0] * dims[1] * dims[2]

        def cell_ranges(lo_pts, hi_pts, inflate):
            c0 = np.floor((lo_pts - inflate - lo) / h).astype(int)
            c1 = np.floor((hi_pts + inflate - lo) / h).astype(int)
            c0 = np.clip(c0, 0, np.asarray(dims) - 1)
            c1 = np.clip(c1, 0, np.asarray(dims) - 1)
            return c0, c1

        def build_table(lo_pts, hi_pts, inflate):
            c0, c1 = cell_ranges(lo_pts, hi_pts, inflate)
            buckets = [[] for _ in range(ncell)]
            for idx in range(len(lo_pts)):
                for ix in range(c0[idx, 0], c1[idx, 0] + 1):
                    for iy in range(c0[idx, 1], c1[idx, 1] + 1):
                        for iz in range(c0[idx, 2], c1[idx, 2] + 1):
                            buckets[(ix * dims[1] + iy) * dims[2] + iz].append(idx)
            cap = max(1, max(len(bk) for bk in buckets))
            table = np.zeros((ncell, cap), dtype=np.int32)
            count = np.zeros((ncell,), dtype=np.int32)
            for ci_, bk in enumerate(buckets):
                count[ci_] = len(bk)
                table[ci_, : len(bk)] = bk
            return table, count

        tri_pts = verts[faces]  # [F, 3, 3]
        face_table, face_count = build_table(
            tri_pts.min(axis=1), tri_pts.max(axis=1), capture)
        x4 = verts[tets]
        _, tet_count = build_table(x4.min(axis=1), x4.max(axis=1), 0.0)
        tet_count = (tet_count > 0).astype(np.int8)
        if len(faces) < 32768:
            face_table = face_table.astype(np.int16)

        return PassiveMeshExact(
            tri_abc=np.stack([a, b, c], axis=1),
            nrm=np.concatenate([nf[:, None, :], n_vert, n_edge], axis=1),
            face_table=face_table, face_count=face_count, tet_count=tet_count,
            origin=lo, h=np.asarray(float(h)), dims=dims,
            capture_cells=float(capture_cells),
            fallback_lanes=int(fallback_lanes), near_lanes=int(near_lanes),
        )


def _pt_tri_closest(p, a, b, c):
    """Ericson's closest point on triangle abc, batched: (closest, v, w) with
    closest = a + v (b - a) + w (c - a), the region clamps in the JAX
    package's order, every dot product in component order."""
    tiny = 1e-30
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = dot3(ab, ap)
    d2 = dot3(ac, ap)
    bp = p - b
    d3 = dot3(ab, bp)
    d4 = dot3(ac, bp)
    cp = p - c
    d5 = dot3(ab, cp)
    d6 = dot3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp_min(va + vb + vc, tiny)
    v = torch.clamp(vb / denom, 0.0, 1.0)
    w = torch.clamp(vc / denom, 0.0, 1.0)
    on_a = (d1 <= 0) & (d2 <= 0)
    v = torch.where(on_a, 0.0, v)
    w = torch.where(on_a, 0.0, w)
    on_b = (d3 >= 0) & (d4 <= d3)
    v = torch.where(on_b, 1.0, v)
    w = torch.where(on_b, 0.0, w)
    on_c = (d6 >= 0) & (d5 <= d6)
    v = torch.where(on_c, 0.0, v)
    w = torch.where(on_c, 1.0, w)
    e_ab = torch.clamp(d1 / torch.clamp_min(d1 - d3, tiny), 0.0, 1.0)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = torch.where(on_ab, e_ab, v)
    w = torch.where(on_ab, 0.0, w)
    e_ac = torch.clamp(d2 / torch.clamp_min(d2 - d6, tiny), 0.0, 1.0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = torch.where(on_ac, 0.0, v)
    w = torch.where(on_ac, e_ac, w)
    e_bc = torch.clamp((d4 - d3) / torch.clamp_min((d4 - d3) + (d5 - d6), tiny), 0.0, 1.0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = torch.where(on_bc, 1.0 - e_bc, v)
    w = torch.where(on_bc, e_bc, w)
    closest = a + v[..., None] * ab + w[..., None] * ac
    return closest, v, w


ANALYTIC = (Floor, Sphere)
MESH = (PassiveMeshSDF, PassiveMeshExact)


def check_obstacle(obj) -> None:
    """Raise TypeError for anything but this package's four obstacles; an
    obstacle of the JAX package is converted first."""
    if isinstance(obj, ANALYTIC + MESH):
        return
    name = type(obj).__name__
    if type(obj).__module__.split(".")[0] == "admm_elastic_tpu":
        raise TypeError(f"{name} is the JAX package's obstacle: build this package's, or carry "
                        "its arrays over with convert.obstacle_from_numpy")
    raise TypeError(f"{name} is not an obstacle: Floor, Sphere, PassiveMeshSDF or "
                    "PassiveMeshExact of admm_elastic_tpu_torch")


def pick_deepest(found):
    """The first of least dx over the obstacles' (dx, point, normal) found:
    (dx, point, normal), as jnp.argmin picks (Collider::detect's
    payload-min, src/Collider.hpp:178-189)."""
    if len(found) == 1:  # the argmin of one picks it
        return found[0]
    dx = torch.stack([f[0] for f in found], dim=0)  # [O, ...]
    best = torch.argmin(dx, dim=0)  # the first least

    def pick(k):
        arr = torch.stack([f[k] for f in found], dim=0)
        return torch.take_along_dim(arr, best[None, ..., None], dim=0)[0]

    return torch.take_along_dim(dx, best[None, ...], dim=0)[0], pick(1), pick(2)


def detect_passive(obstacles, xs, scenes: bool = False):
    """The deepest passive hit per query point across all obstacles, in their
    plain versions. Returns (dx, point, normal, hit_mask, overflow): overflow
    is the OR over the mesh obstacles' fixed-capacity stages. scenes: xs
    [S, H, 3] is S scenes, each mesh obstacle's stages per scene, and the
    overflow [S]."""
    ovf = torch.zeros(xs.shape[:1] if scenes else (), dtype=torch.bool, device=xs.device)
    if not obstacles:
        z3 = torch.zeros(xs.shape, dtype=xs.dtype, device=xs.device)
        big = torch.full(xs.shape[:-1], torch.finfo(xs.dtype).max, dtype=xs.dtype,
                         device=xs.device)
        return big, z3, z3, torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device), ovf
    found = []
    for obs in obstacles:
        if isinstance(obs, MESH):
            d, p, n, o = obs.signed_distance_with_overflow(xs, scenes=scenes)
            ovf = ovf | o
        else:
            d, p, n = obs.signed_distance(xs)
        found.append((d, p, n))
    d_best, p_best, n_best = pick_deepest(found)
    return d_best, p_best, n_best, d_best < 0.0, ovf


# numpy helpers for SDF baking -------------------------------------------------

def _points_in_tets_np(pts, verts, tets, chunk=65536):
    x4 = verts[tets]  # [T,4,3]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    einv = np.linalg.inv(e)  # [T,3,3]
    base = x4[:, 0]  # [T,3]
    inside = np.zeros((len(pts),), dtype=bool)
    for s in range(0, len(pts), chunk):
        p = pts[s : s + chunk]
        # barycentric-ish coords b = einv @ (p - base): [P,T,3]
        d = p[:, None, :] - base[None, :, :]
        b = np.einsum("tij,ptj->pti", einv, d)
        ok = (b >= -1e-12).all(-1) & (b.sum(-1) <= 1 + 1e-12)
        inside[s : s + chunk] = ok.any(-1)
    return inside


def _point_tri_distance_np(pts, verts, faces, chunk=16384):
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    out = np.empty((len(pts),), dtype=np.float64)
    for s in range(0, len(pts), chunk):
        p = pts[s : s + chunk][:, None, :]
        d = _pt_tri_np(p, a[None], b[None], c[None])
        out[s : s + chunk] = d.min(axis=1)
    return out


def _pt_tri_np(p, a, b, c):
    """Distance from points to triangles (Ericson's closest-point)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = (ab * ap).sum(-1)
    d2 = (ac * ap).sum(-1)
    bp = p - b
    d3 = (ab * bp).sum(-1)
    d4 = (ac * bp).sum(-1)
    cp = p - c
    d5 = (ab * cp).sum(-1)
    d6 = (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-300)
    v = np.clip(vb / denom, 0, 1)
    w = np.clip(vc / denom, 0, 1)
    # Region clamps
    v = np.where((d1 <= 0) & (d2 <= 0), 0.0, v)
    w = np.where((d1 <= 0) & (d2 <= 0), 0.0, w)
    v = np.where((d3 >= 0) & (d4 <= d3), 1.0, v)
    w = np.where((d3 >= 0) & (d4 <= d3), 0.0, w)
    v = np.where((d6 >= 0) & (d5 <= d6), 0.0, v)
    w = np.where((d6 >= 0) & (d5 <= d6), 1.0, w)
    e_ab = np.clip(np.where(np.abs(d1 - d3) > 1e-300, d1 / np.maximum(d1 - d3, 1e-300), 0), 0, 1)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    v = np.where(on_ab, e_ab, v)
    w = np.where(on_ab, 0.0, w)
    e_ac = np.clip(np.where(np.abs(d2 - d6) > 1e-300, d2 / np.maximum(d2 - d6, 1e-300), 0), 0, 1)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    v = np.where(on_ac, 0.0, v)
    w = np.where(on_ac, e_ac, w)
    e_bc = np.clip((d4 - d3) / np.maximum((d4 - d3) + (d5 - d6), 1e-300), 0, 1)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v = np.where(on_bc, 1.0 - e_bc, v)
    w = np.where(on_bc, e_bc, w)
    closest = a + v[..., None] * ab + w[..., None] * ac
    return np.linalg.norm(p - closest, axis=-1)
