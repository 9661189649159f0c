"""Shape factories (numpy): a copy of ``make_plane``, ``make_sphere``,
``make_tet_blocks``, ``make_tet_sphere``, ``make_tet_torus``,
``make_tet_bunny_like`` (scipy's Delaunay and Halton) and ``make_xform`` from
``admm_elastic_tpu.geometry.factory`` (mcl::factory)."""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu_torch.geometry.mesh import TetMesh, TriangleMesh

# The 5-tet decomposition of a cube (alternating parity to share faces).
_CUBE_TETS_EVEN = [
    (0, 1, 3, 5),
    (0, 3, 2, 6),
    (0, 5, 4, 6),
    (3, 5, 6, 7),
    (0, 3, 5, 6),
]
_CUBE_TETS_ODD = [
    (1, 2, 0, 4),
    (1, 7, 3, 2),
    (1, 4, 5, 7),
    (2, 4, 6, 7),
    (1, 2, 7, 4),
]


def make_plane(nx: int, ny: int, size: float = 1.0) -> TriangleMesh:
    """A [-size, size]^2 planar grid in the xy-plane with nx x ny cells."""
    xs = np.linspace(-size, size, nx + 1)
    ys = np.linspace(-size, size, ny + 1)
    verts = np.array([[x, y, 0.0] for y in ys for x in xs])
    faces = []
    for j in range(ny):
        for i in range(nx):
            v0 = j * (nx + 1) + i
            v1 = v0 + 1
            v2 = v0 + (nx + 1)
            v3 = v2 + 1
            faces.append([v0, v1, v3])
            faces.append([v0, v3, v2])
    return TriangleMesh(vertices=verts, faces=np.asarray(faces, dtype=np.int64))


def make_sphere(center, radius: float, subdiv: int = 16) -> TriangleMesh:
    """UV sphere triangle mesh."""
    center = np.asarray(center, dtype=np.float64)
    verts = [center + [0, radius, 0]]
    for i in range(1, subdiv):
        theta = np.pi * i / subdiv
        for j in range(subdiv):
            phi = 2 * np.pi * j / subdiv
            verts.append(
                center
                + radius
                * np.array(
                    [np.sin(theta) * np.cos(phi), np.cos(theta), np.sin(theta) * np.sin(phi)]
                )
            )
    verts.append(center + [0, -radius, 0])
    faces = []
    for j in range(subdiv):
        faces.append([0, 1 + (j + 1) % subdiv, 1 + j])
    for i in range(subdiv - 2):
        ring0 = 1 + i * subdiv
        ring1 = ring0 + subdiv
        for j in range(subdiv):
            a = ring0 + j
            b = ring0 + (j + 1) % subdiv
            c = ring1 + j
            d = ring1 + (j + 1) % subdiv
            faces.append([a, b, d])
            faces.append([a, d, c])
    last = len(verts) - 1
    ring = last - subdiv
    for j in range(subdiv):
        faces.append([last, ring + j, ring + (j + 1) % subdiv])
    return TriangleMesh(
        vertices=np.asarray(verts), faces=np.asarray(faces, dtype=np.int64)
    )


def make_tet_blocks(nx: int, ny: int, nz: int, cell: float = 1.0) -> TetMesh:
    """A structured nx x ny x nz grid of cubes, each split into 5 tets
    (parity-alternating so neighboring cubes share diagonal faces)."""

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    verts = np.array(
        [
            [i * cell, j * cell, k * cell]
            for i in range(nx + 1)
            for j in range(ny + 1)
            for k in range(nz + 1)
        ]
    )
    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                c = [
                    vid(i, j, k),
                    vid(i + 1, j, k),
                    vid(i, j + 1, k),
                    vid(i + 1, j + 1, k),
                    vid(i, j, k + 1),
                    vid(i + 1, j, k + 1),
                    vid(i, j + 1, k + 1),
                    vid(i + 1, j + 1, k + 1),
                ]
                pattern = _CUBE_TETS_EVEN if (i + j + k) % 2 == 0 else _CUBE_TETS_ODD
                for t in pattern:
                    tets.append([c[t[0]], c[t[1]], c[t[2]], c[t[3]]])
    tets = np.asarray(tets, dtype=np.int64)
    # Ensure positive orientation.
    x4 = verts[tets]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    bad = np.linalg.det(e) < 0
    tets[bad] = tets[bad][:, [0, 2, 1, 3]]
    # Structured-grid tag: the solver verifies it against the tets and
    # then takes the flat-stencil D / D^T path (ops/stencil.py).
    return TetMesh(vertices=verts, tets=tets, lattice_dims=(nx, ny, nz))


def _reorient(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Flip tets to positive orientation."""
    x4 = verts[tets]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    bad = np.linalg.det(e) < 0
    tets[bad] = tets[bad][:, [0, 2, 1, 3]]
    return tets


def make_tet_sphere(radius: float = 1.0, n: int = 6) -> TetMesh:
    """Solid tetrahedralized ball: an n^3 cube grid mapped onto the ball
    (radial max-norm map keeps element quality reasonable), 5 tets/cube.

    Procedural stand-in for the reference's sphere.node/.ele sample data
    (samples/tvcg2017/signorini.cpp loads it via mclscene meshio).
    """
    g = make_tet_blocks(n, n, n, cell=2.0 / n)
    p = g.vertices - 1.0  # [-1, 1]^3
    linf = np.abs(p).max(axis=1)
    l2 = np.linalg.norm(p, axis=1)
    scale = np.where(l2 > 1e-12, linf / np.maximum(l2, 1e-12), 0.0)
    verts = p * (radius * scale)[:, None]
    tets = _reorient(verts, g.tets.copy())
    return TetMesh(vertices=verts, tets=tets)


def make_tet_torus(major_radius: float = 1.0, minor_radius: float = 0.35,
                   n_ring: int = 24, n_sec: int = 4) -> TetMesh:
    """Solid tetrahedralized torus: an n_sec^2 cross-section square grid
    mapped to a disk (max-norm map), swept around the ring in n_ring
    segments of hexes (wrapping), each split into 5 tets. Tagged as a ring
    lattice (``lattice_dims = (n_ring, n_sec, n_sec)``, ``lattice_wrap``):
    its first axis is periodic, and it runs as a wrap stencil."""
    if n_ring % 2 != 0:
        n_ring += 1  # parity-alternating tet split must close the loop

    # Cross-section vertex grid mapped square->disk.
    m = n_sec
    vv, ww = np.meshgrid(np.linspace(-1, 1, m + 1), np.linspace(-1, 1, m + 1),
                         indexing="ij")
    sq = np.stack([vv.ravel(), ww.ravel()], axis=1)
    linf = np.abs(sq).max(axis=1)
    l2 = np.linalg.norm(sq, axis=1)
    disk = sq * np.where(l2 > 1e-12, linf / np.maximum(l2, 1e-12), 0.0)[:, None]
    disk *= minor_radius
    n_cs = disk.shape[0]

    verts = []
    for s in range(n_ring):
        a = 2.0 * np.pi * s / n_ring
        ca, sa = np.cos(a), np.sin(a)
        # ring in the xz-plane; cross-section spans (radial, y)
        r = major_radius + disk[:, 0]
        verts.append(np.stack([r * ca, disk[:, 1], r * sa], axis=1))
    verts = np.concatenate(verts)

    def vid(s, i, j):
        return (s % n_ring) * n_cs + i * (m + 1) + j

    tets = []
    for s in range(n_ring):
        for i in range(m):
            for j in range(m):
                c = [
                    vid(s, i, j), vid(s + 1, i, j),
                    vid(s, i + 1, j), vid(s + 1, i + 1, j),
                    vid(s, i, j + 1), vid(s + 1, i, j + 1),
                    vid(s, i + 1, j + 1), vid(s + 1, i + 1, j + 1),
                ]
                pattern = _CUBE_TETS_EVEN if (s + i + j) % 2 == 0 else _CUBE_TETS_ODD
                for t in pattern:
                    tets.append([c[t[0]], c[t[1]], c[t[2]], c[t[3]]])
    tets = _reorient(verts, np.asarray(tets, dtype=np.int64))
    return TetMesh(vertices=verts, tets=tets, lattice_dims=(n_ring, m, m), lattice_wrap=True)


def _bunny_blob_sdf_inside(q: np.ndarray) -> np.ndarray:
    """Implicit bunny-like blob: body, offset head, two asymmetric ears,
    tail. Deliberately non-convex and asymmetric so inversion-recovery
    and self-collision demos exercise bunny-like geometry, not a sphere."""

    def ell(center, radii):
        d = (q - np.asarray(center)) / np.asarray(radii)
        return np.sum(d * d, axis=-1) <= 1.0

    body = ell((0.0, -0.30, 0.0), (0.62, 0.50, 0.55))
    head = ell((0.05, 0.35, 0.25), (0.38, 0.35, 0.36))
    ear_l = ell((-0.18, 0.74, 0.18), (0.17, 0.34, 0.18))
    ear_r = ell((0.22, 0.72, 0.12), (0.18, 0.30, 0.19))
    tail = ell((0.0, -0.38, -0.62), (0.22, 0.22, 0.22))
    return body | head | ear_l | ear_r | tail


def make_tet_bunny_like(n_points: int = 900, seed: int = 7) -> TetMesh:
    """A bunny-class irregular organic tet mesh, fully procedural.

    Self-contained stand-in for the reference's bunny_1124.node/.ele
    sample data (samples/data/, loaded by sca2016/bunnyexpand.cpp):
    Delaunay tetrahedralization of quasi-random points inside an implicit
    blob, keeping tets whose centroid is inside — the same unstructured
    coarse-Delaunay mesh class as the real bunny data. This matters for
    the inversion-recovery demo: a structured 5-split voxel grid of the
    same blob gets STUCK half-inverted after a random scramble (~1300 of
    3245 tets, flat from step 50 to 300) while unstructured Delaunay
    meshes — this one and the real bunny — recover to 0 inverted tets.
    n_points=900 yields ~3.5k tets / ~900 verts, the bunny_1124 class.
    """
    from scipy.spatial import Delaunay
    from scipy.stats import qmc

    lo = np.array([-0.72, -0.95, -0.90])
    hi = np.array([0.45, 1.10, 0.75])
    # Quasi-random (Halton) interior points: evenly spread without grid
    # structure, deterministic for reproducible cached data.
    sampler = qmc.Halton(d=3, seed=seed)
    pts = []
    while sum(len(p) for p in pts) < n_points:
        cand = lo + (hi - lo) * sampler.random(4 * n_points)
        cand = cand[_bunny_blob_sdf_inside(cand)]
        pts.append(cand)
    verts = np.concatenate(pts)[:n_points]

    tri = Delaunay(verts)
    tets = tri.simplices.astype(np.int64)
    # Delaunay fills the convex hull; keep tets whose centroid is inside
    # the blob (carves the neck/ear concavities back out).
    cents = verts[tets].mean(axis=1)
    tets = tets[_bunny_blob_sdf_inside(cents)]
    # Drop slivers (Delaunay of random points makes a few): volume below
    # 1% of the median destabilizes nothing but wastes conditioning.
    x4 = verts[tets]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0],
                  x4[:, 3] - x4[:, 0]], axis=-1)
    vol = np.abs(np.linalg.det(e)) / 6.0
    tets = tets[vol > 0.01 * np.median(vol)]
    # Compact unused vertices.
    used = np.unique(tets)
    remap = -np.ones(len(verts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    verts = verts[used]
    tets = remap[tets]
    tets = _reorient(verts, tets)
    return TetMesh(vertices=verts, tets=tets)


def make_xform(trans=(0, 0, 0), rot_deg: float = 0.0, rot_axis=(1, 0, 0),
               scale=(1, 1, 1)) -> np.ndarray:
    """4x4 homogeneous transform T @ R @ S (mcl::XForm equivalent)."""
    axis = np.asarray(rot_axis, dtype=np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-30)
    a = np.deg2rad(rot_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R3 = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
    M = np.eye(4)
    M[:3, :3] = R3 @ np.diag(scale)
    M[:3, 3] = trans
    return M
