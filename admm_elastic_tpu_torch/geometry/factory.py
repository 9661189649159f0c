"""Shape factories (numpy): a copy of ``make_plane``, ``make_tet_blocks`` and
``make_xform`` from ``admm_elastic_tpu.geometry.factory`` (mcl::factory)."""

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
