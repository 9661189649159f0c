"""Tet-block beams (numpy): a copy of ``make_tet_blocks`` from
``admm_elastic_tpu.geometry.factory`` (mcl::factory::make_tet_blocks)."""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu_torch.geometry.mesh import TetMesh

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
