"""Host tet and triangle mesh containers and mesh utilities (numpy).

A copy of the tet and triangle parts of ``admm_elastic_tpu.geometry.mesh``:
surface faces and vertices, volumes, areas and lumped masses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def surface_faces_from_tets(tets: np.ndarray) -> np.ndarray:
    """Boundary faces (appearing in exactly one tet), outward winding."""
    tets = np.asarray(tets, dtype=np.int64)
    f = np.concatenate(
        [
            tets[:, [0, 2, 1]],
            tets[:, [0, 1, 3]],
            tets[:, [0, 3, 2]],
            tets[:, [1, 2, 3]],
        ],
        axis=0,
    )
    key = np.sort(f, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    return f[counts[inv] == 1]


def surface_vertex_indices(tets: np.ndarray) -> np.ndarray:
    """Vertices on the boundary (mcl::TetMesh::surface_inds)."""
    return np.unique(surface_faces_from_tets(tets))


def tet_volumes(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    x4 = verts[tets]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    return np.linalg.det(e) / 6.0


def lumped_masses_tet(verts: np.ndarray, tets: np.ndarray, density: float) -> np.ndarray:
    """Per-vertex lumped masses: density * vol/4 to each tet vertex."""
    vols = tet_volumes(verts, tets)
    m = np.zeros((verts.shape[0],))
    np.add.at(m, np.asarray(tets).reshape(-1), np.repeat(density * vols / 4.0, 4))
    return m


def tri_areas(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    x3 = verts[tris]
    n = np.cross(x3[:, 1] - x3[:, 0], x3[:, 2] - x3[:, 0])
    return 0.5 * np.linalg.norm(n, axis=-1)


def lumped_masses_tri(verts: np.ndarray, tris: np.ndarray, density: float) -> np.ndarray:
    """Per-vertex lumped masses: density * area/3 to each triangle vertex."""
    areas = tri_areas(verts, tris)
    m = np.zeros((verts.shape[0],))
    np.add.at(m, np.asarray(tris).reshape(-1), np.repeat(density * areas / 3.0, 3))
    return m


@dataclasses.dataclass
class TetMesh:
    """Host tet mesh (mcl::TetMesh equivalent)."""

    vertices: np.ndarray  # [V, 3] f64
    tets: np.ndarray  # [T, 4] i64
    flags: int = 0
    # (nx, ny, nz) of a make_tet_blocks lattice, verified at build.
    lattice_dims: Optional[tuple] = None
    lattice_wrap: bool = False
    _faces: Optional[np.ndarray] = None

    @property
    def faces(self) -> np.ndarray:
        if self._faces is None:
            self._faces = surface_faces_from_tets(self.tets)
        return self._faces

    def surface_inds(self) -> np.ndarray:
        return np.unique(self.faces)

    def weighted_masses(self, density: float) -> np.ndarray:
        return lumped_masses_tet(self.vertices, self.tets, density)

    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def apply_xform(self, M: np.ndarray):
        """Apply a 4x4 homogeneous transform in place."""
        v = self.vertices
        self.vertices = (v @ M[:3, :3].T) + M[:3, 3]
        self._faces = None


@dataclasses.dataclass
class TriangleMesh:
    """Host triangle mesh (mcl::TriangleMesh equivalent)."""

    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3]
    flags: int = 0

    def weighted_masses(self, density: float) -> np.ndarray:
        return lumped_masses_tri(self.vertices, self.faces, density)

    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def apply_xform(self, M: np.ndarray):
        v = self.vertices
        self.vertices = (v @ M[:3, :3].T) + M[:3, 3]
