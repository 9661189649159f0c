"""Scene binding: add a whole mesh (nodes, masses, energies) to a Solver.

A port of ``admm_elastic_tpu/binding.py`` ``add_tetmesh``, ``add_trimesh`` and ``GrabbySphere``
(reference samples/utils/AddMeshes.hpp:97-235): lumped masses, zero-mass
validation, node append, tet energy family by flag (linear, neo-Hookean, StVK,
Xu spline). A tet mesh with ``lattice_dims`` (make_tet_blocks) runs as a flat
stencil; any other (a mesh from ``geometry/io.load_elenode``, or a lattice
whose ``lattice_dims`` is None) runs as a gather family, as does a triangle
mesh that is no regular sheet (``system/elements.py``). A tet mesh without
NOSELFCOLLISION registers its self-collision collider
(``collision/dynamic.make_tet_mesh_collider``) and appends its surface
vertices to the query set, as the reference turns self-collision on for every
mesh that does not opt out (AddMeshes.hpp:125-137).
"""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu_torch.collision.dynamic import make_tet_mesh_collider
from admm_elastic_tpu_torch.geometry.mesh import TetMesh, TriangleMesh
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.solver import Solver

# Mesh flags bitmask (AddMeshes.hpp:57-62).
NOSELFCOLLISION = 1 << 1
LINEAR = 1 << 2
NEOHOOKEAN = 1 << 3
STVK = 1 << 4
SPLINE = 1 << 5  # Xu-spline material family

_FLAG_TO_MODEL = {
    LINEAR: "linear",
    NEOHOOKEAN: "neohookean",
    STVK: "stvk",
    SPLINE: "spline_nh",
}

RUBBER_DENSITY = 1522.0  # kg/m^3 (AddMeshes.hpp:105)


def add_tetmesh(solver: Solver, mesh: TetMesh, lame: Lame | None = None, verbose: bool = True,
                density: float = RUBBER_DENSITY):
    """Append a tet mesh to the solver; returns its vertex offset."""
    if lame is None:
        lame = Lame.rubber()
    prev_verts = solver._n_verts
    masses = mesh.weighted_masses(density)
    if np.any(masses <= 0.0):
        raise RuntimeError("TetMesh Error: Zero mass")
    solver.add_nodes(mesh.vertices, masses)

    if not (mesh.flags & NOSELFCOLLISION):
        solver.add_dynamic_collider(
            make_tet_mesh_collider(mesh.vertices, mesh.tets, mesh.faces, prev_verts))
        for i in mesh.surface_inds():
            solver.surface_inds.append(int(i) + prev_verts)

    model = "linear"
    for flag, m in _FLAG_TO_MODEL.items():
        if mesh.flags & flag:
            model = m
    solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model,
                            vertex_offset=prev_verts,
                            lattice_dims=mesh.lattice_dims,
                            lattice_wrap=mesh.lattice_wrap)
    if verbose:
        print(
            f"Added mesh:\n\tmass: {masses.sum()}kg\n\tvertices: {len(mesh.vertices)}"
            f"\n\ttets: {len(mesh.tets)}\n\t(total) verts: {solver._n_verts}"
        )
    return prev_verts


def add_trimesh(solver: Solver, mesh: TriangleMesh, lame: Lame | None = None,
                verbose: bool = True, density: float = 1.0):
    """Append a triangle (cloth) mesh (AddMeshes.hpp:186-235); returns its
    vertex offset."""
    if lame is None:
        lame = Lame.rubber()
    prev_verts = solver._n_verts
    masses = mesh.weighted_masses(density)
    if np.any(masses <= 0.0):
        raise RuntimeError("TriMesh Error: Zero mass")
    solver.add_nodes(mesh.vertices, masses)
    solver.add_tri_energies(mesh.vertices, mesh.faces, lame, vertex_offset=prev_verts)
    if verbose:
        print(
            f"Added mesh:\n\tmass: {masses.sum()}kg\n\tvertices: {len(mesh.vertices)}"
            f"\n\ttris: {len(mesh.faces)}\n\t(total) verts: {solver._n_verts}"
        )
    return prev_verts


class GrabbySphere:
    """Radius vertex picker for interactive pinning (AddMeshes.hpp:70-91)."""

    def __init__(self, center, radius: float):
        self.c = np.asarray(center, dtype=np.float64)
        self.r = float(radius)

    def get_indices(self, x: np.ndarray) -> list[int]:
        x = np.asarray(x).reshape(-1, 3)
        d = np.linalg.norm(x - self.c, axis=-1)
        return [int(i) for i in np.where(d < self.r)[0]]
