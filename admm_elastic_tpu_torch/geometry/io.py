"""Mesh file IO: TetGen .node/.ele pairs and Wavefront .obj.

A copy of ``admm_elastic_tpu/geometry/io.py:17-82`` (numpy only):
``load_elenode``, ``save_elenode``, ``load_obj``, ``save_obj`` (the
reference's mcl::meshio::load_elenode, consumed at
samples/tvcg2017/torus.cpp:33, and obj loading). File formats per the
sample data (data/bunny_1124.node: header "N 3 0 0" / "M 4 0"); indices
are normalised to 0-based. A loaded mesh has no ``lattice_dims``, so it
runs as a gather family.
"""

from __future__ import annotations

import numpy as np

from admm_elastic_tpu_torch.geometry.mesh import TetMesh, TriangleMesh


def _read_rows(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                rows.append(line.split())
    return rows


def load_elenode(basename: str) -> TetMesh:
    """Load `<basename>.node` + `<basename>.ele` (TetGen format)."""
    node_rows = _read_rows(basename + ".node")
    n_pts = int(node_rows[0][0])
    first_idx = int(node_rows[1][0])
    verts = np.array([[float(v) for v in r[1:4]] for r in node_rows[1 : 1 + n_pts]])

    ele_rows = _read_rows(basename + ".ele")
    n_tets = int(ele_rows[0][0])
    tets = np.array(
        [[int(v) for v in r[1:5]] for r in ele_rows[1 : 1 + n_tets]], dtype=np.int64
    )
    tets -= first_idx  # normalize to 0-indexed
    # Fix inverted tets (negative volume) by swapping two vertices, as
    # TetGen files sometimes mix orientation.
    x4 = verts[tets]
    e = np.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], axis=-1)
    bad = np.linalg.det(e) < 0
    tets[bad] = tets[bad][:, [0, 2, 1, 3]]
    return TetMesh(vertices=verts, tets=tets)


def save_elenode(mesh: TetMesh, basename: str):
    with open(basename + ".node", "w") as f:
        f.write(f"{len(mesh.vertices)}  3  0  0\n")
        for i, v in enumerate(mesh.vertices):
            f.write(f"   {i}    {v[0]}  {v[1]}  {v[2]}\n")
    with open(basename + ".ele", "w") as f:
        f.write(f"{len(mesh.tets)}  4  0\n")
        for i, t in enumerate(mesh.tets):
            f.write(f"    {i}     {t[0]}   {t[1]}   {t[2]}   {t[3]}\n")


def load_obj(path: str) -> TriangleMesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriangleMesh(vertices=np.asarray(verts, dtype=np.float64),
                        faces=np.asarray(faces, dtype=np.int64))


def save_obj(mesh: TriangleMesh, path: str):
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in mesh.faces:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
