"""The demo meshes by the reference's sample-data names (a port of
``admm_elastic_tpu/geometry/demo_data.py``).

The reference ships .node/.ele meshes under samples/data/ (bunny_1124,
torus, sphere, ...). ``load_demo_mesh`` looks a name up, in this order:

1. ``$ADMM_DATA_DIR/<name>.node`` (data of the user's own, such as the
   reference's samples/data);
2. ``<repo>/data/<name>.node`` (bunny_1124, sphere and torus are there);
3. the name's generator in ``GENERATORS``, whose mesh goes through the
   .node/.ele text format in a temporary directory and is loaded back, so
   that it is the mesh that the JAX package's loader saves into
   ``<repo>/data`` and loads (a loaded mesh carries no lattice tag and runs
   as a gather family). Unlike the JAX package's loader, this one writes
   nothing into the repository.
"""

from __future__ import annotations

import os
import tempfile

from admm_elastic_tpu_torch.geometry import factory
from admm_elastic_tpu_torch.geometry.io import load_elenode, save_elenode

_REPO_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data")


def _scaled(mesh, s: float):
    mesh.apply_xform(factory.make_xform(scale=(s,) * 3))
    return mesh


# name -> generator (a bunny-class blob; the analytic torus and sphere), at
# the scales of the reference's data (bunny_1124 is some 0.15 m across).
GENERATORS = {
    "bunny_1124": lambda: _scaled(factory.make_tet_bunny_like(600), 0.08),
    "bunny_2250": lambda: _scaled(factory.make_tet_bunny_like(1200), 0.08),
    "torus": lambda: factory.make_tet_torus(1.0, 0.35, 24, 4),
    "sphere": lambda: factory.make_tet_sphere(0.5, 6),
    "box768": lambda: factory.make_tet_blocks(4, 8, 4, cell=0.25),
}


def load_demo_mesh(name: str, fallback=None):
    """Load a demo mesh by the reference's data name (see the module's
    docstring); ``fallback`` generates a name that GENERATORS lacks."""
    user_dir = os.environ.get("ADMM_DATA_DIR")
    if user_dir and os.path.exists(os.path.join(user_dir, name + ".node")):
        return load_elenode(os.path.join(user_dir, name))

    base = os.path.join(_REPO_DATA, name)
    if os.path.exists(base + ".node"):
        return load_elenode(base)

    gen = GENERATORS.get(name, fallback)
    if gen is None:
        raise FileNotFoundError(
            f"no demo mesh {name!r}: not in ADMM_DATA_DIR, {_REPO_DATA}, or GENERATORS")
    with tempfile.TemporaryDirectory() as tmp:
        save_elenode(gen(), os.path.join(tmp, name))
        return load_elenode(os.path.join(tmp, name))
