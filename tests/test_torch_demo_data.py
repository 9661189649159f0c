"""The port's demo meshes (geometry/demo_data.py, the generators of
geometry/factory.py) against the JAX package's, on the CPU.

- every generator of GENERATORS bit for bit the JAX package's, and
  make_tet_sphere / make_tet_bunny_like / make_sphere at other sizes;
- load_demo_mesh: the meshes in data/ bit for bit the JAX loader's; a generated
  mesh bit for bit what the JAX loader saves into data/ and loads back (built
  here as the JAX generator's mesh through save_elenode into a temporary
  directory and load_elenode: the JAX loader itself would write into data/);
- its priority: $ADMM_DATA_DIR, then data/, then the generator, then the
  caller's fallback, else FileNotFoundError;
- it creates and touches no file under data/ (names and mtimes before and
  after).
"""

import os

import numpy as np
import pytest

from admm_elastic_tpu.geometry import demo_data as jdemo
from admm_elastic_tpu.geometry import factory as jfactory
from admm_elastic_tpu.geometry.io import load_elenode as j_load
from admm_elastic_tpu.geometry.io import save_elenode as j_save
from admm_elastic_tpu_torch.geometry import demo_data, factory
from admm_elastic_tpu_torch.geometry.io import save_elenode

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
IN_DATA = ("bunny_1124", "sphere", "torus")  # shipped under data/
GENERATED = ("bunny_2250", "box768")  # in no data directory: generated


def _same(a, b):
    assert a.vertices.dtype == b.vertices.dtype and a.tets.dtype == b.tets.dtype
    assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.tets, b.tets)


def _data_files():
    return {f: os.stat(os.path.join(DATA, f)).st_mtime_ns for f in sorted(os.listdir(DATA))}


@pytest.fixture(autouse=True)
def _no_user_data(monkeypatch):
    monkeypatch.delenv("ADMM_DATA_DIR", raising=False)


@pytest.mark.parametrize("name", sorted(jdemo.GENERATORS))
def test_generators_bit_equal(name):
    assert sorted(demo_data.GENERATORS) == sorted(jdemo.GENERATORS)
    got, want = demo_data.GENERATORS[name](), jdemo.GENERATORS[name]()
    _same(got, want)
    assert got.lattice_dims == getattr(want, "lattice_dims", None)


@pytest.mark.parametrize("args", [(1.0, 4), (0.3, 7)])
def test_tet_sphere_bit_equal(args):
    _same(factory.make_tet_sphere(*args), jfactory.make_tet_sphere(*args))


@pytest.mark.parametrize("n_points, seed", [(250, 7), (400, 3)])
def test_bunny_like_bit_equal(n_points, seed):
    _same(factory.make_tet_bunny_like(n_points, seed), jfactory.make_tet_bunny_like(n_points, seed))
    q = np.random.default_rng(seed).uniform(-1, 1, (500, 3))
    assert np.array_equal(factory._bunny_blob_sdf_inside(q), jfactory._bunny_blob_sdf_inside(q))


@pytest.mark.parametrize("name", IN_DATA)
def test_loads_the_meshes_in_data(name):
    before = _data_files()
    got = demo_data.load_demo_mesh(name)
    _same(got, jdemo.load_demo_mesh(name))  # a file in data/: the JAX loader writes nothing
    _same(got, j_load(os.path.join(DATA, name)))
    assert _data_files() == before


@pytest.mark.parametrize("name", GENERATED)
def test_generated_mesh_is_the_jax_loaders_and_writes_nothing(name, tmp_path):
    before = _data_files()
    got = demo_data.load_demo_mesh(name)
    assert _data_files() == before
    j_save(jdemo.GENERATORS[name](), str(tmp_path / name))
    _same(got, j_load(str(tmp_path / name)))
    assert got.lattice_dims is None  # a loaded mesh runs as a gather family


def test_priority(tmp_path, monkeypatch):
    """$ADMM_DATA_DIR first, then data/, then the generator, then fallback."""
    small = factory.make_tet_blocks(1, 1, 1)
    save_elenode(small, str(tmp_path / "sphere"))
    save_elenode(small, str(tmp_path / "custom"))
    monkeypatch.setenv("ADMM_DATA_DIR", str(tmp_path))
    _same(demo_data.load_demo_mesh("sphere"), small)  # the user's beats data/
    _same(demo_data.load_demo_mesh("custom"), small)
    _same(demo_data.load_demo_mesh("torus"), j_load(os.path.join(DATA, "torus")))
    monkeypatch.setenv("ADMM_DATA_DIR", str(tmp_path / "missing"))
    _same(demo_data.load_demo_mesh("sphere"), j_load(os.path.join(DATA, "sphere")))
    monkeypatch.delenv("ADMM_DATA_DIR")
    before = _data_files()
    got = demo_data.load_demo_mesh("nowhere", fallback=lambda: factory.make_tet_blocks(2, 1, 1))
    j_save(jfactory.make_tet_blocks(2, 1, 1), str(tmp_path / "nowhere"))
    _same(got, j_load(str(tmp_path / "nowhere")))
    with pytest.raises(FileNotFoundError, match="nowhere"):
        demo_data.load_demo_mesh("nowhere")
    assert _data_files() == before


def test_make_sphere_bit_equal():
    for args in (((0.0, 1.0, 0.0), 0.5), ((1.0, -2.0, 3.0), 2.0, 7)):
        got, want = factory.make_sphere(*args), jfactory.make_sphere(*args)
        assert np.array_equal(got.vertices, want.vertices)
        assert np.array_equal(got.faces, want.faces)
