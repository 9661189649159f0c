"""The port's command line, rendering and the small API beside them, against
the JAX package on the CPU.

- Settings.parse_args / help: the four cases of tests/test_config.py, the help
  text equal to the JAX package's;
- utils/render.py: a copy of tests/test_render.py (frames and an mp4 through
  ffmpeg where installed, else a GIF through PIL);
- an app runs without matplotlib and PIL where it asks for no picture, and
  fails with their ImportError where it asks for screenshots;
- binding.GrabbySphere, factory.make_sphere, materials.lame and
  system.init_state against the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from admm_elastic_tpu import binding as jbind
from admm_elastic_tpu import materials as jmat
from admm_elastic_tpu.config import Settings as JSettings
from admm_elastic_tpu.geometry import factory as jfactory
from admm_elastic_tpu.system import system as jsys
from admm_elastic_tpu_torch import binding, materials
from admm_elastic_tpu_torch.apps import trianglestrain
from admm_elastic_tpu_torch.config import Settings
from admm_elastic_tpu_torch.geometry import factory
from admm_elastic_tpu_torch.system import system as sysm

torch.set_num_threads(1)


# --- tests/test_config.py ----------------------------------------------------------

def test_parse_args_flags():
    s = Settings()
    assert not s.parse_args(["-dt", "0.01", "-v", "2", "-it", "7",
                             "-g", "-1.5", "-ls", "4", "-ck", "3.0"])
    assert s.timestep_s == 0.01
    assert s.verbose == 2
    assert s.admm_iters == 7
    assert s.gravity == -1.5
    assert s.linsolver == 4
    assert s.constraint_w == 3.0


def test_parse_args_help_returns_true(capsys):
    assert Settings().parse_args(["-help"])
    assert "-ls" in capsys.readouterr().out


def test_parse_args_trailing_flag_errors():
    with pytest.raises(ValueError, match="-it"):
        Settings().parse_args(["-dt", "0.01", "-it"])


def test_parse_args_ignores_unknown():
    s = Settings()
    assert not s.parse_args(["--frames", "5", "-it", "3"])
    assert s.admm_iters == 3


@pytest.mark.parametrize("argv", [["-dt", "0.02", "-v", "0", "--x", "-ls", "2", "-g", "1"],
                                  ["-h"], ["--help", "-it", "4"], ["-ck", "-1", "-it", "9"]])
def test_parse_args_as_the_jax_package(argv, capsys):
    s, js = Settings(), JSettings()
    assert s.parse_args(argv) == js.parse_args(argv)
    for f in ("timestep_s", "verbose", "admm_iters", "gravity", "linsolver", "constraint_w"):
        assert getattr(s, f) == getattr(js, f), f


def test_help_text_is_the_jax_packages(capsys):
    Settings.help()
    got = capsys.readouterr().out
    JSettings.help()
    assert got == capsys.readouterr().out and "-ls" in got


# --- tests/test_render.py -----------------------------------------------------------

def test_render_trajectory_and_video(tmp_path):
    from admm_elastic_tpu_torch.geometry.mesh import surface_faces_from_tets
    from admm_elastic_tpu_torch.utils.render import render_trajectory

    mesh = factory.make_tet_blocks(2, 2, 2)
    faces = surface_faces_from_tets(mesh.tets)
    x0 = mesh.vertices.astype(np.float64)
    traj = np.stack([x0 + [0, -0.1 * k, 0] for k in range(3)])

    out = tmp_path / "frames"
    video = tmp_path / "drop.mp4"
    paths = render_trajectory(traj, [(0, len(x0), faces)], str(out),
                              video=str(video), floor_y=-1.0)
    for k in range(3):
        p = out / f"{k:05d}.png"
        assert p.exists() and p.stat().st_size > 1000, p
    assert os.path.exists(paths[-1]) and os.path.getsize(paths[-1]) > 1000
    assert paths[-1].endswith((".mp4", ".gif"))


# --- pictures only where asked for ------------------------------------------------------

@pytest.fixture
def no_pictures(monkeypatch):
    """matplotlib and PIL made unimportable (a None entry in sys.modules)."""
    for name in ("matplotlib", "matplotlib.pyplot", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)


def test_app_runs_without_matplotlib(no_pictures, tmp_path, capsys):
    out = tmp_path / "traj.npz"
    assert trianglestrain.main(["--cpu", "--frames", "2", "-v", "0", "--out", str(out)]) == 0
    assert np.load(out)["x"].shape == (2, 242, 3)
    assert "limited sheet min y" in capsys.readouterr().out


def test_app_asking_for_screenshots_needs_matplotlib(no_pictures, tmp_path):
    with pytest.raises(ImportError):
        trianglestrain.main(["--cpu", "--frames", "1", "-v", "0",
                             "--screenshots", str(tmp_path / "shots")])


# --- the rest of the API ------------------------------------------------------------------

def test_grabby_sphere_as_the_jax_package():
    x = np.random.default_rng(3).uniform(-1, 1, (200, 3))
    for center, r in (((0.0, 0.0, 0.0), 0.5), ((0.5, -0.2, 0.1), 0.8), ((5, 5, 5), 1.0)):
        got = binding.GrabbySphere(center, r).get_indices(x)
        assert got == jbind.GrabbySphere(center, r).get_indices(x)
        assert all(isinstance(i, int) for i in got)


@pytest.mark.parametrize("args", [((0, 0, 0), 1.0), ((1.0, 2.0, -3.0), 0.25, 5)])
def test_make_sphere_as_the_jax_package(args):
    got, want = factory.make_sphere(*args), jfactory.make_sphere(*args)
    assert np.array_equal(got.vertices, want.vertices)
    assert np.array_equal(got.faces, want.faces)
    assert got.faces.dtype == np.int64


@pytest.mark.parametrize("k, v", [(1e7, 0.499), (1e6, 0.3), (100.0, 0.1)])
def test_lame_as_the_jax_package(k, v):
    got, want = materials.lame(k, v), jmat.lame(k, v)
    assert (got.mu, got.lam, got.limit_min, got.limit_max) == (
        want.mu, want.lam, want.limit_min, want.limit_max)
    assert got.bulk_modulus() == want.bulk_modulus()


def test_init_state_as_the_jax_package():
    x = np.random.default_rng(4).standard_normal((5, 3)).astype(np.float32)
    st, jst = sysm.init_state(x, 4), jsys.init_state(x, 4)
    for f in ("x", "v", "y", "prev_active"):
        got, want = getattr(st, f).numpy(), np.asarray(getattr(jst, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
