"""utils/checkpoint.py (save_state / load_state) against the JAX package's,
on the CPU: the round trip, files written by either package loading in the
other under the same npz keys, tests/test_utils.py's bitwise replay from a
checkpoint, and the round-1 migration (a file with n_active_prev and no
prev_active loads with an all-False prev_active). Exact: a checkpoint holds
the state's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.system.system import SimState as JSimState
from admm_elastic_tpu.utils import checkpoint as jck
from admm_elastic_tpu_torch import Lame, Settings, Solver
from admm_elastic_tpu_torch.system.system import SimState
from admm_elastic_tpu_torch.utils import checkpoint as tck
from test_torch_contact import _jax_api

torch.set_num_threads(1)
FIELDS = ("x", "v", "y", "prev_active")
VERTS = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)


def _state(dtype=torch.float64, rows=6, seed=0):
    rng = np.random.default_rng(seed)
    return SimState(x=torch.as_tensor(rng.standard_normal((4, 3))).to(dtype),
                    v=torch.as_tensor(rng.standard_normal((4, 3))).to(dtype),
                    y=torch.as_tensor(rng.standard_normal(rows)).to(dtype),
                    prev_active=torch.as_tensor(rng.random(rows) < 0.5))


def _equal(a, b):
    for f in FIELDS:
        ta, tb = getattr(a, f), np.asarray(getattr(b, f))
        assert np.array_equal(ta.numpy(), tb) and ta.numpy().dtype == tb.dtype, f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_round_trip(tmp_path, dtype):
    st = _state(dtype)
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, st, step=np.asarray(7))
    back = tck.load_state(path, device="cpu")
    _equal(back, st)
    assert int(np.load(path)["step"]) == 7
    as64 = tck.load_state(path, torch.float64, device="cpu")
    assert all(getattr(as64, f).dtype == torch.float64 for f in ("x", "v", "y"))
    assert as64.prev_active.dtype == torch.bool
    assert torch.equal(as64.x, st.x.double())


def test_a_file_of_either_package_loads_in_the_other(tmp_path):
    st = _state()
    jst = JSimState(**{f: jnp.asarray(getattr(st, f).numpy()) for f in FIELDS})
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_state(jpath, jst)
    tck.save_state(tpath, st)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(FIELDS)
    _equal(tck.load_state(jpath, device="cpu"), st)
    back = jck.load_state(tpath)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(back, f)), getattr(st, f).numpy()), f


def test_round_1_migration(tmp_path):
    """A round-1 checkpoint (an i32 n_active_prev, no prev_active) loads in
    both packages with prev_active all False, of y's shape."""
    st = _state()
    path = str(tmp_path / "r1.npz")
    np.savez(path, x=st.x.numpy(), v=st.v.numpy(), y=st.y.numpy(),
             n_active_prev=np.asarray(3, np.int32))
    back = tck.load_state(path, device="cpu")
    assert back.prev_active.dtype == torch.bool and back.prev_active.shape == st.y.shape
    assert not bool(back.prev_active.any())
    assert np.array_equal(np.asarray(jck.load_state(path).prev_active), back.prev_active.numpy())


def _one_tet():
    s = Solver(device="cpu")
    s.add_nodes(VERTS, np.ones(4))
    s.add_tet_energies(VERTS, np.array([[0, 1, 2, 3]]), Lame.from_youngs_poisson(5e5, 0.25))
    s.set_pins([0])
    assert s.initialize(Settings(verbose=0, admm_iters=10))
    return s


def test_bitwise_replay(tmp_path):
    """tests/test_utils.py:22-40: three steps, a checkpoint, a step away; the
    loaded state gives the checkpoint's x, and the step from it repeats bit
    for bit."""
    s = _one_tet()
    s.run(3)
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, s.state)
    x3 = s.x
    s.step()  # diverge
    s.state = tck.load_state(path, device=s.device)
    assert np.array_equal(s.x, x3)
    s.step()
    x4 = s.x
    s.state = tck.load_state(path, device=s.device)
    s.step()
    assert np.array_equal(s.x, x4)


def test_contact_state_resumes(tmp_path):
    """A contact scene (crossval's 6x3x3 beam on a Floor, AL-PCG, float64)
    checkpointed after landing resumes bit for bit, its multipliers and
    active rows included; the JAX package resumes from the port's file to
    the same step within 1e-9 (measured 1e-14). AL-PCG, not Uzawa: Uzawa's
    Schur CG leaves the contact vertices on the floor within rounding, and the
    next detection then parts the two packages by a last bit
    (tests/test_torch_logging.py)."""
    chip_smoke.DEVICE = "cpu"
    s = chip_smoke.contact_scene("contact_alpcg_f64", chip_smoke.torch_api("cpu"))
    s.run(12)
    assert bool(s.state.prev_active.any())
    path = str(tmp_path / "ck.npz")
    tck.save_state(path, s.state)
    s.step()
    x13 = s.x
    s.state = tck.load_state(path, device="cpu")
    s.step()
    assert np.array_equal(s.x, x13)
    jx = chip_smoke.contact_scene("contact_alpcg_f64", _jax_api())
    jx.state = jck.load_state(path)
    jx.step()
    assert np.abs(np.asarray(jx.x) - x13).max() <= 1e-9 * np.abs(x13).max()
