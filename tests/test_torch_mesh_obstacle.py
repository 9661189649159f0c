"""The port's mesh obstacles (PassiveMeshSDF, PassiveMeshExact) against the JAX
package's on the CPU: the baked tables bit for bit (crossval's slab and the
5k slab of chip_smoke's card paths); the narrow phases on seeded query points
in float64 within 1e-12 and float32 within F32_TOL (the same hit masks but
for lanes within rounding of dx = 0), dense, compacted with and without
overflow, with the deep fallback and with its overflow; a Floor beside a mesh
(the first of least distance); the nonconvex sign oracle of
tests/test_contact.py:613; that GS's padded slots (duplicates at a colour's
tail) change no real lane's answer; convert.obstacle_from_numpy; kernel J's
wrapper on CPU tensors; the C layout constants the wrappers share with
csrc/obstacle_body.cuh; and the port's __all__ against the JAX package's.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admm_elastic_tpu
import admm_elastic_tpu_torch
import chip_smoke
from admm_elastic_tpu.collision import passive as jpassive
from admm_elastic_tpu.geometry.factory import make_tet_blocks as j_make_tet_blocks
from admm_elastic_tpu.geometry.factory import make_tet_torus as j_make_tet_torus
from admm_elastic_tpu.geometry.factory import make_xform as j_make_xform
from admm_elastic_tpu.geometry.mesh import surface_faces_from_tets as j_faces
from admm_elastic_tpu_torch import convert
from admm_elastic_tpu_torch.collision import passive as tpassive
from admm_elastic_tpu_torch.ops import cuda_gs, cuda_obstacle

torch.set_num_threads(1)
F64, F32 = torch.float64, torch.float32
CSRC = Path(cuda_obstacle.__file__).resolve().parent.parent / "csrc"
# float32: the two packages' sums in another order (XLA's reductions against
# the port's component and corner order): seen at 1.2e-7 on coordinates of
# about 2; a lane's hit may flip only within rounding of dx = 0
F32_TOL = 2e-6
F32_FLIP_DX = 1e-5
F32_TIES = 0.01

SLABS = {"crossval": chip_smoke.CROSSVAL_SLAB, "5k": chip_smoke.SLAB_5K}
BAKES = {("crossval", "sdf"): dict(resolution=24), ("crossval", "exact"): dict(cells=16),
         ("5k", "sdf"): dict(resolution=48, pad=chip_smoke.SDF_5K_PAD),
         ("5k", "exact"): dict(cells=32)}
JAX_ARRAYS = {"sdf": ("vals4", "minv", "origin", "h"),
              "exact": ("tri_abc", "nrm", "face_table", "face_count", "tet_count", "origin", "h")}
META = {"sdf": ("dims", "near_lanes"),
        "exact": ("dims", "capture_cells", "fallback_lanes", "near_lanes")}


def _slab(which):
    s = SLABS[which]
    mesh = j_make_tet_blocks(*s["blocks"], cell=s["cell"])
    mesh.apply_xform(j_make_xform(trans=s["trans"]))
    return mesh


_BAKED = {}


def baked(which, kind, **extra):
    """(JAX obstacle, port obstacle) of a slab, baked by each package, with
    extra meta fields replaced on both."""
    key = (which, kind)
    if key not in _BAKED:
        mesh = _slab(which)
        jcls = jpassive.PassiveMeshSDF if kind == "sdf" else jpassive.PassiveMeshExact
        tcls = tpassive.PassiveMeshSDF if kind == "sdf" else tpassive.PassiveMeshExact
        _BAKED[key] = (jcls.from_tet_mesh(mesh.vertices, mesh.tets, **BAKES[key]),
                       tcls.from_tet_mesh(mesh.vertices, mesh.tets, **BAKES[key]))
    j, t = _BAKED[key]
    return dataclasses.replace(j, **extra), dataclasses.replace(t, **extra)


@pytest.mark.parametrize("which,kind", sorted(BAKES))
def test_the_baked_tables_are_the_jax_package_s_bit_for_bit(which, kind):
    j, t = baked(which, kind)
    for f in JAX_ARRAYS[kind]:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if f == "face_table":
            a, b = a.astype(np.int32), b.astype(np.int32)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    for f in META[kind]:
        assert getattr(j, f) == getattr(t, f), f


def _queries(which, n=600, seed=0):
    """Seeded query points around a slab: most near it (inside, on and just
    outside its faces), some deep inside, some far outside the grid."""
    rng = np.random.default_rng(seed)
    mesh = _slab(which)
    lo, hi = mesh.vertices.min(0), mesh.vertices.max(0)
    ext = hi - lo
    return np.concatenate([
        rng.uniform(lo - 0.1 * ext, hi + 0.1 * ext, size=(n, 3)),
        rng.uniform(lo + 0.3 * ext, hi - 0.3 * ext, size=(n // 6, 3)),
        rng.uniform(lo - 5.0 * ext, lo - 3.0 * ext, size=(n // 6, 3)),
    ])


@jax.jit
def _jax_detect(obs, x):
    return obs.signed_distance_with_overflow(x)


def _both(j, t, x, dtype):
    jd = jnp.float64 if dtype == F64 else jnp.float32
    a = [np.asarray(v) for v in _jax_detect(j, jnp.asarray(x, jd))]
    b = [v.numpy() for v in t.to("cpu", dtype).signed_distance_with_overflow(
        torch.as_tensor(x).to(dtype))]
    return a, b


def _hold(a, b, dtype, scale, x):
    """Hold the port's (dx, point, normal, overflow) b at x to the JAX
    package's a. In float32 two candidate triangles can tie in squared
    distance within rounding (a query over an edge the two share), and each
    package's rounding picks its first of least: such a lane's dx agrees and
    its two points lie equally far from it, F32_TIES of the lanes at most."""
    assert bool(a[3]) == bool(b[3])
    flips = (a[0] < 0) != (b[0] < 0)
    if dtype == F64:
        assert not flips.any()
        tol = 1e-12 * scale
        keep = ~flips
    else:
        assert np.abs(a[0][flips]).max(initial=0.0) <= F32_FLIP_DX * scale
        tol = F32_TOL * scale
        keep = ~flips
        off = keep & (np.abs(a[1] - b[1]).max(-1) > tol)
        assert off.sum() <= F32_TIES * len(x)
        assert np.abs(np.linalg.norm(x[off] - a[1][off], axis=-1)
                      - np.linalg.norm(x[off] - b[1][off], axis=-1)).max(initial=0.0) <= tol
        keep = keep & ~off
        assert np.abs(a[0][off] - b[0][off]).max(initial=0.0) <= tol
    for k in range(3):
        assert a[k].shape == b[k].shape
        assert np.abs(a[k][keep] - b[k][keep]).max(initial=0.0) <= tol, k
    return int((b[0] < 0).sum()), bool(b[3])


# mode -> the obstacle's meta (near_lanes, fallback_lanes) and what must show
MODES = {
    "dense": dict(near_lanes=0),
    "compact": dict(near_lanes=650),
    "compact_overflow": dict(near_lanes=40),
}


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["sdf", "exact"])
def test_narrow_phase_against_the_jax_package(kind, mode, dtype):
    # room in the deep fallback for every interior query (its own test below)
    j, t = baked("crossval", kind, **MODES[mode],
                 **({} if kind == "sdf" else dict(fallback_lanes=1000)))
    x = _queries("crossval")
    a, b = _both(j, t, x, dtype)
    hits, ovf = _hold(a, b, dtype, float(np.abs(x).max()), x)
    assert hits > 20
    assert ovf == (mode == "compact_overflow")


# the deep fallback: points deep inside the slab of the 5k paths (cells=32:
# h 1.375, capture 2.75; the slab is 2 m thick, so use a capture of 0.5 cell
# to put most of its interior beyond the radius)
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("fallback,compact", [(400, 0), (400, 300), (8, 0), (8, 300)])
def test_deep_fallback_against_the_jax_package(fallback, compact, dtype):
    j, t = baked("5k", "exact", capture_cells=0.5, fallback_lanes=fallback, near_lanes=compact)
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform((-1.5, -2.9, -2.0), (41.5, -1.1, 7.0), size=(200, 3)),
                        rng.uniform((-3.0, -4.0, -4.0), (43.0, 0.0, 9.0), size=(200, 3))])
    a, b = _both(j, t, x, dtype)
    hits, ovf = _hold(a, b, dtype, float(np.abs(x).max()), x)
    cid, in_grid = t.cells(torch.as_tensor(x))
    near = int((in_grid & (t.tet_count[cid] > 0)).sum())
    deep = int((a[0] < -0.5 * float(t.h)).sum())  # the lanes the fallback served
    assert hits > deep >= min(fallback, 8) and near > compact
    assert ovf == (fallback == 8 or compact > 0)


def test_floor_beside_a_mesh_takes_the_first_of_least_distance():
    j, t = baked("crossval", "exact", near_lanes=300)
    x = _queries("crossval", seed=2)
    jf = jpassive.Floor(y=jnp.asarray(-0.05))
    tf = tpassive.Floor(y=-0.05)
    a = [np.asarray(v) for v in jax.jit(jpassive.detect_passive)((jf, j), jnp.asarray(x))]
    b = [v.numpy() for v in tpassive.detect_passive([tf, t.to("cpu", F64)], torch.as_tensor(x))]
    assert np.array_equal(a[3], b[3])
    for k in range(3):
        assert np.abs(a[k] - b[k]).max() <= 1e-12 * float(np.abs(x).max()), k
    assert bool(a[4]) == bool(b[4])
    # both obstacles win somewhere
    d_floor = x[:, 1] + 0.05
    assert ((b[0] == d_floor) & (b[0] < 0)).any() and ((b[0] != d_floor) & (b[0] < 0)).any()


@pytest.mark.parametrize("capture_cells", [1.0, 2.0])
def test_nonconvex_sign_oracle(capture_cells):
    """tests/test_contact.py:613 on the port: on a torus at a tight capture
    radius every inside point reports its exact global penetration and no
    outside point a phantom hit; and the port's answer is the JAX package's."""
    obs = j_make_tet_torus(major_radius=1.0, minor_radius=0.45, n_ring=16, n_sec=4)
    faces = j_faces(obs.tets)
    rng = np.random.default_rng(5)
    lo, hi = obs.vertices.min(0) - 0.05, obs.vertices.max(0) + 0.05
    pts = rng.uniform(lo, hi, size=(1500, 3))
    d_ref = tpassive._point_tri_distance_np(pts, obs.vertices, faces)
    ins_ref = tpassive._points_in_tets_np(pts, obs.vertices, obs.tets)
    sure = d_ref > 1e-6
    m = tpassive.PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=20,
                                                capture_cells=capture_cells, fallback_lanes=2048)
    dx, _, _, ovf = (v.numpy() for v in m.signed_distance_with_overflow(torch.as_tensor(pts)))
    assert not bool(ovf)
    inn = ins_ref & sure
    assert inn.sum() > 100
    assert (dx[inn] < 0).all()
    assert np.abs(dx[inn] + d_ref[inn]).max() < 1e-10
    out = ~ins_ref & sure
    assert (dx[out] >= 0).all()
    near_out = out & (d_ref < capture_cells * float(m.h))
    assert near_out.sum() > 50
    assert np.abs(dx[near_out] - d_ref[near_out]).max() < 1e-10
    jm = jpassive.PassiveMeshExact.from_tet_mesh(obs.vertices, obs.tets, cells=20,
                                                 capture_cells=capture_cells, fallback_lanes=2048)
    jdx = np.asarray(_jax_detect(jm, jnp.asarray(pts))[0])
    assert np.abs(jdx - dx).max() <= 1e-12


@pytest.mark.parametrize("kind", ["sdf", "exact"])
def test_padded_slots_at_a_colour_s_tail_change_no_real_lane(kind):
    """Gauss-Seidel detects on a colour's padded rows, its padding (copies of
    row n - 1's update) at the tail: they rank after every real lane, so
    they take no near-lane place and no fallback place from one, and kernel
    H may skip them. Tail copies of the deepest lane change every real lane's
    answer not a bit, though they overflow the compaction."""
    extra = dict(near_lanes=60) if kind == "sdf" else dict(near_lanes=60, fallback_lanes=6,
                                                           capture_cells=0.5)
    _, t = baked("5k" if kind == "exact" else "crossval", kind, **extra)
    rng = np.random.default_rng(4)
    if kind == "exact":
        x = np.concatenate([rng.uniform((-1.5, -2.9, -2.0), (41.5, -1.1, 7.0), size=(30, 3)),
                            rng.uniform((-3.0, -4.0, -4.0), (43.0, 0.0, 9.0), size=(200, 3))])
    else:
        x = _queries("crossval", n=300, seed=4)
    t = t.to("cpu", F64)
    xt = torch.as_tensor(x)
    real = t.signed_distance_with_overflow(xt)
    deepest = int(torch.argmin(real[0]))
    padded = torch.cat([xt, xt[deepest].expand(40, 3)])
    got = t.signed_distance_with_overflow(padded)
    for k in range(3):
        assert torch.equal(got[k][:x.shape[0]], real[k]), k
    assert bool(got[3])  # the copies overflow what the real lanes filled


@pytest.mark.parametrize("kind", ["sdf", "exact"])
def test_obstacle_from_numpy_carries_a_jax_obstacle_over(kind):
    j, t = baked("crossval", kind, near_lanes=100)
    d = {f: np.asarray(getattr(j, f)) for f in JAX_ARRAYS[kind]}
    d.update({f: getattr(j, f) for f in META[kind]},
             kind="PassiveMeshSDF" if kind == "sdf" else "PassiveMeshExact")
    c = convert.obstacle_from_numpy(d)
    assert type(c) is type(t)
    for f in JAX_ARRAYS[kind]:
        assert torch.equal(getattr(c, f), getattr(t, f)), f
    x = torch.as_tensor(_queries("crossval", n=120, seed=6))
    for u, v in zip(c.signed_distance_with_overflow(x), t.signed_distance_with_overflow(x)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("kind", ["sdf", "exact"])
def test_kernel_j_wrapper_takes_the_plain_version_on_the_cpu(kind):
    _, t = baked("crossval", kind, near_lanes=40)
    t = t.to("cpu", F32)
    x = torch.as_tensor(_queries("crossval", seed=7)).to(F32)
    flag = torch.zeros((1,), dtype=torch.int32)
    before = cuda_obstacle.mesh_detect.launches
    dx, point, normal, mask = cuda_obstacle.mesh_detect(t, x, flag)
    want = t.signed_distance_with_overflow(x)
    assert torch.equal(dx, want[0]) and torch.equal(point, want[1])
    assert torch.equal(normal, want[2]) and torch.equal(mask, want[0] < 0)
    assert int(flag) == 1 and bool(want[3])  # overflow set, never cleared
    cuda_obstacle.mesh_detect(dataclasses.replace(t, near_lanes=0), x, flag)
    assert int(flag) == 1
    assert cuda_obstacle.mesh_detect.launches == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_obstacle._launch(t, x, flag)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / "obstacle_body.cuh").read_text()).group(1))


def test_the_wrappers_layout_matches_the_cuda_sources():
    body = (CSRC / "obstacle_body.cuh").read_text()
    kinds = re.search(r"enum MeshKind \{ MESH_SDF = (\d+), MESH_EXACT = (\d+) \}", body)
    assert (int(kinds.group(1)), int(kinds.group(2))) == (cuda_obstacle.MESH_SDF,
                                                          cuda_obstacle.MESH_EXACT)
    assert _constant("kMeshInts") == cuda_obstacle.MESH_INTS
    assert _constant("kMeshPtrs") == cuda_obstacle.MESH_PTRS
    gs = (CSRC / "gs.cu").read_text()
    assert int(re.search(r"constexpr int kSlot = (\d+);", gs).group(1)) == cuda_gs.SLOT_SCRATCH
    for kind in ("sdf", "exact"):
        _, t = baked("crossval", kind, near_lanes=7)
        t = t.to("cpu", F32)
        ints, ptrs, capture = cuda_obstacle.mesh_desc(t, torch.device("cpu"), F32)
        assert len(ints) == cuda_obstacle.MESH_INTS and len(ptrs) == cuda_obstacle.MESH_PTRS
        assert ints[:5] == [cuda_obstacle.MESH_SDF if kind == "sdf" else cuda_obstacle.MESH_EXACT,
                            *t.dims, 7]
        assert ints[9] == t.dims[0] * t.dims[1] * t.dims[2]
        assert capture == (0.0 if kind == "sdf" else 2.0)
        with pytest.raises(ValueError, match="float64"):  # the tables in another dtype
            cuda_obstacle.mesh_desc(t, torch.device("cpu"), F64)
    kinds, par = cuda_gs.obstacle_params([tpassive.Floor(y=-1.0),
                                          baked("crossval", "exact")[1],
                                          baked("crossval", "sdf")[1]])
    assert kinds == (cuda_gs.FLOOR, cuda_obstacle.MESH_EXACT, cuda_obstacle.MESH_SDF)
    assert list(par)[4] == 2.0  # capture_cells
    with pytest.raises(TypeError, match="kernel H takes"):
        cuda_gs.obstacle_params([object()])


def test_all_is_the_jax_package_s():
    assert admm_elastic_tpu_torch.__all__ == admm_elastic_tpu.__all__
    for name in admm_elastic_tpu_torch.__all__:
        assert hasattr(admm_elastic_tpu_torch, name)
