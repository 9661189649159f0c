"""Mesh obstacles in a batch (parallel/batch.py) on the CPU: kernel J's
twin with a scene axis, the mesh obstacles' signed_distance_with_overflow(
scenes=True), each scene bit for bit its own call, including scenes whose
compaction differs, which a compaction over the pooled lanes would fail; a
per-scene overflow that the JAX package's batch flags in some scenes and not
in others (chip_smoke's batch_exactmesh_alpcg4); Uzawa over the exact slab of
tests/test_parallel.py:224-270 (batch_exactmesh_uzawa) against the JAX
package's batch and its golden.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.parallel import batch as jb
from admm_elastic_tpu_torch.collision import passive as tpassive
from admm_elastic_tpu_torch.parallel import batch as tb
from make_torch_golden import jax_api
from test_torch_batch import _carry

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _slab(kind, **bake):
    spec = dict(chip_smoke.EXACTMESH_BATCH_SLAB, kind=kind,
                bake=dict(cells=24, **bake) if kind == "exact" else dict(resolution=24, **bake))
    return chip_smoke.mesh_obstacle(spec, chip_smoke.torch_api("cpu"))


@pytest.mark.parametrize("kind", ["exact", "sdf"])
def test_mesh_obstacle_scenes_compact_per_scene(kind):
    """A mesh obstacle's narrow phase with a scene axis, each scene bitwise
    its own call (near lanes, the deep fallback and the overflow its own),
    on scenes whose near lanes differ in number and place: a compaction of
    the pooled lanes (the first K of the whole batch) gives other lanes and
    one overflow, which the scene form does not."""
    k_near = 6
    obs = _slab(kind, near_lanes=k_near, **({"fallback_lanes": 2} if kind == "exact" else {}))
    obs = obs.to("cpu", F64)
    rng = np.random.default_rng(2)
    v = 40
    base = np.stack([rng.uniform(0.2, 1.8, v), rng.uniform(0.4, 0.6, v),
                     rng.uniform(0.2, 1.8, v)], axis=1)
    # scene i sinks 3 (i + 1) lanes, every other one, just under the slab's top,
    # and its last such lane 0.6 m deep (the exact slab's deep fallback)
    x = np.repeat(base[None], 3, axis=0)
    for i in range(3):
        sunk = np.arange(0, 6 * (i + 1), 2)
        x[i, sunk, 1] = -0.03
        x[i, sunk[-1], 1] = -0.6
    xt = torch.as_tensor(x)
    got = obs.signed_distance_with_overflow(xt, scenes=True)
    hit = [int((got[0][i] < 0.0).sum()) for i in range(3)]
    assert len(set(hit)) > 1, hit  # the scenes compact differently
    for i in range(3):
        want = obs.signed_distance_with_overflow(xt[i])
        assert all(torch.equal(g[i], w) for g, w in zip(got, want)), i
    assert got[3].tolist() == [False, False, True]  # 9 near lanes > 6 in the last scene only
    pooled = obs.signed_distance_with_overflow(xt)
    assert not torch.equal(pooled[0], got[0]) and bool(pooled[3])
    _, _, _, mask, ovf = tpassive.detect_passive([obs], xt, scenes=True)
    assert torch.equal(ovf, got[3]) and torch.equal(mask, got[0] < 0.0)


def _both_batches(build, n_steps, scales, gravity, dtype=F64, control=False):
    """Both packages' batches of build's scene from the JAX package's batch,
    n_steps: [(JAX x, port x, JAX overflow, port overflow)] a step, the
    port's step, and with control the JAX package's batch from x one ulp up
    after n_steps (its x)."""
    js, ts = build(jax_api()), build(chip_smoke.torch_api("cpu"))
    jbatch = jb.make_scenario_batch(js, len(scales), stiffness_scale=np.asarray(scales),
                                    gravity=np.asarray(gravity))
    tbatch = _carry(jbatch, dtype)
    ctl = dataclasses.replace(jbatch, x=jnp.asarray(np.nextafter(np.asarray(jbatch.x), np.inf)))
    jstep = jb.make_batched_step(js, mesh=None, donate=False)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    out = []
    for _ in range(n_steps):
        jbatch, tbatch = jstep(jbatch), tstep(tbatch)
        if control:
            ctl = jstep(ctl)
        out.append((np.asarray(jbatch.x), tbatch.x.double().numpy(),
                    np.asarray(jbatch.overflow), tbatch.overflow.numpy()))
    return out, tstep, (np.asarray(ctl.x) if control else None)


def test_per_scene_overflow_is_the_jax_package_s():
    """chip_smoke's batch_exactmesh_alpcg4: near_lanes=4 over the exact slab,
    the body 0.1 m above it, the middle scene held there (gravity 0): after
    the others reach the slab's cells, the JAX package's batch flags them and
    not the held scene, and the port's batch flags the same scenes at every
    step, its x on the JAX package's and on the golden's."""
    name = "batch_exactmesh_alpcg4"
    p = chip_smoke.BATCH_SCENES[name]
    out, _, _ = _both_batches(lambda api: chip_smoke.batch_scene(name, api)[0],
                              max(chip_smoke.batch_steps(name)), p["scales"], p["gravity"])
    g = chip_smoke.golden(name)
    for k, (xj, xt, oj, ot) in enumerate(out, 1):
        np.testing.assert_array_equal(ot, oj, err_msg=f"step {k}")
        assert _rel(xt, xj) <= 1e-9, k
        if k in chip_smoke.batch_steps(name):
            np.testing.assert_array_equal(ot, g[f"ovf{k}"])
            assert _rel(xt, g[f"x{k}"]) <= 1e-9, k
    assert out[-1][2].tolist() == [True, False, True]


# Uzawa on the exact slab (float32), port against the JAX package relative to
# max |x|: 0 before the body reaches the slab (step 1), then the landing parts
# them by rounding (the port's fixed-order dots), 4.0e-4 after 5 steps, and
# the JAX package's own batch from x one ulp up parts from itself by as much
# (4.4e-4; in float64 2.5e-3 and 2.5e-3): the port is held under twice that
# control's gap (or 1e-4).
def test_uzawa_on_the_exact_slab():
    """chip_smoke's batch_exactmesh_uzawa: Uzawa (ls=2) over the compacted
    exact slab at crossval's size (the 3x2x2 body 0.1 m above it, near_lanes
    24, scales 0.5, 1, 2, float32): 5 steps, past landing, against the JAX
    package's batch and its golden; the body on the slab, overflow clear."""
    name = "batch_exactmesh_uzawa"
    p = chip_smoke.BATCH_SCENES[name]
    out, tstep, ctl = _both_batches(lambda api: chip_smoke.batch_scene(name, api)[0], 5,
                                    p["scales"], p["gravity"], dtype=torch.float32,
                                    control=True)
    xj, xt, oj, ot = out[-1]
    assert _rel(out[0][1], out[0][0]) <= 1e-12
    control = _rel(ctl, xj)
    assert _rel(xt, xj) <= max(1e-4, 2.0 * control), (_rel(xt, xj), control)
    g = chip_smoke.golden(name)
    for k, bound in zip(chip_smoke.batch_steps(name), chip_smoke.BATCH_STEP_TOL[name]):
        assert _rel(out[k - 1][1], g[f"x{k}"].astype(np.float64)) <= bound, k
    assert not ot.any() and not oj.any()
    assert -0.05 < xt[..., 1].min() < 0.05, xt[..., 1].min()
    assert (tstep.trips.numpy() > 10).all()  # the slab's rows took Schur trips
