"""tests/test_parallel.py's batched point collapses on the port's CPU batch
(parallel/batch.py): the point-collapsed neo-Hookean bunny over a stiffness
sweep, and the 6x3x3 lattice through _debloat_for_throughput's gather
rebuild; every scene finite with no inverted tet, the first step against
the JAX package's from the same batch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admm_elastic_tpu.ops import prox as jprox
from admm_elastic_tpu.parallel import batch as jb
from admm_elastic_tpu_torch.parallel import batch as tb
from test_torch_batch import _carry, _jax_api, _torch_api

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


def _collapse(api, mesh, lame, **settings):
    solver = api.Solver()
    api.binding.add_tetmesh(solver, mesh, lame, verbose=False)
    assert solver.initialize(api.Settings(verbose=0, admm_iters=10, linsolver=3, gravity=0.0,
                                          pcg_max_iters=60, pcg_tol=1e-8, dtype=np.float64,
                                          **settings))
    return solver


def _collapse_run(build, scales, n_steps, mesh_tets):
    """Point-collapse every scene (x = 0) and step the port's batch n_steps;
    the first step also in the JAX package, from the same batch. Returns
    (the port's x [S, N, 3], the first step's gap to the JAX package's)."""
    from admm_elastic_tpu_torch.geometry.mesh import tet_volumes

    s = len(scales)
    js, ts = build(_jax_api()), build(_torch_api())
    jbatch = jb.make_scenario_batch(js, s, stiffness_scale=scales, gravity=np.zeros(s))
    jbatch = dataclasses.replace(jbatch, x=jnp.zeros_like(jbatch.x))
    tbatch = _carry(jbatch)
    tstep = tb.make_batched_step(ts, mesh=None, donate=False)
    tbatch = tstep(tbatch)
    xj = np.asarray(jb.make_batched_step(js, mesh=None, donate=False)(jbatch).x)
    gap = float(np.abs(tbatch.x.numpy() - xj).max() / max(np.abs(xj).max(), 1e-30))
    for _ in range(n_steps - 1):
        tbatch = tstep(tbatch)
    x = tbatch.x.numpy()
    assert np.isfinite(x).all(), "batched point collapse went non-finite"
    for k in range(s):
        vols = tet_volumes(x[k], mesh_tets)
        bad = int(((vols <= 0) | ~np.isfinite(vols)).sum())
        assert bad == 0, f"scene {k}: {bad} inverted tets after recovery"
    return x, gap


# The first step of a point collapse against the JAX package's, relative to
# its max |x|, float64: from x = 0 every lane's SVD starts at a singular F
# (the collapse inflation's branch), where the two packages' sum orders part
# more than anywhere else: measured 4.6e-6 (bunny) and 1.1e-4 (lattice); the
# regular scenes above agree to 1e-13.
COLLAPSE_FIRST_TOL = 1e-3
# tests/test_parallel.py runs 80 steps; a batched step of the bunny takes
# 1.1 s here (every PCG solve at its 60-trip cap), so these take 12: the
# port's batch has no inverted tet in any scene from step 1 on (measured
# every 5 steps to 80).
COLLAPSE_STEPS = 12


def test_batched_point_collapse_recovers_all_scenes():
    """tests/test_parallel.py:58-93: the point-collapsed NH bunny through the
    batched path over a stiffness sweep recovers in every scene."""
    def build(api):
        mesh = api.make_tet_bunny_like(250)
        mesh.flags = api.binding.NOSELFCOLLISION | api.binding.NEOHOOKEAN
        mesh.apply_xform(api.make_xform(rot_deg=20.0, rot_axis=(1, 0, 0)))
        solver = _collapse(api, mesh, None)
        return solver

    _, gap = _collapse_run(build, np.array([0.5, 1.0, 2.0]), COLLAPSE_STEPS, _bunny_tets())
    assert gap <= COLLAPSE_FIRST_TOL


def _bunny_tets():
    from admm_elastic_tpu_torch.geometry.factory import make_tet_bunny_like

    return make_tet_bunny_like(250).tets


def test_batched_point_collapse_through_debloat_rebuild():
    """tests/test_parallel.py:96-136: the 6x3x3 NH lattice (30.6 % padding)
    rebuilt as gather families by _debloat_for_throughput, then the point
    collapse as above."""
    def build(api):
        mesh = api.make_tet_blocks(6, 3, 3)
        mesh.flags = api.binding.NOSELFCOLLISION | api.binding.NEOHOOKEAN
        return _collapse(api, mesh, api.Lame.soft_rubber())

    ts = build(_torch_api())
    assert ts.system.tets[0].stencil is not None
    rebuilt = tb._debloat_for_throughput(ts, ts.system)
    assert rebuilt is not ts.system and rebuilt.tets[0].stencil is None
    _, gap = _collapse_run(build, np.array([1.0, 2.0]), COLLAPSE_STEPS,
                           _torch_api().make_tet_blocks(6, 3, 3).tets)
    assert gap <= COLLAPSE_FIRST_TOL
