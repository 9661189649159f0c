"""The port's slice on the bench scene, against the JAX Solver and the
golden trajectory that chip_smoke.py checks the card against.

Scene (bench.py:23-24,78-94): 40x5x5 neo-Hookean beam, 5,000 tets and
1,476 vertices, -x face pinned, float32, linsolver=0 "inv", 10 ADMM
iterations, dt 1/24; steps 1 and 8. Bounds relative to max |x|: 1e-4
after one step, 2e-3 after eight (benchmarks/crossval.py:299-302);
measured 1.0e-6 and 1.5e-6.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_solver import _assert_close, _jax_solver, _port_solver, _rel, _traj

from admm_elastic_tpu.ops import prox as jprox

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_port_golden_beam.npz")


@pytest.fixture(autouse=True, scope="module")
def _jacobi_svd():
    jprox.set_svd_impl("jacobi")
    yield
    jprox.set_svd_impl("auto")


@pytest.fixture(scope="module")
def bench_port():
    return _traj(_port_solver((40, 5, 5), np.float32))


def test_bench_scene_matches_jax(bench_port):
    _assert_close(bench_port, _traj(_jax_solver((40, 5, 5), np.float32)), np.float32)


def test_bench_scene_matches_golden(bench_port):
    """The golden stays in step with the port's CPU path
    (tests/make_torch_golden.py rewrites it)."""
    g = np.load(GOLDEN)
    assert tuple(g["dims"]) == (40, 5, 5) and int(g["admm_iters"]) == 10
    assert _rel(bench_port[1], g["x1"]) < 1e-4
    assert _rel(bench_port[8], g["x8"]) < 2e-3
