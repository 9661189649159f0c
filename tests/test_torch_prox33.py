"""Kernels D and F (the tet prox on [T, 3, 3], csrc/prox.cu) as far as the
CPU reaches them:

- the identity the card check relies on: the plain prox_plain on [T, 3, 3]
  is local_step_plain's z on the same values as rows [9, T] with u = 0, bit
  for bit, for all six models (chip_smoke.rows_entry_bits holds kernels D and
  F to kernel A's rows entry the same way), in float64 and float32, on the
  main-path values of the bench beam (its D x), tiled as chip_smoke tiles
  them, and on tests/test_pallas.py's stress recipe; in float64 on the beam's
  values also the JAX package's jnp prox (within 1e-9);
- chip_smoke's own bookkeeping of D and F: the profiler names of D, F and
  A's rows entry (one kernel template, told apart by its ROWS argument), and
  tet_errs counting a tiled input's lanes by their lane of the
  tile.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu.ops import hyper_soa as j_hyper
from admm_elastic_tpu.ops import soa as j_soa
from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
from admm_elastic_tpu_torch.materials import Lame
from admm_elastic_tpu_torch.ops import stencil as st
from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, prox_plain
from admm_elastic_tpu_torch.ops.prox import TET_MODELS
from admm_elastic_tpu_torch.system import elements as el

torch.set_num_threads(1)


def _beam_values(dtype, model, tiles=1):
    """The bench beam's D x on a perturbed pose as [T, 3, 3] (chip_smoke's
    main-path values) with the family's material rows, tiled `tiles` times."""
    mesh = make_tet_blocks(40, 5, 5)
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), model, device="cpu",
                           dtype=dtype, kappa=chip_smoke.beam_kappa(model),
                           lattice_dims=mesh.lattice_dims)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                        dtype=dtype)
    zi = st.tet_Dx_rows_plain(x, b).T.reshape(-1, 3, 3).contiguous()
    params = (b.mu, b.lam, b.kappa, b.bulk)
    return chip_smoke.tiled(zi, tiles), tuple(chip_smoke.tiled(p, tiles) for p in params)


def _stress_values(dtype, model, t=600):
    rng = np.random.default_rng(3)
    zi = torch.as_tensor(chip_smoke.stress_f(rng, t), dtype=dtype)
    mu = torch.as_tensor(rng.uniform(1e4, 1e6, t), dtype=dtype)
    lam = torch.as_tensor(rng.uniform(1e4, 1e6, t), dtype=dtype)
    k = lam + (2.0 / 3.0) * mu
    kappa = 1e-3 * k if model.startswith("spline") else torch.zeros_like(k)
    return zi, (mu, lam, kappa, k)


def _jax_z(zi, model, params):
    """The JAX package's jnp prox on the same values (the body its Pallas
    kernels share)."""
    f = tuple(zi[:, r, c].numpy() for r in range(3) for c in range(3))
    if model == "linear":
        out = j_soa.prox_tet_linear_tuple(f)
    else:
        out = j_hyper.prox_tet_hyper_tuple(f, model, *(p.numpy() for p in params))
    return np.stack([np.asarray(o) for o in out], axis=-1).reshape(-1, 3, 3)


@pytest.mark.parametrize("model", TET_MODELS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("values", ["beam", "beam tiled", "stress"])
def test_plain_prox_is_the_rows_entry_with_zero_u(model, dtype, values):
    if values == "stress":
        zi, params = _stress_values(dtype, model)
    else:
        zi, params = _beam_values(dtype, model, tiles=2 if values == "beam tiled" else 1)
    z33 = prox_plain(zi, model, *params)
    rows = zi.reshape(-1, 9).T.contiguous()
    zr = local_step_plain(rows, torch.zeros_like(rows), *params, model=model)[0]
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(z33.reshape(-1, 9).T.contiguous().view(bits), zr.view(bits))
    # the chip's check passes on it, naming no lane
    res = chip_smoke.rows_entry_bits(torch, z33, zi, params, model, "plain")
    assert res == dict(bitwise=True, lanes_differ=0)
    if values == "beam" and dtype == torch.float64:  # the JAX package's prox, same values
        assert np.abs(z33.numpy() - _jax_z(zi, model, params)).max() < 1e-9


@pytest.mark.parametrize("symbol,name", [
    ("void (anonymous namespace)::tet_prox_kernel<float, 5, false>(float const*, ...)",
     "prox_tet_linear"),
    ("void (anonymous namespace)::tet_prox_kernel<double, 0, false>(double const*, ...)",
     "prox_tet_hyper[neohookean]"),
    ("void (anonymous namespace)::tet_prox_kernel<float, 3, false>(float const*, ...)",
     "prox_tet_hyper[spline_stvk]"),
    ("void (anonymous namespace)::tet_prox_kernel<float, 2, true>(float const*, ...)",
     "local_step_tet_hyper[spline_nh]"),
    ("void (anonymous namespace)::tet_local_step_stencil_kernel<float, 1>(float const*, ...)",
     "local_step_tet_stencil[stvk]"),
    ("void at::native::elementwise_kernel<128, 4>(int, ...)", None),
    # the scene forms of scenario batching (parallel/batch.py)
    ("void (anonymous namespace)::tet_local_step_scenes_kernel<float, 0>(float const*, ...)",
     "local_step_tet_hyper_scenes[neohookean]"),
    ("void (anonymous namespace)::tet_local_step_stencil_scenes_kernel<double, 5>(...)",
     "local_step_tet_stencil_scenes[linear]"),
    ("void (anonymous namespace)::tri_local_step_stencil_scenes_kernel<float>(...)",
     "local_step_tri_stencil_scenes"),
    ("void (anonymous namespace)::tet_rhs_tiled_kernel<float, true>(...)", "tet_rhs_rows_scenes"),
    ("void (anonymous namespace)::tet_rhs_wide_kernel<double, false>(...)", "tet_rhs_rows"),
    ("void (anonymous namespace)::pcg_kernel<float, false, true, false, true>(...)",
     "pcg_solve_scenes"),
    ("void (anonymous namespace)::pcg_kernel<float, true, false, false, true>(...)",
     "pcg_solve_penalty_scenes"),
    ("void (anonymous namespace)::pcg_kernel<float, false, true, false, false>(...)",
     "pcg_solve"),
])
def test_profiler_names_of_the_prox_kernels(symbol, name):
    assert chip_smoke.wrapper_of_symbol(symbol) == name


def test_tet_errs_counts_a_tiled_lane_once():
    period, tiles = 50, 4
    want = torch.zeros((9, period * tiles))
    got = want.clone()
    got[0, [7, 57, 107, 157]] = 0.5  # one lane of the tile, over LANE_TOL in every copy
    got[1, 20] = 1e-7

    def rerun(lanes):
        assert lanes.tolist() == [7]
        return [torch.zeros((9, 1))], [torch.zeros((9, 1))]

    res = chip_smoke.tet_errs(torch, [got], [want], "f32", "D[stvk] main-path", rerun=rerun,
                              period=period)
    assert res["lanes_over"] == [7] and res["tiled_lanes_over"] == 4
    assert res["rerun_max"] == 0.0
    with pytest.raises(chip_smoke.SmokeFailure):  # without the period: four lanes, no rerun
        chip_smoke.tet_errs(torch, [got], [want], "f32", "D[stvk] main-path")
