"""The solver extras on a CUDA card: kernel I (the sequential wind), Anderson
acceleration through the captured step, the kept state as a snapshot, and the
profiled step. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_extras.py

Without a card every test here skips (chip_smoke.py runs the same checks at
the paths' shapes). On the card:

- kernel I against its plain version (ops/cuda_wind.wind_seq_plain, the
  scan, on the card: the same IEEE-rounded operations in the same order;
  PyTorch's CPU square root is not IEEE-rounded on every host) on
  chip_smoke.wind_lists (3,200 and 51,200 triangles: the 40x40 and 160x160
  sheets; the 160x160 sheet shuffled, its levels wider than a block; a fan;
  repeated vertices), float32 and float64, in each form that takes the
  shape: bit for bit, as the plain level walk (wind_seq_levels_plain); a form
  that cannot take the shape raises;
- the Anderson-accelerated step (aa_window=4) and the sequential wind through
  the captured graph against the eager loop from one state (bitwise, or
  within chip_smoke.GRAPH_EAGER_TOL), two graph rollouts bitwise equal; the
  wrappers' calls in the warm-up step and the capture of the bench beam's
  Anderson step (kernel A's rows entry, the standalone B, C);
- a kept state (st0 = s.state after a graph step) restores the step bit for
  bit after step() and after run(3);
- the profiled step (verbose=2) leaves the state of the eager step bit for
  bit, each phase > 0 and their sum within step_ms.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch.ops import _build, cuda_local_step, cuda_stencil, cuda_wind

pytestmark = pytest.mark.cuda

NH = chip_smoke.NH


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


WIND_LISTS = ("wind_seq@3200", "wind_seq@51200", "wind_seq@51200 shuffled",
              f"wind_seq fan@{chip_smoke.WIND_FAN}", "wind_seq repeated@34")


@pytest.mark.parametrize("name", WIND_LISTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_i_matches_its_plain_version(cuda_device, name, dtype):
    (tris, d, x, v), = [c[1:] for c in chip_smoke.wind_lists(torch, dtype) if c[0] == name]
    sched = cuda_wind.bake_schedule(tris, tris.device)
    want = cuda_wind.wind_seq_plain(tris, d, 1000.0, 1.0 / 24.0, x, v)
    walked = cuda_wind.wind_seq_levels_plain(sched, tris, d, 1000.0, 1.0 / 24.0, x, v)
    assert torch.equal(walked, want), (walked - want).abs().max()
    optin = _build.library().admm_smem_optin()
    n, w, item = x.shape[0], tris.shape[0], x.element_size()
    before, ran = cuda_wind.wind_seq.launches, []
    for form in cuda_wind.FORMS:
        try:
            cuda_wind.i_form(n, w, item, optin, form)
        except ValueError:
            with pytest.raises(ValueError, match="does not fit"):
                cuda_wind.wind_seq(tris, d, 1000.0, 1.0 / 24.0, x, v, sched, form=form)
            continue
        got = cuda_wind.wind_seq(tris, d, 1000.0, 1.0 / 24.0, x, v, sched, form=form)
        ran.append(form)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and not torch.equal(got, v)
        assert torch.equal(got, want), (form, (got - want).abs().max())
    fits = cuda_wind.i_form(n, w, item, optin) == "shared"
    assert ran == (["shared", "global"] if fits else ["global"])
    assert cuda_wind.wind_seq.launches - before == len(ran)
    with pytest.raises(ValueError, match="no level schedule"):
        cuda_wind.wind_seq(tris, d, 1000.0, 1.0 / 24.0, x, v)


def _small_sheet(device, sequential=False, aa_window=0):
    """A 6x6 sheet under wind, strain-limited, -x edge pinned, float64."""
    from admm_elastic_tpu_torch import Lame, Settings, Solver
    from admm_elastic_tpu_torch.forces import make_wind_force
    from admm_elastic_tpu_torch.geometry.factory import make_plane

    mesh = make_plane(6, 6, size=2.0)
    s = Solver(device=device)
    s.add_nodes(mesh.vertices, mesh.weighted_masses(1.0))
    lame = Lame.soft_rubber()
    lame.limit_min, lame.limit_max = 0.95, 1.05
    s.add_tri_energies(mesh.vertices, mesh.faces, lame)
    s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < -2.0 + 1e-9)[0]])
    s.add_explicit_force(make_wind_force(mesh.faces, (0.05, 0.1, 0.02), sequential=sequential,
                                         device=device, dtype=torch.float64))
    assert s.initialize(Settings(verbose=0, admm_iters=10, linsolver=0, dtype=np.float64,
                                 gravity=-9.8, aa_window=aa_window))
    return s


SCENES = {
    "beam_aa4": lambda d: chip_smoke.make_solver(NH, name="beam_aa4")[0],
    "cloth_aa4": lambda d: chip_smoke.make_cloth_solver("cloth_aa4")[0],
    "sheet_aa4_f64": lambda d: _small_sheet(d, aa_window=4),
    "sheet_wind_seq_f64": lambda d: _small_sheet(d, sequential=True),
    "contact_alpcg_aa4": lambda d: chip_smoke.contact_scene(
        "contact_alpcg", chip_smoke.torch_api("cuda"), aa_window=4),
    "contact_alpcg_aa4_f64": lambda d: chip_smoke.contact_scene(
        "contact_alpcg_f64", chip_smoke.torch_api("cuda"), aa_window=4),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_graph_matches_eager_and_repeats(cuda_device, scene):
    s = SCENES[scene](cuda_device)
    state0 = s.state.clone()
    s.run(4)
    x_graph = s.state.x.clone()
    assert s._graph is not None and torch.isfinite(x_graph).all()
    s.state = state0.clone()
    s.run(4)
    assert torch.equal(s.state.x, x_graph)
    res = chip_smoke.graph_vs_eager(torch, scene, s, state0, 4, x_graph)
    assert res["bitwise"] or res["rel_err"] <= chip_smoke.GRAPH_EAGER_TOL


def test_anderson_step_calls_the_rows_entry_and_standalone_b(cuda_device):
    """The bench beam's Anderson step: per ADMM iteration one launch of kernel
    A's rows entry (the prox with u = 0), of C (the rhs) and of the
    standalone B (D x for g(v)), and B once more for v0; no stencil entry.
    The wrappers count the warm-up step and the capture."""
    s = chip_smoke.make_solver(NH, name="beam_aa4")[0]
    it = s.m_settings.admm_iters
    wrappers = (cuda_local_step.local_step_tet_hyper, cuda_local_step.local_step_tet_stencil,
                cuda_stencil.tet_Dx_rows, cuda_stencil.tet_rhs_rows)
    before = [w.launches for w in wrappers]
    s.run(0)
    got = [w.launches - b for w, b in zip(wrappers, before)]
    assert got == [2 * it, 0, 2 * (it + 1), 2 * it]


def test_kept_state_is_a_snapshot(cuda_device):
    """st0 = s.state after a graph step; step; s.state = st0; step: the
    second step starts from st0 (a snapshot that no replay wrote), and gives
    bit for bit what one step from a copy of st0 gives; the same with run(3),
    and where the state handed out is overwritten in place. Before the repair
    st0 was the graph's own buffers, which the replay advanced."""
    s = chip_smoke.make_solver(NH)[0]
    s.run(1)
    for steps, advance in ((1, lambda: s.step()), (3, lambda: s.run(3))):
        st0 = s.state
        ref = st0.clone()
        advance()
        x_a = s.state.x.clone()
        assert not torch.equal(x_a, ref.x)
        assert all(torch.equal(getattr(st0, f), getattr(ref, f))
                   for f in ("x", "v", "y", "prev_active")), steps
        s.state = st0
        advance()
        assert torch.equal(s.state.x, x_a), steps
        s.state = ref.clone()
        advance()
        assert torch.equal(s.state.x, x_a), steps
        # a handed-out state written in place is copied in, not skipped
        for f in ("x", "v", "y", "prev_active"):
            getattr(s.state, f).copy_(getattr(ref, f))
        advance()
        assert torch.equal(s.state.x, x_a), steps


@pytest.mark.parametrize("scene", ["beam", "contact_gs"])
def test_profiled_step_is_the_eager_step(cuda_device, scene):
    if scene == "beam":
        s = chip_smoke.make_solver(NH)[0]
    else:
        s = chip_smoke.contact_scene(scene, chip_smoke.torch_api("cuda"))
        s.run(12)  # landed: contacts in the sweeps
    state0 = s.state.clone()
    s._run_eager(1)
    x_eager = s.state.x.clone()
    s.state = state0.clone()
    s.m_settings.verbose = 2
    rt = s.step()
    s.m_settings.verbose = 0
    assert torch.equal(s.state.x, x_eager)
    phases = (rt.local_ms, rt.collision_ms, rt.global_ms)
    assert min(phases) > 0 and sum(phases) <= rt.step_ms
    assert rt.inner_iters > 0
