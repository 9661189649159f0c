"""Scenario batching on a CUDA card: the scene forms of kernels A, C, E, G,
L, M and J (parallel/batch.py). This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_batch.py

Without a card every test here skips (chip_smoke.py runs the same checks,
and the batch paths at full size, in its batch phase). On the card:

- each scene form on a batch path's inputs, scene by scene bitwise to the
  single-scene kernel on that scene's scaled inputs (chip_smoke.
  batch_kernel_cases): A's rows entry and G's CLUSTER form on the bench beam's
  sweep (64 scenes here), G's penalty form on crossval's batched scene landed
  on the floor, E's entries and G on the cloth sheet, A's stencil entry, C and
  G's GRID form a scene at a time on the 20x20x20 lattice, float32 and
  float64; G also against its plain twin within G's bounds;
- the batch paths through make_batched_step against their goldens
  (chip_smoke.batch_path): graph replays bitwise the eager loop, overflow
  clear, the beam's pins at their targets and its 8 scenes bitwise an 8-scene
  batch's;
- L's, M's and J's scene forms and G's per-scene done on the Uzawa and
  exact-slab batches (full width and crossval's size, past landing), each
  bitwise its plain twin and, scene by scene, the single-scene kernel, and at
  S = 1, 4, 64 and one scene more than the card holds blocks of the form at
  once (chip_smoke.scene_size_checks: a team then takes two scenes);
- the Uzawa and mesh-obstacle batch paths against their goldens (held steps,
  one step from the golden's batch where the landing is chaotic, overflow
  per scene), and the full-width scenes in a batch of 64 bitwise the same
  scenes alone;
- donate: the step writes into the donated batch; the refusals.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from admm_elastic_tpu_torch.parallel.batch import make_batched_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chip_smoke.DEVICE = "cuda"
    return torch.device("cuda")


CASES = [("beam_sweep64", "batch_beam_sweep8", 64, 1),
         ("batched_contact_alpcg", "batched_contact_alpcg", None, chip_smoke.BATCH_LANDED),
         ("batch_cloth_sweep4", "batch_cloth_sweep4", None, 1),
         ("batch_lattice_stencil", "batch_lattice_stencil", None, 1)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("label,name,n,steps", CASES)
def test_scene_forms_bitwise_per_scene(cuda_device, label, name, n, steps, dtype):
    res, timing = {}, {}
    chip_smoke.batch_kernel_cases(torch, res, timing, label, name, n, dtype, steps)
    assert res and all(r["bitwise_per_scene"] for r in res.values())
    kinds = {k.partition("@")[0] for k in res}
    want = {"batch_beam_sweep8": {"local_step_tet_hyper_scenes", "pcg_solve_scenes"},
            "batched_contact_alpcg": {"local_step_tet_hyper_scenes", "pcg_solve_penalty_scenes"},
            "batch_cloth_sweep4": {"local_step_tri_stencil_scenes", "pcg_solve_scenes"},
            "batch_lattice_stencil": {"local_step_tet_stencil_scenes", "tet_rhs_rows_scenes",
                                      "pcg_solve_scenes"}}[name]
    assert kinds == want
    g = [r for k, r in res.items() if k.startswith("pcg_solve")][0]
    assert g["form"] == ("grid" if name == "batch_lattice_stencil" else "cluster")


@pytest.mark.parametrize("label,name,n", [
    ("beam_sweep64", "batch_beam_sweep8", 64),
    ("batched_contact_alpcg", "batched_contact_alpcg", None),
    ("batched_contact_alpcg_f64", "batched_contact_alpcg_f64", None),
    ("batch_cloth_sweep4", "batch_cloth_sweep4", None),
    ("batch_lattice_stencil", "batch_lattice_stencil", None)])
def test_batch_paths_against_their_goldens(cuda_device, label, name, n):
    _, step, out = chip_smoke.batch_path(torch, label, name, n)
    assert out["graph_vs_eager_bitwise"]
    assert out["launches"]
    if n:
        assert out["s8_bitwise"] and out["pin_drift"] <= chip_smoke.BATCH_PIN_TOL


def test_donate_writes_into_the_batch(cuda_device):
    _, step, batch = chip_smoke.batch_setup(torch, "batch_cloth_sweep4", donate=True)
    x_before = batch.x
    out = step(batch)
    assert out.x.data_ptr() == x_before.data_ptr()
    keep, _, b2 = chip_smoke.batch_setup(torch, "batch_cloth_sweep4", donate=False)
    out2 = make_batched_step(keep, donate=False)(b2)
    assert out2.x.data_ptr() != b2.x.data_ptr() and torch.equal(out2.x, out.x)


def test_scene_forms_refuse_what_they_cannot_take(cuda_device):
    from admm_elastic_tpu_torch.ops import cuda_pcg

    solver, step, batch = chip_smoke.batch_setup(torch, "batch_cloth_sweep4")
    data = step.pcg
    s = batch.n_scenes
    b = torch.zeros_like(batch.x)
    with pytest.raises(ValueError, match="trips"):
        cuda_pcg.pcg_solve_scenes(data, b, b, 1e-6, 10, torch.zeros((1,), dtype=torch.int32,
                                                                      device="cuda"),
                                  batch.stiffness_scale)
    with pytest.raises(ValueError, match="scale"):
        cuda_pcg.pcg_solve_scenes(data, b, b, 1e-6, 10, torch.zeros((s,), dtype=torch.int32,
                                                                      device="cuda"),
                                  batch.stiffness_scale[:1])
    with pytest.raises(ValueError, match="f32|dtype|float"):
        step(chip_smoke.batch_setup(torch, "batch_cloth_sweep4", dtype=np.float64)[2])


UZAWA_MESH_CASES = [
    ("batch_floor_uzawa5k", "batch_floor_uzawa5k", None, chip_smoke.BATCH_WIDE_LANDED),
    ("batch_slab_exact_alpcg5k", "batch_slab_exact_alpcg5k", None,
     chip_smoke.BATCH_WIDE_LANDED),
    ("batched_contact_uzawa", "batched_contact_uzawa", None, chip_smoke.BATCH_LANDED),
    ("batch_exactmesh_alpcg", "batch_exactmesh_alpcg", None, 8),
    ("batch_exactmesh_uzawa", "batch_exactmesh_uzawa", None, 5)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("label,name,n,steps", UZAWA_MESH_CASES)
def test_uzawa_and_mesh_scene_forms_bitwise(cuda_device, label, name, n, steps, dtype):
    res, timing = {}, {}
    chip_smoke.batch_kernel_cases(torch, res, timing, label, name, n, dtype, steps)
    assert all(r["bitwise_per_scene"] for r in res.values())
    kinds = {k.partition("@")[0] for k in res}
    p = chip_smoke.BATCH_SCENES[name]
    uzawa = {"ct_apply_scenes", "schur_trip_scenes", "pcg_solve_scenes", "pcg_solve_scenes[done]"}
    ls = (p["settings"]["linsolver"] if "settings" in p else
          p.get("change", {}).get("linsolver", chip_smoke.CONTACT_SCENES[p["contact"]]["ls"]))
    want = ((uzawa if ls == 2 else {"pcg_solve_penalty_scenes"})
            | ({"mesh_detect_scenes"} if p["mesh"] == "exactmesh" or "obstacle" in
               chip_smoke.CONTACT_SCENES.get(p.get("contact"), {}) else set()))
    assert want <= kinds, kinds
    if name in chip_smoke.BATCH_WIDE:
        chip_smoke.scene_size_checks(torch, res, timing)
        sizes = {k.rpartition("S=")[2] for k in res if "S=" in k}
        assert {"1", "4", "64"} <= sizes


@pytest.mark.parametrize("name", chip_smoke.BATCH_WIDE + (
    "batched_contact_uzawa", "batched_contact_uzawa_f64", "batch_exactmesh_alpcg",
    "batch_exactmesh_alpcg4", "batch_exactmesh_uzawa"))
def test_uzawa_and_mesh_batch_paths(cuda_device, name):
    _, step, out = chip_smoke.batch_path(torch, name, name)
    assert out["graph_vs_eager_bitwise"]
    assert out["launches"]


@pytest.mark.parametrize("name", chip_smoke.BATCH_WIDE)
def test_wide_scenes_in_a_batch_of_64_are_the_scenes_alone(cuda_device, name):
    assert chip_smoke.batch_alone_bitwise(torch, name, 64, chip_smoke.BATCH_WIDE_LANDED)[
        "bitwise"]
