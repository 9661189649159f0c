#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--profile] [--kernels-only] [--batch]

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. JAX is not needed: the reference trajectories come
from tests/data/torch_port_golden_*.npz (written by
tests/make_torch_golden.py). Phases, each of which exits non-zero on
failure:

1. environment: GPU name and power limit, torch / CUDA / nvcc / Triton
   versions, TF32 flags (set off: the direct solve needs full FP32);
   Solver() with no device lands on the card;
2. build the kernels of admm_elastic_tpu_torch/csrc with nvcc (one process
   per translation unit, all started together);
3. each kernel against its plain PyTorch version on the card, float64 and
   float32, at the shapes of the paths, on main-path inputs and on a stress
   recipe, all outputs finite: A (the tet local step's rows entry, once per
   model, and at a ragged lane count), D and F (the tet prox on [T,3,3]) at
   7,680 lanes, at a ragged lane count, on a tensor that starts 3 lanes into
   its storage and (float32) at the throughput size of TILES x 7,680 lanes, every lane
   held (see LANE_TOL), and each z bit for bit kernel A's rows entry's on the
   same values with u = 0 (rows_entry_bits), B (D x, exact)
   and C (rhs, its tiled and its wide branch, bitwise equal to each other)
   at 1,536 cells and 1,476 vertices, C's wide branch on a 2x40x40 lattice
   whose halo fits no tile, E (the cloth local step's rows entry) at 3,362
   lanes; C and E bitwise repeatable; then the stencil entries of A (per
   model) and E (with and without limits, and as the second sheet of a
   system), in which each lane computes its own D x: bitwise equal to the
   two-launch route (B or tri_Dx_rows, then the rows entry) and within the
   rows entries' bounds of the plain composition; the rows entries of A and
   E at the gather paths' shapes, on gathered D x; on ring lattices
   (ring_checks: the torus_pcg20k ring and a 12x4 torus at a vertex offset) B
   and C's two branches exact and A's stencil entry bitwise against the
   two-launch route, the lanes whose corner reads cross the seam held apart;
   kernel G (the whole PCG solve in one launch) against the plain solve_T on
   each PCG path's first solve and on crossval's small scenes in every
   operator form (pcg_checks: float64 in the same trips within 1e-10, float32
   within PCG_F32_TOL; the bunny under the bounds its conditioning allows),
   twice bitwise, and captured into a CUDA graph; kernel H (the whole
   Gauss-Seidel solve in one launch) against the plain gs.solve at the GS
   paths' shapes on a real step's first solve at the golden's landed state,
   with pins and a Floor, a Sphere beside it, and the sphere scene (h_checks:
   float64 in the same sweeps within H_F64_TOL, float32 within H_F32_TOL),
   and G's penalty form against alcg.solve_plain at floor_alpcg67k's shapes
   with its ~900 floor hits, Jacobi and two-grid (gpen_checks); each of G's
   forms (CLUSTER where the system fits one thread-block cluster, GRID) and
   H's (SHARED where x fits shared memory, GLOBAL) that takes a shape,
   bitwise equal to the one the wrapper chooses there, in as many trips or
   sweeps, captured and replayed, G also on beams at and beyond the CLUSTER
   form's largest N (G_EDGE_SCENES); G's GRID form on 8 blocks bitwise its full
   grid; H beyond the SHARED form's reach (the 67k beam in float64) bitwise
   the plain gs.solve; A, C and E
   at the PCG paths' shapes, A and C at the 67k contact beam's, and there
   too the standalone B and A's linear rows entry with u = 0 as
   floor_alpcg67k_aa4 launches them (path_shape_cases); kernel I (the sequential wind, the
   triangles' level schedule a level at a time) against its plain version, the
   scan, run on the card at 3,200 and 51,200 triangles, on the 160x160 sheet
   shuffled, a fan and repeated vertices (wind_lists), float32 and float64, in
   each form that takes the shape (SHARED, v and the geometry in shared
   memory; GLOBAL), bit for bit, and the
   plain level walk bit for bit the scan (kernel_i_checks);
   kernel H with the mesh obstacles against the plain gs.solve
   (h_mesh_checks: the 5k slab paths landed, a Floor beside the exact slab,
   the deep crossval scene's first solve through the fallback, the
   near_lanes=4 scenes whose colour passes overflow), and kernel J (a mesh
   obstacle's detection) against its plain version (kernel_j_checks: the
   67k slab at the golden's steps 1 and 12, compacted as its path runs it
   and dense, the 5k SDF slab, near_lanes=4 overflowing, the deep fallback
   and its overflow; float64 within J_F64_TOL, float32 with every flipped hit
   within rounding of dx = 0, the overflow flags equal); kernel K (every
   collider's self-collision detection in one call, merged into the dynamic
   rows) and kernel L (the rows' C^T and diag(C^T C) as an ordered gather)
   bit for bit their plain twins, float64 and float32, on the self-collision
   paths' golden states (two colliders; boxes_gs20's broad phase), tests/
   test_broadphase.py's folded block dense and broad, HIT_CAP = 1, the dense
   tiles' edges and a ragged tet count, overflowing cells, three colliders
   listing one vertex twice, and a state with no hit (kernel_k_checks);
   H's DYN form against gs.solve with the dynamic rows and G's DYN form
   against alcg.solve_plain at boxes_gs8's and boxes_alpcg8's first solve
   from a state with dynamic rows (hdyn_gdyn_checks: float64 in
   the same sweeps or trips within 1e-10, float32 within 1e-4); Uzawa's
   Schur trip, kernel L's full C^T and kernel M (the trip's update), on
   every trip of a solve at boxes_uzawa8's, floor_uzawa5k's and
   floor_uzawa67k's states (UZAWA_PATHS, uzawa_state), float32 and float64,
   bit for bit their plain twins, L also the parent's C^T, M on the
   wrapper's grid and on one block, and uzawa.solve bitwise those trips
   (schur_trip_checks, trip_pairs);
4. the paths (path_phase, in a process of its own with the graph checks
   below), each built through the normal entry points on cuda (float32
   unless named, linsolver=0, 10 ADMM iterations, dt 1/24), Solver.run(n)
   replaying the captured step, in one window with the wrappers' counts set
   to 0 just before and read just after: captured (run(0): the wrappers count
   their calls in the warm-up step and the capture), then stepped 8 times,
   the kernels of the replays counted on the device by torch.profiler
   (device_launches: a replay runs no wrapper); steps 1 and 8 within 1e-4
   and 2e-3 of the JAX golden (relative to max |x|; the displacement after
   each within DISP_TOL), pins held, the 8 steps run twice from one state
   bitwise equal, and the eager loop (Solver._run_eager) from the same state
   bitwise equal to the graph (or within GRAPH_EAGER_TOL):
   - "beam" and "materials": the 40x5x5 bench beam, neo-Hookean and then
     linear, stvk, spline_nh (mesh flags of binding.add_tetmesh) and
     spline_stvk, spline_corot (Solver.add_tet_energies): the steps launch
     kernel A's stencil entry (which does kernel B's work) and C 80 times and
     B not at all, with bench.py's sanity checks; then system.Dx (B
     standalone) and TetBatch.prox on its rows (A's rows entry, held bitwise
     to the stencil entry) and on [T,3,3] (kernel D, or F for the linear
     beam), held to the rows entry;
   - "cloth": the 40x40 sheets cloth_limit40 (strain limits, gravity) and
     cloth_wind40 (colored wind, no gravity): the steps launch kernel E's
     stencil entry 80 times and call tri_Dx_rows not at all; then E's rows
     entry on system.Dx's rows, held bitwise to the stencil entry;
   - "beam_free": the bench beam without pins, 2 steps of free fall against
     its own golden: the float32 system takes one refinement pass per ADMM
     iteration, so every iteration applies A through system.A_mv, the
     standalone B and C once more (B 20, C 40 launches);
   - GATHER_SCENES: beam_gather (the bench beam without lattice_dims),
     bunny_nh and bunny_linear (data/bunny_1124 through load_elenode; again
     in float64, bunny_nh_f64 and bunny_linear_f64) launch A's rows entry 80
     times and no stencil entry, C or B;
     cloth_gather_limit40 and cloth_gather_wind40 (the two sheets
     renumbered, each also held, mapped back, to its grid sheet's golden at
     both steps) E's rows entry 80 times; beam_cho (direct_mode "cho") what
     the lattice beam launches;
   - PCG_PATHS (pcg_path): beam_pcg160k (80x20x20 cells, 35,721 vertices,
     Jacobi PCG), torus_pcg20k (a 64x8 ring), cloth_ls0_160 (the 160x160
     sheet with linsolver=0, switched to two-grid PCG above
     direct_max_verts) and bunny_pcg, against their goldens under
     PCG_STEP_TOL / PCG_DISP_TOL, kernel G launched 80 times beside the local
     step's kernel (and C on the lattices), then each step's CG trips beside
     the JAX package's and the device operations per iteration;
   - CONTACT_PATHS (contact_path): floor_gs5k (kernel H), floor_uzawa5k
     (Uzawa, direct inner), floor_uzawa67k (Uzawa around kernel G),
     floor_alpcg67k (G's penalty form), 20 steps held at steps 1, 12 and 20,
     and sphere_gs, 40 steps held at 1, 16 and 40, under CONTACT_STEP_TOL /
     CONTACT_DISP_TOL, the launches of contact_counts (Uzawa's predicated
     trips launch their applies in every replay), the vertices in contact,
     no tunnelling, each step's inner iterations beside the JAX package's;
   - MESH_PATHS (contact_path, the mesh obstacles): slab_sdf_gs5k and
     slab_exact_gs5k (floor_gs5k's beam on a make_tet_blocks slab, kernel H
     detecting per vertex, compacted), slab_exact_alpcg67k (floor_alpcg67k's
     beam on an exact slab, kernel J 10 times a step, compacted over 15,616
     lanes), exactmesh_deep_gs (crossval's deep scene: H's deep fallback),
     each also with collision_overflow at every step equal to the JAX
     package's; then bench.py's contact sanity (bench_contact_sanity);
   - AA_PATHS (VARIANT_SCENES: an earlier path with aa_window=4): beam_aa4
     and cloth_aa4 (aa_path: every iteration launches A's or E's rows entry
     with u = 0 and no stencil entry, the standalone B 11 times a step on the
     beam), floor_alpcg67k_aa4 (contact_path, held under floor_alpcg67k's
     bounds; its landing overshoot no deeper than the JAX package's own), each
     with its device operations per iteration beside its base path's;
     cloth_wind40_seq (cloth_path: cloth_wind40 with the sequential wind,
     kernel I once per step), and its rate and replayed step with kernel I
     held to GLOBAL against its chosen form (wind_form_turns);
   - SELFCOLL_PATHS (selfcoll_path, self-collision: benchmarks/matrix.py's
     two boxes on a floor, each box a collider): boxes_gs8 (H's DYN form),
     boxes_uzawa8 (Uzawa: L's full C^T and M in every Schur trip, as on the
     floor Uzawa paths; graph and eager bitwise on every Uzawa path),
     boxes_alpcg8 (G's DYN
     form), boxes_gs20 (K's broad phase), K once an ADMM iteration (both
     colliders in one call), held at
     step 1, the golden's first step with a dynamic hit and the last, under
     SELFCOLL_STEP_TOL / SELFCOLL_DISP_TOL, with the dynamic hits, no
     tunnelling between the boxes and each step's collision_overflow;
   then the extras (extras_checks): Anderson's gain on the 10x3x3 beam in
   float64 (aa_wins_check), the logged step once per linsolver on
   LOGGED_SCENES against a Solver(device="cpu") from the same state
   (logged_checks), the profiled step bitwise the eager step on the beam and
   floor_gs5k (profiled_checks), a kept state as a snapshot, the bitwise
   replay from a checkpoint and the card's file on the CPU, and the
   snapshot's cost, with a step() on the handed state against one on an
   assigned state (checkpoint_checks);
   then the captured step's invalidation checks on the bench beam (set_pins,
   the setters, admm_iters, gravity, initialize), the frozen state of
   cloth_wind40 after a graph run (frozen_checks: field assignments raise,
   the x setter is honored) and the one-tet goldens of
   tests/test_lineartet.py through the graph;
4b. the demo apps (apps_phase, in a process of its own after the paths):
   each of APP_RUNS (beams, trianglestrain, bunnyexpand point and rand,
   signorini with a floor, an SDF slab and an exact slab, torus, boxes)
   through its admm_elastic_tpu_torch.apps.<name>.main(argv) with the app's
   default settings and --frames APP_FRAMES (24, past first contact), the
   wrappers' counts set to 0 just before and read just after (APP_KERNELS
   each launched; signorini's obstacle as kernel H takes it, APP_MESH_KIND),
   one graph capture in the run, the trajectory held to the JAX app's golden
   (APP_STEPS under crossval's bounds, or step 1 and one step from the
   golden's state at each later held step, APP_ONESTEP; bunnyexpand also in
   float64, APP_F64) and to the app's invariants (beams' pins on their moving
   targets, no contact app below APP_FLOOR_BOUND, bunnyexpand finite, its
   inverted tets beside the golden's), and its ADMM iterations per second on
   the host's clock;
4c. the scenario batches (batch_phase, in a process of its own after the
   apps; alone with --batch): the scene forms of A, C, E and G on the batch
   paths' inputs, scene by scene bitwise the single-scene kernels on each
   scene's scaled inputs (G also its trips) and within the single-scene
   bounds of their plain twins (batch_kernel_cases: the bench beam's sweep at
   BATCH_BEAM_S = 1,024 scenes, crossval's batched scene landed on its floor,
   the cloth sheet, the 20x20x20 lattice, float32 and float64); the four
   BATCH_SCENES paths through make_batched_step (graph replays, the wrappers'
   counts from 0 over the first call) against their goldens (BATCH_STEP_TOL),
   the graph bitwise the eager loop, overflow clear, the beam's pinned face
   within BATCH_PIN_TOL and its 8 golden scenes bitwise an 8-scene batch's,
   crossval's scene above BATCH_FLOOR_BOUND (batch_path); the total ADMM
   iterations/s of the beam's and the cloth sheet's sweeps at BATCH_CURVE
   sizes, with device ops, busy time and idle share at 8 and 1,024 scenes
   (batch_curve); each scene form's
   time per launch beside its twin, its bound and a library call
   (batch_kernel_times); the Uzawa and mesh-obstacle batches
   (BATCH_WIDE: batch_floor_uzawa5k, batch_slab_exact_alpcg5k at full width;
   batched_contact_uzawa in f32 and f64, batch_exactmesh_alpcg): L's, M's
   and J's scene forms and G's per-scene done on their inputs past landing,
   each bitwise its plain twin and scene by scene the single-scene kernel
   (lmj_case, g_done_case), also at S = 1, 4, 64 and one scene more than the
   card holds blocks of the form (scene_size_checks); their paths against
   the goldens (the later held steps of BATCH_WIDE one step from the
   golden's stored batch, beside the JAX package's one-ulp control), overflow
   scene by scene the golden's, no vertex below BATCH_FLOOR_BOUND (or the
   JAX package's own least y, batch_floor_bound); their 4 golden scenes in a
   batch of 64 bitwise the same scenes alone (batch_alone_bitwise); their
   curves at S = 1, 8, 64;
5. timing (host_timing, on solvers of its own, runs before phase 4 and
   before any profiler window, so that no profiler state can slow the host):
   the beam, cloth_limit40, beam_gather, the PCG and the contact paths
   through the graph and through the eager loop in turns, ADMM
   iterations/s over rollouts of at least TARGET_S (0.5 s; 2 s, then 1 s,
   before the run grew by later slices' paths), the
   phases of the beam and cloth steps, and each kernel's time against its
   plain version (CUDA events) beside its bound (and D and F at the
   throughput size beside kernel A's rows entry on the same values, in
   turns, prox_event_times; kernel I at both sheets per form beside its
   latency floor and its plain version's one call; each variant path's
   rollout rate beside its base path's, in turns (variant_turns); kernel G per
   solve on each PCG path's first
   solve by torch.profiler, beside the plain solve_T on the card and
   torch.sparse.mm times its trips, pcg_times; H and G's penalty form per
   solve the same way, contact_kernel_times (H also on the two slab paths);
   kernel J per launch on slab_exact_alpcg67k's detections, compacted and
   dense, kernel_j_times; K, L, H[DYN] and G[DYN] at the self-collision
   paths' shapes beside their plain twins, bounds and (L) index_add_,
   selfcoll_kernel_times; L's full C^T and M at the UZAWA_PATHS states by
   queued CUDA events and torch.profiler, M beside its latency floor, the
   twins, the bounds, index_add_ beside L (schur_trip_times); B and C beside
   one torch.sparse.mm call with D or D^T W^2 as CSR at the bench beam's and
   beam_pcg160k's shapes (stencil_library_times, CUDA events: the library_ms
   of their rows); each form of G and H by CUDA
   events queued behind a sleep kernel, in turns, beside its latency floor,
   the same solve in a build whose phases do no row work, floor_library):
   the larger of the bytes it
   must move over 3.35 TB/s and the operations the function needs on the
   same inputs over 67 TFLOP/s (the tet kernels: a count per lane taken from
   the CUDA body times the Newton and line-search trips these inputs take;
   B, C, E: the plain version's operations, counted as it runs; a stencil
   entry: its own bytes, x and the stencil fields in place of D x rows, and
   D x's operations on top); C's two branches in turns (wide, tiled, tiled,
   wide) within this one run; in phase 4's process, after the paths, every
   path's rollout through the graph, twice, the second time in the reverse
   order;
6. with --profile only: torch.profiler over 5 steps of the beam, the cloth
   steps and beam_gather, graph replays and eager loop (device busy time,
   idle share, device operations per ADMM iteration, time by kernel), and,
   before phase 4, over 20 launches of each kernel, of C's
   branches in turns, of each local step's rows entry and stencil entry in
   turns (the difference is what D x costs inside the launch), of D and F
   beside kernel A's rows entry on the same values at both sizes
   (prox_device_times), and of an empty
   kernel (device time per launch, free of the host's enqueue time; the empty
   kernel's is the floor under any launch).

With --kernels-only the run stops after phases 1-3 and the per-kernel device
times of phase 6: the short first run of a changed kernel. It prints the GPU
line but no result line.

The last lines are the GPU line, one JSON line of kernels (a row per TPU
kernel, and one each for kernel G, its penalty form, kernel H, kernel I and
kernel J, K, L (its standalone gather, "dyn_gather", and the Schur trip's
full C^T, "ct_apply"), M ("schur_trip") and the DYN forms of G and H, which
replace the JAX package's jnp loops of PCG, AL-PCG, Gauss-Seidel, the
sequential wind, the mesh obstacles' narrow phases, the self-collision
detection, the dynamic rows' scatters and Uzawa's Schur trip, and one for
each scene form of A (rows and stencil entries), C, E and G (plain and
penalty) with an entry per batch path it was timed on; every row with
its launches on the self-collision and Uzawa paths (SELFCOLL_PATHS,
UZAWA_PATHS), "launches_on_new_paths", and per step;
with an entry per solve and form, "main" the form the wrapper chooses,
"floor_ms" the latency floor; each row with the numbers of the entry its path
launches: "launches" those of
the path's replays, counted on the device, and of its eager calls after them,
"wrapper_calls" the wrapper's count over the path's window; "entries"
lists every entry that does the kernel's work; D and F add their numbers at
the throughput size), and {"ok": true, "device": {...}}. Details go to
chip_smoke.json in the output directory (OUT_DIR).
"""

import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "tests", "data")
OUT_DIR = os.path.join(HERE, "chiprun_out")

# Kernel-versus-plain bounds, on max |kernel - plain| <= tol * max(1, max |plain|)
# for B and C. float32: FMA contraction in the kernels versus separate
# rounding in the plain ops, over sums of at most 8 x 4 terms. The same bound,
# absolute (|z| ~ 1), holds E, which has no iteration: one sqrt / division
# chain behind the products.
F64_TOL = 1e-10
F32_TOL_STENCIL = 1e-5
F32_TOL_DIRECT = 2e-5
# The tet kernels (A, D, F), absolute on z and u' (|z| ~ 1), per lane and in
# the whole. float64 on main-path inputs: allclose(rtol=atol=1e-10), every
# lane. Elsewhere a lane is held to LANE_TOL and the whole to a 99th
# percentile (and, with a Newton loop, a median of 1e-6): in float32 a
# last-ulp difference can flip the Newton backtracking accept test on the few
# lanes whose objective is flat to float32 precision, seen as 2.4e-4 on
# main-path inputs and 6.4e-3 on the stress recipe (inverted and x3-stretched
# F); the kernels without a Newton loop (F and the linear variant of A) were
# seen at 1.5e-6.
# A lane over LANE_TOL is not waved through under a wider bound. The one
# known cause is a stall of the signed SVD: its Jacobi rotation takes
# t = sign(theta) / (...), and sign(0) = 0 skips the rotation of a pair whose
# two diagonal entries are bitwise equal (as the JAX package's does), which
# leaves that lane's SVD unconverged; it happens on about one float32 lane in
# 10^4-10^5, in the kernel or in the plain version (their roundings differ),
# seen as 4.6e-2 on one of 7,680 lanes. A stall is a bitwise coincidence, so
# it does not survive a change of the input in the fifth digit, and a fault
# of the kernel does: every lane over LANE_TOL goes through the kernel and
# the plain version once more with its F scaled entry by entry by
# 1 + 1e-5 * N(0, 1) and has to hold LANE_TOL then; more than
# MAX_RERUN_LANES such lanes in one comparison fail it.
LANE_TOL = {("f64", "stress"): 1e-8, ("f32", "main"): 2e-3, ("f32", "stress"): 2e-2,
            ("f32", "linear"): 1e-4}
A_P99_F32, A_MEDIAN_F32 = 2e-4, 1e-6
MAX_RERUN_LANES = 4
STEP1_TOL, STEP8_TOL = 1e-4, 2e-3
# The displacement x - x0 after the first and the last step against the
# golden's, relative to its largest entry (disp_err), by the golden's
# precision. The bunny moves 9.5e-6 m in one step and 1.5e-5 m in 8 at a max
# |x| of 0.06 m, so STEP1_TOL and STEP8_TOL on x cannot tell a still solver
# (disp_err 1) from one that moves. Readings of tests/bunny_disp_control.py
# (the port on the CPU against the JAX goldens, step 1 / step 8; a planted
# fault scales kernel A's correction z - v by 1 + eps): float32 sound 2.9e-2 /
# 6.3e-2 (bunny_nh), 2.1e-2 / 2.2e-2 (bunny_linear), eps = 0.1 from 0.117 /
# 0.166 up; float64 sound 1.2e-11 to 2.1e-11, eps = 0.01 from 1.6e-2 up.
# float32 cannot hold the bunny's elastic response closer than a tenth: the
# float64 golden of bunny_nh is 0.19 / 0.31 off the float32 one.
DISP_TOL = {"float32": 0.1, "float64": 1e-6}
# A graph rollout against the eager loop over the same steps, where the two
# are not bitwise equal: relative to max |x| (see graph_vs_eager).
GRAPH_EAGER_TOL = 1e-6
TARGET_S = 0.5  # a timed rollout's least wall time, s
DEVICE = "cuda"
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory rate
# and float32 rate outside the tensor cores, an FMA counted as two operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NH = "neohookean"
# Models that binding.add_tetmesh reaches by a mesh flag, and those that only
# Solver.add_tet_energies(model=...) reaches (with kappa = the bulk modulus).
BEAM_FLAGS = {NH: "NEOHOOKEAN", "linear": "LINEAR", "stvk": "STVK", "spline_nh": "SPLINE"}
BEAM_MODELS = ("linear", "stvk", "spline_nh", "spline_stvk", "spline_corot")
TET_MODELS = (NH,) + BEAM_MODELS
HYPER_MODELS = tuple(m for m in TET_MODELS if m != "linear")

_CSRC = "admm_elastic_tpu_torch/csrc/"
_PALLAS = "admm_elastic_tpu/ops/"
# kernel name (without the [model]) -> (source, the TPU kernel's pallas_call)
REPLACES = {
    "local_step_tet_hyper": (_CSRC + "local_step.cu", _PALLAS + "pallas_kernels.py:220"),
    "tet_Dx_rows": (_CSRC + "stencil.cu", _PALLAS + "pallas_stencil.py:164"),
    "tet_rhs_rows": (_CSRC + "stencil.cu", _PALLAS + "pallas_stencil.py:193"),
    "prox_tet_hyper": (_CSRC + "prox.cu", _PALLAS + "pallas_kernels.py:141"),
    "local_step_tri": (_CSRC + "tri_local_step.cu", _PALLAS + "pallas_kernels.py:286"),
    "prox_tet_linear": (_CSRC + "prox.cu", _PALLAS + "pallas_kernels.py:322"),
    # kernels G, its penalty form and H have no Pallas original: each replaces
    # a jnp loop of the JAX package
    "pcg_solve": (_CSRC + "pcg.cu", "admm_elastic_tpu/solvers/pcg.py:304 solve_T (jnp)"),
    "pcg_solve_penalty": (_CSRC + "pcg.cu", "admm_elastic_tpu/solvers/alcg.py:73 solve (jnp)"),
    "gs_solve": (_CSRC + "gs.cu", "admm_elastic_tpu/solvers/gs.py:147 solve (jnp)"),
    # kernel I: the sequential wind's scan over the triangles
    "wind_seq": (_CSRC + "wind_seq.cu", "admm_elastic_tpu/forces.py:78 WindForce.project "
                 "sequential lax.scan (jnp)"),
    # kernel J: a mesh obstacle's narrow phase (SDF and exact)
    "mesh_detect": (_CSRC + "obstacle.cu", "admm_elastic_tpu/collision/passive.py:120,401 "
                    "PassiveMeshSDF / PassiveMeshExact.signed_distance_with_overflow (jnp)"),
    # kernel K: every collider's self-collision detection; L: the dynamic rows'
    # face-corner sums (a gather in place of .at[d_face].add); H's and G's DYN
    # forms: their solves with the dynamic rows' penalty
    "dyn_detect": (_CSRC + "self_collision.cu", "admm_elastic_tpu/collision/dynamic.py:196 "
                   "detect_dynamic (jnp)"),
    "dyn_gather": (_CSRC + "dyn_rows.cuh", "admm_elastic_tpu/collision/constraints.py:146,167 "
                   "Ct_apply / CtC_diag .at[d_face].add (jnp)"),
    "gs_solve_dyn": (_CSRC + "gs.cu", "admm_elastic_tpu/solvers/gs.py:85 solve, may_have_dyn "
                     "(jnp)"),
    "pcg_solve_dyn": (_CSRC + "pcg.cu", "admm_elastic_tpu/solvers/alcg.py:105 solve with dynamic "
                      "rows (jnp)"),
    # Uzawa's Schur trip: L's full C^T in one launch and M, the trip's update
    "ct_apply": (_CSRC + "uzawa.cu", "admm_elastic_tpu/solvers/uzawa.py:57 Ct, "
                 "admm_elastic_tpu/collision/constraints.py:129 Ct_apply (jnp)"),
    "schur_trip": (_CSRC + "uzawa.cu", "admm_elastic_tpu/solvers/uzawa.py:94 body, the Schur "
                   "trip's update (jnp)"),
}
# The entry of each kernel that an ADMM step launches, where that is not the
# wrapper the kernel is named after: the local steps' stencil entries, in
# which each lane computes its own D x (csrc/stencil_body.cuh).
STENCIL_ENTRY = {"local_step_tet_hyper": "local_step_tet_stencil",
                 "local_step_tri": "local_step_tri_stencil"}
FREE_BEAM = "beam_free"  # the bench beam without pins: golden name and path label


def cloth_sheet(nx, ny):
    """The cloth sheet of benchmarks/matrix.py:76-98: an xz-plane grid of
    nx x ny cells of pitch (1, nx/ny), two triangles per cell, masses
    area-lumped at 1522 kg/m^3, the -x edge pinned. Returns vertices [V,3],
    triangles [T,3], masses [V] and the pinned vertex ids (numpy only;
    tests/make_torch_golden.py builds the JAX scene from the same arrays)."""
    verts = np.array([[i, 0.0, j * nx / ny] for i in range(nx + 1) for j in range(ny + 1)],
                     dtype=np.float64)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            tris.append([vid(i, j), vid(i + 1, j), vid(i, j + 1)])
            tris.append([vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)])
    tris = np.asarray(tris)
    masses = np.zeros(len(verts))
    for t in tris:
        p = verts[t]
        area = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        masses[t] += 1522.0 * area / 3.0
    pins = np.where(verts[:, 0] < 1e-9)[0]
    return verts, tris, masses, pins


# The cloth cells of benchmarks/matrix.py:279-281, with linsolver=0 as
# benchmarks/crossval.py:43-44 runs cloth: golden file suffix -> parameters.
CLOTH_SCENES = {
    "cloth_limit40": dict(nx=40, ny=40, limits=(0.95, 1.05), wind=None, gravity=-9.8),
    "cloth_wind40": dict(nx=40, ny=40, limits=None, wind=(0.05, 0.1, 0.02), gravity=0.0),
}


BUNNY = os.path.join(HERE, "data", "bunny_1124")  # the reference's .node / .ele, verbatim
BUNNY_PIN_BAND = 0.015  # the feet: y < y_min + band (benchmarks/crossval.py:173-182)
RENUMBER_SEED = 0


def renumbered_sheet(nx, ny):
    """cloth_sheet(nx, ny) with its vertex ids renumbered by a fixed
    permutation from np.random.default_rng(RENUMBER_SEED): vertex i of the
    grid is vertex perm[i] here, so x_grid = x[perm]. Positions, masses,
    pins and triangles move with it, and the triangle list is no regular
    sheet any more. Returns vertices, triangles, masses, pinned ids (sorted)
    and perm."""
    verts, tris, masses, pins = cloth_sheet(nx, ny)
    perm = np.random.default_rng(RENUMBER_SEED).permutation(len(verts))
    v2, m2 = np.empty_like(verts), np.empty_like(masses)
    v2[perm], m2[perm] = verts, masses
    return v2, perm[tris], m2, np.sort(perm[pins]), perm


def bunny_pins(verts):
    return np.where(verts[:, 1] < verts[:, 1].min() + BUNNY_PIN_BAND)[0]


# The paths on the gather D / D^T and on the Cholesky solve, float32 unless
# named, linsolver=0, 10 ADMM iterations, dt 1/24, gravity -9.8 (a sheet:
# its grid scene's): golden file suffix -> scene. "beam" is the 40x5x5 bench
# beam (its lattice_dims dropped where lattice is False, so that it takes the
# gather path in both packages), "bunny" the reference's bunny_1124 through
# load_elenode, "sheet" the sheet of the CLOTH_SCENES entry `sheet` (its
# limits, wind and gravity) renumbered by renumbered_sheet. The bunny moves
# so little (see DISP_TOL) that float32 rounding blurs its displacement; its
# float64 runs hold the elastic response itself.
GATHER_SCENES = {
    "beam_gather": dict(mesh="beam", model=NH, lattice=False, direct_mode="inv"),
    "bunny_nh": dict(mesh="bunny", model=NH, direct_mode="inv"),
    "bunny_linear": dict(mesh="bunny", model="linear", direct_mode="inv"),
    "bunny_nh_f64": dict(mesh="bunny", model=NH, direct_mode="inv", dtype=np.float64),
    "bunny_linear_f64": dict(mesh="bunny", model="linear", direct_mode="inv", dtype=np.float64),
    "cloth_gather_limit40": dict(mesh="sheet", sheet="cloth_limit40", direct_mode="inv"),
    "cloth_gather_wind40": dict(mesh="sheet", sheet="cloth_wind40", direct_mode="inv"),
    "beam_cho": dict(mesh="beam", model=NH, lattice=True, direct_mode="cho"),
}


# The PCG scenes (linsolver=3, or linsolver=0 switched to two-grid PCG above
# direct_max_verts), neo-Hookean soft rubber unless a sheet, float32 unless
# named, 10 ADMM iterations, dt 1/24, gravity -9.8: golden file suffix ->
# scene. The first four are the paths this script drives at full size
# (PCG_PATHS, benchmarks/matrix.py): the beam-nh-160k beam (:244-245, its -x
# face pinned), the torus-nh-20k ring (:269, _torus_solver(64, 8): the first
# (8 + 1)^2 vertices pinned), the 160x160 strain-limited sheet of
# cloth-limit-160 (:274) with linsolver=0 and the default PCG settings (25,921
# vertices: above direct_max_verts, so two-grid PCG at tol 1e-10 serves it),
# and crossval's bunny_nh_pcg (benchmarks/crossval.py:68-69,173-182: the feet
# pinned, the default Jacobi PCG). The others are crossval's small PCG scenes
# (:28-37: the 6x3x3 beam, the 12x4 torus), whose goldens the CPU tests read,
# in float32 and float64.
PCG_SCENES = {
    "beam_pcg160k": dict(mesh="beam", dims=(80, 20, 20), settings=dict(
        linsolver=3, pcg_precond="jacobi", pcg_max_iters=120, pcg_tol=1e-6)),
    "torus_pcg20k": dict(mesh="torus", ring=(64, 8), settings=dict(
        linsolver=3, pcg_precond="jacobi", pcg_max_iters=60, pcg_tol=1e-6)),
    "cloth_ls0_160": dict(mesh="sheet", nx=160, ny=160, limits=(0.95, 1.05),
                          settings=dict(linsolver=0)),
    "bunny_pcg": dict(mesh="bunny", settings=dict(linsolver=3)),
    "bunny_pcg_f64": dict(mesh="bunny", settings=dict(linsolver=3), dtype=np.float64),
    "beam_pcg": dict(mesh="beam", dims=(6, 3, 3), settings=dict(linsolver=3)),
    "beam_pcg_f64": dict(mesh="beam", dims=(6, 3, 3), settings=dict(linsolver=3),
                         dtype=np.float64),
    "torus_pcg": dict(mesh="torus", ring=(12, 4), settings=dict(linsolver=3)),
    "torus_pcg_f64": dict(mesh="torus", ring=(12, 4), settings=dict(linsolver=3),
                          dtype=np.float64),
}
PCG_PATHS = ("beam_pcg160k", "torus_pcg20k", "cloth_ls0_160", "bunny_pcg")
# Beams at and just beyond the CLUSTER form of kernel G's largest N, 16 blocks
# of 512 threads: 16 x 16 x 32 = 8,192 vertices, and 17 x 16 x 32 (the GRID
# form alone); held to the plain solve_T by pcg_checks (no golden).
G_EDGE_SCENES = {
    "beam_g_edge_inside": dict(mesh="beam", dims=(15, 15, 31), settings=dict(linsolver=3)),
    "beam_g_edge_beyond": dict(mesh="beam", dims=(16, 15, 31), settings=dict(linsolver=3)),
}
# The PCG paths' golden bounds (step 1, step 8) on x relative to max |x|, and
# on the displacement (disp_err), at three to ten times the larger gap to the
# JAX package's golden of two readings at full size: the port's plain path on
# the CPU (tests/pcg_fault_control.py, which also plants faults that the
# bounds catch) and this script on an NVIDIA H100 (PERF.md §6), whose
# kernel G sums in another order. x: beam_pcg160k 7.0e-6 / 6.7e-6 (CPU),
# 1.9e-6 / 7.0e-6 (card); torus_pcg20k 9.1e-6 / 5.4e-6, 1.4e-4 / 4.8e-6 (the
# ring is as sensitive after one step as benchmarks/crossval.py:282-296
# found); cloth_ls0_160 1.2e-6 / 7.9e-6, 8.6e-7 / 7.3e-6; bunny_pcg 2.2e-2 /
# 1.7e-2 on both. Displacement at the worse step: 3.3e-2, 1.1e-2, 1.1e-2,
# 0.12. The float32 PCG solve on the pin-stiffened bunny is only as accurate
# as its clamped tolerance allows: one solve lands 1.4e-2 (the port) and
# 2.2e-2 (the JAX package) of max |x| from the exact solution of the same
# system, so the two packages' bunnies part by that much after one step,
# where crossval's 2e-3 (measured between two backends of the JAX package)
# assumed one sum order.
PCG_STEP_TOL = {"beam_pcg160k": (5e-5, 5e-5), "torus_pcg20k": (1e-3, 5e-5),
                "cloth_ls0_160": (1e-5, 5e-5), "bunny_pcg": (0.1, 0.1)}
PCG_DISP_TOL = {"beam_pcg160k": 0.1, "torus_pcg20k": 0.1, "cloth_ls0_160": 0.05,
                "bunny_pcg": 0.5}


def pcg_scene(name, api, scenes=None):
    """One of PCG_SCENES (or of scenes) built through the normal entry points
    of a package whose API the namespace `api` holds (Solver, a no-argument
    constructor; Settings, Lame, binding, make_tet_blocks, make_tet_torus,
    load_elenode): returns the initialized solver and the pinned vertex ids.
    The JAX package's API here is how tests/make_torch_golden.py writes the
    goldens."""
    p = (scenes or PCG_SCENES)[name]
    solver = api.Solver()
    if p["mesh"] == "sheet":
        verts, tris, masses, pins = cloth_sheet(p["nx"], p["ny"])
        solver.add_nodes(verts, masses)
        lame = api.Lame.from_youngs_poisson(10000000, 0.399)
        lame.limit_min, lame.limit_max = p["limits"]
        solver.add_tri_energies(verts, tris, lame)
    else:
        if p["mesh"] == "beam":
            mesh = api.make_tet_blocks(*p["dims"])
            pins = np.where(mesh.vertices[:, 0] < 1e-9)[0]
        elif p["mesh"] == "torus":
            n_ring, n_sec = p["ring"]
            mesh = api.make_tet_torus(n_ring=n_ring, n_sec=n_sec)
            pins = np.arange((n_sec + 1) ** 2)
        else:
            mesh = api.load_elenode(BUNNY)
            pins = bunny_pins(mesh.vertices)
        mesh.flags = api.binding.NOSELFCOLLISION | api.binding.NEOHOOKEAN
        api.binding.add_tetmesh(solver, mesh, api.Lame.soft_rubber(), verbose=False)
    solver.set_pins([int(i) for i in pins])
    st = api.Settings(verbose=0, admm_iters=10, gravity=-9.8, timestep_s=1.0 / 24.0,
                      dtype=p.get("dtype", np.float32), **p["settings"])
    need(solver.initialize(st), f"{name}: initialize failed")
    return solver, np.asarray(pins, dtype=np.int64)


# The contact scenes: an unpinned soft-rubber beam dropped on a Floor(y=-1)
# (its bottom face starts at y = 0 and reaches the floor after about 11 steps
# of free fall), or crossval's Sphere; float32 unless named, 10 ADMM
# iterations, dt 1/24, gravity -9.8, direct_mode "inv": golden file suffix ->
# scene. The first five are the paths this script drives at full size
# (CONTACT_PATHS), built as benchmarks/matrix.py's _beam_solver builds them
# (:28-51: uzawa_max_iters 10, uzawa_inner_tol 1e-5, uzawa_inner_iters 60,
# PCG ("jacobi", 40, 1e-6) unless named): beam-floor-gs-5k (:246, the 40x5x5
# neo-Hookean bench beam, Gauss-Seidel), beam-floor-uzawa-5k (:247, Uzawa, its
# direct inner: 1,476 vertices <= uzawa_dense_max_verts), beam-floor-uzawa-67k
# (:248, the 60x15x15 linear beam, 15,616 vertices: Uzawa around a two-grid
# PCG inner), beam-floor-alpcg-67k (:250-252, the same beam, AL-PCG, Jacobi,
# 120 trips, tol 1e-6), and crossval's sphere_obstacle_gs (benchmarks/
# crossval.py:122-131 = tests/test_contact.py:384-407: the 4x2x2 linear beam
# moved by (-2, 2, -1) onto a Sphere of radius 10 at (0, -10, 0), Gauss-Seidel,
# crossval's settings), the only Sphere scene the JAX package has, at its own
# size. The rest are crossval's small contact scenes (:39-41, :102-111: the
# 6x3x3 linear beam on the floor, crossval's settings) for the CPU tests, in
# float32 and float64, with Uzawa's PCG inner and AL-PCG's two-grid form
# beside them. "steps" are the steps a rollout runs and "compare" the steps
# held to the golden.
CONTACT_SCENES = {
    "floor_gs5k": dict(dims=(40, 5, 5), model=NH, ls=1, matrix=True),
    "floor_uzawa5k": dict(dims=(40, 5, 5), model=NH, ls=2, matrix=True),
    "floor_uzawa67k": dict(dims=(60, 15, 15), model="linear", ls=2, matrix=True),
    "floor_alpcg67k": dict(dims=(60, 15, 15), model="linear", ls=4, matrix=True,
                           settings=dict(pcg_max_iters=120)),
    "sphere_gs": dict(dims=(4, 2, 2), model="linear", ls=1, sphere=True, steps=40,
                      compare=(1, 16, 40)),
    "contact_gs": dict(dims=(6, 3, 3), model="linear", ls=1),
    "contact_uzawa": dict(dims=(6, 3, 3), model="linear", ls=2),
    "contact_uzawa_pcg": dict(dims=(6, 3, 3), model="linear", ls=2,
                              settings=dict(uzawa_inner="pcg", pcg_precond="twogrid")),
    "contact_alpcg": dict(dims=(6, 3, 3), model="linear", ls=4),
    "contact_alpcg_twogrid": dict(dims=(6, 3, 3), model="linear", ls=4,
                                  settings=dict(pcg_precond="twogrid")),
    "contact_gs_f64": dict(dims=(6, 3, 3), model="linear", ls=1, dtype=np.float64),
    "contact_uzawa_f64": dict(dims=(6, 3, 3), model="linear", ls=2, dtype=np.float64),
    "contact_uzawa_pcg_f64": dict(dims=(6, 3, 3), model="linear", ls=2, dtype=np.float64,
                                  settings=dict(uzawa_inner="pcg", pcg_precond="twogrid")),
    "contact_alpcg_f64": dict(dims=(6, 3, 3), model="linear", ls=4, dtype=np.float64),
    "contact_alpcg_twogrid_f64": dict(dims=(6, 3, 3), model="linear", ls=4,
                                      dtype=np.float64, settings=dict(pcg_precond="twogrid")),
    "sphere_gs_f64": dict(dims=(4, 2, 2), model="linear", ls=1, sphere=True, steps=20,
                          compare=(1, 16, 20), dtype=np.float64),
}
# Mesh obstacles (ROADMAP Queue 1 item 9): a make_tet_blocks slab under the
# body (blocks, cell, translation; "top": the y of its top face), as
# benchmarks/crossval.py:132-156 and apps/signorini.py:37-53 build theirs;
# "bake": the keywords of the obstacle's from_tet_mesh. The paths on the card
# take the floor paths' bodies and settings with a slab in place of the Floor;
# crossval's five mesh scenes (crossval.py:47-61, 144-156, 204-218: the
# 3x2x2 linear body of cell 0.4 launched down at 2.5 m/s, the deep one at
# 7 m/s; 8 steps) and two with near_lanes=4, where Gauss-Seidel's compaction
# engages and overflows, go to the CPU tests, with two small AL-PCG scenes
# whose exact obstacle compacts in the solver's detection (near_lanes 16, and
# 4, where it overflows: collision_overflow). The near_lanes of the
# 5k paths (256 < the 558-slot colours) and of the 67k path (V = 15,616)
# engage the compaction; PERF.md gives the most near lanes a colour pass or a
# detection saw on each (tools/mesh_near_lanes.py), all below K.
SLAB_5K = dict(blocks=(22, 1, 5), cell=2.0, trans=(-2.0, -3.0, -2.5), top=-1.0)
SLAB_67K = dict(blocks=(32, 1, 9), cell=2.0, trans=(-2.0, -3.0, -1.5), top=-1.0)
CROSSVAL_SLAB = dict(blocks=(4, 2, 4), cell=0.5, trans=(0.0, -1.0, 0.0), top=0.0)
CROSSVAL_BODY = dict(cell=0.4, trans=(0.4, 1.0, 0.4))
CROSSVAL_DEEP_BODY = dict(cell=0.4, trans=(0.4, 0.05, 0.4))
# the SDF of the 5k slab: the grid reaches 1.5 m above the top face (pad), so
# that a vertex above the slab's cell layer falls in cells whose corners are
# all outside; with the default pad of 0.1 the grid ends 0.1 m above the top,
# every vertex above it clips into the cells that straddle the surface, and
# every vertex of the beam is near
SDF_5K_PAD = 1.5
CROSSVAL_MESH = dict(dims=(3, 2, 2), model="linear", ls=1, body=CROSSVAL_BODY, v0=-2.5,
                     steps=8, compare=(1, 8))
CONTACT_SCENES.update({
    "slab_sdf_gs5k": dict(dims=(40, 5, 5), model=NH, ls=1, matrix=True, obstacle=dict(
        kind="sdf", slab=SLAB_5K, bake=dict(resolution=48, pad=SDF_5K_PAD, near_lanes=256))),
    "slab_exact_gs5k": dict(dims=(40, 5, 5), model=NH, ls=1, matrix=True, obstacle=dict(
        kind="exact", slab=SLAB_5K, bake=dict(cells=32, fallback_lanes=128, near_lanes=256))),
    "slab_exact_alpcg67k": dict(dims=(60, 15, 15), model="linear", ls=4, matrix=True,
                                settings=dict(pcg_max_iters=120), obstacle=dict(
        kind="exact", slab=SLAB_67K, bake=dict(cells=32, fallback_lanes=128, near_lanes=2048))),
    "sdf_obstacle_gs": dict(CROSSVAL_MESH, obstacle=dict(
        kind="sdf", slab=CROSSVAL_SLAB, bake=dict(resolution=24))),
    "sdf_obstacle_compact_gs": dict(CROSSVAL_MESH, obstacle=dict(
        kind="sdf", slab=CROSSVAL_SLAB, bake=dict(resolution=24, near_lanes=32))),
    "exactmesh_obstacle_gs": dict(CROSSVAL_MESH, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256))),
    "exactmesh_compact_gs": dict(CROSSVAL_MESH, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256,
                                                    near_lanes=32))),
    "exactmesh_deep_gs": dict(CROSSVAL_MESH, body=CROSSVAL_DEEP_BODY, v0=-7.0, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=32, fallback_lanes=256))),
    "sdf_obstacle_gs4": dict(CROSSVAL_MESH, obstacle=dict(
        kind="sdf", slab=CROSSVAL_SLAB, bake=dict(resolution=24, near_lanes=4))),
    "exactmesh_gs4": dict(CROSSVAL_MESH, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256,
                                                    near_lanes=4))),
    "exactmesh_compact_alpcg": dict(CROSSVAL_MESH, ls=4, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256,
                                                    near_lanes=16))),
    "exactmesh_alpcg4": dict(CROSSVAL_MESH, ls=4, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256,
                                                    near_lanes=4))),
    "exactmesh_compact_gs_f64": dict(CROSSVAL_MESH, dtype=np.float64, obstacle=dict(
        kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=16, fallback_lanes=256,
                                                    near_lanes=32))),
})
CONTACT_PATHS = ("floor_gs5k", "floor_uzawa5k", "floor_uzawa67k", "floor_alpcg67k",
                 "sphere_gs")
MESH_PATHS = ("slab_sdf_gs5k", "slab_exact_gs5k", "slab_exact_alpcg67k", "exactmesh_deep_gs")
# the CPU tests' mesh scenes (tests/test_torch_mesh_obstacle_paths.py)
MESH_CPU_SCENES = ("sdf_obstacle_gs", "sdf_obstacle_compact_gs", "exactmesh_obstacle_gs",
                   "exactmesh_compact_gs", "exactmesh_deep_gs", "sdf_obstacle_gs4",
                   "exactmesh_gs4", "exactmesh_compact_alpcg", "exactmesh_alpcg4",
                   "exactmesh_compact_gs_f64")
CONTACT_STEPS = 20  # bench.py:51-64: the floor is reached after about 11
CONTACT_COMPARE = (1, 12, 20)  # just after landing, and at rest
SMALL_CONTACT_STEPS, SMALL_CONTACT_COMPARE = 14, (1, 12, 14)
SPHERE_CENTER, SPHERE_RAD = (0.0, -10.0, 0.0), 10.0
CONTACT_EPS = 1e-3  # a vertex within this of an obstacle (or in it) is in contact


# Self-collision (ROADMAP Queue 1 item 10): benchmarks/matrix.py _boxes_solver
# (:183-199, the box of apps/boxes.py's fallback): two make_tet_blocks boxes of
# n x n x n cells of 1/n, the second 1.25 above the first, self-collision on
# (LINEAR, no NOSELFCOLLISION), Lame.rubber(), a Floor at y = -0.5, 10 ADMM
# iterations, float32, pcg_max_iters 60, pcg_tol 1e-6; n = 8 under GS, Uzawa
# (the solver of apps/torus.py) and AL-PCG, n = 20 under GS (40,000 tets a box,
# above BROADPHASE_MIN_TETS: the hash-grid broad phase). "steps": the steps a
# rollout runs; the golden holds step 1, the first step whose state shows a
# dynamic hit, and the last. The CPU tests' 3x3x3 stacks
# (tests/test_contact.py:199-220, 317-345: the same scene at n = 3, the
# default settings) are SELFCOLL_CPU_SCENES.
SELFCOLL_SCENES = {
    "boxes_gs8": dict(n=8, ls=1, steps=14),
    "boxes_uzawa8": dict(n=8, ls=2, steps=14),
    "boxes_alpcg8": dict(n=8, ls=4, steps=14),
    "boxes_gs20": dict(n=20, ls=1, steps=12),
}
SELFCOLL_PATHS = tuple(SELFCOLL_SCENES)
BOXES_SPACING, BOXES_FLOOR = 1.25, -0.5


def boxes_scene(name, api, dtype=np.float32, **change):
    """A SELFCOLL_SCENES scene built through the normal entry points of a
    package whose API the namespace `api` holds (as contact_scene), with the
    Settings changes `change`: returns (the initialized solver, the number of
    vertices of a box)."""
    p = SELFCOLL_SCENES[name]
    solver = api.Solver()
    n_box = 0
    for i in range(2):
        m = api.make_tet_blocks(p["n"], p["n"], p["n"], cell=1.0 / p["n"])
        m.apply_xform(api.make_xform(trans=(0.0, i * BOXES_SPACING, 0.0)))
        m.flags = api.binding.LINEAR
        api.binding.add_tetmesh(solver, m, api.Lame.rubber(), verbose=False)
        n_box = len(m.vertices)
    solver.add_obstacle(api.Floor(y=api.asarray(BOXES_FLOOR)))
    kw = dict(verbose=0, admm_iters=10, linsolver=p["ls"], dtype=dtype, pcg_max_iters=60,
              pcg_tol=1e-6)
    kw.update(change)
    need(solver.initialize(api.Settings(**kw)), f"{name}: initialize failed")
    return solver, n_box


# The demo apps (ROADMAP Queue 1 item 11b): admm_elastic_tpu_torch.apps.<module>
# run through main(argv) at the apps' own sizes and default settings, for
# APP_FRAMES frames, past first contact (the torus reaches the floor near frame
# 19): run name -> (module, the app's own leading arguments). The goldens
# (tests/make_torch_golden.py) are the JAX package's apps/<module>.py under
# the same arguments, float32, on its Jacobi SVD. An app without contact is
# held at APP_STEPS; a contact app at step 1 and then, at the first step with
# a vertex within CONTACT_EPS of the floor (or of the slab's top), the first
# with a dynamic hit and the last, one step from the golden's state before it
# (APP_ONESTEP).
APP_FRAMES = 24
APP_RUNS = {
    "beams": ("beams", ()),
    "trianglestrain": ("trianglestrain", ()),
    "bunnyexpand": ("bunnyexpand", ("point",)),
    "bunnyexpand_rand": ("bunnyexpand", ("rand",)),
    "signorini": ("signorini", ()),
    "signorini_sdf": ("signorini", ("--obstacle", "sdf")),
    "signorini_exact": ("signorini", ("--obstacle", "exact")),
    "torus": ("torus", ()),
    "boxes": ("boxes", ()),
}
APP_CONTACT = ("signorini", "signorini_sdf", "signorini_exact", "torus", "boxes")
APP_STEPS = (1, 8)
APP_STEPS_TOL = (1e-4, 2e-3)
APP_FLOOR = -1.0  # the floor's y, and the slab's top, in every contact app


def app_held_steps(name, xs, hits=None):
    """The steps a run of APP_RUNS is held at, from its positions after each
    step xs[0..] and, with colliders, the dynamic hits of each step's state."""
    if name not in APP_CONTACT:
        return list(APP_STEPS)
    held = {1, len(xs)}
    touch = [k + 1 for k, x in enumerate(xs) if float(x[:, 1].min()) <= APP_FLOOR + CONTACT_EPS]
    if touch:
        held.add(touch[0])
    if hits:
        first = [k + 1 for k, h in enumerate(hits) if h > 0]
        if first:
            held.add(first[0])
    return sorted(held)


def app_module(name):
    """The port's app module of a run of APP_RUNS."""
    import importlib

    return importlib.import_module(f"admm_elastic_tpu_torch.apps.{APP_RUNS[name][0]}")


def app_scene(name, device=None, **change):
    """A run of APP_RUNS built by its app's own builder, on `device` (the
    card unless named), with its default settings, verbose 0 and the
    Settings changes `change`: the app's Scene."""
    mod = app_module(name)
    s = mod.settings()
    s.verbose = 0
    for k, v in change.items():
        setattr(s, k, v)
    lead = APP_RUNS[name][1]
    opt = (mod.split_argv(lead)[0],) if hasattr(mod, "split_argv") else ()
    scene = mod.build(s, device or DEVICE, *opt)
    need(scene is not None, f"app {name}: initialize failed")
    return scene


# The Anderson paths and the sequential wind: an earlier path's scene with one
# setting changed, golden file suffix -> (the base scene, the change). The
# Anderson window is the JAX package's measured one (admm_elastic_tpu/
# config.py:86-99, tests/test_anderson.py:53-91); "sequential" is the wind's
# order (WindForce(sequential=True)), any other key a Settings field.
# Scenario batches (admm_elastic_tpu_torch/parallel/batch.py, ROADMAP Queue 1
# item 12): golden name -> scene and sweep, built by batch_scene in either
# package. batch_beam_sweep8 is benchmarks/scaling.py's sweep (:36-47: the
# 40x5x5 neo-Hookean bench beam, soft rubber, -x face pinned, linsolver 3,
# Jacobi, pcg_max_iters 40, pcg_tol 1e-6, 10 ADMM iterations, dt 1/24) with
# 8 scenes of distinct scale and gravity; its stencil is 34.9 % padding, so
# the batch runs it as a gather family (_debloat_for_throughput). The card
# runs it at BATCH_BEAM_S scenes with these 8 at BATCH_BEAM_AT. batched_contact_alpcg is
# crossval's batched scene (benchmarks/crossval.py:76,183-203: the 6x3x3
# linear beam on Floor(y=-1), AL-PCG, crossval's settings, 4 scenes),
# also in float64. batch_cloth_sweep4 is the cloth-limit-40 sheet under PCG
# (4.8 % padding: it keeps its stencil, kernel E's stencil entry);
# batch_lattice_stencil a 20x20x20 neo-Hookean lattice (9,261 vertices, 9.4 %
# padding: kernel A's stencil entry and C, and G's GRID form a scene at a time).
BATCH_SWEEP = dict(linsolver=3, pcg_precond="jacobi", pcg_max_iters=40, pcg_tol=1e-6)
BATCH_SCENES = {
    "batch_beam_sweep8": dict(mesh="beam", dims=(40, 5, 5), flag="NEOHOOKEAN",
                              settings=BATCH_SWEEP,
                              scales=(0.25, 0.5, 1.0, 2.0, 4.0, 1.0, 1.0, 0.5),
                              gravity=(-9.8,) * 5 + (-5.0, -15.0, -15.0)),
    "batched_contact_alpcg": dict(mesh="floor", dims=(6, 3, 3), flag="LINEAR",
                                  settings=dict(linsolver=4), scales=(0.5, 1.0, 2.0, 4.0),
                                  gravity=(-9.8, -9.8, -5.0, -15.0)),
    "batched_contact_alpcg_f64": dict(mesh="floor", dims=(6, 3, 3), flag="LINEAR",
                                      settings=dict(linsolver=4), scales=(0.5, 1.0, 2.0, 4.0),
                                      gravity=(-9.8, -9.8, -5.0, -15.0), dtype=np.float64),
    "batch_cloth_sweep4": dict(mesh="sheet", nx=40, ny=40, limits=(0.95, 1.05),
                               settings=BATCH_SWEEP, scales=(0.5, 1.0, 2.0, 4.0),
                               gravity=(-9.8,) * 4),
    "batch_lattice_stencil": dict(mesh="beam", dims=(20, 20, 20), flag="NEOHOOKEAN",
                                  settings=BATCH_SWEEP, scales=(0.5, 2.0), gravity=(-9.8, -9.8)),
}
# Uzawa and mesh obstacles in a batch (ROADMAP Queue 1 item 12b, first part):
# batch_floor_uzawa5k is floor_uzawa5k's body, floor and settings
# (benchmarks/matrix.py:28-51: Uzawa, 10 trips, inner tol 1e-5, 60 inner
# trips) and batch_slab_exact_alpcg5k the bench beam over slab_exact_gs5k's
# exact slab under AL-PCG (pcg_max_iters 120, as slab_exact_alpcg67k), each at
# full width with four scenes of scale and gravity, 20 steps held at 1, 12 and
# 20 as CONTACT_COMPARE (the later held steps one step from the golden's
# stored state: "onestep"); batched_contact_uzawa is crossval's batched scene
# under Uzawa (also in float64); batch_exactmesh_alpcg the scene of
# tests/test_parallel.py:224-270 (the 3x2x2 linear body above the 4x2x4
# exact slab, near_lanes 24, scales 0.5, 1, 2, 30 steps; float64, the JAX
# test's dtype under its x64).
BATCH_CONTACT_SWEEP = dict(scales=(0.5, 1.0, 2.0, 4.0), gravity=(-9.8, -9.8, -5.0, -15.0))
EXACTMESH_BATCH_SLAB = dict(kind="exact", slab=CROSSVAL_SLAB, bake=dict(cells=24, near_lanes=24))
BATCH_SCENES.update({
    "batch_floor_uzawa5k": dict(mesh="contact", contact="floor_uzawa5k", steps=(1, 12, 20),
                                onestep=True, **BATCH_CONTACT_SWEEP),
    "batch_slab_exact_alpcg5k": dict(mesh="contact", contact="slab_exact_gs5k",
                                     change=dict(linsolver=4, pcg_max_iters=120),
                                     steps=(1, 12, 20), onestep=True, **BATCH_CONTACT_SWEEP),
    "batched_contact_uzawa": dict(mesh="floor", dims=(6, 3, 3), flag="LINEAR",
                                  settings=dict(linsolver=2), **BATCH_CONTACT_SWEEP),
    "batched_contact_uzawa_f64": dict(mesh="floor", dims=(6, 3, 3), flag="LINEAR",
                                      settings=dict(linsolver=2), dtype=np.float64,
                                      **BATCH_CONTACT_SWEEP),
    "batch_exactmesh_alpcg": dict(mesh="exactmesh", dims=(3, 2, 2), flag="LINEAR",
                                  settings=dict(linsolver=4), scales=(0.5, 1.0, 2.0),
                                  gravity=(-9.8,) * 3, steps=(1, 8, 30), dtype=np.float64),
    # the same slab with near_lanes 4 and the body 0.1 m above it, the middle
    # scene held there (gravity 0): the others' compaction overflows, its not
    "batch_exactmesh_alpcg4": dict(mesh="exactmesh", dims=(3, 2, 2), flag="LINEAR",
                                   settings=dict(linsolver=4), near_lanes=4, lift=0.1,
                                   scales=(1.0, 1.0, 2.0), gravity=(-9.8, 0.0, -15.0),
                                   steps=(1, 4), dtype=np.float64),
    # Uzawa over the same slab (L, M, G's done and J in one batch), the body
    # 0.1 m above it, landed by step 3; float32
    "batch_exactmesh_uzawa": dict(mesh="exactmesh", dims=(3, 2, 2), flag="LINEAR",
                                  settings=dict(linsolver=2), lift=0.1, scales=(0.5, 1.0, 2.0),
                                  gravity=(-15.0,) * 3, steps=(1, 5)),
})
# the full-width Uzawa and mesh-obstacle scenes, whose held steps after
# the first are one step from the golden's stored state
BATCH_WIDE = ("batch_floor_uzawa5k", "batch_slab_exact_alpcg5k")
BATCH_STEPS = (1, 8)  # the steps each batch golden holds (a scene's "steps" where given)


def batch_steps(name):
    return BATCH_SCENES[name].get("steps", BATCH_STEPS)

# Each golden's bounds after 1 and 8 steps, relative to max |x|: crossval's
# (1e-4, 2e-3; crossval.py:256-302), but for the strain-limited sheet, whose
# float32 trajectory the port on the CPU holds to 5.2e-7 and 2.5e-3 (float64:
# 4.1e-12 after 8 steps, so rounding, not a fault) and which takes crossval's
# bound of its chaotic scenes, 1e-2; the float64 scene at 1e-8 (the CPU:
# 1.5e-13 after 20 steps). The port on the CPU (tests/test_torch_batch_paths.py):
# beam 1.0e-5 / 4.9e-5, crossval's scene 0 / 7.0e-8, lattice 1.8e-5 / 1.7e-4.
BATCH_STEP_TOL = {"batch_beam_sweep8": (1e-4, 2e-3), "batched_contact_alpcg": (1e-4, 2e-3),
                  "batched_contact_alpcg_f64": (1e-8, 1e-8),
                  "batch_cloth_sweep4": (1e-4, 1e-2), "batch_lattice_stencil": (1e-4, 2e-3),
                  # the Uzawa and mesh-obstacle batches: crossval's bounds at every held step
                  "batch_floor_uzawa5k": (1e-4, 2e-3, 2e-3),
                  "batch_slab_exact_alpcg5k": (1e-4, 2e-3, 2e-3),
                  "batched_contact_uzawa": (1e-4, 2e-3),
                  "batched_contact_uzawa_f64": (1e-4, 2e-3),
                  "batch_exactmesh_alpcg": (1e-4, 2e-3, 2e-3),
                  "batch_exactmesh_alpcg4": (1e-4, 2e-3),
                  "batch_exactmesh_uzawa": (1e-4, 2e-3)}
# The beam's pinned face after 8 steps, from its target: the JAX package's own
# run drifts up to 8.2e-5 at the sweep's PCG tolerance of 1e-6 in float32 (a
# scaled pin diagonal would put it near target / scale: O(1)); the JAX test's
# 1e-6 holds at its own settings (tests/test_torch_batch.py).
BATCH_PIN_TOL = 2e-4
BATCH_BEAM_S = 1024
BATCH_FLOOR_BOUND = -1.1  # crossval's batched scene: no vertex below (no tunnelling)
BATCH_FLOOR_SLACK = 1e-3  # below the JAX package's own least y, where that is lower


def batch_scene(name, api, dtype=None):
    """One of BATCH_SCENES through the normal entry points of a package whose
    API `api` holds (as pcg_scene's, with Floor and asarray), in dtype where
    given (else the scene's): (the initialized solver, the scales [S], the
    gravities [S])."""
    p = BATCH_SCENES[name]
    if p["mesh"] == "contact":
        solver = contact_scene(p["contact"], api, **p.get("change", {}),
                               **({"dtype": dtype} if dtype else {}))
        return solver, np.asarray(p["scales"], np.float64), np.asarray(p["gravity"], np.float64)
    solver = api.Solver()
    if p["mesh"] == "sheet":
        verts, tris, masses, pins = cloth_sheet(p["nx"], p["ny"])
        solver.add_nodes(verts, masses)
        lame = api.Lame.from_youngs_poisson(10000000, 0.399)
        lame.limit_min, lame.limit_max = p["limits"]
        solver.add_tri_energies(verts, tris, lame)
        solver.set_pins([int(i) for i in pins])
    else:
        exact = p["mesh"] == "exactmesh"  # the body above the slab (test_parallel.py:238-248)
        mesh = api.make_tet_blocks(*p["dims"], **({"cell": 0.4} if exact else {}))
        mesh.flags = api.binding.NOSELFCOLLISION | getattr(api.binding, p["flag"])
        if exact:
            mesh.apply_xform(api.make_xform(trans=(0.4, p.get("lift", 0.6), 0.4)))
        api.binding.add_tetmesh(solver, mesh, api.Lame.soft_rubber(), verbose=False)
        if exact:
            slab = dict(EXACTMESH_BATCH_SLAB, bake=dict(
                EXACTMESH_BATCH_SLAB["bake"], near_lanes=p.get("near_lanes", 24)))
            solver.add_obstacle(mesh_obstacle(slab, api))
        elif p["mesh"] == "floor":
            solver.add_obstacle(api.Floor(y=api.asarray(-1.0)))
        else:
            solver.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
    st = api.Settings(verbose=0, admm_iters=10, gravity=-9.8, timestep_s=1.0 / 24.0,
                      dtype=dtype or p.get("dtype", np.float32), direct_mode="inv",
                      **p["settings"])
    need(solver.initialize(st), f"{name}: initialize failed")
    return solver, np.asarray(p["scales"], np.float64), np.asarray(p["gravity"], np.float64)


AA_WINDOW = 4
VARIANT_SCENES = {
    "beam_aa4": ("beam", dict(aa_window=AA_WINDOW)),
    "cloth_aa4": ("cloth_limit40", dict(aa_window=AA_WINDOW)),
    "floor_alpcg67k_aa4": ("floor_alpcg67k", dict(aa_window=AA_WINDOW)),
    "cloth_wind40_seq": ("cloth_wind40", dict(sequential=True)),
}
AA_PATHS = ("beam_aa4", "cloth_aa4", "floor_alpcg67k_aa4")
WIND_SEQ_PATH = "cloth_wind40_seq"
WIND_SEQ_TRIANGLES = 3200  # its 40x40 sheet


def variant_of(name):
    """(base scene, Settings changes, sequential wind) of a scene name: a
    VARIANT_SCENES entry, or the scene itself unchanged."""
    base, change = VARIANT_SCENES.get(name, (name, {}))
    change = dict(change)
    return base, change, bool(change.pop("sequential", False))


def contact_steps(name):
    """(steps run, steps compared) of a contact scene."""
    p = CONTACT_SCENES[variant_of(name)[0]]
    if "steps" in p:
        return p["steps"], p["compare"]
    if p["dims"] == (6, 3, 3):
        return SMALL_CONTACT_STEPS, SMALL_CONTACT_COMPARE
    return CONTACT_STEPS, CONTACT_COMPARE


def contact_scene(name, api, **extra):
    """One of CONTACT_SCENES (or a VARIANT_SCENES entry of one) built through
    the normal entry points of a package whose API the namespace `api` holds
    (as pcg_scene, and Floor, Sphere, make_xform, asarray: the package's
    array constructor), with the Settings changes `extra` on top: returns the
    initialized solver."""
    base, change, _ = variant_of(name)
    change.update(extra)
    p = CONTACT_SCENES[base]
    solver = api.Solver()
    body = p.get("body")
    mesh = api.make_tet_blocks(*p["dims"], **({"cell": body["cell"]} if body else {}))
    if p.get("sphere"):
        mesh.apply_xform(api.make_xform(trans=(-2.0, 2.0, -1.0)))
    if body:
        mesh.apply_xform(api.make_xform(trans=body["trans"]))
    mesh.flags = api.binding.NOSELFCOLLISION | getattr(api.binding, BEAM_FLAGS[p["model"]])
    api.binding.add_tetmesh(solver, mesh, api.Lame.soft_rubber(), verbose=False)
    if p.get("sphere"):
        solver.add_obstacle(api.Sphere(center=api.asarray(list(SPHERE_CENTER)),
                                       rad=api.asarray(SPHERE_RAD)))
    elif "obstacle" in p:
        solver.add_obstacle(mesh_obstacle(p["obstacle"], api))
    else:
        solver.add_obstacle(api.Floor(y=api.asarray(-1.0)))
    kw = dict(verbose=0, admm_iters=10, linsolver=p["ls"], gravity=-9.8,
              timestep_s=1.0 / 24.0, dtype=p.get("dtype", np.float32), direct_mode="inv")
    if p.get("matrix"):
        kw.update(pcg_precond="jacobi", pcg_max_iters=40, pcg_tol=1e-6, uzawa_max_iters=10,
                  uzawa_inner_tol=1e-5, uzawa_inner_iters=60)
    kw.update(p.get("settings", {}), **change)
    need(solver.initialize(api.Settings(**kw)), f"{name}: initialize failed")
    if "v0" in p:  # launched down (crossval.py:204-218)
        v0 = np.zeros((len(mesh.vertices), 3), np.float32)
        v0[:, 1] = p["v0"]
        solver.v = v0
    return solver


def mesh_obstacle(spec, api):
    """A mesh obstacle of CONTACT_SCENES (its "obstacle" entry) baked from
    its slab by the package whose API the namespace api holds."""
    slab = api.make_tet_blocks(*spec["slab"]["blocks"], cell=spec["slab"]["cell"])
    slab.apply_xform(api.make_xform(trans=spec["slab"]["trans"]))
    cls = api.PassiveMeshSDF if spec["kind"] == "sdf" else api.PassiveMeshExact
    return cls.from_tet_mesh(slab.vertices, slab.tets, **spec["bake"])


def obstacle_top(name):
    """The y of the top face of a scene's floor or slab."""
    p = CONTACT_SCENES[variant_of(name)[0]]
    return p["obstacle"]["slab"]["top"] if "obstacle" in p else -1.0


def contacts(name, x):
    """The vertices within CONTACT_EPS of the scene's obstacle, or in it
    (a slab: of its top face's plane; the bodies stay inside its
    footprint)."""
    if CONTACT_SCENES[variant_of(name)[0]].get("sphere"):
        d = np.linalg.norm(x - np.asarray(SPHERE_CENTER), axis=1) - SPHERE_RAD
    else:
        d = x[:, 1] - obstacle_top(name)
    return int(np.sum(d <= CONTACT_EPS))


def torch_api(device=None):
    """pcg_scene's and contact_scene's namespace for this package, its solvers
    on `device` (the card unless named)."""
    import types

    from admm_elastic_tpu_torch import (Floor, Lame, PassiveMeshExact, PassiveMeshSDF, Settings,
                                        Solver, Sphere, binding)
    from admm_elastic_tpu_torch.geometry.factory import (make_tet_blocks, make_tet_torus,
                                                          make_xform)
    from admm_elastic_tpu_torch.geometry.io import load_elenode

    return types.SimpleNamespace(
        Solver=lambda: Solver(device=device or DEVICE), Settings=Settings, Lame=Lame,
        binding=binding, make_tet_blocks=make_tet_blocks, make_tet_torus=make_tet_torus,
        load_elenode=load_elenode, Floor=Floor, Sphere=Sphere, PassiveMeshSDF=PassiveMeshSDF,
        PassiveMeshExact=PassiveMeshExact, make_xform=make_xform,
        asarray=lambda v: np.asarray(v, dtype=np.float64))


class SmokeFailure(Exception):
    pass


class ProfilerShort(SmokeFailure):
    """A counted window came back short of launches three times: records
    that torch.profiler lost, or launches that did not happen."""


# The exit code of the paths' process (--paths) where a counted window came
# back short three times; main runs that process once more, from the start.
PROFILER_SHORT_RC = 3


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    """Print a line, and keep it in OUT_DIR/chip_smoke.log: the end of the
    standard output is all that a remote run may bring back."""
    print(msg, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as f:
        f.write(msg + "\n")


def stamp(t0, label):
    """Log the seconds since t0 after a phase: where a run's time goes."""
    log(f"{label}: done {time.perf_counter() - t0:.1f} s from the start")


def run_cmd(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise SmokeFailure(f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def golden(name):
    return np.load(os.path.join(DATA, f"torch_port_golden_{name}.npz"))


def beam_golden_name(model):
    return "beam" if model == NH else f"beam_{model}"


# --- phase 1: environment ----------------------------------------------------

def environment(torch):
    gpu = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    from admm_elastic_tpu_torch import Solver
    from admm_elastic_tpu_torch.ops import _build

    nvcc = run_cmd([_build._nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    need(Solver().device.type == "cuda", "Solver() did not land on the card")
    env = dict(gpu=gpu, python=sys.version.split()[0], torch=torch.__version__,
               cuda=torch.version.cuda, nvcc=nvcc, triton=triton_v,
               matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
               cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
               float32_matmul_precision=torch.get_float32_matmul_precision(),
               device_name=torch.cuda.get_device_name(0),
               device_count=torch.cuda.device_count())
    log("env " + json.dumps(env))
    return env


# --- phase 2: build ------------------------------------------------------------

# The latency floor of kernels G, H, I and M: pcg.cu, gs.cu, wind_seq.cu and
# uzawa.cu built with phases and passes that do no row work (csrc/pcg.cu
# ADMM_G_ANATOMY, csrc/gs.cu ADMM_H_ANATOMY: the barriers, block sums and
# totals of G, the __syncthreads chain of H, in a fixed number of trips or
# sweeps; csrc/uzawa.cu ADMM_M_FLOOR: M's launch and its two reductions);
# tools/g_h_anatomy.py builds the other variants.
FLOOR_UNITS = (("pcg.cu", None), ("gs.cu", None), ("wind_seq.cu", None), ("uzawa.cu", None))
FLOOR_DEFINES = ("-DADMM_G_ANATOMY=1", "-DADMM_H_ANATOMY=1", "-DADMM_I_FLOOR=1",
                 "-DADMM_M_FLOOR=1")


def floor_library():
    """The latency-floor build of G, H, I and M (FLOOR_DEFINES; kernel I's
    walk with the loads and stores of v and no arithmetic), loaded."""
    from admm_elastic_tpu_torch.ops import _build

    return _build.variant(FLOOR_UNITS, FLOOR_DEFINES)


def build():
    """The port's kernels and the latency-floor build, all units compiled in
    parallel."""
    import concurrent.futures

    from admm_elastic_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.library), pool.submit(_build.build, FLOOR_UNITS, FLOOR_DEFINES)]
        for j in jobs:
            j.result()
    secs = time.perf_counter() - t0
    so = _build.build()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if ln.startswith("==") or "registers" in ln or "Compiling entry" in ln
             or ("spill" in ln and "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
                 not in ln)]
    log(f"build {secs:.1f} s -> {so.name} and the latency-floor build")
    for ln in ptxas:
        log(f"  ptxas {ln}")
    return dict(build_s=secs, library=so.name, ptxas=ptxas)


# --- shared scene helpers ----------------------------------------------------------

def beam_mesh(model):
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

    g = golden(beam_golden_name(model))
    return make_tet_blocks(*[int(d) for d in g["dims"]]), g


def beam_kappa(model):
    """The spline stabiliser of a beam family: the bulk modulus where the model
    goes through Solver.add_tet_energies, 0 behind a mesh flag."""
    from admm_elastic_tpu_torch.materials import Lame

    return 0.0 if model in BEAM_FLAGS else Lame.soft_rubber().bulk_modulus()


def beam_batch(torch, dtype, model=NH):
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.system import elements as el

    mesh, _ = beam_mesh(model)
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), model,
                           device=DEVICE, dtype=dtype, kappa=beam_kappa(model),
                           lattice_dims=mesh.lattice_dims)
    return mesh, b


def cloth_batch(torch, dtype, limits=True, vertex_offset=0):
    """The 40x40 sheet as one TriBatch on the card, strain-limited unless told
    otherwise."""
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.system import elements as el

    p = CLOTH_SCENES["cloth_limit40"]
    verts, tris, _, _ = cloth_sheet(p["nx"], p["ny"])
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if limits:
        lame.limit_min, lame.limit_max = p["limits"]
    return verts, el.build_tri_batch(verts, tris, lame, device=DEVICE, dtype=dtype,
                                     vertex_offset=vertex_offset)


def settings_of(g, gravity, direct_mode="inv", dtype=np.float32, **change):
    from admm_elastic_tpu_torch import Settings

    return Settings(verbose=0, admm_iters=int(g["admm_iters"]), linsolver=0, gravity=gravity,
                    timestep_s=float(g["dt"]), dtype=dtype, direct_mode=direct_mode, **change)


def make_solver(model=NH, device=None, pinned=True, name=None):
    """The bench beam with one of the six tet models, through the normal entry
    points, on the card unless a device is named; returns (solver, mesh,
    golden, pins). Without pins (neo-Hookean only, golden FREE_BEAM) the
    float32 system takes one refinement pass per ADMM iteration, which applies
    A through system.A_mv. name: a VARIANT_SCENES entry of the beam (its
    golden and its settings)."""
    from admm_elastic_tpu_torch import Lame, Solver, binding

    mesh, g = beam_mesh(model)
    if not pinned:
        need(model == NH, "the unpinned beam is neo-Hookean")
        g = golden(FREE_BEAM)
    change = {}
    if name is not None:
        need(model == NH and pinned and variant_of(name)[0] == "beam", f"{name}: not the beam")
        g, change = golden(name), variant_of(name)[1]
    solver = Solver(device=device or DEVICE)
    lame = Lame.soft_rubber()
    if model in BEAM_FLAGS:
        mesh.flags = binding.NOSELFCOLLISION | getattr(binding, BEAM_FLAGS[model])
        binding.add_tetmesh(solver, mesh, lame, verbose=False)
    else:
        solver.add_nodes(mesh.vertices, mesh.weighted_masses(binding.RUBBER_DENSITY))
        solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model,
                                kappa=beam_kappa(model), lattice_dims=mesh.lattice_dims)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]] if pinned else []
    need(pins == [int(i) for i in g["pins"]], "pinned set differs from the golden's")
    if pinned:
        solver.set_pins(pins)
    need(solver.initialize(settings_of(g, float(g["gravity"]), **change)), "initialize failed")
    need(solver.system.tets[0].model == model, "the beam got another model")
    need(solver._refine_eff == (0 if pinned else 1), "unexpected refinement passes")
    return solver, mesh, g, pins


def make_cloth_solver(name, device=None):
    """One of CLOTH_SCENES (or a VARIANT_SCENES entry of one) through the
    normal entry points, on the card unless a device is named; returns
    (solver, golden, pins)."""
    import torch

    from admm_elastic_tpu_torch import Lame, Solver
    from admm_elastic_tpu_torch.forces import make_wind_force

    device = device or DEVICE
    base, change, sequential = variant_of(name)
    p, g = CLOTH_SCENES[base], golden(name)
    verts, tris, masses, pin_ids = cloth_sheet(p["nx"], p["ny"])
    pins = [int(i) for i in pin_ids]
    need(pins == [int(i) for i in g["pins"]], "pinned set differs from the golden's")
    solver = Solver(device=device)
    solver.add_nodes(verts, masses)
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if p["limits"] is not None:
        lame.limit_min, lame.limit_max = p["limits"]
    solver.add_tri_energies(verts, tris, lame)
    solver.set_pins(pins)
    if p["wind"] is not None:
        solver.add_explicit_force(make_wind_force(tris, direction=p["wind"],
                                                  colored=not sequential, sequential=sequential,
                                                  device=device, dtype=torch.float32))
    need(solver.initialize(settings_of(g, p["gravity"], **change)), "initialize failed")
    return solver, g, pins


def make_gather_solver(name, device=None):
    """One of GATHER_SCENES through the normal entry points (a mesh file
    through geometry.io.load_elenode and binding.add_tetmesh, a triangle list
    through Solver.add_tri_energies), on the card unless a device is named;
    returns (solver, golden, pins)."""
    import torch

    from admm_elastic_tpu_torch import Lame, Solver, binding
    from admm_elastic_tpu_torch.forces import make_wind_force
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.geometry.io import load_elenode

    p, g = GATHER_SCENES[name], golden(name)
    dtype = p.get("dtype", np.float32)
    solver = Solver(device=device or DEVICE)
    if p["mesh"] == "sheet":
        c = CLOTH_SCENES[p["sheet"]]
        verts, tris, masses, pins, _ = renumbered_sheet(c["nx"], c["ny"])
        solver.add_nodes(verts, masses)
        lame = Lame.from_youngs_poisson(10000000, 0.399)
        if c["limits"] is not None:
            lame.limit_min, lame.limit_max = c["limits"]
        solver.add_tri_energies(verts, tris, lame)
        if c["wind"] is not None:
            solver.add_explicit_force(make_wind_force(
                tris, direction=c["wind"], colored=True, device=solver.device,
                dtype=torch.float64 if dtype == np.float64 else torch.float32))
    else:
        if p["mesh"] == "beam":
            mesh = make_tet_blocks(*[int(d) for d in g["dims"]])
            if not p["lattice"]:
                mesh.lattice_dims = None
            pins = np.where(mesh.vertices[:, 0] < 1e-9)[0]
        else:
            mesh = load_elenode(BUNNY)
            pins = bunny_pins(mesh.vertices)
        mesh.flags = binding.NOSELFCOLLISION | getattr(binding, BEAM_FLAGS[p["model"]])
        binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in pins]
    need(pins == [int(i) for i in g["pins"]], f"{name}: pinned set differs from the golden's")
    solver.set_pins(pins)
    need(solver.initialize(settings_of(g, float(g["gravity"]), p["direct_mode"], dtype)),
         "initialize failed")
    fams = solver.system.tets + solver.system.tris
    need(len(fams) == 1 and (fams[0].stencil is not None) == (p.get("lattice") is True),
         f"{name}: the family took the wrong layout")
    need(solver._solve_data.mode == p["direct_mode"], f"{name}: wrong direct mode")
    return solver, g, pins


def events_ms(torch, fn, reps):
    """Mean ms of fn() over reps launches, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


SLEEP_CYCLES = 100_000_000  # some 60 ms at the card's clock: longer than the host's enqueue


def queued_us(torch, calls, reps):
    """{label: device µs per call} for each (label, fn) of calls, fn()
    launching one kernel (and at most a few small tensor operations before
    it): CUDA events around each call, the calls in turns, reps rounds, all
    queued behind a sleep kernel so that the card runs them back to back and
    no event waits on the host's enqueue. Off the card (a rehearsal) the
    host's clock."""
    for _, fn in calls:
        fn()
    if DEVICE != "cuda":
        out = {}
        for label, fn in calls:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out[label] = (time.perf_counter() - t0) / reps * 1e6
        return out
    torch.cuda.synchronize()
    pairs = {label: [] for label, _ in calls}
    torch.cuda._sleep(SLEEP_CYCLES)
    for _ in range(reps):
        for label, fn in calls:
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            fn()
            stop.record()
            pairs[label].append((start, stop))
    torch.cuda.synchronize()
    return {label: sum(a.elapsed_time(b) for a, b in ev) / len(ev) * 1e3
            for label, ev in pairs.items()}


def stencil_err(torch, got, want):
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    return err, err / scale


def stress_f(rng, t):
    """tests/test_pallas.py's _random_f: near-identity F [t,3,3], every 5th
    inverted, every 7th stretched x3."""
    f = np.eye(3)[None] + 0.4 * rng.standard_normal((t, 3, 3))
    f[::5] *= -1.0
    f[1::7] *= 3.0
    return f


def stress_kappa(b, model):
    """kappa of the stress recipe: k / 1000 for the spline models. The cubic
    compression term is unbounded below, and on the x3-stretched lanes a kappa
    above ~k / 100 outgrows the quadratic and the Newton iterates run away."""
    return 1e-3 * b.bulk if model.startswith("spline") else b.kappa


# --- phase 3: kernels against their plain versions --------------------------------

def tet_errs(torch, got, want, name, label, rerun=None, period=None):
    """Kernel A, D or F against plain (see LANE_TOL). got and want are lists
    of tensors with the lanes on the last axis; rerun(lanes) gives (kernel,
    plain) outputs of those lanes on perturbed inputs. With a period, the
    inputs are one block of `period` lanes tiled, lane l holding the values
    of lane l % period: the lanes over LANE_TOL count (and are rerun) as
    their lane of the block."""
    for g in got:
        need(bool(torch.isfinite(g).all()), f"{label} {name}: non-finite output")
    e = torch.cat([(g - w).abs().reshape(-1, g.shape[-1]) for g, w in zip(got, want)])
    scale = torch.cat([w.abs().reshape(-1, w.shape[-1]) for w in want])
    linear = "[linear]" in label
    which = "stress" if "stress" in label else "main"
    e_np = e.double().cpu().numpy()
    out = dict(max=float(e_np.max()), p99=float(np.quantile(e_np, 0.99)),
               median=float(np.median(e_np)))
    if name == "f64" and which == "main":
        need(bool((e <= F64_TOL + F64_TOL * scale).all()),
             f"{label} f64: {out} exceeds allclose(1e-10)")
        return out
    lane_tol = LANE_TOL[name, "linear" if linear and name == "f32" else which]
    lane_err = e.max(dim=0).values
    over = torch.nonzero(lane_err > lane_tol).flatten()
    if period is not None:
        out["tiled_lanes_over"] = len(over)
        over = torch.unique(over % period)
        lane_err = lane_err.reshape(-1, period).max(dim=0).values
    out.update(lane_tol=lane_tol, lanes_over=over.tolist(),
               max_within=float(lane_err[lane_err <= lane_tol].max()))
    need(len(over) <= MAX_RERUN_LANES, f"{label} {name}: {len(over)} lanes over {lane_tol}: {out}")
    if len(over):
        need(rerun is not None, f"{label} {name}: lanes over {lane_tol}: {out}")
        got2, want2 = rerun(over)
        out["rerun_max"] = max((g - w).abs().max().item() for g, w in zip(got2, want2))
        log(f"{label} {name}: lanes {out['lanes_over']} at "
            f"{[float(lane_err[i]) for i in over]}; perturbed, {out['rerun_max']:.3e}")
        need(out["rerun_max"] <= lane_tol,
             f"{label} {name}: lanes over {lane_tol} stay over it on perturbed inputs: {out}")
    if name == "f64":
        need(out["p99"] < F64_TOL, f"{label} f64: {out}")
    elif linear:
        need(out["p99"] < F32_TOL_DIRECT, f"{label} f32: {out}")
    else:
        need(out["p99"] < A_P99_F32 and out["median"] < A_MEDIAN_F32, f"{label} f32: {out}")
    return out


# The throughput size of kernels D and F: the main-path values of the bench
# beam (7,680 lanes) tiled TILES times, 983,040 lanes, each lane taking the
# Newton trips of its lane of the beam; 71 MB in and out for F, more than the
# 50 MB L2, so that each launch reads cold.
TILES = 128


def prox_call(zi, params, model):
    """Kernel F for the linear model, else kernel D (params: mu, lam, kappa,
    k)."""
    from admm_elastic_tpu_torch.ops import cuda_prox

    if model == "linear":
        return cuda_prox.prox_tet_linear(zi)
    return cuda_prox.prox_tet_hyper(zi, model, *params)


def tiled(x, reps):
    """x repeated reps times along its first (lane) axis."""
    return x.repeat((reps,) + (1,) * (x.dim() - 1)).contiguous()


def tiled_prox_check(torch, model, zi, params, jitter):
    """Kernel D or F at the throughput size (zi and params tiled TILES
    times), float32: against plain (tet_errs, with the beam's lanes as the
    period) and bit for bit against kernel A's rows entry."""
    from admm_elastic_tpu_torch.ops.hyper_soa import prox_plain

    zt, pt = tiled(zi, TILES), tuple(tiled(p, TILES) for p in params)
    label = f"{'F' if model == 'linear' else 'D'}[{model}] main-path x{TILES} f32"
    k_out = prox_call(zt, pt, model)
    bits = rows_entry_bits(torch, k_out, zt, pt, model, label)

    def rerun(lanes):
        zj, pj = jitter(zi[lanes]), tuple(p[lanes] for p in params)
        return ([prox_call(zj, pj, model).reshape(-1, 9).T],
                [prox_plain(zj, model, *pj).reshape(-1, 9).T])

    res = tet_errs(torch, [k_out.reshape(-1, 9).T], [prox_plain(zt, model, *pt).reshape(-1, 9).T],
                   "f32", label, rerun=rerun, period=zi.shape[0])
    return dict(res, lanes=zt.shape[0], rows_entry=bits)


def rows_entry_bits(torch, z33, zi, params, model, label):
    """Kernel D or F's z against kernel A's rows entry on the same values as
    rows [9, T] with u = 0, bit for bit: both run lane_prox of
    csrc/prox_body.cuh. The one difference allowed is the sign of a zero:
    the rows entry's v = D x + u turns an input -0 into +0, which may reach
    z as a zero of the other sign. Such lanes are named; any other
    difference fails."""
    from admm_elastic_tpu_torch.ops import cuda_local_step

    rows = zi.reshape(-1, 9).T.contiguous()
    za = cuda_local_step.local_step_tet_hyper(rows, torch.zeros_like(rows), *params,
                                              model=model)[0]
    zd = z33.reshape(-1, 9).T
    bits = torch.int32 if zd.dtype == torch.float32 else torch.int64
    lanes = torch.nonzero((zd.view(bits) != za.view(bits)).any(dim=0)).flatten()
    out = dict(bitwise=len(lanes) == 0, lanes_differ=len(lanes))
    if len(lanes):
        need(bool(torch.equal(zd[:, lanes], za[:, lanes])),
             f"{label}: z differs from kernel A's rows entry on the same values "
             f"(lanes {lanes[:8].tolist()})")
        negzero = bool((torch.signbit(rows[:, lanes]) & (rows[:, lanes] == 0)).any(dim=0).all())
        need(negzero, f"{label}: signed zeros in z off kernel A's rows entry without a -0 in")
        out["signed_zero_lanes"] = lanes[:8].tolist()
        log(f"{label}: z bitwise equal to kernel A's rows entry (u = 0) but for the sign of "
            f"a zero on {len(lanes)} lanes ({lanes[:8].tolist()}): an input -0 the rows entry "
            "adds to u = 0 as +0")
    return out


def direct_errs(torch, got, want, name, label):
    """Kernel E (no iteration) against plain: absolute."""
    worst = 0.0
    for g, w in zip(got, want):
        need(bool(torch.isfinite(g).all()), f"{label} {name}: non-finite output")
        worst = max(worst, (g - w).abs().max().item())
    tol = F64_TOL if name == "f64" else F32_TOL_DIRECT
    need(worst <= tol, f"{label} {name}: max abs err {worst:.3e} > {tol}")
    return dict(max=worst)


WIDE_DIMS = (2, 40, 40)  # cells: a halo of 41 * 41 + 41 + 1 columns fits no tile


def wide_rhs_check(torch, dtype, name, tol):
    """Kernel C on a lattice whose halo forces the wide branch, at a vertex
    offset and with vertices past the family's block, against plain. Its
    inputs come from a generator of their own: the stream behind the other
    checks' inputs stays as it is."""
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.ops import cuda_stencil
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.system import elements as el

    mesh = make_tet_blocks(*WIDE_DIMS)
    off = 5
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), NH, device=DEVICE,
                           dtype=dtype, vertex_offset=off, lattice_dims=mesh.lattice_dims)
    n = off + len(mesh.vertices) + 3
    rng = np.random.default_rng(2)
    z, u = (torch.as_tensor(rng.standard_normal((9, b.n)), device=DEVICE, dtype=dtype)
            for _ in range(2))
    plan = cuda_stencil.rhs_plan_of(b, z.element_size())
    need(plan[0] == "wide", f"C {name}: {WIDE_DIMS} cells planned as {plan}")
    try:
        cuda_stencil.tet_rhs_rows(z, u, b, n, branch="tiled")
    except ValueError:
        pass
    else:
        raise SmokeFailure(f"C {name}: the tiled branch took a halo that does not fit")
    c1 = cuda_stencil.tet_rhs_rows(z, u, b, n)
    need(bool(torch.isfinite(c1).all()), f"C {name} wide shape: non-finite output")
    need(bool(torch.equal(c1, cuda_stencil.tet_rhs_rows(z, u, b, n))),
         f"C {name} wide shape: two runs differ")
    err, rel = stencil_err(torch, c1, st.tet_rhs_rows_plain(z, u, b, n))
    need(rel <= tol, f"C {name} wide shape: rel err {rel:.3e} > {tol}")
    return dict(cells=list(WIDE_DIMS), n_verts=n, plan=list(plan), max_abs_err=err, rel_err=rel)


def kernel_checks(torch):
    from admm_elastic_tpu_torch.ops import (cuda_local_step, cuda_prox, cuda_stencil,
                                            cuda_tri_local_step)
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, prox_plain
    from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

    rng = np.random.default_rng(0)
    res = {}
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE, dtype=dtype)

        out = res[name] = {}
        mesh, b = beam_batch(torch, dtype)
        n = mesh.vertices.shape[0]
        t = b.n
        x = dev(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape))

        # B: D x
        got = cuda_stencil.tet_Dx_rows(x, b)
        want = st.tet_Dx_rows_plain(x, b)
        need(bool(torch.isfinite(got).all()), f"B {name}: non-finite output")
        eb, rb = stencil_err(torch, got, want)
        tol = F64_TOL if name == "f64" else F32_TOL_STENCIL
        need(rb <= tol, f"B {name}: rel err {rb:.3e} > {tol}")
        need(bool(torch.equal(got, want)), f"B {name}: not exact against plain")
        out["tet_Dx_rows"] = dict(max_abs_err=eb, rel_err=rb, exact=True)

        # C: D^T W^2 (z - u). Both branches against plain, each twice bitwise
        # equal, bitwise equal to each other and to the wrapper's own choice.
        z, uu = dev(rng.standard_normal((9, t))), dev(rng.standard_normal((9, t)))
        cp = st.tet_rhs_rows_plain(z, uu, b, n)
        c_out, ec, rc = {}, 0.0, 0.0
        for branch in ("tiled", "wide"):
            c1 = cuda_stencil.tet_rhs_rows(z, uu, b, n, branch=branch)
            c2 = cuda_stencil.tet_rhs_rows(z, uu, b, n, branch=branch)
            need(bool(torch.isfinite(c1).all()), f"C {name} {branch}: non-finite output")
            need(bool(torch.equal(c1, c2)), f"C {name} {branch}: two runs differ")
            e1, r1 = stencil_err(torch, c1, cp)
            need(r1 <= tol, f"C {name} {branch}: rel err {r1:.3e} > {tol}")
            c_out[branch], ec, rc = c1, max(ec, e1), max(rc, r1)
        need(bool(torch.equal(c_out["tiled"], c_out["wide"])), f"C {name}: the branches differ")
        plan = cuda_stencil.rhs_plan_of(b, z.element_size())
        need(plan[0] == "tiled" and bool(torch.equal(
            cuda_stencil.tet_rhs_rows(z, uu, b, n), c_out["tiled"])),
            f"C {name}: the wrapper chose {plan} at the bench shape")
        out["tet_rhs_rows"] = dict(max_abs_err=ec, rel_err=rc, bitwise_repeat=True,
                                   branches_bitwise_equal=True, plan=list(plan),
                                   wide_shape=wide_rhs_check(torch, dtype, name, tol))

        # A, D and F at 7,680 lanes, per model: main-path inputs (D x of a
        # perturbed beam, small u) and the stress recipe.
        u = dev(0.05 * rng.standard_normal((9, t)))
        f_np = stress_f(rng, t)
        f_rows, f_33 = dev(f_np.reshape(t, 9).T), dev(f_np)
        dix_33 = got.T.reshape(t, 3, 3).contiguous()
        def jitter(f):
            return f * dev(1.0 + 1e-5 * rng.standard_normal(tuple(f.shape)))

        for model in TET_MODELS:
            _, bm = beam_batch(torch, dtype, model)

            def rows_pair(args, model=model):
                return (cuda_local_step.local_step_tet_hyper(*args, model=model),
                        local_step_plain(*args, model=model))

            def rows_rerun(args):
                return lambda lanes: rows_pair(
                    (jitter(args[0][:, lanes]), args[1][:, lanes]) + tuple(
                        a[lanes] for a in args[2:]))

            def prox_pair(zi, params, model=model):
                k_out = prox_call(zi, params, model)
                need(k_out.shape == zi.shape, "D / F: wrong output shape")
                return ([k_out.reshape(-1, 9).T],
                        [prox_plain(zi, model, *params).reshape(-1, 9).T])

            def prox_rerun(zi, params):
                return lambda lanes: prox_pair(jitter(zi[lanes]),
                                               tuple(a[lanes] for a in params))

            main = (got, u, bm.mu, bm.lam, bm.kappa, bm.bulk)
            stress = (f_rows, torch.zeros_like(f_rows), bm.mu, bm.lam, stress_kappa(bm, model),
                      bm.bulk)
            # A lane count that does not fill its last block; and D / F on a
            # tensor that starts 3 lanes into its storage.
            ragged = tuple(a[..., :t - 3].contiguous() for a in main)
            a, d = {}, {}
            for which, args, zi in (("main", main, dix_33), ("stress", stress, f_33),
                                    ("ragged main", ragged, dix_33[:t - 3].contiguous()),
                                    ("unaligned main", tuple(x[..., 3:].contiguous()
                                                             for x in main), dix_33[3:])):
                if which != "unaligned main":
                    a[which] = tet_errs(torch, *rows_pair(args), name,
                                        f"A[{model}] {which}-path", rerun=rows_rerun(args))
                label = f"{'F' if model == 'linear' else 'D'}[{model}] {which}-path {name}"
                got_d, want_d = prox_pair(zi, args[2:])
                d[which] = tet_errs(torch, got_d, want_d, name, label,
                                    rerun=prox_rerun(zi, args[2:]))
                d[which]["rows_entry"] = rows_entry_bits(
                    torch, got_d[0].T.reshape(zi.shape), zi, args[2:], model, label)
            if name == "f32":
                d[f"{TILES * t} lanes"] = tiled_prox_check(torch, model, dix_33, main[2:], jitter)
            out[f"local_step_tet_hyper[{model}]"] = dict(
                a, max_abs_err=max(a[w]["max"] for w in a))
            key = "prox_tet_linear" if model == "linear" else f"prox_tet_hyper[{model}]"
            out[key] = dict(d, max_abs_err=max(v["max"] for v in d.values()))

        # E at 3,362 lanes: D x of a perturbed limited sheet with a small u,
        # then a stress recipe (0.3 noise on the identity, limits on about
        # half the lanes, the rest state / a collapsed column / a zero F /
        # equal column norms with a cross term in lanes 0-3); twice bitwise.
        verts, tb = cloth_batch(torch, dtype)
        tt = tb.n
        xs = dev(verts + 0.02 * rng.standard_normal(verts.shape))
        main = (st.tri_Dx_rows(xs, tb), dev(0.02 * rng.standard_normal((6, tt))),
                tb.limit_min, tb.limit_max)
        ident = np.asarray([1.0, 0.0, 0.0, 1.0, 0.0, 0.0])
        rows = rng.standard_normal((6, tt)) * 0.3 + ident[:, None]
        rows[:, :4] = np.array([[1.0, 0.0, 0.0, 1.0, 0.0, 0.0], [1.2, 0.0, 0.3, 0.0, -0.1, 0.0],
                                [0.0] * 6, [1.0, 0.5, 0.5, 1.0, 0.0, 0.0]]).T
        us = 0.05 * rng.standard_normal((6, tt))
        us[:, :4] = 0.0
        lm = np.where(rng.random(tt) < 0.5, 0.95, -100.0)
        stress = (dev(rows), dev(us), dev(lm), dev(np.where(lm > 0, 1.05, 100.0)))
        e = {}
        for which, args in (("main", main), ("stress", stress)):
            k1 = cuda_tri_local_step.local_step_tri(*args)
            k2 = cuda_tri_local_step.local_step_tri(*args)
            need(all(bool(torch.equal(p, q)) for p, q in zip(k1, k2)),
                 f"E {name} {which}: two runs differ")
            e[which] = direct_errs(torch, k1, local_step_tri_plain(*args), name,
                                   f"E {which}-path")
        out["local_step_tri"] = dict(e, bitwise_repeat=True,
                                     max_abs_err=max(e["main"]["max"], e["stress"]["max"]))
        log(f"kernels {name} " + json.dumps(
            {k: v["max_abs_err"] for k, v in out.items()}))
    return res

STRESS_X_NOISE = 0.3  # of the lattice pitch: F = I + ~0.4 N(0, 1), some tets inverted


def stencil_entry_checks(torch, res):
    """The stencil entries of kernels A and E (each lane computes its own D x)
    at the shapes of the paths, float64 and float32, from a generator of their
    own: bitwise equal to the two-launch route (kernel B, or tri_Dx_rows, then
    the rows entry), twice bitwise, and against the plain composition under
    the bounds the rows entries have (see LANE_TOL; a lane over its bound is
    rerun through the rows entry, whose bits the stencil entry's are). Inputs:
    the perturbed beam with a small u ("main") and the beam perturbed by
    STRESS_X_NOISE of its pitch ("stress", kappa as stress_kappa); the 40x40
    sheet with and without limits, and the same sheet as the second family of
    a system of two, at a vertex offset."""
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil, cuda_tri_local_step
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
    from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

    rng = np.random.default_rng(3)
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE, dtype=dtype)

        out = res[name]
        mesh, _ = beam_mesh(NH)
        noise = rng.standard_normal(mesh.vertices.shape)
        xs = {"main": dev(mesh.vertices + 0.05 * noise),
              "stress": dev(mesh.vertices + STRESS_X_NOISE * noise)}
        _, b0 = beam_batch(torch, dtype)
        dixs = {which: cuda_stencil.tet_Dx_rows(x, b0) for which, x in xs.items()}
        for which, x in xs.items():
            need(bool(torch.equal(dixs[which], st.tet_Dx_rows_plain(x, b0))),
                 f"B {name} {which}-path: not exact against plain")
        for model in TET_MODELS:
            _, bm = beam_batch(torch, dtype, model)
            u = {"main": dev(0.05 * rng.standard_normal((9, bm.n))),
                 "stress": torch.zeros((9, bm.n), device=DEVICE, dtype=dtype)}
            e = {}
            for which, x in xs.items():
                b = bm if which == "main" else dataclasses.replace(
                    bm, kappa=stress_kappa(bm, model))
                label = f"A[{model}] stencil entry {which}-path"
                dix = dixs[which]
                params = (b.mu, b.lam, b.kappa, b.bulk)
                k1 = cuda_local_step.local_step_tet_stencil(x, u[which], b)
                k2 = cuda_local_step.local_step_tet_stencil(x, u[which], b)
                two = cuda_local_step.local_step_tet_hyper(dix, u[which], *params, model=model)
                for a, b2, c in zip(k1, k2, two):
                    need(bool(torch.equal(a, b2)), f"{label} {name}: two runs differ")
                    need(bool(torch.equal(a, c)),
                         f"{label} {name}: differs from B followed by the rows entry")

                def rerun(lanes, dix=dix, uu=u[which], params=params, model=model):
                    args = (dix[:, lanes] * dev(1.0 + 1e-5 * rng.standard_normal(
                        (9, len(lanes)))), uu[:, lanes]) + tuple(a[lanes] for a in params)
                    return (cuda_local_step.local_step_tet_hyper(*args, model=model),
                            local_step_plain(*args, model=model))

                e[which] = tet_errs(torch, k1, local_step_plain(dix, u[which], *params,
                                                                 model=model),
                                    name, label, rerun=rerun)
            out[f"local_step_tet_stencil[{model}]"] = dict(
                e, bitwise_two_launch=True, bitwise_repeat=True,
                max_abs_err=max(v["max"] for v in e.values()))

        # Sheets: one family at base 0 with and without limits, then two
        # families in one x, the second at a vertex offset.
        verts, _ = cloth_batch(torch, dtype)
        nv = len(verts)
        x2 = dev(np.concatenate([verts, verts + np.array([45.0, 0.0, 0.0])])
                 + 0.02 * rng.standard_normal((2 * nv, 3)))
        e = {}
        for label, limits, off in (("limits", True, 0), ("free", False, 0),
                                   ("second sheet", True, nv)):
            _, tb = cloth_batch(torch, dtype, limits=limits, vertex_offset=off)
            need(tb.stencil[0] == off, "the sheet's base is not its vertex offset")
            x = x2 if off else x2[:nv].contiguous()
            u = dev(0.02 * rng.standard_normal((6, tb.n)))
            dix = st.tri_Dx_rows(x, tb)
            k1 = cuda_tri_local_step.local_step_tri_stencil(x, u, tb)
            k2 = cuda_tri_local_step.local_step_tri_stencil(x, u, tb)
            two = cuda_tri_local_step.local_step_tri(dix, u, tb.limit_min, tb.limit_max)
            for a, b2, c in zip(k1, k2, two):
                need(bool(torch.equal(a, b2)), f"E stencil entry {label} {name}: two runs differ")
                need(bool(torch.equal(a, c)), f"E stencil entry {label} {name}: differs from "
                                              "tri_Dx_rows followed by the rows entry")
            e[label] = direct_errs(torch, k1, local_step_tri_plain(
                dix, u, tb.limit_min, tb.limit_max), name, f"E stencil entry {label}")
        out["local_step_tri_stencil"] = dict(e, bitwise_two_launch=True, bitwise_repeat=True,
                                             max_abs_err=max(v["max"] for v in e.values()))
        log(f"stencil entries {name} " + json.dumps(
            {k: v["max_abs_err"] for k, v in out.items() if "stencil" in k}))
    return res


def gather_batches(torch, dtype):
    """The gather families of GATHER_SCENES on the card, built as the paths
    build them: scene -> (rest vertices, batch with its gather table, the
    noise scale of a perturbed pose, a twentieth of the mean edge)."""
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.geometry.io import load_elenode
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.ops import reduction as red
    from admm_elastic_tpu_torch.system import elements as el

    out = {}
    for scene, p in GATHER_SCENES.items():
        if p.get("lattice") or "dtype" in p:  # a float64 bunny: the float32 one's shapes
            continue
        if p["mesh"] == "sheet":
            c = CLOTH_SCENES[p["sheet"]]
            verts, elems, _, _, _ = renumbered_sheet(c["nx"], c["ny"])
            lame = Lame.from_youngs_poisson(10000000, 0.399)
            if c["limits"] is not None:
                lame.limit_min, lame.limit_max = c["limits"]
            b = el.build_tri_batch(verts, elems, lame, device=DEVICE, dtype=dtype)
        else:
            mesh = make_tet_blocks(40, 5, 5) if p["mesh"] == "beam" else load_elenode(BUNNY)
            verts, elems = mesh.vertices, mesh.tets
            b = el.build_tet_batch(verts, elems, Lame.soft_rubber(), p["model"], device=DEVICE,
                                   dtype=dtype)
        need(b.stencil is None, f"{scene}: not a gather family")
        table = red.build_gather_table(b.inds.cpu().numpy(), len(verts))
        b = dataclasses.replace(b, gather_idx=torch.as_tensor(table, device=DEVICE))
        edge = np.linalg.norm(verts[elems[:, 1]] - verts[elems[:, 0]], axis=1).mean()
        out[scene] = (verts, b, 0.05 * edge)
    return out


def gather_key(scene, b):
    """The name of the rows entry that a gather scene's steps launch."""
    if GATHER_SCENES[scene]["mesh"] == "sheet":
        return "local_step_tri"
    return f"local_step_tet_hyper[{b.model}]"


def gather_entry_checks(torch, res):
    """Kernel A's rows entry (neo-Hookean on the beam and the bunny, linear on
    the bunny) and E's (the renumbered sheet) at the shapes of the gather
    paths, float64 and float32, on D x gathered from a perturbed rest pose
    with a small u, against their plain versions (bounds of tet_errs and
    direct_errs), from a generator of their own."""
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_tri_local_step
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain
    from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

    rng = np.random.default_rng(4)
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE, dtype=dtype)

        out = res[name]
        for scene, (verts, b, noise) in gather_batches(torch, dtype).items():
            x = dev(verts + noise * rng.standard_normal(verts.shape))
            dix = b.Dx_rows(x)
            key = gather_key(scene, b)
            if key == "local_step_tri":
                u = dev(0.02 * rng.standard_normal((6, b.n)))
                args = (dix, u, b.limit_min, b.limit_max)
                e = direct_errs(torch, cuda_tri_local_step.local_step_tri(*args),
                                local_step_tri_plain(*args), name, f"E@{scene}")
                out[f"{key}@{scene}"] = dict(e, max_abs_err=e["max"])
                continue
            u = dev(0.05 * rng.standard_normal((9, b.n)))
            args = (dix, u, b.mu, b.lam, b.kappa, b.bulk)

            def rerun(lanes, args=args, model=b.model):
                a = (args[0][:, lanes] * dev(1.0 + 1e-5 * rng.standard_normal(
                    (9, len(lanes)))), args[1][:, lanes]) + tuple(t[lanes] for t in args[2:])
                return (cuda_local_step.local_step_tet_hyper(*a, model=model),
                        local_step_plain(*a, model=model))

            e = tet_errs(torch, cuda_local_step.local_step_tet_hyper(*args, model=b.model),
                         local_step_plain(*args, model=b.model), name,
                         f"A[{b.model}]@{scene} main-path", rerun=rerun)
            out[f"{key}@{scene}"] = dict(e, max_abs_err=e["max"])
        log(f"gather rows entries {name} " + json.dumps(
            {k: v["max_abs_err"] for k, v in out.items() if "@" in k}))
    return res


# --- phase 4: the paths ------------------------------------------------------------------

# --- phase 3, continued: the ring stencil and kernel G ------------------------------

# The ring lattices of the ring checks: the torus_pcg20k path's (64 x 8 x 8
# cells, 5,184 of them, no multiple of 128) at vertex offset 0, and crossval's
# 12 x 4 torus at vertex offset 7 with 3 vertices past its block.
RING_CASES = {"torus_pcg20k": ((64, 8), 0, 0), "torus12x4": ((12, 4), 7, 3)}
# Kernel G against the plain solve_T on the same b and x0 (the first global
# solve of a step from the initial state), on max |x_G - x_plain| / max |x_plain|:
# float64 within PCG_F64_TOL and in the same trips; float32 within PCG_F32_TOL
# and the trips within PCG_F32_TRIPS of the plain version's (the two differ in
# the order of every dot product, which float32 CG amplifies; readings in
# PERF.md §6).
# Readings on an NVIDIA H100 (PERF.md §6): float64 at most 5.7e-15 in equal
# trips, float32 at most 2.5e-6 in equal trips, on every scene and form but
# the bunny.
PCG_F64_TOL = 1e-10
PCG_F32_TOL = 1e-4
PCG_F32_TRIPS = 0.1  # a fraction of the plain version's trips, at least 2
# The pin-stiffened bunny (diagonal ratios of ~1e5) carries the two sum orders
# further, as benchmarks/crossval.py:277-287 found between two backends:
# float64 7.07e-9 in 143 trips, equal, and in the RCM order (spmv_format
# "bands") 1.34e-7 in 141 trips against 143; float32 5.9e-4 (1.2e-3 in the
# RCM order) in 67 trips, equal (on the H100, PERF.md §6). There x is
# held to the bounds below, the float64 trips within PCG_F32_TRIPS too, and in
# float64 both x to the solve's own criterion: a true residual
# |b - A x| / |b| within twice the tolerance.
PCG_F64_TOL_BUNNY = 1e-6
PCG_F32_TOL_BUNNY = 1e-2


def ring_batch(torch, dtype, ring, off):
    from admm_elastic_tpu_torch.geometry.factory import make_tet_torus
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.system import elements as el

    mesh = make_tet_torus(n_ring=ring[0], n_sec=ring[1])
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), NH, device=DEVICE,
                           dtype=dtype, vertex_offset=off, lattice_dims=mesh.lattice_dims,
                           lattice_wrap=mesh.lattice_wrap)
    need(b.stencil is not None and b.stencil[6], f"torus {ring}: no ring stencil")
    return mesh, b


def seam_lanes(mesh, b):
    """The flat lanes of the live tets whose corners lie on both sides of the
    ring's seam (tests/test_stencil.py:144-146): their corner reads wrap."""
    from admm_elastic_tpu_torch.ops import stencil as st

    _, X, Y, Z, _, _, _ = b.stencil
    ii = np.asarray(mesh.tets) // (Y * Z)
    crossing = np.nonzero(ii.max(axis=1) - ii.min(axis=1) > 1)[0]
    src = st.tet_flat_plan(b.stencil).src
    return np.nonzero(np.isin(src, crossing))[0]


def ring_checks(torch, res):
    """Kernels A (stencil entry), B and C on ring lattices (RING_CASES), float64
    and float32, from a generator of their own: B exactly equal to its plain
    version, C's tiled and wide branches each exactly equal to it and bitwise
    equal to each other, A's stencil entry bitwise equal to the two-launch
    route (B, then the rows entry), each twice bitwise; the live lanes whose
    corner reads cross the seam, and the vertices of the first ring segment
    (the head where C folds the wrapped contributions), are counted and held
    on their own; dead lanes stay finite."""
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain

    rng = np.random.default_rng(7)
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE, dtype=dtype)

        for label, (ring, off, extra) in RING_CASES.items():
            mesh, b = ring_batch(torch, dtype, ring, off)
            nv = len(mesh.vertices)
            n = off + nv + extra
            verts = np.concatenate([np.zeros((off, 3)), mesh.vertices, np.zeros((extra, 3))])
            # main-path inputs as the beam's: x off its rest pose by 5 % of the
            # cross-section's pitch (2 x 0.35 / n_sec), u by 0.05
            pitch = 0.7 / ring[1]
            x = dev(verts + 0.05 * pitch * rng.standard_normal(verts.shape))
            u = dev(0.05 * rng.standard_normal((9, b.n)))
            lanes = seam_lanes(mesh, b)
            need(len(lanes) > 0, f"ring {label}: no live lane crosses the seam")
            lanes_t = torch.as_tensor(lanes, device=DEVICE)
            # B
            dx = cuda_stencil.tet_Dx_rows(x, b)
            need(bool(torch.equal(dx, cuda_stencil.tet_Dx_rows(x, b))),
                 f"B ring {label} {name}: two runs differ")
            want = st.tet_Dx_rows_plain(x, b)
            need(bool(torch.equal(dx, want)), f"B ring {label} {name}: not exact against plain")
            need(bool(torch.equal(dx[:, lanes_t], want[:, lanes_t])),
                 f"B ring {label} {name}: the seam lanes differ")
            # C, both branches
            z = dev(rng.standard_normal((9, b.n)))
            want_c = st.tet_rhs_rows_plain(z, u, b, n)
            got_c = {}
            for branch in ("tiled", "wide"):
                got_c[branch] = cuda_stencil.tet_rhs_rows(z, u, b, n, branch=branch)
                need(bool(torch.equal(got_c[branch],
                                      cuda_stencil.tet_rhs_rows(z, u, b, n, branch=branch))),
                     f"C {branch} ring {label} {name}: two runs differ")
                need(bool(torch.equal(got_c[branch], want_c)),
                     f"C {branch} ring {label} {name}: not exact against plain")
            head = max(cuda_stencil.geom_of(b.stencil)[3], 1)
            need(bool(torch.equal(got_c["tiled"], got_c["wide"])),
                 f"C ring {label} {name}: the branches differ")
            need(bool(torch.equal(got_c["tiled"][off:off + head], want_c[off:off + head])),
                 f"C ring {label} {name}: the folded head differs")
            # A's stencil entry against B followed by the rows entry
            k1 = cuda_local_step.local_step_tet_stencil(x, u, b)
            k2 = cuda_local_step.local_step_tet_stencil(x, u, b)
            two = cuda_local_step.local_step_tet_hyper(dx, u, b.mu, b.lam, b.kappa, b.bulk,
                                                       model=NH)
            for a, a2, c in zip(k1, k2, two):
                need(bool(torch.isfinite(a).all()), f"A ring {label} {name}: non-finite lanes")
                need(bool(torch.equal(a, a2)), f"A ring {label} {name}: two runs differ")
                need(bool(torch.equal(a, c)),
                     f"A ring {label} {name}: differs from B followed by the rows entry")
            params = (b.mu, b.lam, b.kappa, b.bulk)

            def rerun(lanes, dx=dx, u=u, params=params):
                args = (dx[:, lanes] * dev(1.0 + 1e-5 * rng.standard_normal((9, len(lanes)))),
                        u[:, lanes]) + tuple(a[lanes] for a in params)
                return (cuda_local_step.local_step_tet_hyper(*args, model=NH),
                        local_step_plain(*args, model=NH))

            # The square-to-disk map distorts the torus's cells, so its lanes
            # are held to the stress recipe's per-lane bound (LANE_TOL): one
            # float32 lane of torus_pcg20k reads 2.0e-3 against plain, 1.3e-2 on
            # perturbed inputs (on an H100, PERF.md §6), a line-search flip.
            ea = tet_errs(torch, k1, local_step_plain(dx, u, *params, model=NH), name,
                          f"A[{NH}] ring stencil entry {label} stress", rerun=rerun)
            key = f"@{label}" if label in PCG_PATHS else f" {label}"
            res[name][f"tet_Dx_rows{key}"] = dict(max_abs_err=0.0, exact=True,
                                                   seam_lanes=len(lanes))
            res[name][f"tet_rhs_rows{key}"] = dict(max_abs_err=0.0, exact=True,
                                                    branches_bitwise=True, head_vertices=head)
            res[name][f"local_step_tet_stencil[{NH}]{key}"] = dict(
                ea, bitwise_two_launch=True, bitwise_repeat=True, seam_lanes=len(lanes),
                max_abs_err=ea["max"])
            log(f"ring {label} {name}: B and C (tiled, wide) exact, A's stencil entry bitwise "
                f"to the two-launch route, max {ea['max']:.3e} against plain; {len(lanes)} "
                f"seam lanes, {head} head vertices")
    return res


def first_solve(torch, solver):
    """(b, x0) of the first global solve of the solver's next step, formed as
    Solver._step_core forms them (no explicit force on these scenes)."""
    from admm_elastic_tpu_torch.system import system as sysm

    system, s = solver.system, solver.m_settings
    state = solver.state
    need(not solver.ext_forces, "first_solve: a scene with an explicit force")
    v = state.v.clone()
    v[:, 1] += solver._kick()
    x_bar = state.x + system.dt * v
    z = sysm.zeros_like_Dx(system, x_bar.dtype, x_bar.device)
    u = [torch.zeros_like(zi) for zi in z]
    z, u = sysm.local_step(system, x_bar, z, u, s.prox_newton_iters)
    return sysm.rhs(system, system.masses[:, None] * x_bar, z, u), x_bar


def pcg_bytes_ops(data, trips):
    """The bytes a solve of kernel G must move and the operations it must do,
    for `trips` trips: per trip the bands, the rest-ELL, the diagonal and its
    inverse read once, and the [N, 3] vectors each phase reads and writes (A p,
    its dot; x, r, z and their dots; p), each once; the two-grid V-cycle adds
    two more applies, P^T, the coarse matrix and its vector, and z's two
    updates. Setup: b, x0, one apply and x written back."""
    n = data.n
    isz = data.diag_mass.element_size()
    nb = len(data.band_offsets)
    kr = data.ell_cols.shape[1]
    mat_bytes = nb * n * isz + n * kr * (isz + 4) + 2 * n * isz
    mat_ops = 2 * 3 * n * (nb + kr + 1)  # a multiply and an add per entry and component
    vec = 3 * n * isz
    trip_bytes = mat_bytes + 12 * vec
    trip_ops = mat_ops + 3 * n * (2 + 4 + 2 + 2 + 2)  # dot, x, r, z, dots, p
    if data.agg is not None:
        c = data.coarse_inv.shape[0]
        trip_bytes += 2 * mat_bytes + 9 * vec + c * c * isz + 2 * 3 * c * isz + n * 4 \
            + data.agg_gather.numel() * 4
        trip_ops += 2 * mat_ops + 3 * n * 6 + 2 * 3 * c * c + 3 * n
    setup_bytes = mat_bytes + 4 * vec
    return setup_bytes + trips * trip_bytes, mat_ops + trips * trip_ops


def pcg_scenes_bytes_ops(data, trips, penalty=False):
    """The bytes and operations of kernel G's scene form: S solves on one
    shared operator, scene i for trips[i] trips. The shared operator (the
    bands, the rest-ELL and diag_mass) is read once at setup and once per
    trip of the longest-running scene: the scenes may walk it together. Per
    scene, per trip of its own: its scaled diagonal and Jacobi inverse, the
    [N, 3] vectors as pcg_bytes_ops counts them and, in the penalty form, its
    rows pn and pen_diag [N, 3]; at setup b, x0, one apply and x written
    back, with its diagonal. Operations as pcg_bytes_ops counts them, per
    scene for its own trips, and in the penalty form pn (pn . p) per trip."""
    n = data.n
    isz = data.diag_mass.element_size()
    nb = len(data.band_offsets)
    kr = data.ell_cols.shape[1]
    shared = nb * n * isz + n * kr * (isz + 4) + n * isz
    vec = 3 * n * isz
    diag = 2 * n * isz
    trip_bytes = diag + 12 * vec + (2 * vec if penalty else 0)
    mat_ops = 2 * 3 * n * (nb + kr + 1)
    trip_ops = mat_ops + 3 * n * (2 + 4 + 2 + 2 + 2) + (3 * n * 4 if penalty else 0)
    trips = [int(k) for k in trips]
    n_bytes = shared * (1 + max(trips)) + sum(diag + 4 * vec + k * trip_bytes for k in trips)
    ops = sum(mat_ops + k * trip_ops for k in trips)
    return n_bytes, ops


def csr_of(torch, solver, dtype):
    """A (single component: the diagonal and every off-diagonal entry) as a
    CSR tensor on the card: the yardstick of a library SpMV."""
    from admm_elastic_tpu_torch.system import assembly

    cols, vals, diag = assembly.assemble_ell(solver.system, dtype=np.float64)
    n, k = cols.shape
    rows = np.repeat(np.arange(n), k)
    keep = vals.reshape(-1) != 0.0
    r = np.concatenate([rows[keep], np.arange(n)])
    c = np.concatenate([cols.reshape(-1)[keep].astype(np.int64), np.arange(n)])
    v = np.concatenate([vals.reshape(-1)[keep], diag])
    order = np.lexsort((c, r))
    crow = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=crow[1:])
    return torch.sparse_csr_tensor(torch.as_tensor(crow), torch.as_tensor(c[order]),
                                   torch.as_tensor(v[order]), size=(n, n)).to(DEVICE, dtype)


def g_forms(data, dtype):
    """The forms of kernel G that take data's system in dtype on this card:
    the GRID form always, the CLUSTER form where it fits (cuda_pcg.g_form).
    Off the card (a rehearsal) the wrappers' plain versions: "plain"."""
    from admm_elastic_tpu_torch.ops import cuda_pcg

    if DEVICE != "cuda":
        return ["plain"]
    forms = ["grid"]
    try:
        cuda_pcg.form_of(data, dtype, "cluster")
        forms.append("cluster")
    except ValueError:
        pass
    return forms


def g_blocks(data, dtype, form=None):
    """(form, blocks, threads a block) of kernel G (cuda_pcg.blocks_of);
    ("plain", 0, 0) off the card."""
    from admm_elastic_tpu_torch.ops import cuda_pcg

    return cuda_pcg.blocks_of(data, dtype, form) if DEVICE == "cuda" else ("plain", 0, 0)


def capture_bitwise(torch, label, fn, want, k_want):
    """fn(t) (a kernel launch that adds its iterations to the int32 counter
    t) captured into a CUDA graph and replayed: its output bitwise want, its
    iterations k_want."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
    with torch.cuda.stream(side):
        fn(t)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            t.zero_()
            xc = fn(t)
    except Exception as e:
        raise SmokeFailure(f"{label}: capturing it into a CUDA graph failed: {e}")
    g.replay()
    torch.cuda.synchronize()
    need(bool(torch.equal(xc, want)) and int(t.item()) == k_want,
         f"{label}: the graph replay differs from the eager launch")


def g_against_plain(torch, label, data, b, x0, tol, max_iters, dtype_name, graph=False):
    """Kernel G against the plain solve_T on the same inputs (see PCG_F64_TOL,
    PCG_F32_TOL), G twice bitwise; every other form that takes the shape
    (g_forms) bitwise equal to the form the wrapper chooses, in as many
    trips; with graph, each form captured into a CUDA graph and replayed,
    bitwise equal to its eager launch."""
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    trips = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
    xg = cuda_pcg.pcg_solve(data, b, x0, tol, max_iters, trips[0])
    xg2 = cuda_pcg.pcg_solve(data, b, x0, tol, max_iters, trips[1])
    need(bool(torch.isfinite(xg).all()), f"G {label} {dtype_name}: non-finite x")
    need(bool(torch.equal(xg, xg2)) and int(trips[0].item()) == int(trips[1].item()),
         f"G {label} {dtype_name}: two runs differ")
    xp, kp = pcg.solve_T(data.apply_T, data.precondition_T(), b, x0, tol, max_iters)
    kg = int(trips[0].item())
    err = rel_err(xg.double().cpu().numpy(), xp.double().cpu().numpy())
    out = dict(rel_err=err, trips=kg, plain_trips=kp, n=data.n,
               max_abs_err=float((xg - xp).abs().max().item()))
    if dtype_name == "f64":
        bound = PCG_F64_TOL_BUNNY if label.startswith("bunny") else PCG_F64_TOL
        out["bound"] = bound
        if label.startswith("bunny"):
            out["residual"], out["plain_residual"] = (
                float((torch.linalg.norm(b - data.apply(x)) / torch.linalg.norm(b)).item())
                for x in (xg, xp))
            stop = max(tol, 64 * torch.finfo(b.dtype).eps) * 2.0
            need(out["residual"] <= stop and out["plain_residual"] <= stop,
                 f"G {label} f64: a residual over the tolerance: {out}")
        same = kg == kp if bound == PCG_F64_TOL else abs(kg - kp) <= max(2, PCG_F32_TRIPS * kp)
        need(err <= bound and same, f"G {label} f64: {out} (bound {bound}, trips)")
    else:
        bound = PCG_F32_TOL_BUNNY if label.startswith("bunny") else PCG_F32_TOL
        out["bound"] = bound
        need(err <= bound and abs(kg - kp) <= max(2, PCG_F32_TRIPS * kp),
             f"G {label} f32: {out} (bound {bound}, trips within {PCG_F32_TRIPS:.0%})")
    out["form"], out["blocks"], out["threads"] = g_blocks(data, b.dtype)
    out["forms"] = {}
    for form in g_forms(data, b.dtype):
        t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        xf = cuda_pcg.pcg_solve(data, b, x0, tol, max_iters, t, form=form)
        need(bool(torch.equal(xf, xg)) and int(t.item()) == kg,
             f"G {label} {dtype_name}: the {form} form differs from the {out['form']} form")
        out["forms"][form] = dict(bitwise_to_chosen=True, trips=kg,
                                  blocks=g_blocks(data, b.dtype, form)[1:])
        if graph:
            capture_bitwise(torch, f"G {label} ({form})", lambda t, form=form: cuda_pcg.pcg_solve(
                data, b, x0, tol, max_iters, t, form=form), xg, kg)
            out["forms"][form]["graph_replay_bitwise"] = True
    if graph:
        out["graph_replay_bitwise"] = True
    return xg, out


def pcg_checks(torch):
    """Kernel G against the plain solve_T on the card: on the first solve of
    each PCG path (the float32 operator, and the same system's float64
    operator on the same b and x0 widened), and on crossval's small scenes
    (ragged N: 112, 300 and 600 vertices) in every operator form the port
    builds: bands, circular bands (the torus), RCM with a rest-ELL (the bunny
    with spmv_format "bands"), no bands (spmv_format "ell", and the bunny's
    "auto"), each with Jacobi and two-grid; and on the G_EDGE_SCENES beams at
    and beyond the CLUSTER form's largest N, Jacobi and two-grid. Every form
    of G that takes a shape runs (g_against_plain); each form's launch
    captured into a CUDA graph and replayed, in float32, on the first path
    and on the edge beams. Returns the results and, per path, what the
    timing needs."""
    from admm_elastic_tpu_torch.solvers import pcg

    out, timing = {}, {}
    api = torch_api()
    runs = [(name, False) for name in PCG_PATHS] + [(name, True) for name in (
        "beam_pcg", "torus_pcg", "bunny_pcg")] + [(name, True) for name in G_EDGE_SCENES]
    for name, every_form in runs:
        solver, _ = pcg_scene(name, api, dict(PCG_SCENES, **G_EDGE_SCENES))
        s = solver.m_settings
        b, x0 = first_solve(torch, solver)
        forms = [(s.pcg_precond, "auto", solver._solve_data)]
        if every_form:
            fmts = ("auto",) if name in G_EDGE_SCENES else ("auto", "ell", "bands")
            forms = [(pre, fmt, pcg.prepare(solver.system, torch.float32, precond=pre,
                                             spmv_format=fmt))
                     for pre in ("jacobi", "twogrid") for fmt in fmts]
        for pre, fmt, d32 in forms:
            label = f"{name} {pre} {fmt}" if every_form else name
            d64 = pcg.prepare(solver.system, torch.float64, precond=pre, spmv_format=fmt)
            shape = dict(bands=len(d32.band_offsets), circular=d32.band_circular,
                         rcm=d32.perm is not None, rest=d32.ell_cols.shape[1],
                         coarse=0 if d32.agg is None else d32.coarse_inv.shape[0])
            res = {"form": shape}
            xg, res["f32"] = g_against_plain(torch, label, d32, b, x0, s.pcg_tol,
                                             s.pcg_max_iters, "f32",
                                             graph=DEVICE == "cuda" and (
                                                 name == PCG_PATHS[0] or name in G_EDGE_SCENES))
            _, res["f64"] = g_against_plain(torch, label, d64, b.double(), x0.double(),
                                            s.pcg_tol, s.pcg_max_iters, "f64")
            if name in G_EDGE_SCENES and DEVICE == "cuda":
                want = ["grid", "cluster"] if name.endswith("inside") else ["grid"]
                need(all(list(res[t]["forms"]) == want for t in ("f32", "f64")),
                     f"G {label}: forms {list(res['f32']['forms'])}, expected {want}")
            out[label] = res
            log(f"G {label} {json.dumps(shape)}: f32 {res['f32']['rel_err']:.3e} in "
                f"{res['f32']['trips']} trips (plain {res['f32']['plain_trips']}), f64 "
                f"{res['f64']['rel_err']:.3e} in {res['f64']['trips']} trips; forms "
                f"{list(res['f32']['forms'])} bitwise equal")
            if not every_form:
                timing[name] = dict(solver=solver, b=b, x0=x0, data=d32, tol=s.pcg_tol,
                                    max_iters=s.pcg_max_iters, trips=res["f32"]["trips"],
                                    max_abs_err=res["f32"]["max_abs_err"])
    return out, timing


def uzawa_inner_checks(torch):
    """Kernel G as Uzawa's inner solve on floor_uzawa67k (15,616 vertices,
    two-grid, uzawa_inner_tol 1e-5, uzawa_inner_iters 60; the unpenalized
    instantiation, which pcg_checks' paths do not reach at this size) against
    the plain solve_T on two solves of a real step at the golden's landed
    state: the first inner solve (y = 0, so the right-hand side is b and the
    guess x_bar) and the first Schur direction's (C^T r from 0, r the active
    rows' residual after the first). Each in float32 (the first also captured
    and replayed bitwise) and in the same system's float64 operator on the
    same inputs widened (equal trips, 1e-10). Then the predicated trip in both
    precisions: with done set G returns x0 bitwise and adds no trip; with done
    unset it returns what it returns without the flag, in as many trips.
    Returns the results and what the timing needs, each keyed by the path's
    name for the first solve and by "<name> schur" for the other."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    name = "floor_uzawa67k"
    solver = landed_solver(torch, name)
    s, c = solver.m_settings, solver._contact
    d32 = solver._solve_data
    need(isinstance(d32, pcg.PCGData) and d32.agg is not None,
         f"{name}: Uzawa's inner solve is not two-grid PCG")
    tol, iters = s.uzawa_inner_tol, s.uzawa_inner_iters
    d64 = pcg.prepare(solver.system, torch.float64, precond="twogrid")
    b, x0 = first_solve(torch, solver)
    # the first Schur direction's right-hand side, as solvers/uzawa.solve forms it
    hits = solver._detect(x0)
    h, n = hits.capacity, x0.shape[0]
    active = torch.cat([hits.p_mask, hits.d_mask])
    need(bool(active.any()), f"{name}: no active row at the landed state")
    xa = cuda_pcg.pcg_solve(d32, b, x0, tol, iters, None)
    r = torch.where(active, torch.cat(con.C_apply(hits, c.ck, xa))
                    - torch.cat(con.C_rhs(hits, c.ck)), 0.0)
    rhs = con.Ct_apply(hits, c.ck, r[:h], r[h:], n)
    out, timing = {}, {}
    for case, bb, xx in (("first", b, x0), ("schur", rhs, torch.zeros_like(rhs))):
        label = name if case == "first" else f"{name} {case}"
        res = dict(active_rows=int(active.sum().item()))
        x32, res["f32"] = g_against_plain(torch, label, d32, bb, xx, tol, iters, "f32",
                                          graph=case == "first" and DEVICE == "cuda")
        x64, res["f64"] = g_against_plain(torch, label, d64, bb.double(), xx.double(), tol,
                                          iters, "f64")
        if case == "first":
            for tag, data, bt, xt, want in (("f32", d32, bb, xx, x32),
                                            ("f64", d64, bb.double(), xx.double(), x64)):
                for form in g_forms(data, bt.dtype):
                    for flag in (True, False):
                        t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
                        x = cuda_pcg.pcg_solve(data, bt, xt, tol, iters, t,
                                               done=torch.tensor(flag, device=DEVICE), form=form)
                        k = int(t.item())
                        if flag:
                            need(bool(torch.equal(x, xt)) and k == 0,
                                 f"G {label} {tag} {form}: with done set, {k} trips and x is "
                                 "not x0")
                        else:
                            need(bool(torch.equal(x, want)) and k == res[tag]["trips"],
                                 f"G {label} {tag} {form}: with done unset, {k} trips and x "
                                 "differs from the solve without the flag")
                res[tag]["done_set_returns_x0"] = res[tag]["done_unset_bitwise"] = True
                if DEVICE != "cuda":
                    continue
                # the GRID form on 8 blocks: each walks some 8 chunks, with the
                # same bits
                t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
                x = cuda_pcg._launch(data, bt, xt, tol, iters, t, None, None, grid=8, form="grid")
                need(bool(torch.equal(x, want)) and int(t.item()) == res[tag]["trips"],
                     f"G {label} {tag}: the GRID form on 8 blocks differs from the full grid")
                res[tag]["grid_of_8_bitwise"] = True
        out[label] = res
        log(f"G {label} (Uzawa's inner, two-grid, coarse {d32.coarse_inv.shape[0]}, "
            f"{res['active_rows']} active rows): f32 {res['f32']['rel_err']:.3e} in "
            f"{res['f32']['trips']} trips (plain {res['f32']['plain_trips']}), f64 "
            f"{res['f64']['rel_err']:.3e} in {res['f64']['trips']} trips (plain "
            f"{res['f64']['plain_trips']}); forms {list(res['f32']['forms'])} bitwise equal"
            + ("; done set: x0, no trip; done unset: bitwise the unflagged solve; the GRID form "
               "on 8 blocks bitwise" if case == "first" else ""))
        timing[label] = dict(solver=solver, b=bb, x0=xx, data=d32, tol=tol, max_iters=iters,
                             trips=res["f32"]["trips"], max_abs_err=res["f32"]["max_abs_err"])
    return out, timing


def g_device_us(torch, fn, reps, kernel="pcg_kernel"):
    """Device time per launch of kernel G (or the kernel named) by fn()
    (torch.profiler), after a warm-up; a window with events missing is taken
    again, three at most, and then the reading is None (not measured): the
    time the kernels line reports is the queued CUDA events' (queued_us),
    and this one only stands beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) >= reps:
            return sum(us) / len(us)
        log(f"profiler saw {len(us)} of {reps} launches of {kernel}"
            + ("; the window is taken again" if attempt < 2 else "; not measured"))
    return None


def profiler_or_queued(torch, fn, kernel, queued_ms):
    """(profiler_ms, ms) of a solve: torch.profiler's device time per launch
    of fn() (g_device_us; None where the profiler did not see every launch)
    and the time to report, the profiler's or else the queued CUDA events'."""
    us = g_device_us(torch, fn, 20, kernel=kernel)
    prof_ms = None if us is None else us * 1e-3
    return prof_ms, queued_ms if prof_ms is None else prof_ms


def g_form_times(torch, run, data, dtype, trips, reps=10):
    """Each form of G (g_forms) on one solve, in turns: device µs per solve
    (queued_us) of run(form, lib, max_iters) with its own exit, and of the
    latency-floor build (floor_library: no row work) in as many trips, its
    blocks; off the card (a rehearsal) no floor build: null."""
    from admm_elastic_tpu_torch.ops import cuda_pcg

    forms = g_forms(data, dtype)
    calls = [(("kernel", f), lambda f=f: run(f, None, None)) for f in forms]
    if DEVICE == "cuda":
        lib = floor_library()
        calls += [(("floor", f), lambda f=f: run(f, lib, max(trips, 1))) for f in forms]
    us = queued_us(torch, calls + calls[::-1], reps)
    out = {}
    for f in forms:
        floor = us.get(("floor", f))
        kind, blocks, threads = g_blocks(data, dtype, f)
        out[f] = dict(ms=us[("kernel", f)] * 1e-3, floor_ms=None if floor is None else floor * 1e-3,
                      ms_per_trip=us[("kernel", f)] * 1e-3 / max(trips, 1), blocks=blocks,
                      threads=threads)
    return out


def pcg_times(torch, timing, gpu):
    """Kernel G's time per solve on each path's first solve with its trips:
    the form the wrapper chooses by torch.profiler (device time per launch),
    every form (g_forms) by queued CUDA events in turns beside its latency
    floor (the no-row-work build in as many trips); beside the plain solve_T
    on the card, a library SpMV (torch.sparse.mm on A as CSR) times the
    trips, and G's bound (pcg_bytes_ops); each at the tolerance and trip
    limit of its path's solve."""
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    out = {}
    for name, t in timing.items():
        data, b, x0, tol, iters = (t[k] for k in ("data", "b", "x0", "tol", "max_iters"))
        trips = torch.zeros((1,), dtype=torch.int32, device=DEVICE)

        def kern():
            return cuda_pcg.pcg_solve(data, b, x0, tol, iters, trips)

        def plain():
            return pcg.solve_T(data.apply_T, data.precondition_T(), b, x0, tol, iters)

        def run(form, lib, its):
            if lib is None:
                return cuda_pcg.pcg_solve(data, b, x0, tol, iters, None, form=form)
            return cuda_pcg._launch(data, b, x0, tol, its, None, None, None, lib=lib, form=form)

        a = csr_of(torch, t["solver"], b.dtype)
        p1, k1, k2, p2 = (events_ms(torch, plain, 2), events_ms(torch, kern, 20),
                          events_ms(torch, kern, 20), events_ms(torch, plain, 2))
        spmv = events_ms(torch, lambda: torch.sparse.mm(a, b), 200)
        n_bytes, ops = pcg_bytes_ops(data, t["trips"])
        bound_ms, bound_by = bound_of(n_bytes, ops)
        forms = g_form_times(torch, run, data, b.dtype, t["trips"])
        # G's device time per launch (torch.profiler): the events above also
        # hold the host's enqueue of each launch
        form = g_blocks(data, b.dtype)[0]
        prof_ms, ms = profiler_or_queued(torch, kern, "pcg_kernel", forms[form]["ms"])
        out[name] = dict(ms=ms, profiler_ms=prof_ms, events_ms=min(k1, k2), plain_ms=min(p1, p2),
                         readings=[p1, k1, k2, p2], form=form, forms=forms,
                         floor_ms=forms[form]["floor_ms"],
                         trips=t["trips"], ms_per_trip=ms / max(t["trips"], 1),
                         library_ms=spmv * t["trips"], library_spmv_ms=spmv, bytes=n_bytes,
                         operations=ops, bound_ms=bound_ms, bound_by=bound_by,
                         grid=forms[form]["blocks"], n=data.n,
                         bands=len(data.band_offsets), rest=data.ell_cols.shape[1],
                         twogrid=data.agg is not None)
        per_form = "; ".join(
            f"{f} ({v['blocks']} x {v['threads']}) {v['ms'] * 1e3:.1f} us, floor "
            + ("n/a" if v["floor_ms"] is None else f"{v['floor_ms'] * 1e3:.1f} us")
            for f, v in forms.items())
        log(f"time pcg_solve@{name}: {ms * 1e3:.1f} us per solve on the device in the {form} "
            f"form ({'torch.profiler' if prof_ms is not None else 'queued CUDA events'}; "
            f"{min(k1, k2) * 1e3:.1f} by CUDA events), {t['trips']} trips, "
            f"{ms / max(t['trips'], 1) * 1e3:.2f} us per trip; by queued events {per_form}; "
            f"plain {min(p1, p2) * 1e3:.1f} us; torch.sparse.mm {spmv * 1e3:.2f} us x trips; "
            f"bound {bound_ms * 1e3:.2f} us by {bound_by} [{gpu}]")
    return out


def _wrappers():
    from admm_elastic_tpu_torch.ops import (cuda_dynamic, cuda_gs, cuda_local_step,
                                            cuda_obstacle, cuda_pcg, cuda_prox, cuda_stencil,
                                            cuda_tri_local_step, cuda_uzawa, cuda_wind)

    return dict(pcg_solve=cuda_pcg.pcg_solve, pcg_solve_penalty=cuda_pcg.pcg_solve_penalty,
                pcg_solve_dyn=cuda_pcg.pcg_solve_dyn, gs_solve=cuda_gs.gs_solve,
                gs_solve_dyn=cuda_gs.gs_solve_dyn, wind_seq=cuda_wind.wind_seq,
                mesh_detect=cuda_obstacle.mesh_detect, dyn_detect=cuda_dynamic.dyn_detect,
                dyn_gather=cuda_dynamic.dyn_gather, ct_apply=cuda_uzawa.ct_apply,
                schur_trip=cuda_uzawa.schur_trip,
                local_step_tet_hyper=cuda_local_step.local_step_tet_hyper,
                local_step_tet_stencil=cuda_local_step.local_step_tet_stencil,
                tet_Dx_rows=cuda_stencil.tet_Dx_rows, tet_rhs_rows=cuda_stencil.tet_rhs_rows,
                prox_tet_hyper=cuda_prox.prox_tet_hyper, prox_tet_linear=cuda_prox.prox_tet_linear,
                local_step_tri=cuda_tri_local_step.local_step_tri,
                local_step_tri_stencil=cuda_tri_local_step.local_step_tri_stencil,
                # the scene forms (scenario batching)
                local_step_tet_hyper_scenes=cuda_local_step.local_step_tet_hyper_scenes,
                local_step_tet_stencil_scenes=cuda_local_step.local_step_tet_stencil_scenes,
                local_step_tri_stencil_scenes=cuda_tri_local_step.local_step_tri_stencil_scenes,
                tet_rhs_rows_scenes=cuda_stencil.tet_rhs_rows_scenes,
                pcg_solve_scenes=cuda_pcg.pcg_solve_scenes,
                pcg_solve_penalty_scenes=cuda_pcg.pcg_solve_penalty_scenes,
                ct_apply_scenes=cuda_uzawa.ct_apply_scenes,
                schur_trip_scenes=cuda_uzawa.schur_trip_scenes,
                mesh_detect_scenes=cuda_obstacle.mesh_detect_scenes)


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def wrapper_counts():
    """Each kernel wrapper's count of its launches, by the wrapper's name."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_counts(model=None):
    """The wrappers' counts by kernel name; A and D under the tet model of the
    path. A wrapper counts each call of its launch: in the warm-up step and in
    the capture of a captured step, and in any eager call; a replay of the
    captured step launches its kernels without them."""
    by_model = ("local_step_tet_hyper", "local_step_tet_stencil", "prox_tet_hyper")
    return {f"{name}[{model}]" if name in by_model else name: n
            for name, n in wrapper_counts().items()}


# The port's kernels as torch.profiler names them ("void (anonymous
# namespace)::tet_prox_kernel<float, 0, true>(...)", csrc/*.cu), with their
# template arguments.
_KERNEL_SYMBOL = re.compile(
    r"\b(tet_prox_kernel|tet_local_step_stencil_kernel|tet_dx_kernel|tet_rhs_tiled_kernel|"
    r"tet_local_step_scenes_kernel|tet_local_step_stencil_scenes_kernel|"
    r"tri_local_step_stencil_scenes_kernel|"
    r"tet_rhs_wide_kernel|tri_local_step_kernel|tri_local_step_stencil_kernel|pcg_kernel|"
    r"gs_kernel|wind_seq_kernel|mesh_detect_kernel|dyn_rank_kernel|dyn_gather_kernel|"
    r"uzawa_ct_kernel|schur_trip_grid_kernel|uzawa_ct_scenes_kernel|schur_trip_scenes_kernel|"
    r"mesh_detect_scenes_kernel)"
    r"<([^>]*)>")


def wrapper_of_symbol(symbol):
    """The name (A and D with [model]) of the wrapper that launches the kernel
    a profiler event names, or None for a kernel that is not the port's."""
    from admm_elastic_tpu_torch.ops.cuda_local_step import MODEL_IDS

    m = _KERNEL_SYMBOL.search(symbol)
    if m is None:
        return None
    kernel, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
    scenes = len(args) > 1 and args[-1] == "true"  # C's and G's scene forms (SCN last)
    if kernel.startswith("tet_rhs"):  # <T, SCN>
        return "tet_rhs_rows_scenes" if scenes else "tet_rhs_rows"
    if kernel == "pcg_kernel":  # <T, PEN, CL, DYN, SCN>: the penalty form where PEN, DYN's
        if len(args) > 3 and args[3] == "true":
            return "pcg_solve_dyn"
        name = "pcg_solve_penalty" if args[1] == "true" else "pcg_solve"
        return f"{name}_scenes" if len(args) > 4 and scenes else name
    if kernel == "gs_kernel":  # <T, SH, WIDE, MESH, DYN>
        return "gs_solve_dyn" if len(args) > 4 and args[4] == "true" else "gs_solve"
    # kernel K is four launches a call, whatever the number of colliders
    # (self_collision.cu): its rank launch counts it
    plain = dict(tet_dx_kernel="tet_Dx_rows", tri_local_step_kernel="local_step_tri",
                 tri_local_step_stencil_kernel="local_step_tri_stencil",
                 wind_seq_kernel="wind_seq", mesh_detect_kernel="mesh_detect",
                 dyn_rank_kernel="dyn_detect", dyn_gather_kernel="dyn_gather",
                 uzawa_ct_kernel="ct_apply", schur_trip_grid_kernel="schur_trip",
                 uzawa_ct_scenes_kernel="ct_apply_scenes",
                 schur_trip_scenes_kernel="schur_trip_scenes",
                 mesh_detect_scenes_kernel="mesh_detect_scenes",
                 tri_local_step_stencil_scenes_kernel="local_step_tri_stencil_scenes")
    if kernel in plain:
        return plain[kernel]
    model = {i: name for name, i in MODEL_IDS.items()}[int(args[1])]
    if kernel == "tet_local_step_scenes_kernel":
        return f"local_step_tet_hyper_scenes[{model}]"
    if kernel == "tet_local_step_stencil_scenes_kernel":
        return f"local_step_tet_stencil_scenes[{model}]"
    if kernel == "tet_local_step_stencil_kernel":
        return f"local_step_tet_stencil[{model}]"
    if args[2] == "true":  # ROWS: the local step's rows entry
        return f"local_step_tet_hyper[{model}]"
    return "prox_tet_linear" if model == "linear" else f"prox_tet_hyper[{model}]"


def port_kernel_counts(events):
    """The port's kernels among a profiler window's device events, counted
    by name (wrapper_of_symbol)."""
    from torch.autograd import DeviceType

    counts = {}
    for e in events:
        name = wrapper_of_symbol(e.name) if e.device_type == DeviceType.CUDA else None
        if name is not None:
            counts[name] = counts.get(name, 0) + 1
    return counts


PROFILED_I = "wind_seq records"  # kernel I's launches as torch.profiler recorded them


def device_launches(torch, fn, model=None):
    """Run fn() and count the port's kernels that ran on the device in it, by
    name. On the card from torch.profiler's kernel records, which see inside
    a graph replay, where no wrapper runs, and kernel I from its own device
    counter; off the card (a rehearsal whose wrappers count their calls) from
    the wrappers' counts, A and D under [model]."""
    if DEVICE != "cuda":
        before = read_counts(model)
        fn()
        return {k: v - before[k] for k, v in read_counts(model).items() if v != before[k]}
    from torch.profiler import ProfilerActivity, profile

    from admm_elastic_tpu_torch.ops import cuda_wind

    torch.cuda.synchronize()
    dev = torch.device("cuda", torch.cuda.current_device())
    wind_before = cuda_wind.device_launches(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = port_kernel_counts(prof.events())
    # Kernel I counts its own launches on the device: the profiler misses some
    # of its records (PERF.md §7, tools/kernel_i_records.py). What the
    # profiler recorded of it stays beside the count, under PROFILED_I.
    seen = counts.pop("wind_seq", 0)
    wind = cuda_wind.device_launches(dev) - wind_before
    if wind:
        counts["wind_seq"] = wind
    if wind or seen:
        counts[PROFILED_I] = seen
    return counts


def counted_window(torch, label, fn, expect, reset=None, model=None, split=None):
    """device_launches of fn(), held to expect (name -> exact count, 0 for a
    kernel fn must not launch). The profiler now and then drops events of a
    window, so a window short of expect is taken again (reset() first, where
    fn must start from the same state), three times at most. Where it stays
    short and split is given, split() takes it once more in smaller windows,
    each held the same way to its own share of expect, and returns their
    counts summed: the largest window (floor_uzawa67k's, some 117,000 device
    records) lost a few of them on most runs (PERF.md §7)."""
    for attempt in range(3):
        if reset is not None:
            reset()
        counts = device_launches(torch, fn, model)
        off = {k: counts.get(k, 0) for k, want in expect.items() if counts.get(k, 0) != want}
        if not off:
            return counts
        log(f"{label}: a window counted {off}, expected {expect}"
            + ("; it is taken again" if attempt < 2 else ""))
    short = all(v < expect[k] for k, v in off.items())
    if short and split is not None:
        log(f"{label}: the window is taken again in smaller windows")
        if reset is not None:
            reset()
        counts = split()
        off = {k: counts.get(k, 0) for k, want in expect.items() if counts.get(k, 0) != want}
        need(not off, f"{label}: the smaller windows counted {off} in all, expected {expect}")
        return counts
    raise (ProfilerShort if short else SmokeFailure)(
        f"{label}: launched {off}, expected {expect}, three times")


def profiler_warmup(torch):
    """The process's first torch.profiler window, on a few small kernels:
    CUPTI is set up here, once (main sets TEARDOWN_CUPTI=0, so no later
    window tears it down and sets it up again among the captured graphs).
    In the paths' process it comes before any graph is captured, in the main
    process after host_timing, whose host clock it must not slow. Logs and
    returns the device events it saw: a profiler that traces nothing shows
    here, before any reading needs it."""
    if DEVICE != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((1024,), device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            x = x * 1.5
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    log(f"profiler warm-up: {n} device events of 8 launches (TEARDOWN_CUPTI="
        f"{os.environ.get('TEARDOWN_CUPTI')})")
    return n


def rel_err(x, ref):
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-9))


def disp_err(x, g, step):
    """DISP_TOL's measure for x after the golden's step `step`, and its bound."""
    x0 = g["x0"].astype(np.float64)
    ref = g[f"x{step}"]
    return rel_err(x - x0, ref - x0), DISP_TOL[ref.dtype.name]


class count_calls:
    """Count the calls of module.name while the block runs (for a plain
    PyTorch function, which has no launch counter of its own)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def counted(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def graph_vs_eager(torch, label, solver, state0, n_steps, x_graph):
    """The captured step against the eager loop (Solver._run_eager) over
    n_steps from state0: bitwise equal, or within GRAPH_EAGER_TOL of max |x|.
    Leaves the eager state in the solver."""

    solver.state = state0.clone()
    solver._run_eager(n_steps)
    x_eager = solver.state.x
    bitwise = bool(torch.equal(x_eager, x_graph))
    rel = rel_err(x_graph.cpu().double().numpy(), x_eager.cpu().double().numpy())
    need(bitwise or rel <= GRAPH_EAGER_TOL,
         f"{label}: the graph rollout is {rel:.3e} off the eager loop (bound {GRAPH_EAGER_TOL})")
    return dict(bitwise=bitwise, rel_err=rel)


def drive_path(torch, label, solver, g, pins, kernels, after_steps=None, model=None,
               step_counts=None, grid=None, tols=None, disp_bound=None):
    """Drive a path in one window, with the wrappers' counts set to 0 just
    before and read just after: run(0) (a warm-up step and the capture, the
    wrappers' calls), the replays to the golden's last step (8, or 2),
    counted on the device by name (counted_window, from the same state at
    each retake), then after_steps (the element-level entries held against
    the step's, eager: each wrapper call a launch). Checks: every kernel of
    `kernels` was called by its wrapper and launched; the replays launched
    each kernel of step_counts (name -> exact count, 0 for a kernel the steps
    must not launch) as often as stated, and its wrapper was called once per
    launch of one step in the warm-up and once in the capture; the plain
    tri_Dx_rows was called as often as stated by run(0) and the steps; the
    first and the last step against the golden (and, for a renumbered sheet,
    mapped back by the golden's perm against the grid sheet's golden `grid`);
    the pins; that the rollout repeats bitwise and that the eager loop gives
    what the graph gives. Where the golden compares more than two steps (the
    contact paths), each of them is held, the first under tols[0] and the
    rest under tols[1]."""
    from admm_elastic_tpu_torch.ops import stencil as st

    compared = [int(k) for k in g["steps"]]
    first, last = compared[0], compared[-1]
    x0 = solver.x
    state0 = solver.state.clone()
    on_card = solver.device.type == "cuda"
    step_counts = step_counts or {}
    xs = {}

    def steps():
        done = 0
        for k in compared:
            solver.run(k - done)
            done = k
            if k != last:
                xs[k] = solver.x

    with count_calls(st, "tri_Dx_rows") as plain_dx:
        reset_counts()
        solver.run(0)
        need(solver._graph is not None or not on_card, f"{label}: run(0) captured no graph")
        captured = read_counts(model)

        def restore():
            solver.state = state0.clone()

        expect = {k: v for k, v in step_counts.items() if k != "tri_Dx_rows"}

        def step_by_step():
            # one window a replayed step, each from its own start state
            need(all(v % last == 0 for v in expect.values()),
                 f"{label}: launches {expect} not a whole number per step")
            total = {}
            for k in range(1, last + 1):
                start = solver.state.clone()
                got = counted_window(torch, f"{label} step {k}", lambda: solver.run(1),
                                     {n: v // last for n, v in expect.items()},
                                     lambda start=start: setattr(solver, "state", start.clone()),
                                     model)
                for n, v in got.items():
                    total[n] = total.get(n, 0) + v
                if k in compared and k != last:
                    xs[k] = solver.x
            return total

        by_steps = counted_window(torch, label, steps, expect, restore, model,
                                  split=step_by_step)
    x_last_t = solver.state.x.clone()
    before_after = read_counts(model)
    extra = after_steps(solver) if after_steps is not None else {}
    calls = read_counts(model)
    after = {k: v - before_after[k] for k, v in calls.items() if v != before_after[k]}
    if on_card:  # on the CPU the stencil entry's plain version calls it
        need(plain_dx.calls == step_counts.get("tri_Dx_rows", plain_dx.calls),
             f"{label}: tri_Dx_rows called {plain_dx.calls} times by the steps")
        for k in (set(by_steps) - {PROFILED_I}) | {k for k, v in captured.items() if v}:
            n = by_steps.get(k, 0)
            c = captured.get(k, 0)
            need(c == 2 * n // last,
                 f"{label}: {k}: {c} wrapper calls in the warm-up step and the "
                 f"capture, {n} launches in {last} replays")
    launches = {k: by_steps.get(k, 0) + after.get(k, 0) for k in set(by_steps) | set(after)}
    log(f"{label} launches " + json.dumps(launches) + "; by the replays, on the device "
        + json.dumps(by_steps) + "; wrapper calls " + json.dumps({k: v for k, v in calls.items() if v}))
    for k in kernels:
        need(calls.get(k, 0) > 0 and launches.get(k, 0) > 0,
             f"{label}: kernel {k}: {calls.get(k, 0)} wrapper calls, {launches.get(k, 0)} launches")
    xs[last] = x_last_t.cpu().numpy()
    x_first, x_last = xs[first], xs[last]

    errs, disp = {}, {}
    for step in compared:
        x, ref = xs[step], g[f"x{step}"]
        need(x.shape == ref.shape and np.isfinite(x).all(), f"{label} step {step}: bad state")
        errs[step] = rel_err(x, ref)
        disp[step], disp_tol = disp_err(x, g, step)
    step1_tol, step8_tol = tols or (STEP1_TOL, STEP8_TOL)
    disp_tol = disp_bound or disp_tol
    # step8_tol None: the trajectory is held at its first compared step only
    # (the caller holds the others one step at a time)
    held = compared if step8_tol is not None else [first]
    log(f"{label} vs JAX golden: " + ", ".join(
        f"step {k} {errs[k]:.3e} (bound {step1_tol if k == first else step8_tol})"
        for k in compared) + ", displacement " + ", ".join(f"{disp[k]:.3e}" for k in compared)
        + f" (bound {disp_tol}, held at steps {held})")
    need(errs[first] < step1_tol and all(errs[k] < step8_tol for k in held[1:])
         and max(disp[k] for k in held) < disp_tol,
         f"{label}: trajectory off the golden: {errs}, displacement {disp}")
    to_grid = {}
    if grid is not None:
        to_grid = {step: rel_err(x[g["perm"]], grid[f"x{step}"])
                   for step, x in ((first, x_first), (last, x_last))}
        log(f"{label} mapped back, vs the grid sheet's golden: step {first} "
            f"{to_grid[first]:.3e}, step {last} {to_grid[last]:.3e}")
        need(to_grid[first] < STEP1_TOL and to_grid[last] < STEP8_TOL,
             f"{label}: off the grid sheet's golden: {to_grid}")
    pin_dev = float(np.abs(x_last[pins] - x0[pins]).max()) if pins else 0.0
    # Pins are springs: where the golden's own pins give more (the PCG sheet's
    # by 4.6e-3 in 8 steps: its solve stops at a residual of 7.6e-6), the
    # bound is twice that.
    ref = g[f"x{last}"]
    pin_tol = max(1e-3, 2.0 * float(np.abs(ref[pins] - g["x0"][pins]).max())) if pins else 1e-3
    need(pin_dev < pin_tol, f"{label}: pins not held: {pin_dev} (bound {pin_tol})")

    graph = solver._graph
    solver.state = state0.clone()
    solver.run(last)
    need(solver._graph is graph, f"{label}: a new state recaptured the step")
    need(bool(torch.equal(solver.state.x, x_last_t)),
         f"{label}: {last}-step graph rollout not bitwise repeatable")
    eager = graph_vs_eager(torch, label, solver, state0, last, x_last_t)
    log(f"{label}: graph rollout bitwise repeatable; against the eager loop "
        f"{'bitwise equal' if eager['bitwise'] else 'rel err %.3e' % eager['rel_err']}")
    drive_path.xs = xs  # x at each compared step, for the caller's own checks
    return x0, x_last, dict(launches=launches, launches_by_steps=by_steps, wrapper_calls=calls,
                            tri_Dx_rows_calls=plain_dx.calls, steps=[first, last],
                            rel_err_step1=errs[first], rel_err_last=errs[last],
                            disp_err_step1=disp[first], disp_err_last=disp[last],
                            rel_err={str(k): v for k, v in errs.items()},
                            rel_err_to_grid_sheet={str(k): v for k, v in to_grid.items()},
                            pin_dev=pin_dev, bitwise_repeat=True, graph_vs_eager=eager, **extra)


def check_sag(label, x0, x8):
    """bench.py's sanity check (bench.py:101-106): the beam sags, and not through the floor."""
    need(-60.0 < x8[:, 1].min() < x0[:, 1].min(), f"{label}: no sag?")
    return dict(min_y=float(x8[:, 1].min()))


def sheet_rows_entry(torch):
    """After the steps of a cloth path: the sheet's D x as rows (plain
    PyTorch, as system.Dx gives it) through kernel E's rows entry with u = 0."""
    from admm_elastic_tpu_torch.system import system as sysm

    def run(solver):
        b = solver.system.tris[0]
        rows = sysm.Dx(solver.system, solver.state.x)[0]
        by_rows = b.local_step_rows(rows, torch.zeros_like(rows))
        need(all(bool(torch.isfinite(t).all()) for t in by_rows), "bad rows-entry cloth step")
        return dict(_by_rows=by_rows)

    return run


def cloth_path(torch, name):
    """A sheet of CLOTH_SCENES (or cloth_wind40_seq: kernel I once per step)
    through the captured step: E's stencil entry once per ADMM iteration, then
    E's rows entry held to it on the stepped state."""
    solver, g, pins = make_cloth_solver(name)
    log(f"{name}: no tet family, tet_rhs_rows is not on this path")
    steps = int(g["steps"][-1])
    iters = steps * int(g["admm_iters"])
    kernels = ["local_step_tri_stencil", "local_step_tri"]
    counts = {"local_step_tri_stencil": iters, "local_step_tri": 0, "tri_Dx_rows": 0}
    if variant_of(name)[2]:  # the sequential wind
        kernels.append("wind_seq")
        counts["wind_seq"] = steps
    x0, x8, res = drive_path(
        torch, name, solver, g, pins, kernels, after_steps=sheet_rows_entry(torch),
        step_counts=counts)
    log(f"{name}: the steps launch the sheet's stencil entry {iters} times and tri_Dx_rows "
        "not at all")
    # Outside the counted window: the stencil entry on the same stepped state.
    b = solver.system.tris[0]
    by_x = b.local_step_x(solver.state.x, torch.zeros_like(res["_by_rows"][0]))
    need(all(bool(torch.equal(p, q)) for p, q in zip(res.pop("_by_rows"), by_x)),
         f"{name}: the rows entry and the stencil entry differ on the stepped state")
    res["rows_entry_bitwise"] = True
    moved = float(np.abs(x8 - x0).max())
    if CLOTH_SCENES[variant_of(name)[0]]["gravity"] < 0.0:
        need(x8[:, 1].min() < -1e-3, f"{name}: the sheet did not sag")
    need(moved > 1e-4, f"{name}: the sheet did not move")
    res.update(moved=moved, min_y=float(x8[:, 1].min()))
    return solver, res


def element_prox(torch, model):
    """After the steps of a beam path: D x as rows (the standalone kernel B,
    through system.Dx), TetBatch.prox on [T,3,3] of it (kernel D, or F for the
    linear model) and on the rows (kernel A's rows entry with u = 0)."""
    from admm_elastic_tpu_torch.system import system as sysm

    def run(solver):
        b = solver.system.tets[0]
        rows = sysm.Dx(solver.system, solver.state.x)[0]
        zi = rows.T.reshape(-1, 3, 3).contiguous()
        z33 = b.prox(zi)
        need(tuple(z33.shape) == (b.n, 3, 3) and bool(torch.isfinite(z33).all()),
             f"{model}: bad element-level prox")
        return dict(_zr=b.prox(rows), _z33=z33)

    return run


def path_label(model):
    return "beam" if model == NH else f"beam[{model}]"


def beam_path(torch, model):
    """The bench beam with one tet model: 8 steps (kernel A[model] through its
    stencil entry, which does kernel B's work, and C), then the element-level
    entries (B standalone, A's rows entry, D[model] or F)."""
    solver, _, g, pins = make_solver(model)
    label = path_label(model)
    from admm_elastic_tpu_torch.ops import cuda_stencil

    plan = cuda_stencil.rhs_plan_of(solver.system.tets[0], 4)
    log(f"{label}: tet_rhs_rows takes the {plan[0]} branch (tile {plan[1]}, {plan[2]} B shared)")
    need(plan[0] == "tiled", f"{label}: kernel C planned as {plan} on the bench beam")
    dkey = "prox_tet_linear" if model == "linear" else f"prox_tet_hyper[{model}]"
    iters = int(g["steps"][-1]) * int(g["admm_iters"])
    x0, x8, res = drive_path(
        torch, label, solver, g, pins,
        [f"local_step_tet_stencil[{model}]", f"local_step_tet_hyper[{model}]", "tet_Dx_rows",
         "tet_rhs_rows", dkey],
        after_steps=element_prox(torch, model), model=model,
        step_counts={f"local_step_tet_stencil[{model}]": iters, "tet_rhs_rows": iters,
                     "tet_Dx_rows": 0, f"local_step_tet_hyper[{model}]": 0})
    log(f"{label}: the steps launch the stencil entry {iters} times and tet_Dx_rows not at all")
    res.update(check_sag(label, x0, x8), rhs_plan=list(plan))
    zr, z33 = res.pop("_zr"), res.pop("_z33")
    # Outside the counted window: the stencil entry on the same stepped state.
    zx = solver.system.tets[0].local_step_x(solver.state.x, torch.zeros_like(zr))[0]
    need(bool(torch.equal(zr, zx)),
         f"{label}: the rows entry and the stencil entry differ on the stepped state")
    res["rows_entry_bitwise"] = True
    res["prox_vs_rows_entry"] = tet_errs(torch, [z33.reshape(-1, 9).T], [zr], "f32",
                                         f"{label} [T,3,3] against rows")
    res["prox_vs_rows_entry"]["bitwise"] = bool(torch.equal(z33.reshape(-1, 9).T, zr))
    return solver, res


def free_beam_path(torch):
    """The bench beam without pins, 2 steps of free fall: the float32 system
    takes one refinement pass per ADMM iteration, so every iteration applies A
    through system.A_mv, the standalone kernel B and kernel C once more."""
    solver, mesh, g, pins = make_solver(NH, pinned=False)
    iters = int(g["steps"][-1]) * int(g["admm_iters"])
    x0, x2, res = drive_path(
        torch, FREE_BEAM, solver, g, pins,
        [f"local_step_tet_stencil[{NH}]", "tet_Dx_rows", "tet_rhs_rows"], model=NH,
        step_counts={f"local_step_tet_stencil[{NH}]": iters, "tet_Dx_rows": iters,
                     "tet_rhs_rows": 2 * iters})
    # Free fall: every vertex drops alike, by symplectic Euler's
    # g dt^2 n (n + 1) / 2, and the beam keeps its shape.
    drop = x2 - x0
    n_steps = int(g["steps"][-1])
    want = float(g["gravity"]) * float(g["dt"]) ** 2 * n_steps * (n_steps + 1) / 2
    spread = float(np.abs(drop - drop.mean(axis=0)).max())
    need(abs(float(drop[:, 1].mean()) - want) < 1e-4 and spread < 1e-3,
         f"{FREE_BEAM}: not a free fall: mean drop {drop[:, 1].mean()} against {want}, "
         f"spread {spread}")
    res.update(drop_y=float(drop[:, 1].mean()), spread=spread)
    return solver, res


def gather_path(torch, name):
    """One of GATHER_SCENES, 8 steps: a gather family launches the rows entry
    of kernel A (tets) or E (the sheet) once per ADMM iteration and no
    stencil entry, C or D x kernel (its D x and D^T are plain PyTorch
    gathers); beam_cho launches what the lattice beam does, around two
    triangular solves in place of the GEMM."""
    solver, g, pins = make_gather_solver(name)
    p = GATHER_SCENES[name]
    iters = int(g["steps"][-1]) * int(g["admm_iters"])
    model = p.get("model")
    if p["mesh"] == "sheet":
        kernels = ["local_step_tri"]
        counts = {"local_step_tri": iters, "local_step_tri_stencil": 0, "tri_Dx_rows": 0}
    elif p.get("lattice"):
        kernels = [f"local_step_tet_stencil[{model}]", "tet_rhs_rows"]
        counts = {f"local_step_tet_stencil[{model}]": iters, "tet_rhs_rows": iters,
                  "tet_Dx_rows": 0, f"local_step_tet_hyper[{model}]": 0}
    else:
        kernels = [f"local_step_tet_hyper[{model}]"]
        counts = {f"local_step_tet_hyper[{model}]": iters, f"local_step_tet_stencil[{model}]": 0,
                  "tet_rhs_rows": 0, "tet_Dx_rows": 0}
    x0, x8, res = drive_path(torch, name, solver, g, pins, kernels, model=model,
                             step_counts=counts,
                             grid=golden(p["sheet"]) if p["mesh"] == "sheet" else None)
    log(f"{name}: the steps launch {kernels[0]} {iters} times")
    if p["mesh"] == "beam":
        res.update(check_sag(name, x0, x8))
    return solver, res


def device_ops(torch, fn, iters):
    """Device operations (kernels, copies, fills) and busy time per ADMM
    iteration of fn() (torch.profiler on the card; None elsewhere)."""
    if DEVICE != "cuda":
        fn()
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The profiler now and then returns a window with events missing (see
    # counted_window): a window with fewer than 3 device ops an iteration,
    # fewer than the port's kernels alone, is taken again, three times at most.
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(ev) >= 3 * iters:
            break
    return dict(ops_per_iter=len(ev) / iters,
                busy_us_per_iter=sum(e.time_range.elapsed_us() for e in ev) / iters)


def pcg_path(torch, name):
    """One of PCG_PATHS through the normal entry points (chip_smoke.pcg_scene),
    8 steps through the captured step against its golden under PCG_STEP_TOL /
    PCG_DISP_TOL: the steps launch kernel G once per ADMM iteration, A's
    stencil entry and C (beam, torus: a ring), E's stencil entry (the sheet)
    or A's rows entry (the bunny's gather family) as often; then the CG trips
    of each step (step(), the step's device counter) beside the JAX package's,
    and the device operations per iteration of one replayed step."""
    solver, pins = pcg_scene(name, torch_api())
    g = golden(name)
    need(np.array_equal(pins, g["pins"]), f"{name}: pinned set differs from the golden's")
    s = solver.m_settings
    need(s.linsolver == 3 and s.pcg_precond == str(g["pcg_precond"])
         and s.pcg_tol == float(g["pcg_tol"]) and s.pcg_max_iters == int(g["pcg_max_iters"])
         and solver.requested_linsolver == int(g["requested_linsolver"]),
         f"{name}: the solver's PCG settings differ from the golden's")
    iters = int(g["steps"][-1]) * int(g["admm_iters"])
    p = PCG_SCENES[name]
    model = None if p["mesh"] == "sheet" else NH
    if p["mesh"] == "sheet":
        kernels = ["local_step_tri_stencil", "pcg_solve"]
        counts = {"local_step_tri_stencil": iters, "pcg_solve": iters, "local_step_tri": 0,
                  "tri_Dx_rows": 0}
    elif p["mesh"] == "bunny":
        kernels = [f"local_step_tet_hyper[{NH}]", "pcg_solve"]
        counts = {f"local_step_tet_hyper[{NH}]": iters, "pcg_solve": iters,
                  f"local_step_tet_stencil[{NH}]": 0, "tet_rhs_rows": 0, "tet_Dx_rows": 0}
    else:
        kernels = [f"local_step_tet_stencil[{NH}]", "tet_rhs_rows", "pcg_solve"]
        counts = {f"local_step_tet_stencil[{NH}]": iters, "tet_rhs_rows": iters,
                  "pcg_solve": iters, "tet_Dx_rows": 0, f"local_step_tet_hyper[{NH}]": 0}

    state0 = solver.state.clone()
    x0, x8, res = drive_path(torch, name, solver, g, [int(i) for i in pins], kernels,
                             model=model, step_counts=counts, tols=PCG_STEP_TOL[name],
                             disp_bound=PCG_DISP_TOL[name])
    solver.state = state0.clone()
    trips = []
    for _ in range(int(g["steps"][-1])):
        solver.step()
        trips.append(solver.runtime_data().inner_iters)
    need(all(t > 0 for t in trips), f"{name}: a step took no CG trip: {trips}")
    res.update(trips_per_step=trips, jax_trips_per_step=g["trips"].tolist(),
               pcg=dict(precond=s.pcg_precond, tol=s.pcg_tol, max_iters=s.pcg_max_iters,
                        requested_linsolver=solver.requested_linsolver,
                        bands=len(solver._solve_data.band_offsets),
                        circular=solver._solve_data.band_circular,
                        rest=solver._solve_data.ell_cols.shape[1]))
    res["device"] = device_ops(torch, lambda: solver.run(1), int(g["admm_iters"]))
    log(f"{name}: CG trips per step {trips} (the JAX package's {g['trips'].tolist()}); "
        f"device per iteration {json.dumps(res['device'])}")
    if p["mesh"] in ("beam", "torus"):
        res.update(check_sag(name, x0, x8))
    elif p["mesh"] == "sheet":
        need(x8[:, 1].min() < -1e-3, f"{name}: the sheet did not sag")
    return solver, res


# --- contact: kernel H, kernel G's penalty form, the contact paths -----------

# Kernel H against the plain gs.solve on the same inputs: float64 in the same
# sweeps within H_F64_TOL of max |x|; float32 sweeps within one and x within
# H_F32_TOL (a Floor's update is bit for bit the plain one's; a Sphere's
# norms are summed in another order, and the exit test's sums of squares
# differ by rounding: one sweep more or less moves x by its last update).
H_F64_TOL = 1e-10
H_F32_TOL = 1e-4
# Kernel G's penalty form against alcg.solve_plain: float64 in the same trips
# within PCG_F64_TOL, float32 trips within one and x within PCG_F32_TOL.
GPEN_F32_TRIPS = 1
# The contact paths' golden bounds (the first compared step, the later ones)
# on x relative to max |x|, and on the displacement: three to ten times the
# larger gap of two readings at full size, the port's plain path on the CPU
# (tests/contact_fault_control.py, which also plants faults that they catch)
# and this script on an NVIDIA H100 (PERF.md). x, the worse later step:
# floor_gs5k 1.5e-5 (CPU) / 6.5e-6 (card), floor_uzawa5k 1.6e-3 / 1.6e-3,
# floor_uzawa67k 2.3e-3 (card; its CPU run takes too long to repeat),
# floor_alpcg67k 3.1e-6 / 2.9e-6, sphere_gs 2.1e-4 / 3.1e-4; the
# displacement: 9.4e-3 (step 1), 5.6e-2 / 5.7e-2, 0.108, 1.8e-4 / 1.7e-4,
# 4.3e-4 / 3.1e-4. Uzawa's Schur CG meets uzawa_max_iters on the landing
# beam, and its unconverged iterate carries each sum order into the contact
# forces: its bounds catch tunnelling, not a centimetre (PERF.md). The mesh
# paths take their floor counterparts' bounds and crossval's for the deep
# scene: the port on the CPU against their goldens, x at the worse later step
# (the displacement): slab_sdf_gs5k 1.8e-5, slab_exact_gs5k 1.5e-5,
# slab_exact_alpcg67k 3.1e-6 (1.8e-4), exactmesh_deep_gs 1.7e-5.
CONTACT_STEP_TOL = {"floor_gs5k": (1e-4, 1e-4), "floor_uzawa5k": (1e-4, 1e-2),
                    "floor_uzawa67k": (1e-4, 1e-2), "floor_alpcg67k": (1e-4, 3e-5),
                    "sphere_gs": (1e-4, 1e-3), "slab_sdf_gs5k": (1e-4, 1e-4),
                    "slab_exact_gs5k": (1e-4, 1e-4), "slab_exact_alpcg67k": (1e-4, 3e-5),
                    "exactmesh_deep_gs": (STEP1_TOL, STEP8_TOL)}
CONTACT_DISP_TOL = {"floor_gs5k": 0.05, "floor_uzawa5k": 0.2, "floor_uzawa67k": 0.35,
                    "floor_alpcg67k": 1e-3, "sphere_gs": 2e-3, "slab_sdf_gs5k": 0.05,
                    "slab_exact_gs5k": 0.05, "slab_exact_alpcg67k": 1e-3,
                    "exactmesh_deep_gs": 0.05}
LANDING_STEP = 12  # the first compared step after the floor is reached


def landed_solver(torch, name):
    """The path's solver (float32, on the card) in the golden's landed state
    (x at LANDING_STEP, or the sphere's step 16; v = 0): its next step pushes
    the bottom face into the obstacle."""
    import dataclasses

    solver = contact_scene(name, torch_api())
    g = golden(name)
    step = [int(k) for k in g["steps"]][1]
    x = torch.as_tensor(g[f"x{step}"], device=DEVICE, dtype=torch.float32)
    solver.state = dataclasses.replace(solver.state, x=x, v=torch.zeros_like(x))
    return solver


def gs_data64(torch, solver):
    """The GSData of the solver's system in float64 (A assembled in float64
    from the same element batches)."""
    import dataclasses

    from admm_elastic_tpu_torch.system import assembly

    cols, vals, diag = assembly.assemble_ell(solver.system, dtype=np.float64)
    d = solver._solve_data
    return dataclasses.replace(d, ell_vals=torch.as_tensor(vals, device=DEVICE),
                               diag=torch.as_tensor(diag, device=DEVICE))


def h_forms(n, dtype):
    """The forms of kernel H that take n vertices in dtype on this card: the
    GLOBAL form always, the SHARED form where x fits (cuda_gs.h_form). Off
    the card (a rehearsal) the wrapper's plain version: "plain"."""
    from admm_elastic_tpu_torch.ops import cuda_gs

    if DEVICE != "cuda":
        return ["plain"]
    forms = ["global"]
    try:
        cuda_gs.form_of(n, dtype, "shared")
        forms.append("shared")
    except ValueError:
        pass
    return forms


def h_chosen(n, dtype):
    """The form kernel H takes for n vertices (cuda_gs.form_of); "plain"
    off the card."""
    from admm_elastic_tpu_torch.ops import cuda_gs

    return cuda_gs.form_of(n, dtype) if DEVICE == "cuda" else "plain"


def h_against_plain(torch, label, data, b, x0, pin_mask, pin_target, obstacles, s, dtype_name,
                    graph=False, bitwise=False):
    """Kernel H against the plain gs.solve on the same inputs (H_F64_TOL,
    H_F32_TOL; with bitwise, the same bits), twice bitwise; every other form
    that takes the shape (h_forms) bitwise equal to the form the wrapper
    chooses, in as many sweeps; with an exact mesh obstacle, the exact walk at
    every group size (cuda_gs.GROUPS) in the chosen form, each bitwise the
    chosen run; with graph, each form captured and replayed bitwise."""
    from admm_elastic_tpu_torch.ops import cuda_gs
    from admm_elastic_tpu_torch.solvers import gs

    dtype = b.dtype
    obs = [o.to(DEVICE, dtype) for o in obstacles]
    params = cuda_gs.obstacle_params(obs)  # a host read: before the capture
    sweeps = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
    args = (b, x0, pin_mask, pin_target, obs, s.gs_omega, s.gs_max_iters, s.gs_tol)
    xh = cuda_gs.gs_solve(data, *args, sweeps[0], params=params)
    xh2 = cuda_gs.gs_solve(data, *args, sweeps[1], params=params)
    need(bool(torch.isfinite(xh).all()), f"H {label} {dtype_name}: non-finite x")
    kh = int(sweeps[0].item())
    need(bool(torch.equal(xh, xh2)) and kh == int(sweeps[1].item()),
         f"H {label} {dtype_name}: two runs differ")
    xp, kp = gs.solve(data.ell_cols, data.ell_vals, data.diag, data.colors, data.colors_mask, b,
                      x0, pin_mask, pin_target, obs, None, None, s.gs_omega, s.gs_max_iters,
                      s.gs_tol, may_have_dyn=False)
    err = rel_err(xh.double().cpu().numpy(), xp.double().cpu().numpy())
    n = int(b.shape[0])
    out = dict(rel_err=err, sweeps=kh, plain_sweeps=kp, n=n,
               bitwise=bool(torch.equal(xh, xp)), max_abs_err=float((xh - xp).abs().max()),
               colors=int(data.colors.shape[0]), width=int(data.colors.shape[1]),
               form=h_chosen(n, dtype))
    if dtype_name == "f64":
        need(err <= H_F64_TOL and kh == kp, f"H {label} f64: {out} (bound {H_F64_TOL})")
    else:
        need(err <= H_F32_TOL and abs(kh - kp) <= 1, f"H {label} f32: {out} (bound {H_F32_TOL})")
    need(not bitwise or (out["bitwise"] and kh == kp),
         f"H {label} {dtype_name}: not bitwise the plain gs.solve: {out}")
    if DEVICE == "cuda" and any(is_exact(o) for o in obs):
        out["variants"] = {}
        for name, kw in h_variants():
            t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
            xv = cuda_gs.gs_solve(data, *args, t, params=params, **kw)
            need(bool(torch.equal(xv, xh)) and int(t.item()) == kh,
                 f"H {label} {dtype_name}: {name} differs from the chosen run")
            out["variants"][name] = True
    out["forms"] = {}
    for form in h_forms(n, dtype):
        t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        xf = cuda_gs.gs_solve(data, *args, t, params=params, form=form)
        need(bool(torch.equal(xf, xh)) and int(t.item()) == kh,
             f"H {label} {dtype_name}: the {form} form differs from the {out['form']} form")
        out["forms"][form] = dict(bitwise_to_chosen=True, sweeps=kh)
        if graph:
            capture_bitwise(torch, f"H {label} ({form})", lambda t, form=form: cuda_gs.gs_solve(
                data, *args, t, params=params, form=form), xh, kh)
            out["forms"][form]["graph_replay_bitwise"] = True
    if graph:
        out["graph_replay_bitwise"] = True
    return out


def is_exact(obstacle):
    """Whether an obstacle is the port's exact mesh obstacle."""
    from admm_elastic_tpu_torch import PassiveMeshExact

    return isinstance(obstacle, PassiveMeshExact)


def h_variants():
    """(label, gs_solve keywords) of kernel H's exact walk at every group size."""
    from admm_elastic_tpu_torch.ops import cuda_gs

    return [(f"group {g}", dict(group=g)) for g in cuda_gs.GROUPS]


def gs_data_of(torch, system, np_dtype):
    """The GSData Solver builds for linsolver=1 (solver.py), of any system,
    in np_dtype."""
    from admm_elastic_tpu_torch.solvers import gs
    from admm_elastic_tpu_torch.system import assembly

    cols, vals, diag = assembly.assemble_ell(system, dtype=np_dtype)
    groups, gmask = assembly.color_groups(
        assembly.greedy_coloring(assembly.vertex_adjacency(system)))
    return gs.GSData(ell_cols=torch.as_tensor(cols, device=DEVICE),
                     ell_vals=torch.as_tensor(vals, device=DEVICE),
                     diag=torch.as_tensor(diag, device=DEVICE),
                     colors=torch.as_tensor(groups, device=DEVICE),
                     colors_mask=torch.as_tensor(gmask, device=DEVICE))


def h_checks(torch):
    """Kernel H on the card against the plain gs.solve at the GS paths'
    shapes, on a real step's first solve (b and x_bar from the local step at
    the golden's landed state: the bottom face pushed into the obstacle): the
    floor_gs5k beam with its -x face pinned in the dense pin arrays (targets
    5 mm off), float32 and the same inputs widened to float64; the same with a
    Sphere beside the Floor whose top meets the floor plane under the beam
    (both hit: the first of least distance wins); and sphere_gs; each in
    every form that takes it (h_forms), the float32 floor_gs5k case also
    captured and replayed. Then H beyond the SHARED form's reach: the
    floor_uzawa67k beam (15,616 vertices) on its Floor under Gauss-Seidel
    (gs_data_of), float64 (x 375 KB: the GLOBAL form only) and float32 (both
    forms), each bitwise the plain gs.solve. Returns the results and, per
    path, what the timing needs."""
    from admm_elastic_tpu_torch import Floor, Sphere

    out, timing = {}, {}
    for name in ("floor_gs5k", "sphere_gs"):
        solver = landed_solver(torch, name)
        s = solver.m_settings
        b, x0 = first_solve(torch, solver)
        n = x0.shape[0]
        pin_mask = torch.zeros((n,), dtype=torch.bool, device=DEVICE)
        pin_target = torch.zeros_like(x0)
        if name == "floor_gs5k":
            face = np.where(golden(name)["x0"][:, 0] < 1e-9)[0]
            pin_mask[torch.as_tensor(face, device=DEVICE)] = True
            pin_target[pin_mask] = x0[pin_mask] + 0.005
        cases = [(name, list(solver.obstacles))]
        if name == "floor_gs5k":
            cases.append((f"{name} sphere+floor", [Sphere(center=[20.0, -11.0, 2.5], rad=10.0),
                                                   Floor(y=-1.0)]))
        d64 = gs_data64(torch, solver)
        for label, obstacles in cases:
            res = {}
            res["f32"] = h_against_plain(torch, label, solver._solve_data, b, x0, pin_mask,
                                         pin_target, obstacles, s, "f32",
                                         graph=(label == name == "floor_gs5k"
                                                and DEVICE == "cuda"))
            res["f64"] = h_against_plain(torch, label, d64, b.double(), x0.double(), pin_mask,
                                         pin_target.double(), obstacles, s, "f64")
            out[label] = res
            log(f"H {label} ({res['f32']['colors']} colours of at most {res['f32']['width']}): "
                f"f32 {res['f32']['rel_err']:.3e} in {res['f32']['sweeps']} sweeps (plain "
                f"{res['f32']['plain_sweeps']}, bitwise {res['f32']['bitwise']}), f64 "
                f"{res['f64']['rel_err']:.3e} in {res['f64']['sweeps']} sweeps; forms "
                f"{list(res['f32']['forms'])} bitwise equal")
        timing[name] = dict(solver=solver, b=b, x0=x0, pin_mask=pin_mask, pin_target=pin_target,
                            sweeps=out[name]["f32"]["sweeps"],
                            max_abs_err=out[name]["f32"]["max_abs_err"])
    label = "floor_uzawa67k gs"
    solver = landed_solver(torch, "floor_uzawa67k")
    b, x0 = first_solve(torch, solver)
    no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=DEVICE)
    res = {}
    for tag, np_dtype, dtype in (("f32", np.float32, torch.float32),
                                 ("f64", np.float64, torch.float64)):
        data = gs_data_of(torch, solver.system, np_dtype)
        res[tag] = h_against_plain(torch, label, data, b.to(dtype), x0.to(dtype), no_pin,
                                   x0.to(dtype), list(solver.obstacles), solver.m_settings, tag)
        need(res[tag]["bitwise"], f"H {label} {tag}: not bitwise the plain gs.solve on a Floor")
    need(list(res["f64"]["forms"]) == (["global"] if DEVICE == "cuda" else ["plain"]),
         f"H {label} f64: the SHARED form took x")
    out[label] = res
    log(f"H {label} ({res['f32']['colors']} colours of at most {res['f32']['width']}): f32 "
        f"forms {list(res['f32']['forms'])}, f64 forms {list(res['f64']['forms'])}, each "
        f"bitwise the plain gs.solve in {res['f32']['sweeps']} / {res['f64']['sweeps']} sweeps")
    return out, timing


# Kernel H with the mesh obstacles against the plain gs.solve: the 5k slab
# paths at the golden's landed state, the deep crossval scene on its first
# solve (its launch puts the body's bottom 0.24 m into the slab, beyond the
# capture radius of 0.125: the deep fallback), and the near_lanes=4 scenes at
# their step 8, whose colour passes overflow the compaction.
H_MESH_CASES = ("slab_sdf_gs5k", "slab_exact_gs5k", "exactmesh_deep_gs", "sdf_obstacle_gs4",
                "exactmesh_gs4")


def h_mesh_checks(torch):
    """Kernel H with a mesh obstacle (PassiveMeshSDF, PassiveMeshExact) on
    the card against the plain gs.solve, on a real step's first solve of
    H_MESH_CASES: float64 and float32 bitwise, in the same sweeps, every form
    that takes the shape bitwise the chosen one, with an exact obstacle its
    walk at every group size (h_variants), the
    float32 slab_exact_gs5k case also captured and replayed; then a Floor
    beside the exact slab (both obstacles in one sweep; the first of least
    distance). Returns (checks, timing of the mesh paths)."""
    from admm_elastic_tpu_torch import Floor

    out, timing = {}, {}
    for name in H_MESH_CASES:
        solver = (contact_scene(name, torch_api()) if name == "exactmesh_deep_gs"
                  else landed_solver(torch, name))
        s = solver.m_settings
        b, x0 = first_solve(torch, solver)
        no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=DEVICE)
        cases = [(name, list(solver.obstacles))]
        if name == "slab_exact_gs5k":
            cases.append((f"{name} floor+slab", [Floor(y=-1.05)] + list(solver.obstacles)))
        d64 = gs_data64(torch, solver)
        for label, obstacles in cases:
            res = dict(
                f32=h_against_plain(torch, label, solver._solve_data, b, x0, no_pin, x0,
                                    obstacles, s, "f32",
                                    graph=(label == "slab_exact_gs5k" and DEVICE == "cuda"),
                                    bitwise=True),
                f64=h_against_plain(torch, label, d64, b.double(), x0.double(), no_pin,
                                    x0.double(), obstacles, s, "f64", bitwise=True))
            out[label] = res
            log(f"H {label} ({res['f32']['colors']} colours of at most {res['f32']['width']}): "
                f"f32 {res['f32']['rel_err']:.3e} in {res['f32']['sweeps']} sweeps (plain "
                f"{res['f32']['plain_sweeps']}, bitwise {res['f32']['bitwise']}), f64 "
                f"{res['f64']['rel_err']:.3e} in {res['f64']['sweeps']} sweeps; forms "
                f"{list(res['f32']['forms'])} bitwise equal; "
                f"{list(res['f32'].get('variants', {}))} bitwise the chosen run")
        if name in MESH_PATHS:
            timing[name] = dict(solver=solver, b=b, x0=x0, pin_mask=no_pin, pin_target=x0,
                                sweeps=out[name]["f32"]["sweeps"],
                                max_abs_err=out[name]["f32"]["max_abs_err"])
    return out, timing


# Kernel J against its plain version on the card: float64 within
# J_F64_TOL of max(1, max |x|) with the same hit masks; float32 with every
# lane whose hit flips within J_F32_FLIP of dx = 0 (relative to max(1,
# max |x|)) and the other lanes within J_F32_TOL.
J_F64_TOL = 1e-12
J_F32_TOL = 1e-5
J_F32_FLIP = 1e-5
J_STEPS = (1, 12)  # slab_exact_alpcg67k's golden states that J is checked on
# a grid cap for kernel J's block-boundary cases: 15,616 lanes in spans of
# 3,124, the last one short, and the boundary whose near count sets near_lanes
J_CAP = 5
J_BOUNDARY = 2
J_SPREAD_BLOCKS = 4  # the deep lanes spread one a block over this many


def j_blocks(x, blocks=None):
    """The blocks kernel J runs on for x (cuda_obstacle.j_grid on this card,
    capped at blocks); None off the card."""
    from admm_elastic_tpu_torch.ops import cuda_obstacle as co

    if x.device.type != "cuda":
        return None
    return co.j_grid(int(x.shape[0]), co.max_blocks(x.device, x.dtype), blocks)


def j_near_mask(torch, obs, x):
    """The near lanes of an exact obstacle at x (float64, on the CPU): in the
    grid and in a tet-occupied cell, as the compaction ranks them."""
    p = torch.as_tensor(np.asarray(x, np.float64)).reshape(-1, 3)
    o = obs.to("cpu", torch.float64)
    cid, in_grid = o.cells(p)
    return (in_grid & (o.tet_count[cid] > 0)).numpy()


def j_spread_deep(torch, deep, x_deep):
    """(x, blocks): one deep lane of the deep scene's query (more than the
    capture radius inside, so it needs the fallback) at the end of each of
    J_SPREAD_BLOCKS spans of 16 lanes, the other lanes far outside the grid,
    so that the fallback's served lanes lie in more than one block."""
    p = np.asarray(x_deep, np.float64).reshape(-1, 3)
    o = deep.to("cpu", torch.float64)
    d = o.signed_distance(torch.as_tensor(p))[0].numpy()
    lanes = np.flatnonzero(d < -float(o.capture_cells) * float(o.h))
    need(lanes.size >= J_SPREAD_BLOCKS, f"J: {lanes.size} deep lanes in the deep scene's query")
    span = 16
    x = np.tile(o.origin.numpy() - 100.0, (J_SPREAD_BLOCKS * span, 1))
    for b in range(J_SPREAD_BLOCKS):
        x[b * span + span - 1] = p[lanes[b]]
    return x, J_SPREAD_BLOCKS


def mesh_work(torch, obs, x):
    """(lanes evaluated, candidate triangles over them, deep lanes) of a
    detection of mesh obstacle obs at x [V, 3], from the plain version's
    masks: what this run's data needs of kernel J. A deep lane (more than the
    capture radius inside) takes the fallback over the whole soup."""
    from admm_elastic_tpu_torch.collision import passive

    p = x.reshape(-1, 3)
    v, k = p.shape[0], obs.near_lanes
    if isinstance(obs, passive.PassiveMeshSDF):
        base, _ = obs.cells(p)
        near = obs.minv[base] < 0
        return (min(int(near.sum()), k) if 0 < k < v else v), 0, 0
    cid, in_grid = obs.cells(p)
    near = in_grid & (obs.tet_count[cid] > 0)
    sel = torch.arange(v, device=p.device)
    if 0 < k < v:
        sel = passive._first_k(near, k)[:min(int(near.sum()), k)]
    cand = int((obs.face_count[cid[sel]] * in_grid[sel]).sum())
    d = obs.signed_distance(p)[0][sel]
    deep = int((d < -float(obs.capture_cells) * float(obs.h)).sum())
    return int(sel.shape[0]), cand, min(deep, obs.fallback_lanes)


def mesh_bytes_ops(torch, obs, x, itemsize):
    """The bytes kernel J must move (the lanes and the obstacle's tables read
    once, dx, point, normal and the mask written once) and the operations
    this run's data needs of it: some 20 a lane's cell, 120 an SDF blend, 100
    a candidate triangle and as many again for the chosen one's feature, a
    deep lane's pass over the soup."""
    v = x.shape[0]
    tables = sum(t.numel() * t.element_size() for t in
                 (getattr(obs, f) for f in ("vals4", "minv", "tri_abc", "nrm", "face_table",
                                            "face_count", "tet_count") if hasattr(obs, f)))
    nbytes = v * 3 * itemsize + tables + v * 7 * itemsize + v
    ev, cand, deep = mesh_work(torch, obs, x)
    if not hasattr(obs, "tri_abc"):
        return nbytes, 20 * v + 120 * ev
    return nbytes, 20 * v + 100 * (cand + ev) + 100 * deep * (obs.tri_abc.shape[0] + 1)


def j_case(torch, label, obs, x, dtype_name, blocks=None):
    """Kernel J against the plain version at x on the card (its grid capped
    at blocks), twice bitwise, and bitwise the plain version with its
    overflow flag: the comparison's numbers."""
    from admm_elastic_tpu_torch.ops import cuda_obstacle

    dtype = x.dtype
    obs = obs.to(DEVICE, dtype)
    ovf = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
    dk, pk, nk, mk = cuda_obstacle.mesh_detect(obs, x, ovf[0], blocks=blocks)
    dk2, pk2, nk2, _ = cuda_obstacle.mesh_detect(obs, x, ovf[1], blocks=blocks)
    need(all(bool(torch.equal(a, b)) for a, b in ((dk, dk2), (pk, pk2), (nk, nk2)))
         and int(ovf[0].item()) == int(ovf[1].item()), f"J {label} {dtype_name}: two runs differ")
    dp, pp, np_, op = obs.signed_distance_with_overflow(x)
    scale = max(1.0, float(x.abs().max()))
    mp = dp < 0
    flips = (mk != mp)
    keep = ~flips
    err = max(float((dk - dp)[keep].abs().max()) if bool(keep.any()) else 0.0,
              float((pk - pp)[keep].abs().max()) if bool(keep.any()) else 0.0,
              float((nk - np_)[keep].abs().max()) if bool(keep.any()) else 0.0)
    out = dict(lanes=int(x.shape[0]), hits=int(mp.sum()), flips=int(flips.sum()),
               max_abs_err=err, overflow=bool(ovf[0].item()), plain_overflow=bool(op),
               near_lanes=obs.near_lanes, blocks=j_blocks(x, blocks),
               bitwise=bool(torch.equal(dk, dp) and torch.equal(pk, pp)
                            and torch.equal(nk, np_) and torch.equal(mk, mp)))
    need(out["overflow"] == out["plain_overflow"],
         f"J {label} {dtype_name}: overflow {out['overflow']}, plain {out['plain_overflow']}")
    need(out["bitwise"], f"J {label} {dtype_name}: not bitwise the plain version: {out}")
    need(bool(torch.isfinite(dk).all() and torch.isfinite(pk).all() and torch.isfinite(nk).all()),
         f"J {label} {dtype_name}: non-finite output")
    if dtype_name == "f64":
        need(out["flips"] == 0 and err <= J_F64_TOL * scale,
             f"J {label} f64: {out} (bound {J_F64_TOL} of {scale})")
    else:
        flip_dx = float(dp[flips].abs().max()) if out["flips"] else 0.0
        out["flip_max_abs_dx"] = flip_dx
        need(flip_dx <= J_F32_FLIP * scale and err <= J_F32_TOL * scale,
             f"J {label} f32: {out} (bounds {J_F32_TOL}, flips {J_F32_FLIP} of {scale})")
    return out


def kernel_j_checks(torch):
    """Kernel J (csrc/obstacle.cu) against its plain version on the card, in
    float64 and float32: the exact slab of slab_exact_alpcg67k at the golden's
    states of steps 1 and 12 (J_STEPS), compacted as the path runs it
    (near_lanes 2048 over 15,616 lanes) and dense; the SDF slab of
    slab_sdf_gs5k at its step 12, compacted and dense; both with near_lanes=4,
    whose compaction overflows; the deep crossval scene's query at its first
    step's x_bar (0.24 m into the slab: the deep fallback), with the path's
    fallback_lanes and with 2 (the fallback overflows); the grid's ranking
    across blocks: the 67k state on J_CAP blocks (spans that do not divide
    15,616), compacted, dense and with near_lanes at J_BOUNDARY's near count
    and one below it, and four deep lanes one a block (j_spread_deep), served
    and with fallback_lanes 2. Every case bitwise the plain version, twice
    the same bits, the same overflow flag. Returns (checks, timing of the
    67k path's detection)."""
    import dataclasses

    api = torch_api()
    checks, timing = {}, {}
    exact67 = mesh_obstacle(CONTACT_SCENES["slab_exact_alpcg67k"]["obstacle"], api)
    sdf5 = mesh_obstacle(CONTACT_SCENES["slab_sdf_gs5k"]["obstacle"], api)
    deep = mesh_obstacle(CONTACT_SCENES["exactmesh_deep_gs"]["obstacle"], api)
    deep_solver = contact_scene("exactmesh_deep_gs", api)
    _, x_deep = first_solve(torch, deep_solver)
    queries = [(f"slab_exact_alpcg67k@{k}", exact67, golden("slab_exact_alpcg67k")[f"x{k}"])
               for k in J_STEPS]
    queries.append(("slab_sdf_gs5k@12", sdf5, golden("slab_sdf_gs5k")["x12"]))
    cases = []
    for label, obs, x in queries:
        cases += [(label, obs, x), (f"{label} dense", dataclasses.replace(obs, near_lanes=0), x),
                  (f"{label} near4", dataclasses.replace(obs, near_lanes=4), x)]
    xd = x_deep.double().cpu().numpy()
    cases += [("exactmesh_deep_gs x_bar", deep, xd),
              ("exactmesh_deep_gs x_bar fallback2", dataclasses.replace(deep, fallback_lanes=2), xd)]
    cases = [c + (None,) for c in cases]
    # the multi-block ranking: a capped grid whose spans do not divide the
    # lanes, near_lanes at a block boundary's near count and one below it, the
    # dense form, and the deep fallback's served lanes in several blocks
    x12 = golden("slab_exact_alpcg67k")["x12"]
    edge = int(j_near_mask(torch, exact67, x12)[:J_BOUNDARY * -(-len(x12) // J_CAP)].sum())
    cases += [(f"slab_exact_alpcg67k@12 blocks{J_CAP}", exact67, x12, J_CAP),
              (f"slab_exact_alpcg67k@12 blocks{J_CAP} dense",
               dataclasses.replace(exact67, near_lanes=0), x12, J_CAP)]
    cases += [(f"slab_exact_alpcg67k@12 blocks{J_CAP} near{k}",
               dataclasses.replace(exact67, near_lanes=k), x12, J_CAP) for k in (edge, edge - 1)]
    xs, nb = j_spread_deep(torch, deep, xd)
    cases += [(f"exactmesh_deep_gs spread blocks{nb}", dataclasses.replace(deep, near_lanes=0),
               xs, nb),
              (f"exactmesh_deep_gs spread blocks{nb} fallback2",
               dataclasses.replace(deep, near_lanes=0, fallback_lanes=2), xs, nb)]
    for label, obs, x, blocks in cases:
        res = {}
        for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            xt = torch.as_tensor(np.asarray(x, np.float64)).to(DEVICE, dtype)
            res[dname] = j_case(torch, label, obs, xt, dname, blocks=blocks)
        checks[label] = res
        log(f"J {label}: {res['f64']['lanes']} lanes on {res['f64']['blocks']} / "
            f"{res['f32']['blocks']} blocks, {res['f64']['hits']} hits, overflow "
            f"{res['f64']['overflow']}; f64 {res['f64']['max_abs_err']:.3e} (bitwise "
            f"{res['f64']['bitwise']}), f32 {res['f32']['max_abs_err']:.3e} with "
            f"{res['f32']['flips']} flips (bitwise {res['f32']['bitwise']})")
    need(checks["slab_exact_alpcg67k@12"]["f64"]["hits"] > 0, "J: no hit on the 67k path's state")
    need(all(checks[f"{q[0]} near4"]["f64"]["overflow"] for q in queries),
         "J: near_lanes=4 did not overflow")
    need(checks["exactmesh_deep_gs x_bar fallback2"]["f64"]["overflow"]
         and not checks["exactmesh_deep_gs x_bar"]["f64"]["overflow"],
         "J: the deep fallback's capacity did not decide its overflow")
    need(checks[f"exactmesh_deep_gs spread blocks{nb} fallback2"]["f64"]["overflow"]
         and not checks[f"exactmesh_deep_gs spread blocks{nb}"]["f64"]["overflow"],
         "J: the spread deep lanes' overflow")
    need(all(checks[f"slab_exact_alpcg67k@12 blocks{J_CAP} near{k}"]["f64"]["overflow"]
             for k in (edge, edge - 1)), "J: near_lanes at a block boundary did not overflow")
    for k in J_STEPS:
        label = f"slab_exact_alpcg67k@{k}"
        timing[label] = dict(obs=exact67, x=golden("slab_exact_alpcg67k")[f"x{k}"],
                             max_abs_err=checks[label]["f32"]["max_abs_err"])
        timing[f"{label} dense"] = dict(obs=dataclasses.replace(exact67, near_lanes=0),
                                        x=timing[label]["x"],
                                        max_abs_err=checks[f"{label} dense"]["f32"]["max_abs_err"])
    return checks, timing


def kernel_j_times(torch, j_timing, gpu):
    """Kernel J per launch on the 67k path's detections (float32, its
    compacted and its dense form): torch.profiler's device time (else queued
    CUDA events), CUDA events, the plain version on the card, the bound; no
    library call computes a mesh obstacle's narrow phase (library_ms null)."""
    from admm_elastic_tpu_torch.ops import cuda_obstacle

    out = {}
    for label, t in j_timing.items():
        x = torch.as_tensor(np.asarray(t["x"], np.float64)).to(DEVICE, torch.float32)
        obs = t["obs"].to(DEVICE, torch.float32)
        ovf = torch.zeros((1,), dtype=torch.int32, device=DEVICE)

        def kern():
            return cuda_obstacle.mesh_detect(obs, x, ovf)

        def plain():
            return obs.signed_distance_with_overflow(x)

        p1, k1, k2, p2 = (events_ms(torch, plain, 2), events_ms(torch, kern, 20),
                          events_ms(torch, kern, 20), events_ms(torch, plain, 2))
        queued = queued_us(torch, [("kernel", kern)], 10)["kernel"] * 1e-3
        prof_ms, ms = profiler_or_queued(torch, kern, "mesh_detect_kernel", queued)
        nbytes, ops = mesh_bytes_ops(torch, obs, x, 4)
        bound_ms, bound_by = bound_of(nbytes, ops)
        ev, cand, deep = mesh_work(torch, obs, x)
        out[f"mesh_detect@{label}"] = dict(
            ms=ms, profiler_ms=prof_ms, events_ms=min(k1, k2), queued_ms=queued,
            plain_ms=min(p1, p2), readings=[p1, k1, k2, p2], lanes=int(x.shape[0]),
            evaluated=ev, candidates=cand, deep=deep, near_lanes=obs.near_lanes, bytes=nbytes,
            operations=ops, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=t["max_abs_err"], blocks=j_blocks(x))
        v = out[f"mesh_detect@{label}"]
        log(f"time mesh_detect@{label}: {ms * 1e3:.1f} us per launch on the device "
            f"({'torch.profiler' if prof_ms is not None else 'queued CUDA events'}; "
            f"{v['events_ms'] * 1e3:.1f} by CUDA events), {ev} lanes evaluated, {cand} "
            f"candidates, {v['blocks']} blocks; plain {v['plain_ms'] * 1e3:.1f} us; library "
            f"none; bound {bound_ms * 1e3:.3f} us by {bound_by} [{gpu}]")
    return out


def gpen_inputs(torch, solver, dtype):
    """(hits, ck, b, x0, y) of the solver's next first global solve in dtype:
    the passive hits at x_bar (a float64 run detects on x_bar widened)."""
    import dataclasses

    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.collision.passive import detect_passive

    b, x0 = first_solve(torch, solver)
    b, x0 = b.to(dtype), x0.to(dtype)
    c = solver._contact
    obs = [o.to(DEVICE, dtype) for o in solver.obstacles]
    _, point, normal, mask, _ = detect_passive(obs, x0)
    hits = dataclasses.replace(con.empty_hits(c.surf, dtype, dense=c.dense, may_dyn=False),
                               p_mask=mask, p_normal=normal, p_point=point)
    y = torch.zeros((2 * hits.capacity,), dtype=dtype, device=DEVICE)
    return hits, c.ck.to(dtype), b, x0, y


def gpen_against_plain(torch, label, data, hits, ck, b, x0, y, s, dtype_name, graph=False):
    """Kernel G's penalty form (alcg.solve on the card) against the plain
    alcg.solve_plain on the same inputs; twice bitwise; every form that takes
    the shape (g_forms) bitwise equal to the one the wrapper chooses, in as
    many trips; with graph, each form captured and replayed bitwise."""
    from admm_elastic_tpu_torch.solvers import alcg

    trips = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
    xg, yg = alcg.solve(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters, trips[0])
    xg2, _ = alcg.solve(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters, trips[1])
    kg = int(trips[0].item())
    need(bool(torch.isfinite(xg).all()), f"G penalty {label} {dtype_name}: non-finite x")
    need(bool(torch.equal(xg, xg2)) and kg == int(trips[1].item()),
         f"G penalty {label} {dtype_name}: two runs differ")
    xp, yp, kp = alcg.solve_plain(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters)
    err = rel_err(xg.double().cpu().numpy(), xp.double().cpu().numpy())
    out = dict(rel_err=err, trips=kg, plain_trips=kp, n=data.n,
               hits=int(hits.p_mask.sum().item()), max_abs_err=float((xg - xp).abs().max()),
               y_rel_err=rel_err(yg.double().cpu().numpy(), yp.double().cpu().numpy()))
    if dtype_name == "f64":
        need(err <= PCG_F64_TOL and kg == kp, f"G penalty {label} f64: {out}")
    else:
        need(err <= PCG_F32_TOL and abs(kg - kp) <= GPEN_F32_TRIPS,
             f"G penalty {label} f32: {out}")
    # every form of G's penalty form on the solve alcg.solve hands it
    from admm_elastic_tpu_torch.ops import cuda_pcg

    _, b_hat, pen_diag, _ = alcg._setup(hits, ck, b, y)
    pn = alcg.penalty_vectors(hits, ck, b.shape[0])
    out["form"] = g_blocks(data, b.dtype)[0]
    out["forms"] = {}
    for form in g_forms(data, b.dtype):
        def solve(t, form=form):
            return cuda_pcg.pcg_solve_penalty(data, b_hat, x0, s.pcg_tol, s.pcg_max_iters, t, pn,
                                              pen_diag, form=form)

        t = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        xf = solve(t)
        need(bool(torch.equal(xf, xg)) and int(t.item()) == kg,
             f"G penalty {label} {dtype_name}: the {form} form differs from the {out['form']} "
             "form")
        out["forms"][form] = dict(bitwise_to_chosen=True, trips=kg)
        if graph:
            capture_bitwise(torch, f"G penalty {label} ({form})", solve, xg, kg)
            out["forms"][form]["graph_replay_bitwise"] = True
    if graph:
        out["graph_replay_bitwise"] = True
    return out


def gpen_checks(torch):
    """Kernel G's penalty form on the card against alcg.solve_plain at
    floor_alpcg67k's shapes (15,616 vertices) on a real step's first solve at
    the golden's landed state (some 900 floor hits): the path's Jacobi form
    (the dense surface: the JAX package's solve_T form) and a two-grid form
    of the same system (the JAX package's general form, with C^T C), each in
    float32 and widened to float64; the unpenalized G on Uzawa's inner solve
    (floor_uzawa67k) is held by uzawa_inner_checks. Returns the results and
    what the timing needs."""
    from admm_elastic_tpu_torch.solvers import pcg

    out = {}
    solver = landed_solver(torch, "floor_alpcg67k")
    s = solver.m_settings
    timing = {}
    for pre in ("jacobi", "twogrid"):
        d32 = (solver._solve_data if pre == s.pcg_precond
               else pcg.prepare(solver.system, torch.float32, precond=pre))
        d64 = pcg.prepare(solver.system, torch.float64, precond=pre)
        res = {}
        for dtype, tag, data in ((torch.float32, "f32", d32), (torch.float64, "f64", d64)):
            hits, ck, b, x0, y = gpen_inputs(torch, solver, dtype)
            res[tag] = gpen_against_plain(torch, f"floor_alpcg67k {pre}", data, hits, ck, b, x0,
                                          y, s, tag, graph=(tag == "f32" and pre == "jacobi"
                                                            and DEVICE == "cuda"))
            if tag == "f32" and pre == s.pcg_precond:
                timing["floor_alpcg67k"] = dict(solver=solver, data=data, hits=hits, ck=ck, b=b,
                                                x0=x0, y=y, trips=res[tag]["trips"],
                                                max_abs_err=res[tag]["max_abs_err"])
        out[pre] = res
        log(f"G penalty floor_alpcg67k {pre} ({res['f32']['hits']} hits): f32 "
            f"{res['f32']['rel_err']:.3e} in {res['f32']['trips']} trips (plain "
            f"{res['f32']['plain_trips']}), f64 {res['f64']['rel_err']:.3e} in "
            f"{res['f64']['trips']} trips (plain {res['f64']['plain_trips']})")
    return out, timing


def contact_counts(name, iters, admm_iters=10):
    """The launches of each port kernel that a contact path's replays make in
    `iters` ADMM iterations (0 for one they must not launch), and the
    kernels that must launch. An Anderson path (VARIANT_SCENES) launches A's
    rows entry in place of its stencil entry, and the standalone B once per
    iteration and once more per step."""
    base, change, _ = variant_of(name)
    p = CONTACT_SCENES[base]
    model = p["model"]
    if change.get("aa_window") and p["ls"] == 4:
        counts = {f"local_step_tet_hyper[{model}]": iters, f"local_step_tet_stencil[{model}]": 0,
                  "gs_solve": 0, "pcg_solve": 0, "pcg_solve_penalty": iters,
                  "tet_rhs_rows": iters, "tet_Dx_rows": iters + iters // admm_iters,
                  "mesh_detect": 0}
        return counts, [f"local_step_tet_hyper[{model}]", "tet_Dx_rows", "tet_rhs_rows",
                        "pcg_solve_penalty"]
    applies = 1 + CONTACT_MAX_UZAWA  # Uzawa: the first A^-1 and every predicated trip's
    # kernel J: once per ADMM iteration where a contact solver (Uzawa, AL-PCG)
    # detects a mesh obstacle; Gauss-Seidel detects inside kernel H
    mesh = "obstacle" in p and p["ls"] != 1
    counts = {f"local_step_tet_stencil[{model}]": iters, f"local_step_tet_hyper[{model}]": 0,
              "gs_solve": 0, "pcg_solve": 0, "pcg_solve_penalty": 0,
              "mesh_detect": iters if mesh else 0, "ct_apply": 0, "schur_trip": 0}
    kernels = [f"local_step_tet_stencil[{model}]", "tet_rhs_rows"] + (["mesh_detect"] if mesh else [])
    if p["ls"] == 1:
        counts.update(gs_solve=iters, tet_rhs_rows=iters, tet_Dx_rows=0)
        kernels.append("gs_solve")
    elif p["ls"] == 4:
        counts.update(pcg_solve_penalty=iters, tet_rhs_rows=iters, tet_Dx_rows=0)
        kernels.append("pcg_solve_penalty")
    elif p["dims"] == (60, 15, 15):  # Uzawa around kernel G
        counts.update(pcg_solve=applies * iters, tet_rhs_rows=iters, tet_Dx_rows=0)
        kernels.append("pcg_solve")
    else:  # Uzawa around the direct solve: each apply refines once through A_mv (B, C)
        counts.update(tet_rhs_rows=(1 + applies) * iters, tet_Dx_rows=applies * iters)
        kernels.append("tet_Dx_rows")
    if p["ls"] == 2:  # every apply's C^T is kernel L's launch, every trip's update M
        counts.update(ct_apply=applies * iters, schur_trip=CONTACT_MAX_UZAWA * iters)
        kernels += ["ct_apply", "schur_trip"]
    return counts, kernels


CONTACT_MAX_UZAWA = 10  # uzawa_max_iters of the matrix scenes (benchmarks/matrix.py:47-51)


def contact_path(torch, name):
    """One of CONTACT_PATHS through the normal entry points
    (chip_smoke.contact_scene), 20 steps (sphere_gs 40) through the captured
    step against its golden under CONTACT_STEP_TOL / CONTACT_DISP_TOL at
    steps 1, 12 and 20 (the sphere 1, 16, 40): the launches of contact_counts
    on the device, the graph bitwise equal to the eager loop; the vertices in
    contact (> 0 after landing), no tunnelling (min y > -1.1, bench.py:67; the
    sphere: min distance > 10 - 0.05, tests/test_contact.py:404-406); then each
    step's inner iterations (step(), the step's device counter) beside the JAX
    package's, and the device operations per iteration of one replayed step.
    An Anderson path (floor_alpcg67k_aa4) is held under its base path's
    bounds, with the base's device operations beside its own."""
    base = variant_of(name)[0]
    p = CONTACT_SCENES[base]
    solver = contact_scene(name, torch_api())
    g = golden(name)
    s = solver.m_settings
    need(s.linsolver == int(g["linsolver"])
         and type(solver._solve_data).__name__ == str(g["uzawa_inner"]),
         f"{name}: the solver's global step differs from the golden's")
    need(p["ls"] != 2 or s.uzawa_max_iters == CONTACT_MAX_UZAWA, f"{name}: uzawa_max_iters")
    compared = [int(k) for k in g["steps"]]
    iters = compared[-1] * s.admm_iters
    counts, kernels = contact_counts(name, iters, s.admm_iters)
    state0 = solver.state.clone()
    x0, x_last, res = drive_path(torch, name, solver, g, [], kernels, model=p["model"],
                                 step_counts=counts, tols=CONTACT_STEP_TOL[base],
                                 disp_bound=CONTACT_DISP_TOL[base])
    xs = drive_path.xs
    need(p["ls"] != 2 or res["graph_vs_eager"]["bitwise"],
         f"{name}: the Uzawa graph rollout is not bitwise the eager loop")
    touching = [contacts(name, xs[k]) for k in compared]
    need(all(t > 0 for t in touching[1:]), f"{name}: no contact after landing: {touching}")
    if p.get("sphere"):
        d = np.linalg.norm(x_last - np.asarray(SPHERE_CENTER), axis=1)
        need(d.min() > SPHERE_RAD - 0.05, f"{name}: into the sphere: {d.min()}")
        res["min_distance"] = float(d.min())
    else:
        # no tunnelling: 10 cm below the floor's or the slab's top face
        # (bench.py:67); where the JAX package's own run goes deeper (Anderson's
        # extrapolation at landing, its golden: -1.119 at step 12, -1.009 at
        # 20; a body launched into a slab), no deeper than it by a centimetre,
        # and (Anderson) out by the end
        bottom = obstacle_top(name) - 0.1
        jax_min = min(float(g[f"x{k}"][:, 1].min()) for k in compared)
        need(min(x[:, 1].min() for x in xs.values()) > min(bottom, jax_min - 0.01)
             and (base == name or x_last[:, 1].min() > bottom), f"{name}: through the floor")
        res["jax_min_y"] = jax_min
    res["min_y"] = float(min(x[:, 1].min() for x in xs.values()))
    solver.state = state0.clone()
    inner, overflow = [], []
    for _ in range(compared[-1]):
        solver.step()
        inner.append(solver.runtime_data().inner_iters)
        overflow.append(solver.runtime_data().collision_overflow)
    if "overflow" in g.files:
        need(overflow == g["overflow"].tolist(),
             f"{name}: collision_overflow {overflow}, the JAX package's {g['overflow'].tolist()}")
    res["collision_overflow"] = overflow
    # before contact AL-PCG's warm start can leave a solve no trip, as in the
    # JAX package; from the landing step on every step iterates
    need(all(k > 0 for k in inner[compared[1] - 1:]),
         f"{name}: a step after landing took no inner iteration: {inner}")
    res.update(contacts=touching, jax_contacts=g["contacts"].tolist(),
               active_rows=int(solver.state.prev_active.sum().item()),
               inner_per_step=inner, jax_inner_per_step=g["inner"].tolist())
    if base != name:
        plain = contact_scene(base, torch_api())
        plain.run(LANDING_STEP)
        solver.state = state0.clone()
        solver.run(LANDING_STEP)
        res.update(variant_device_ops(torch, solver, plain))
    else:
        res["device"] = device_ops(torch, lambda: solver.run(1), s.admm_iters)
    log(f"{name}: contacts {touching} (the JAX package's {g['contacts'].tolist()}), inner "
        f"iterations per step {inner} (the JAX package's {g['inner'].tolist()}); device per "
        f"iteration {json.dumps(res['device'])}")
    return solver, res


# --- self-collision (ROADMAP Queue 1 item 10): kernels K, L, H[DYN], G[DYN] ----

# The paths against their goldens: (step 1, the later held steps) relative to
# max |x|, and the displacement bound, some 3-7 times the gaps the card showed
# (PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W): GS 1.2e-5 / 8.0e-4 /
# 1.6e-3 (boxes_gs20 1.7e-5 / 8.8e-4 / 1.4e-3); Uzawa 6.0e-5 / - / 7.9e-3 at
# step 1, AL-PCG 0 / - / 0. Uzawa's and AL-PCG's trajectories are held at step
# 1 only (None): from the landing on the JAX package parts from itself in one
# step as far as the port parts from it. Each golden holds a control, the held
# step once more from the state before it with x one ulp up
# (tests/make_torch_golden.py): boxes_uzawa8's step 9 parts by 1.0e-2 of max
# |x| with 50 hits for 128, boxes_alpcg8's step 6 by 1.9e-2 with 62 hits for
# 128 and 355 PCG trips for 267, where GS's part by 8.1e-6. Every path's held
# steps after the first are held one step at a time instead (SELFCOLL_ONESTEP).
SELFCOLL_STEP_TOL = {"boxes_gs8": (1e-4, 1e-2), "boxes_uzawa8": (2e-4, None),
                     "boxes_alpcg8": (1e-4, None), "boxes_gs20": (1e-4, 1e-2)}
SELFCOLL_DISP_TOL = {"boxes_gs8": 0.02, "boxes_uzawa8": 0.03, "boxes_alpcg8": 0.02,
                     "boxes_gs20": 0.02}
# Each held step after the first, one step (the captured step, run(1)) from
# the golden's state before it: x against the golden's under the first bound
# (relative to max |x|) and its dynamic hits against the golden's under the
# second. The x bounds are 3-4 times the largest one-step gap of the port (on
# the card, PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W; on the CPU) and of
# the golden's one-ulp control: boxes_gs8 7.7e-6 / 5.4e-6 / 8.1e-6,
# boxes_uzawa8 1.006e-2 / 1.006e-2 / 1.007e-2, boxes_alpcg8 9.2e-4 / 1.8e-2
# / 1.9e-2, boxes_gs20 5.1e-6 / - / 7.4e-6. The hit bounds: the control's
# hits part from the golden's by 78 of 128 (boxes_uzawa8 step 9; the port's
# by 85) and 66 of 128 (boxes_alpcg8 step 6; the port's by 0), each bound below
# the count; GS's by none.
SELFCOLL_ONESTEP = {"boxes_gs8": (3e-5, 8), "boxes_uzawa8": (3e-2, 100),
                    "boxes_alpcg8": (6e-2, 96), "boxes_gs20": (3e-5, 24)}
# The dynamic hits at a held step of the port's own run may differ from the
# JAX package's by this many where its trajectory is held (from the same
# runs: GS 0 and 5 of 887); the hits of the port's detection at the golden's
# own states by GOLDEN_HITS_TOL (float32: a barycentric within rounding of 0),
# and its first step with a dynamic hit by one step.
SELFCOLL_HITS_BOUND = {"boxes_gs8": 8, "boxes_uzawa8": 0, "boxes_alpcg8": 0, "boxes_gs20": 24}
GOLDEN_HITS_TOL = 2
TUNNEL_MARGIN = 0.02  # m: the top box may sink this much deeper into the bottom one than
# the JAX package's run lets it (the boxes are 1 m)
K_CASES_FOLD = 8  # tests/test_broadphase.py's folded block


def dyn_hits(solver, x):
    """The dynamic hits of the solver's query vertices at x (numpy or a
    tensor): its detection without the passive rows (kernel K on the card)."""
    import torch

    xt = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    xt = xt.to(device=solver.device, dtype=solver.state.x.dtype)
    return int(solver._detect(xt, with_passive=False).d_mask.sum().item())


def selfcoll_counts(name, iters, s):
    """The launches of each port kernel that a self-collision path's replays
    make in `iters` ADMM iterations (0 for one they must not launch), and the
    kernels that must launch: each box is a family of its own (the local step
    and the rhs twice an iteration) and a collider of its own (K once a
    detection, over both colliders, once per ADMM iteration); L's standalone
    gather twice a solve (C^T c and diag(C^T C)) for GS and AL-PCG; for Uzawa
    L's full C^T once per A^-1 apply (C^T of y, then of each Schur direction)
    and M once per trip, and no standalone gather; Uzawa's direct applies
    refine once through A_mv (B and C per family)."""
    ls = SELFCOLL_SCENES[name]["ls"]
    fam = 2
    model = "linear"
    counts = {f"local_step_tet_stencil[{model}]": fam * iters,
              f"local_step_tet_hyper[{model}]": 0, "gs_solve": 0, "pcg_solve": 0,
              "pcg_solve_penalty": 0, "mesh_detect": 0, "dyn_detect": iters,
              "gs_solve_dyn": 0, "pcg_solve_dyn": 0, "ct_apply": 0, "schur_trip": 0}
    kernels = [f"local_step_tet_stencil[{model}]", "tet_rhs_rows", "dyn_detect"]
    if ls == 1:
        counts.update(gs_solve_dyn=iters, dyn_gather=2 * iters, tet_rhs_rows=fam * iters,
                      tet_Dx_rows=0)
        kernels += ["gs_solve_dyn", "dyn_gather"]
    elif ls == 4:
        counts.update(pcg_solve_dyn=iters, dyn_gather=2 * iters, tet_rhs_rows=fam * iters,
                      tet_Dx_rows=0)
        kernels += ["pcg_solve_dyn", "dyn_gather"]
    else:
        applies = 1 + s.uzawa_max_iters
        counts.update(dyn_gather=0, ct_apply=applies * iters,
                      schur_trip=s.uzawa_max_iters * iters,
                      tet_rhs_rows=fam * (1 + applies) * iters, tet_Dx_rows=fam * applies * iters)
        kernels += ["tet_Dx_rows", "ct_apply", "schur_trip"]
    return counts, kernels


def box_gap(x, n_box):
    """The top box's lowest y less the bottom box's highest."""
    return float(x[n_box:, 1].min() - x[:n_box, 1].max())


def selfcoll_path(torch, name):
    """One of SELFCOLL_PATHS through the normal entry points (boxes_scene),
    its steps through the captured step against its golden under
    SELFCOLL_STEP_TOL / SELFCOLL_DISP_TOL at the held steps (1, the first with
    a dynamic hit, the last): the launches of selfcoll_counts on the device,
    the graph bitwise equal to the eager loop; the dynamic hits at each held
    step beside the JAX package's (SELFCOLL_HITS_BOUND), those of the golden's
    own states (GOLDEN_HITS_TOL), the first step with a hit (one step apart at
    most); no tunnelling (the top box no deeper into the bottom one than the
    JAX package's run by TUNNEL_MARGIN, the floor held 0.1 m); each step's
    collision_overflow equal to the JAX package's and its inner iterations
    beside them; the device operations per iteration."""
    p = SELFCOLL_SCENES[name]
    solver, n_box = boxes_scene(name, torch_api())
    g = golden(name)
    s = solver.m_settings
    need(s.linsolver == int(g["linsolver"]) and int(g["n_box"]) == n_box
         and type(solver._solve_data).__name__ == str(g["uzawa_inner"]),
         f"{name}: the solver differs from the golden's")
    compared = [int(k) for k in g["steps"]]
    iters = compared[-1] * s.admm_iters
    counts, kernels = selfcoll_counts(name, iters, s)
    state0 = solver.state.clone()
    x0, x_last, res = drive_path(torch, name, solver, g, [], kernels, model="linear",
                                 step_counts=counts, tols=SELFCOLL_STEP_TOL[name],
                                 disp_bound=SELFCOLL_DISP_TOL[name])
    xs = drive_path.xs
    need(p["ls"] != 2 or res["graph_vs_eager"]["bitwise"],
         f"{name}: the Uzawa graph rollout is not bitwise the eager loop")
    jh = [int(h) for h in g["hits"]]
    hits = {k: dyn_hits(solver, xs[k]) for k in compared}
    at_golden = {k: dyn_hits(solver, g[f"x{k}"]) for k in compared}
    bound = SELFCOLL_HITS_BOUND[name]
    held = compared if SELFCOLL_STEP_TOL[name][1] is not None else compared[:1]
    for k in compared:
        need(k not in held or abs(hits[k] - jh[k - 1]) <= bound,
             f"{name} step {k}: {hits[k]} dynamic hits, the JAX package's {jh[k - 1]} "
             f"(bound {bound})")
        need(abs(at_golden[k] - jh[k - 1]) <= GOLDEN_HITS_TOL,
             f"{name} step {k}: {at_golden[k]} dynamic hits at the golden's state, the JAX "
             f"package's {jh[k - 1]}")
    gaps = {k: box_gap(xs[k], n_box) for k in compared}
    jax_gap = min(box_gap(g[f"x{k}"], n_box) for k in compared)
    floor_min = min(float(x[:, 1].min()) for x in xs.values())
    need(min(gaps.values()) > min(jax_gap, 0.0) - TUNNEL_MARGIN,
         f"{name}: the top box tunnels into the bottom one: gaps {gaps}, the JAX package's "
         f"least {jax_gap}")
    need(floor_min > BOXES_FLOOR - 0.1, f"{name}: through the floor ({floor_min})")
    solver.state = state0.clone()
    inner, overflow, step_hits = [], [], []
    for _ in range(compared[-1]):
        solver.step()
        inner.append(solver.runtime_data().inner_iters)
        overflow.append(solver.runtime_data().collision_overflow)
        step_hits.append(dyn_hits(solver, solver.state.x))
    need(overflow == g["overflow"].tolist(),
         f"{name}: collision_overflow {overflow}, the JAX package's {g['overflow'].tolist()}")
    first = next((k + 1 for k, h in enumerate(step_hits) if h > 0), None)
    need(first is not None and abs(first - compared[1]) <= 1,
         f"{name}: first dynamic hit at step {first}, the JAX package's at {compared[1]} "
         f"(hits per step {step_hits})")
    one = selfcoll_one_steps(torch, solver, name, g, compared[1:])
    res.update(one_step=one, dynamic_hits={str(k): v for k, v in hits.items()},
               dynamic_hits_at_golden={str(k): v for k, v in at_golden.items()},
               dynamic_hits_per_step=step_hits, jax_hits_per_step=jh,
               jax_dynamic_hits={str(k): jh[k - 1] for k in compared},
               box_gap={str(k): v for k, v in gaps.items()}, jax_least_box_gap=jax_gap,
               min_y=floor_min, collision_overflow=overflow, inner_per_step=inner,
               jax_inner_per_step=g["inner"].tolist(),
               device=device_ops(torch, lambda: solver.run(1), s.admm_iters))
    log(f"{name}: dynamic hits {hits} (the JAX package's {res['jax_dynamic_hits']}; at the "
        f"golden's states {at_golden}), per step {step_hits} (the JAX package's {jh}), box gaps "
        f"{ {k: round(v, 4) for k, v in gaps.items()} } (the JAX package's least "
        f"{jax_gap:.4f}), inner iterations per step {inner} (the JAX package's "
        f"{g['inner'].tolist()}), overflow {overflow}; device per iteration "
        f"{json.dumps(res['device'])}")
    return solver, res


def selfcoll_one_steps(torch, solver, name, g, steps):
    """Each of `steps` one step (run(1), the captured step) from the golden's
    state before it (s{k}_x, _v, _y, _prev_active): x against the golden's
    x{k} and the dynamic hits against the golden's under SELFCOLL_ONESTEP,
    beside the golden's own one-ulp control (ctl{k}_gap, _hits, _inner)."""
    x_tol, hit_tol = SELFCOLL_ONESTEP[name]
    st0 = solver.state
    out = {}
    for k in steps:
        solver.state = type(st0)(**{f: torch.as_tensor(g[f"s{k}_{f}"], device=DEVICE)
                                    for f in ("x", "v", "y", "prev_active")})
        solver.run(1)
        x = solver.x
        gap = rel_err(x, g[f"x{k}"])
        h = dyn_hits(solver, solver.state.x)
        jh = int(g["hits"][k - 1])
        out[str(k)] = dict(rel_err=gap, hits=h, jax_hits=jh,
                           inner=solver.runtime_data().inner_iters, jax_inner=int(g["inner"][k - 1]),
                           control_rel_err=float(g[f"ctl{k}_gap"]),
                           control_hits=int(g[f"ctl{k}_hits"]),
                           control_inner=int(g[f"ctl{k}_inner"]))
        log(f"{name} step {k} one step from the golden's state: {gap:.3e} of max |x| (bound "
            f"{x_tol}; the JAX package's one-ulp control {float(g[f'ctl{k}_gap']):.3e}), {h} "
            f"dynamic hits (the golden's {jh}, bound {hit_tol}; the control's "
            f"{int(g[f'ctl{k}_hits'])})")
        need(np.isfinite(x).all() and gap <= x_tol and abs(h - jh) <= hit_tol,
             f"{name} step {k}: one step from the golden's state off it: {out[str(k)]}")
    solver.state = st0
    return out


def golden_state_solver(torch, name, step):
    """A self-collision path's solver (float32, on the card) at its golden's
    x after `step`, v = 0."""
    import dataclasses

    solver, _ = boxes_scene(name, torch_api())
    x = torch.as_tensor(golden(name)[f"x{step}"], device=DEVICE, dtype=torch.float32)
    solver.state = dataclasses.replace(solver.state, x=x, v=torch.zeros_like(x))
    return solver


def folded_case(torch, n, fold=True):
    """tests/test_broadphase.py's block folded onto itself (at rest where not
    fold): (colliders, x, surf) in float64 on DEVICE."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.geometry.mesh import surface_vertex_indices

    mesh = make_tet_blocks(n, n, n)
    x = mesh.vertices.astype(np.float64).copy()
    if fold:
        x[:, 0] = np.abs(x[:, 0] - n / 2 - 0.2) * 0.9
    col = dyn.make_tet_mesh_collider(mesh.vertices, mesh.tets, mesh.faces, 0)
    return ([col.to(DEVICE, torch.float64)], torch.as_tensor(x, device=DEVICE),
            torch.as_tensor(surface_vertex_indices(mesh.tets), device=DEVICE))


def tile_case(torch, drop=0):
    """Kernel K's dense tiles (float64 tiles of 1,024 tets, float32 of 2,048)
    at their edges: an 8^3 block (2,560 tets, less the last `drop`) at rest,
    collider 0, and a 2^3 block, collider 1, whose 27 vertices lie at the
    centroids of the first block's tets at each tile's first and last index
    and at the last, and at vertices of the first block whose tets lie on
    both sides of a tile boundary (the lowest of them is the pick); the
    query vertices the second block's and the first one's surface. (cols,
    x, surf) in float64 on DEVICE."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.geometry.mesh import surface_vertex_indices

    big, small = make_tet_blocks(8, 8, 8), make_tet_blocks(2, 2, 2)
    tets = big.tets[:len(big.tets) - drop]
    nt, nv = len(tets), len(big.vertices)
    x_big = big.vertices.astype(np.float64)
    picks = [0, 31, 32, 1023, 1024, 2047, 2048, nt - 33, nt - 32, nt - 1]
    pts = [x_big[tets[t]].mean(axis=0) for t in picks]
    for edge in (1024, 2048):  # vertices with tets on both sides of a boundary
        lo = set(tets[max(edge - 64, 0):edge].reshape(-1)) & set(tets[edge:edge + 64].reshape(-1))
        pts += [x_big[v] for v in sorted(lo)[:4]]
    rng = np.random.default_rng(15)
    while len(pts) < len(small.vertices):
        pts.append(x_big[tets[rng.integers(nt)]].mean(axis=0))
    x = np.concatenate([x_big, np.asarray(pts[:len(small.vertices)])])
    cols = [dyn.make_tet_mesh_collider(big.vertices, tets, big.faces, 0),
            dyn.make_tet_mesh_collider(small.vertices, small.tets, small.faces, nv)]
    surf = np.concatenate([np.arange(nv, nv + len(small.vertices)), surface_vertex_indices(tets)])
    return ([c.to(DEVICE, torch.float64) for c in cols], torch.as_tensor(x, device=DEVICE),
            torch.as_tensor(surf, device=DEVICE))


def three_case(torch):
    """Three 4^3 blocks, each a collider, shifted 0.3 apart in x and 0.2 in y,
    so that a vertex lies in the tets of two others: (cols, x, surf) in
    float64 on DEVICE, every vertex a query vertex."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

    m = make_tet_blocks(4, 4, 4)
    nv = len(m.vertices)
    x = np.concatenate([m.vertices + np.array([0.3 * i, 0.2 * i, 0.0]) for i in range(3)])
    cols = [dyn.make_tet_mesh_collider(m.vertices, m.tets, m.faces, i * nv) for i in range(3)]
    return ([c.to(DEVICE, torch.float64) for c in cols],
            torch.as_tensor(x.astype(np.float64), device=DEVICE),
            torch.arange(3 * nv, device=DEVICE))


def k_cases(torch):
    """[(label, colliders, x, surf, limits, expect)] of kernel K's checks,
    float64: boxes_gs8 at its golden's first-hit step and last step (two
    colliders, 772 query vertices), boxes_gs20 at its first-hit and last
    steps (the broad phase, 4,804 query vertices), the folded block dense and
    with the broad phase forced, and with HIT_CAP = 1; the dense tiles' edges
    (tile_case) with 2,560 tets and with 2,553 (no multiple of 32 or of a
    tile); the folded block broad with a cell capacity of 1 and 2 (its cells
    overflow); three colliders, two of them listing one query vertex
    (three_case), dense and broad; the block at rest (no hit). limits: the
    dynamic module's constants for the case; expect: what the plain twin's
    rows must show (hits: "some", or a count; overflow: 0 or 1; shared: a
    query listed by two colliders)."""
    import dataclasses

    out = []
    for name in ("boxes_gs8", "boxes_gs20"):
        g = golden(name)
        solver, _ = boxes_scene(name, torch_api())
        c = solver._contact
        for k in [int(v) for v in g["steps"]][1:]:
            out.append((f"{name}@{k}", [col.to(DEVICE, torch.float64) for col in c.colliders],
                        torch.as_tensor(g[f"x{k}"], device=DEVICE, dtype=torch.float64),
                        c.surf, {}, dict(hits="some")))
    dense, broad = dict(BROADPHASE_MIN_TETS=10 ** 9), dict(BROADPHASE_MIN_TETS=1)
    cols, x, surf = folded_case(torch, K_CASES_FOLD)
    fold = f"folded{K_CASES_FOLD}"
    out += [(f"{fold} dense", cols, x, surf, dense, dict(hits="some")),
            (f"{fold} broad", cols, x, surf, broad, dict(hits="some")),
            (f"{fold} hit_cap 1", cols, x, surf, dict(dense, HIT_CAP=1),
             dict(hits=1, overflow=1))]
    for cap in (1, 2):
        out.append((f"{fold} broad cell_cap {cap}",
                    [dataclasses.replace(c, cell_cap=cap) for c in cols], x, surf, broad,
                    dict(overflow=1)))
    for drop in (0, 7):
        cols, x, surf = tile_case(torch, drop)
        out.append((f"tiles {cols[0].n_tets} tets", cols, x, surf, dense, dict(hits="some")))
    cols, x, surf = three_case(torch)
    out += [("three colliders dense", cols, x, surf, dense, dict(hits="some", shared=True)),
            ("three colliders broad", cols, x, surf, broad, dict(hits="some", shared=True))]
    cols, x, surf = folded_case(torch, K_CASES_FOLD, fold=False)
    out.append((f"{fold} at rest", cols, x, surf, dense, dict(hits=0, overflow=0)))
    return out


class dyn_limits:
    """Set the dynamic module's constants for a block."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        from admm_elastic_tpu_torch.collision import dynamic as dyn

        self.old = {k: getattr(dyn, k) for k in self.kw}
        for k, v in self.kw.items():
            setattr(dyn, k, v)

    def __exit__(self, *exc):
        from admm_elastic_tpu_torch.collision import dynamic as dyn

        for k, v in self.old.items():
            setattr(dyn, k, v)


def k_detect(torch, cols, x, surf, plain):
    """The merged rows and the overflow flag of K (one call) or its plain
    twin over the colliders cols (a list, or their dynamic.ColliderTable) at
    x, from empty rows."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn
    from admm_elastic_tpu_torch.ops import cuda_dynamic

    table = cols if isinstance(cols, dyn.ColliderTable) else dyn.collider_table(cols)
    h = surf.shape[0]
    rows = (torch.zeros((h,), dtype=torch.bool, device=x.device),
            torch.zeros((h, 3), dtype=torch.int64, device=x.device),
            torch.zeros((h, 3), dtype=x.dtype, device=x.device),
            torch.zeros((h, 3), dtype=x.dtype, device=x.device))
    flag = torch.zeros((1,), dtype=torch.int32, device=x.device)
    rows = (cuda_dynamic.detect_plain if plain else cuda_dynamic.dyn_detect)(
        table, x, x[surf], surf, rows, flag)
    return rows, flag


def shared_queries(torch, table, x, surf):
    """The query vertices that two or more colliders of table list (each
    collider's plain detect_dynamic alone)."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    masks = [dyn.detect_dynamic(c, x, x[surf], surf)["mask"] for c in table.colliders]
    return int((torch.stack(masks).sum(dim=0) >= 2).sum().item())


def rows_hits(torch, rows, surf, n):
    """Hits of the dynamic rows alone, with their table."""
    import dataclasses

    from admm_elastic_tpu_torch.collision import constraints as con

    d_mask, d_face, d_barys, d_normal = rows
    e = con.empty_hits(surf, d_barys.dtype, dense=False, may_dyn=True)
    return con.with_table(dataclasses.replace(e, d_mask=d_mask, d_face=d_face, d_barys=d_barys,
                                              d_normal=d_normal), n)


def l_pair(torch, hits, n, seed):
    """Kernel L's two modes against its plain twin on hits: (max |diff|,
    bitwise) over C^T y (random y and base) and diag(C^T C)."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_dynamic

    rng = np.random.default_rng(seed)
    dt = hits.d_barys.dtype
    base = torch.as_tensor(rng.standard_normal((n, 3)), device=DEVICE, dtype=dt)
    yd = torch.as_tensor(rng.standard_normal(hits.capacity), device=DEVICE, dtype=dt)
    ck = torch.tensor(2.5, device=DEVICE, dtype=dt)
    worst, bitwise = 0.0, True
    for mode, y in ((con.CT, yd), (con.DIAG, None)):
        got = cuda_dynamic.dyn_gather(hits, base, mode, ck, y)
        vals = con.corner_values(hits, mode, ck, y).reshape(-1, 3)
        want = con.gather_plain(hits.d_order, hits.d_start, vals, base)
        bitwise &= bool(torch.equal(got, want))
        worst = max(worst, float((got - want).abs().max()))
    return worst, bitwise


def kernel_k_checks(torch):
    """Kernel K (every collider's detection in one call, merged into the
    rows) and kernel L (the rows' C^T and diag(C^T C) by their table) bit for
    bit their plain twins on the card, float64 and float32, on k_cases: the
    paths' states, the folded block dense and broad, HIT_CAP = 1 (its hit
    overflow set), the dense tiles' edges, overflowing cells, three colliders
    and the block at rest, each with its expectation; L where there are rows.
    Returns (checks, what the timing needs)."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    out, timing = {}, {}
    for label, cols, x64, surf, limits, expect in k_cases(torch):
        n = x64.shape[0]
        for dname, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            table = dyn.collider_table([c.to(DEVICE, dtype) for c in cols])
            x = x64.to(dtype)
            with dyn_limits(**limits):
                rows_k, flag_k = k_detect(torch, table, x, surf, plain=False)
                rows_p, flag_p = k_detect(torch, table, x, surf, plain=True)
                shared = shared_queries(torch, table, x, surf) if "shared" in expect else None
            same = all(bool(torch.equal(a, b)) for a, b in zip(rows_k, rows_p))
            hits, ovf = int(rows_k[0].sum().item()), int(flag_k.item())
            need(same and ovf == int(flag_p.item()),
                 f"K {label} {dname}: not bit for bit its plain twin (hits {hits} against "
                 f"{int(rows_p[0].sum().item())}, overflow {ovf} against {int(flag_p.item())})")
            want = expect.get("hits")
            need(want is None or (hits > 0 if want == "some" else hits == want),
                 f"K {label} {dname}: {hits} hits, expected {want}")
            need(expect.get("overflow", ovf) == ovf,
                 f"K {label} {dname}: overflow {ovf}, expected {expect.get('overflow')}")
            need(shared is None or shared > 0,
                 f"K {label} {dname}: no query vertex listed by two colliders")
            l_err, l_bitwise = 0.0, True
            if hits:
                h = rows_hits(torch, rows_k, surf, n)
                l_err, l_bitwise = l_pair(torch, h, n, seed=hits)
                need(l_bitwise, f"L {label} {dname}: not bit for bit its plain twin ({l_err:.3e})")
            out[f"{label} {dname}"] = dict(hits=hits, overflow=ovf, shared=shared,
                                           queries=int(surf.shape[0]), colliders=len(cols),
                                           tets=sum(c.n_tets for c in cols), max_abs_err=0.0,
                                           l_max_abs_err=l_err, bitwise=True)
            if dname == "f32" and label.startswith("boxes"):
                timing[label] = dict(table=table, x=x, surf=surf, hits=h, n=n, limits=limits)
        log(f"K and L {label}: bit for bit their plain twins in float64 and float32 "
            f"({out[label + ' f64']['hits']} hits, {int(surf.shape[0])} queries, "
            f"{len(cols)} collider(s), overflow {out[label + ' f64']['overflow']}"
            + ("" if "shared" not in expect else
               f", {out[label + ' f64']['shared']} listed by two colliders") + ")")
    return out, timing


def overlap_solver(torch, n):
    """Two n^3 boxes under Gauss-Seidel (boxes_scene's, float32, on the
    card), the top one moved down until its bottom layer sits half a cell
    inside the bottom box, v = 0: dynamic rows at rest, in colours narrower
    than kernel H's 512-thread block for n = 6 (288 rows)."""
    import dataclasses

    SELFCOLL_SCENES[f"overlap{n}"] = dict(n=n, ls=1, steps=1)
    try:
        solver, n_box = boxes_scene(f"overlap{n}", torch_api())
    finally:
        del SELFCOLL_SCENES[f"overlap{n}"]
    x = solver.state.x.clone()
    x[n_box:, 1] -= BOXES_SPACING - 1.0 + 0.5 / n
    solver.state = dataclasses.replace(solver.state, x=x, v=torch.zeros_like(x))
    return solver


def dyn_step_inputs(torch, name, step, dtype):
    """(solver, b, x0, hits) of a self-collision path's first global solve from
    its golden's state after `step` (v = 0; name "overlap<n>": overlap_solver's
    state), in dtype: the hits of its detection at x0 (GS: the dynamic rows
    alone; AL-PCG: deduped), with their table."""
    import dataclasses

    from admm_elastic_tpu_torch.collision import constraints as con

    solver = (overlap_solver(torch, int(name[len("overlap"):])) if name.startswith("overlap")
              else golden_state_solver(torch, name, step))
    b, x0 = first_solve(torch, solver)
    gs = solver.m_settings.linsolver == 1
    hits = solver._detect(x0, with_passive=not gs)
    if not gs:
        hits = hits.dedup()
    if dtype == torch.float64:
        hits = dataclasses.replace(hits, **{f: getattr(hits, f).double() for f in (
            "p_normal", "p_point", "d_barys", "d_normal")})
        b, x0 = b.double(), x0.double()
    return solver, b, x0, con.with_table(hits, b.shape[0])


# H[DYN]'s cases: boxes_gs8 (5 colours of at most 600 rows) and boxes_gs20
# (over 512: the WIDE block, 1,024 threads), an overlapped pair of 6^3 boxes
# (288: the 512-thread block)
H_DYN_CASES = ("boxes_gs8", "boxes_gs20", "overlap6")


def h_dyn_forms(torch, n, dtype):
    """The forms of kernel H that take n vertices in dtype on this card:
    global always, shared where x fits the block's shared memory."""
    from admm_elastic_tpu_torch.ops import cuda_gs

    try:
        cuda_gs.form_of(n, dtype, "shared")
    except ValueError:
        return ["global"]
    return ["global", "shared"]


def hdyn_gdyn_checks(torch):
    """H's DYN form against the plain gs.solve (may_have_dyn, the rows' sums
    by constraints.dyn_gather_plain) at the first solve from the golden's
    first-hit state of each H_DYN_CASES path (boxes_gs8 and boxes_gs20: the
    WIDE block) and from overlap_solver(6)'s state (the 512-thread block), in
    every form that takes the shape
    (h_dyn_forms), float32 and float64: bit for bit and in the same sweeps,
    each twice bitwise. G's DYN form (alcg.solve on the card) against the
    plain alcg.solve_plain at boxes_alpcg8's: float64 within PCG_F64_TOL in
    the same trips; float32 no further from it than the plain solve in
    float32 is from the plain solve in float64 (the lower precision's own
    gap, read here), its trips within GPEN_F32_TRIPS; twice bitwise. G is not
    held bit for bit: its dots are tree sums, which no plain twin repeats
    (ROADMAP Queue 2). Returns (checks, what the timing needs)."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_gs
    from admm_elastic_tpu_torch.solvers import alcg, gs, pcg

    out, timing = {}, {}
    plain = con.dyn_gather_plain
    for name in H_DYN_CASES:
        step = None if name.startswith("overlap") else [int(k) for k in golden(name)["steps"]][1]
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            solver, b, x0, hits = dyn_step_inputs(torch, name, step, dtype)
            s, c = solver.m_settings, solver._contact
            data = solver._solve_data if dtype == torch.float32 else gs_data64(torch, solver)
            obs = [o.to(DEVICE, dtype) for o in solver.obstacles]
            ck = c.ck.to(dtype)
            pin_target = c.pin_target.to(dtype)
            params = cuda_gs.obstacle_params(obs)
            args = (data, b, x0, c.pin_mask, pin_target, obs, s.gs_omega, s.gs_max_iters,
                    s.gs_tol)
            n_hits = int(hits.d_mask.sum().item())
            need(n_hits > 0, f"H[DYN] {name}: no dynamic row at the checked state")
            xp, kp = gs.solve(data.ell_cols, data.ell_vals, data.diag, data.colors,
                              data.colors_mask, b, x0, c.pin_mask, pin_target, obs, hits, ck,
                              s.gs_omega, s.gs_max_iters, s.gs_tol, may_have_dyn=True,
                              gather=plain)
            forms = h_dyn_forms(torch, int(b.shape[0]), dtype)
            wide = cuda_gs.h_wide(int(data.colors.shape[1]))
            r = dict(hits=n_hits, n=int(b.shape[0]), plain_sweeps=kp, wide=wide, forms={},
                     max_abs_err=0.0)  # bit for bit in every form, or need() failed
            for form in forms:
                ts = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
                xh, xh2 = (cuda_gs.gs_solve_dyn(*args, t, hits, ck, c.slot_of, params=params,
                                                form=form) for t in ts)
                kh = int(ts[0].item())
                need(bool(torch.equal(xh, xh2)) and kh == int(ts[1].item()),
                     f"H[DYN] {name} {dname} {form}: two runs differ")
                err = rel_err(xh.double().cpu().numpy(), xp.double().cpu().numpy())
                need(bool(torch.equal(xh, xp)) and kh == kp,
                     f"H[DYN] {name} {dname} {form}{' wide' if wide else ''}: not bit for bit "
                     f"its plain twin (rel err {err:.3e}, {kh} sweeps, plain {kp})")
                r["forms"][form] = dict(sweeps=kh, bitwise=True)
            out[f"gs_solve_dyn@{name} {dname}"] = r
            if dname == "f32":
                timing[f"gs_solve_dyn@{name}"] = dict(
                    args=args, hits=hits, ck=ck, slot_of=c.slot_of, params=params, sweeps=kp,
                    max_abs_err=0.0,
                    plain=lambda args=args, hits=hits, ck=ck, s=s, data=data: gs.solve(
                        data.ell_cols, data.ell_vals, data.diag, data.colors, data.colors_mask,
                        *args[1:6], hits, ck, s.gs_omega, s.gs_max_iters, s.gs_tol,
                        may_have_dyn=True, gather=plain))
            log(f"H[DYN] {name} {dname}: {n_hits} dynamic rows, {data.colors.shape[0]} colours "
                f"of at most {data.colors.shape[1]}, {'WIDE' if wide else '512-thread'} block, "
                f"forms {forms} each bit for bit the plain gs.solve in {kp} sweeps")
    name = "boxes_alpcg8"
    step = [int(k) for k in golden(name)["steps"]][1]
    got = {}
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        solver, b, x0, hits = dyn_step_inputs(torch, name, step, dtype)
        s, c = solver.m_settings, solver._contact
        data = (solver._solve_data if dtype == torch.float32
                else pcg.prepare(solver.system, torch.float64, precond=s.pcg_precond))
        ck = c.ck.to(dtype)
        y = torch.zeros((2 * hits.capacity,), dtype=dtype, device=DEVICE)
        ts = [torch.zeros((1,), dtype=torch.int32, device=DEVICE) for _ in range(2)]
        xg, yg = alcg.solve(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters, ts[0],
                            slot_of=c.slot_of)
        xg2, _ = alcg.solve(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters, ts[1],
                            slot_of=c.slot_of)
        kg = int(ts[0].item())
        need(bool(torch.equal(xg, xg2)) and kg == int(ts[1].item()),
             f"G[DYN] {name} {dname}: two runs differ")
        xp, yp, kp = alcg.solve_plain(data, hits, ck, b, x0, y, s.pcg_tol, s.pcg_max_iters,
                                      gather=con.dyn_gather_plain)
        got[dname] = xp.double().cpu().numpy()
        err = rel_err(xg.double().cpu().numpy(), got[dname])
        r = dict(rel_err=err, trips=kg, plain_trips=kp, n=int(b.shape[0]),
                 hits=int(hits.d_mask.sum().item()), passive=int(hits.p_mask.sum().item()),
                 max_abs_err=float((xg - xp).abs().max()),
                 y_rel_err=rel_err(yg.double().cpu().numpy(), yp.double().cpu().numpy()))
        need(r["hits"] > 0, f"G[DYN] {name}: no dynamic row at the checked state")
        out[f"pcg_solve_dyn@{name} {dname}"] = r
        if dname == "f32":
            _, b_hat, pen_diag, _ = alcg._setup(hits, ck, b, y)
            pn = alcg.penalty_vectors(hits, ck, b.shape[0])
            timing["pcg_solve_dyn@boxes_alpcg8"] = dict(
                data=data, b_hat=b_hat, x0=x0, pn=pn, pen_diag=pen_diag, hits=hits, ck=ck,
                slot_of=c.slot_of, s=s, trips=kg, max_abs_err=r["max_abs_err"],
                csr=csr_of(torch, solver, b.dtype))
    r32, r64 = out[f"pcg_solve_dyn@{name} f32"], out[f"pcg_solve_dyn@{name} f64"]
    control = rel_err(got["f32"], got["f64"])  # the plain solve's own float32 gap
    r32["f32_control"] = control
    need(r64["rel_err"] <= PCG_F64_TOL and r64["trips"] == r64["plain_trips"],
         f"G[DYN] {name} f64: {r64} (bound {PCG_F64_TOL})")
    need(r32["rel_err"] <= control and abs(r32["trips"] - r32["plain_trips"]) <= GPEN_F32_TRIPS,
         f"G[DYN] {name} f32: {r32} (bound: the plain solve's float32 gap {control:.3e})")
    for dname, r in (("f32", r32), ("f64", r64)):
        log(f"G[DYN] {name} {dname}: {r['hits']} dynamic and {r['passive']} passive rows, rel "
            f"err {r['rel_err']:.3e}, {r['trips']} trips (plain {r['plain_trips']})"
            + (f"; the plain solve's float32 gap to its float64 {control:.3e}"
               if dname == "f32" else ""))
    return out, timing


K_KERNELS = ("dyn_frames_kernel", "dyn_query_kernel", "dyn_rank_kernel", "dyn_face_kernel")


def k_phase_us(torch, fn, reps):
    """({K's kernel: device µs a detection}, launches a detection) of fn(),
    one detection, by torch.profiler over reps detections; a window with
    records missing (fewer than four a detection) is taken again, three
    times at most, and then ({}, None): not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n = {}, 0
        for e in prof.events():
            k = next((k for k in K_KERNELS if k in e.name), None)
            if e.device_type == DeviceType.CUDA and k is not None:
                us[k] = us.get(k, 0.0) + e.time_range.elapsed_us() / reps
                n += 1
        if n >= len(K_KERNELS) * reps:
            return us, n / reps
        log(f"profiler saw {n} of {len(K_KERNELS) * reps} of K's launches"
            + ("; the window is taken again" if attempt < 2 else "; not measured"))
    return {}, None


def k_bytes_ops(cols, x, surf, n_hits):
    """(bytes, operations, pair tests) of a detection by kernel K of the
    query vertices surf against the colliders cols at x with n_hits hits:
    x, the tets, the rest meshes and the faces read once and the rows written
    once; 40 operations a pair test (every query against every tet dense, the
    broad phase's candidates above BROADPHASE_MIN_TETS) and 80 a face test
    (each hit against its collider's faces)."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    item = x.element_size()
    h_q = int(surf.shape[0])
    pairs = 0
    for c in cols:
        if c.n_tets > dyn.BROADPHASE_MIN_TETS:
            cand, _ = dyn._broad_phase_candidates(x[c.tets.long()], x[surf], c.cell_cap)
            pairs += int((cand < c.n_tets).sum().item())
        else:
            pairs += h_q * c.n_tets
    faces = sum(int(c.faces.shape[0]) for c in cols)
    ops = 40 * pairs + 80 * n_hits * faces // len(cols)
    nbytes = (x.numel() * item + sum(c.tets.numel() * 4 + c.rest_verts.numel() * item
                                     + c.faces.numel() * 4 for c in cols)
              + h_q * (8 + 1 + 24 + 2 * 3 * item))
    return nbytes, ops, pairs


def selfcoll_kernel_times(torch, k_timing, hg_timing, gpu):
    """Kernels K, L, H[DYN] and G[DYN] on the card at the paths' shapes:
    each call by queued CUDA events and by torch.profiler (the device time of
    its kernels, summed over a call; K's split into its four phases, with
    its launches a detection), its plain twin's by CUDA events, the bound (K:
    the pair tests and the face walk at ~40 and ~80 operations, or the bytes
    of x, the tets and the rest mesh; L: the rows and the table read once and
    [N, 3] written once; H and G: as h_bytes_ops / pcg_bytes_ops count them),
    and the yardsticks of L, index_add_ of the same terms (float atomics;
    never in the port), and of G[DYN], torch.sparse.mm of A times its trips.
    Returns {label: entry}."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.collision import dynamic as dyn
    from admm_elastic_tpu_torch.ops import cuda_dynamic, cuda_gs, cuda_pcg

    out = {}
    for label, t in k_timing.items():
        x, surf, table, hits, n = t["x"], t["surf"], t["table"], t["hits"], t["n"]
        cols = table.colliders
        item = x.element_size()

        def k_call(t=t):
            with dyn_limits(**t["limits"]):
                return k_detect(torch, t["table"], t["x"], t["surf"], plain=False)

        def k_plain(t=t):
            with dyn_limits(**t["limits"]):
                return k_detect(torch, t["table"], t["x"], t["surf"], plain=True)

        h_q = int(surf.shape[0])
        broad = any(c.n_tets > dyn.BROADPHASE_MIN_TETS for c in cols)
        n_hits = int(hits.d_mask.sum().item())
        faces = sum(int(c.faces.shape[0]) for c in cols)
        nbytes, ops, pairs = k_bytes_ops(cols, x, surf, n_hits)
        k_us = queued_us(torch, [("k", k_call)] * 2, 5)["k"]
        plain_ms = events_ms(torch, k_plain, 3)
        phases, per_det = k_phase_us(torch, k_call, 5) if DEVICE == "cuda" else ({}, None)
        prof = sum(phases.values()) if phases else None
        bound_ms, bound_by = bound_of(nbytes, ops)
        out[f"dyn_detect@{label}"] = dict(
            ms=k_us * 1e-3, profiler_ms=None if prof is None else prof * 1e-3,
            phases_us=phases, launches_per_detection=per_det,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            operations=ops, library_ms=None, pairs=pairs, hits=n_hits, queries=h_q,
            broad=broad, colliders=len(cols))
        ck = torch.tensor(2.5, device=DEVICE, dtype=x.dtype)
        yd = torch.ones((hits.capacity,), device=DEVICE, dtype=x.dtype)
        base = torch.zeros((n, 3), device=DEVICE, dtype=x.dtype)
        vals = con.corner_values(hits, con.CT, ck, yd).reshape(-1, 3)
        k_ent = int(hits.d_start[-1].item())
        ent = hits.d_order[:k_ent]
        idx, src = hits.d_face.reshape(-1)[ent], vals[ent]
        l_us = queued_us(torch, [("l", lambda: cuda_dynamic.dyn_gather(
            hits, base, con.CT, ck, yd))] * 2, 10)["l"]
        lib_ms = events_ms(torch, lambda: base.clone().index_add_(0, idx, src), 20)
        l_plain = events_ms(torch, lambda: con.gather_plain(hits.d_order, hits.d_start, vals,
                                                             base), 5)
        l_prof = g_device_us(torch, lambda: cuda_dynamic.dyn_gather(hits, base, con.CT, ck, yd),
                             20, kernel="dyn_gather_kernel")
        l_bytes = (hits.capacity * (1 + 8 + 24 + 6 * item) + (3 * hits.capacity + n + 1) * 8
                   + 2 * n * 3 * item)
        l_ops = 4 * 3 * k_ent
        lb, lby = bound_of(l_bytes, l_ops)
        out[f"dyn_gather@{label}"] = dict(
            ms=l_us * 1e-3, profiler_ms=None if l_prof is None else l_prof * 1e-3,
            plain_ms=l_plain, bound_ms=lb, bound_by=lby, bytes=l_bytes, operations=l_ops,
            library_ms=lib_ms, entries=k_ent, n=n)
        log(f"time K {label}: {k_us:.1f} us a detection (queued, with its PyTorch work), "
            f"profiler {'not measured' if prof is None else '%.1f us' % prof} ("
            + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
            + f"; {per_det} launches a detection); plain {plain_ms * 1e3:.1f} us; bound "
            f"{bound_ms * 1e3:.3f} us by {bound_by} ({pairs} pair tests, {n_hits} hits x "
            f"{faces // len(cols)} faces) [{gpu}]")
        log(f"time L {label}: {l_us:.1f} us a launch (queued), profiler "
            f"{'not measured' if l_prof is None else '%.1f us' % l_prof}; plain "
            f"{l_plain * 1e3:.1f} us; index_add_ {lib_ms * 1e3:.1f} us; bound {lb * 1e3:.3f} us "
            f"by {lby} ({k_ent} entries) [{gpu}]")
    for name in H_DYN_CASES:
        key = f"gs_solve_dyn@{name}"
        t = hg_timing[key]
        a = t["args"]
        h_call = lambda t=t, a=a: cuda_gs.gs_solve_dyn(  # noqa: E731
            *a, torch.zeros((1,), dtype=torch.int32, device=DEVICE), t["hits"], t["ck"],
            t["slot_of"], params=t["params"])
        h_us = queued_us(torch, [("h", h_call)] * 2, 5)["h"]
        h_prof = g_device_us(torch, h_call, 5, kernel="gs_kernel")
        h_plain = events_ms(torch, t["plain"], 1)
        nbytes, ops = h_bytes_ops(a[0], t["sweeps"], a[1].element_size())
        hb, hby = bound_of(nbytes, ops)
        out[key] = dict(ms=h_us * 1e-3, profiler_ms=None if h_prof is None else h_prof * 1e-3,
                        plain_ms=h_plain, bound_ms=hb, bound_by=hby, library_ms=None,
                        sweeps=t["sweeps"], max_abs_err=t["max_abs_err"])
    t = hg_timing["pcg_solve_dyn@boxes_alpcg8"]
    s = t["s"]
    g_call = lambda: cuda_pcg.pcg_solve_dyn(  # noqa: E731
        t["data"], t["b_hat"], t["x0"], s.pcg_tol, s.pcg_max_iters,
        torch.zeros((1,), dtype=torch.int32, device=DEVICE), t["pn"], t["pen_diag"], t["hits"],
        t["ck"], t["slot_of"])
    g_us = queued_us(torch, [("g", g_call)] * 2, 5)["g"]
    g_prof = g_device_us(torch, g_call, 5, kernel="pcg_kernel")

    def g_plain():
        from admm_elastic_tpu_torch.solvers.alcg import penalty_solve_dyn

        return penalty_solve_dyn(t["data"], t["pn"], t["pen_diag"], t["hits"], t["ck"],
                                 t["b_hat"], t["x0"], s.pcg_tol, s.pcg_max_iters,
                                 gather=con.dyn_gather_plain)

    g_plain_ms = events_ms(torch, g_plain, 1)
    spmv = events_ms(torch, lambda: torch.sparse.mm(t["csr"], t["b_hat"]), 200)
    nbytes, ops = pcg_bytes_ops(t["data"], t["trips"])
    gb, gby = bound_of(nbytes, ops)
    out["pcg_solve_dyn@boxes_alpcg8"] = dict(ms=g_us * 1e-3, profiler_ms=None if g_prof is None
                                             else g_prof * 1e-3, plain_ms=g_plain_ms,
                                             bound_ms=gb, bound_by=gby,
                                             library_ms=spmv * t["trips"], library_spmv_ms=spmv,
                                             trips=t["trips"], max_abs_err=t["max_abs_err"])
    for k in [f"gs_solve_dyn@{n}" for n in H_DYN_CASES] + ["pcg_solve_dyn@boxes_alpcg8"]:
        e = out[k]
        prof = "not measured" if e["profiler_ms"] is None else f"{e['profiler_ms'] * 1e3:.1f} us"
        lib = ("" if e["library_ms"] is None else
               f"; torch.sparse.mm x trips {e['library_ms'] * 1e3:.1f} us")
        log(f"time {k}: {e['ms'] * 1e3:.1f} us a solve (queued), profiler {prof}; plain "
            f"{e['plain_ms'] * 1e3:.1f} us{lib}; bound {e['bound_ms'] * 1e3:.3f} us by "
            f"{e['bound_by']} [{gpu}]")
    return out


# --- Uzawa's Schur trip: kernel L's full C^T and kernel M (ROADMAP Queue 2 items 17, 9) ---

# The paths whose Schur trips run L's full C^T and M, and the state each is
# checked and timed at: the floor paths' landed state (landed_solver), and
# boxes_uzawa8's golden state at its first step with a dynamic hit.
UZAWA_PATHS = ("boxes_uzawa8", "floor_uzawa5k", "floor_uzawa67k")


def uzawa_state(torch, name):
    """(solver, b, x0, hits, y) of a Uzawa path's first global solve at its
    checked state (UZAWA_PATHS; boxes_uzawa8: the golden's held step with its
    first dynamic hits), float32 on the card: the hits as
    Solver._contact_rows makes them (deduped, with their table; the kernels'
    fields contiguous), y = 0."""
    from admm_elastic_tpu_torch.collision import constraints as con

    if name in SELFCOLL_SCENES:
        solver = golden_state_solver(torch, name, int(golden(name)["steps"][1]))
    else:
        solver = landed_solver(torch, name)
    b, x0 = first_solve(torch, solver)
    hits = widened(con.with_table(solver._detect(x0).dedup(), x0.shape[0]), b.dtype)
    need(bool(hits.p_mask.any()) and (name not in SELFCOLL_SCENES or bool(hits.d_mask.any())),
         f"{name}: no active row at the checked state")
    return solver, b, x0, hits, torch.zeros(2 * hits.capacity, dtype=b.dtype, device=b.device)


def widened(hits, dtype):
    """hits with their float fields in dtype, the kernels' fields contiguous
    (cuda_uzawa.contiguous_hits, as uzawa.solve makes them)."""
    import dataclasses

    from admm_elastic_tpu_torch.ops import cuda_uzawa

    return cuda_uzawa.contiguous_hits(dataclasses.replace(hits, **{
        f: getattr(hits, f).to(dtype) for f in ("p_normal", "p_point", "d_barys", "d_normal")}))


def uzawa_apply(solver, dtype):
    """The solver's A^-1 apply for Uzawa in dtype: its own (float32), or for
    float64 inputs the float32 apply on them narrowed, widened back (L and M
    are held to their twins on whatever q2 the apply gives)."""
    lo = solver.state.x.dtype
    if dtype == lo:
        return solver._uzawa_Ainv

    def apply(rhs, x0, done):
        return solver._uzawa_Ainv(rhs.to(lo), None if x0 is None else x0.to(lo), done).to(dtype)

    return apply


def trip_pairs(torch, label, hits, ck, b, x0, y, max_iters, tol, apply, slot_of):
    """uzawa.solve's trips with kernels L and M, each launch held on the card
    to its plain twin on the same inputs: L (ct_apply) torch.equal to ct_plain
    and to the parent's C^T (constraints.Ct_apply, whose face corners are L's
    standalone dyn_gather) on y and on every trip's d; M (schur_trip, on
    copies, on the wrapper's grid and on a grid of one block) torch.equal to
    schur_trip_plain in all six outputs on every trip, those after the exit
    included. Then uzawa.solve itself from the same
    inputs: x, y and the trips bitwise the walk's. Returns (x, a summary)."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu
    from admm_elastic_tpu_torch.solvers import uzawa

    n, h = b.shape[0], hits.capacity
    dtype = b.dtype

    def ct(v, what):
        got = cu.ct_apply(hits, ck, v, n, slot_of)
        need(bool(torch.equal(got, cu.ct_plain(hits, ck, v, n)))
             and bool(torch.equal(got, con.Ct_apply(hits, ck, v[:h], v[h:], n))),
             f"L {label}: C^T of {what} is not bit for bit its twin and the parent's C^T")
        return got

    x = apply(b - ct(y, "y"), x0, None)
    active = torch.cat([hits.p_mask, hits.d_mask])
    r = torch.where(active, torch.cat(con.C_apply(hits, ck, x)) - torch.cat(con.C_rhs(hits, ck)),
                    0.0)
    d, yv = r.clone(), y.clone()
    fi = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    tiny = float(fi.tiny)
    tol_c = max(fi.dtype.type(tol), fi.dtype.type(64) * fi.eps)
    tol2 = float(tol_c * tol_c)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    for trip in range(int(max_iters)):
        q2 = apply(ct(d, f"d at trip {trip + 1}"), None, done)
        state = (x, yv, r, d, k, done)
        want = cu.schur_trip_plain(hits, ck, q2, *state, tiny, tol2)
        for blocks in (1, None):  # a grid of one block, then the wrapper's
            got = cu.schur_trip(hits, ck, q2, *[t.clone() for t in state], tiny, tol2,
                                blocks=blocks)
            same = [bool(torch.equal(a, w)) for a, w in zip(got, want)]
            need(all(same), f"M {label} on {blocks or 'its'} block(s): trip {trip + 1} not bit "
                 f"for bit its twin (x, y, r, d, k, done equal: {same})")
        x, yv, r, d, k, done = got
    xs, ys, ks = uzawa.solve(apply, hits, ck, b, x0, y, max_iters, tol, slot_of=slot_of)
    need(bool(torch.equal(xs, x)) and bool(torch.equal(ys, yv))
         and int(ks.item()) == max(int(k.item()), 1),
         f"{label}: uzawa.solve differs from its trips walked launch by launch")
    return x, dict(trips=int(k.item()), rows=2 * h, active=int(active.sum().item()),
                   vertices=n, dense=hits.dense, dynamic=int(hits.d_mask.sum().item()),
                   bitwise=True)


def schur_trip_checks(torch):
    """Kernels L (the trip's full C^T) and M (the trip's update) bit for bit
    their plain twins on every trip of a Schur solve at each UZAWA_PATHS
    state (uzawa_state), float32 and float64 (trip_pairs); L also the
    parent's C^T. Returns (checks, what the timing needs)."""
    out, timing = {}, {}
    for name in UZAWA_PATHS:
        solver, b, x0, hits, y = uzawa_state(torch, name)
        s, c = solver.m_settings, solver._contact
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            label = f"{name} {dname}"
            h = widened(hits, dtype)
            ck = c.ck.to(dtype)
            _, res = trip_pairs(torch, label, h, ck, b.to(dtype), x0.to(dtype), y.to(dtype),
                                s.uzawa_max_iters, s.uzawa_tol, uzawa_apply(solver, dtype),
                                c.slot_of)
            out[label] = dict(res, max_abs_err=0.0)
            log(f"L and M {label}: bit for bit their twins on all {s.uzawa_max_iters} trips "
                f"({res['trips']} taken, {res['active']} of {res['rows']} rows active, "
                f"{res['dynamic']} dynamic, {res['vertices']} vertices, "
                f"{'dense' if res['dense'] else 'slot_of'}); L bit for bit the parent's C^T")
        timing[name] = dict(solver=solver, b=b, x0=x0, hits=hits, y=y)
    return out, timing


def schur_bytes_ops(hits, n, itemsize, trip):
    """The bytes L (trip False) or M (trip True) must move and the operations
    it must do on hits: each input read once, each output written once (M:
    the rows, q2 and the state x, y, r, d read and written; L: its rows, y,
    the table and slot_of read, [N, 3] written); the operations of the
    active rows and of the table's entries that these inputs hold."""
    h = hits.capacity
    p_act = int(hits.p_mask.sum().item())
    d_act = int(hits.d_mask.sum().item())
    dyn = hits.may_dyn
    if not trip:
        entries = int(hits.d_start[-1].item()) if dyn else 0
        nbytes = (h * (1 + 3 * itemsize) + 2 * h * itemsize + 3 * n * itemsize
                  + (0 if hits.dense else 4 * n)
                  + ((h + 3 * h * itemsize) + 3 * h * 8 + (n + 1) * 8 + 3 * h * itemsize
                     if dyn else 0))
        ops = 4 * p_act + (7 * d_act + 8 * entries if dyn else 0)
        return nbytes, ops
    nbytes = (h * (1 + 8 + 3 * itemsize) + 3 * n * itemsize
              + (h * (1 + 8 + 24 + 6 * itemsize) if dyn else 0)
              + 2 * (3 * n + 3 * 2 * h) * itemsize + 4 + 1)
    ops = 6 * p_act + 24 * d_act + 4 * 2 * (2 * h) + 2 * 3 * n + 3 * 2 * (2 * h)
    return nbytes, ops


def schur_trip_times(torch, timing, gpu):
    """L and M on the card at each UZAWA_PATHS state, float32: a launch by
    queued CUDA events (in turns, behind a sleep kernel) and by torch.profiler,
    M's latency floor (floor_library, ADMM_M_FLOOR: its launch, done read,
    barrier and reductions, no row), M and its floor each less the queued time of the
    copies that reset the trip's state before it (M runs on copies of a live
    trip's state, done unset), the plain twins by CUDA events, the bounds
    (schur_bytes_ops), and L's yardstick, one index_add_ of the same terms
    (float atomics; never in the port). Returns {label: entry}."""
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    out = {}
    floor = floor_library() if DEVICE == "cuda" else None
    for name, t in timing.items():
        solver, b, x0, hits, y = t["solver"], t["b"], t["x0"], t["hits"], t["y"]
        s, c = solver.m_settings, solver._contact
        n, h, item = b.shape[0], hits.capacity, b.element_size()
        ck = c.ck
        fi = np.finfo(np.float32)
        tol_c = max(fi.dtype.type(s.uzawa_tol), fi.dtype.type(64) * fi.eps)
        tiny, tol2 = float(fi.tiny), float(tol_c * tol_c)
        x = solver._uzawa_Ainv(b - cu.ct_apply(hits, ck, y, n, c.slot_of), x0, None)
        active = torch.cat([hits.p_mask, hits.d_mask])
        r = torch.where(active, torch.cat(con.C_apply(hits, ck, x))
                        - torch.cat(con.C_rhs(hits, ck)), 0.0)
        d = r.clone()
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        k = torch.zeros((), dtype=torch.int32, device=b.device)
        q2 = solver._uzawa_Ainv(cu.ct_apply(hits, ck, d, n, c.slot_of), None, done)
        state = (x, y, r, d, k, done)
        copies = [tt.clone() for tt in state]

        def m_call(lib=None):
            for dst, src in zip(copies, state):
                dst.copy_(src)
            return cu.schur_trip(hits, ck, q2, *copies, tiny, tol2, lib=lib)

        def l_call():
            return cu.ct_apply(hits, ck, d, n, c.slot_of)

        calls = [("l", l_call), ("m", m_call),
                 ("copy", lambda: [dst.copy_(src) for dst, src in zip(copies, state)])]
        if floor is not None:
            calls.append(("m_floor", lambda: m_call(floor)))
        us = queued_us(torch, calls, 10)
        m_us = us["m"] - us["copy"]
        us["m_floor"] = us["m_floor"] - us["copy"] if "m_floor" in us else None
        on_card = DEVICE == "cuda"
        l_prof = g_device_us(torch, l_call, 20, kernel="uzawa_ct_kernel") if on_card else None
        m_prof = g_device_us(torch, m_call, 20, kernel="schur_trip") if on_card else None
        l_plain = events_ms(torch, lambda: cu.ct_plain(hits, ck, d, n), 5)
        m_plain = events_ms(torch, lambda: cu.schur_trip_plain(hits, ck, q2, *state, tiny, tol2),
                            5)
        # L's yardstick: C^T as one index_add_ of every term (the own rows'
        # and the face corners') into zeros
        yp = torch.where(hits.p_mask, d[:h], 0.0)
        own = (ck * yp)[:, None] * hits.p_normal
        idx, src = [hits.p_vidx], [own]
        if hits.may_dyn:
            yd = torch.where(hits.d_mask, d[h:], 0.0)
            idx.append(hits.d_vidx)
            src.append((ck * yd)[:, None] * hits.d_normal)
            e = hits.d_order[:int(hits.d_start[-1].item())]
            idx.append(hits.d_face.reshape(-1)[e])
            src.append(con.corner_values(hits, con.CT, ck, yd).reshape(-1, 3)[e])
        idx, src = torch.cat(idx), torch.cat(src)
        zeros = torch.zeros((n, 3), dtype=b.dtype, device=b.device)
        lib_ms = events_ms(torch, lambda: zeros.clone().index_add_(0, idx, src), 20)
        for kname, q_us, prof, plain_ms, trip in (("ct_apply", us["l"], l_prof, l_plain, False),
                                                  ("schur_trip", m_us, m_prof, m_plain, True)):
            nbytes, ops = schur_bytes_ops(hits, n, item, trip)
            bound_ms, bound_by = bound_of(nbytes, ops)
            out[f"{kname}@{name}"] = dict(
                ms=q_us * 1e-3, profiler_ms=None if prof is None else prof * 1e-3,
                floor_ms=(us["m_floor"] * 1e-3 if trip and us["m_floor"] else None),
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                operations=ops, library_ms=None if trip else lib_ms, rows=2 * h, vertices=n,
                **(dict(blocks=cu.m_blocks(n, h, cu.max_blocks(b.device, b.dtype)))
                   if trip and on_card else {}))
            e = out[f"{kname}@{name}"]
            log(f"time {'M' if trip else 'L'} {name}: {q_us:.2f} us a launch (queued), profiler "
                f"{'not measured' if prof is None else '%.2f us' % prof}"
                + (f", latency floor {e['floor_ms'] * 1e3:.2f} us" if e["floor_ms"] else "")
                + f"; plain {plain_ms * 1e3:.1f} us"
                + ("" if trip else f"; index_add_ {lib_ms * 1e3:.1f} us")
                + (f"; {e['blocks']} block(s)" if "blocks" in e else "")
                + f"; bound {bound_ms * 1e3:.3f} us by {bound_by} ({2 * h} rows, {n} vertices) "
                f"[{gpu}]")
    return out


def bench_contact_sanity(torch):
    """bench.py's contact sanity (bench.py:41-69) on the port, timed: the
    4x2x2 linear beam on a Floor(y=-1) with linsolver 1, 2 and 4, float32,
    direct_mode "inv", run(20) (the captured step): finite, not through the
    floor (min y > -1.1)."""
    from admm_elastic_tpu_torch import Floor, Lame, Settings, Solver, binding
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

    out = {}
    for ls in (1, 2, 4):
        t0 = time.perf_counter()
        mesh = make_tet_blocks(4, 2, 2)
        mesh.flags = binding.NOSELFCOLLISION | binding.LINEAR
        s = Solver(device=DEVICE)
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        s.add_obstacle(Floor(y=-1.0))
        need(s.initialize(Settings(verbose=0, admm_iters=10, linsolver=ls, gravity=-9.8,
                                   dtype=np.float32, direct_mode="inv")), "sanity: initialize")
        s.run(20)
        x = s.x
        need(np.isfinite(x).all(), f"sanity ls={ls}: contact scene non-finite")
        need(x[:, 1].min() > -1.1, f"sanity ls={ls}: tunneled through the floor "
             f"(min y {x[:, 1].min()})")
        out[ls] = dict(min_y=float(x[:, 1].min()), wall_s=time.perf_counter() - t0)
    log("bench.py contact sanity: " + json.dumps(out))
    return out


def h_bytes_ops(data, sweeps, itemsize):
    """The bytes kernel H must move (the ELL, the diagonal, the colour groups,
    b, x0, the pins read once, x written once) and the operations its sweeps
    do on these inputs: per sweep and vertex the ELL row sum (two per entry
    and component) twice (the update and the residual), the update and the
    residual's own (about 40), the contact projection not counted."""
    n, k = data.ell_cols.shape
    nbytes = (n * k * (4 + itemsize) + n * itemsize + data.colors.numel() * 4
              + 3 * n * itemsize * 4 + n)
    ops = sweeps * n * (2 * 2 * 3 * k + 40)
    return nbytes, ops


def contact_kernel_times(torch, h_timing, gpen_timing, gpu):
    """Kernel H per solve (floor_gs5k, sphere_gs) and G's penalty form per
    solve (floor_alpcg67k) on their first-solve inputs: device time of the
    form the wrapper chooses (torch.profiler), every form by queued CUDA
    events in turns beside its latency floor (the no-row-work build in as
    many sweeps or trips), CUDA events, the plain versions on the card, the
    bound; the library yardstick of G's penalty form, torch.sparse.mm of A as
    CSR times its trips (none computes a GS sweep: null)."""
    from admm_elastic_tpu_torch.ops import cuda_gs, cuda_pcg
    from admm_elastic_tpu_torch.solvers import alcg, gs

    out = {}
    for name, t in h_timing.items():
        solver = t["solver"]
        s, data = solver.m_settings, solver._solve_data
        obs = list(solver._contact.obstacles)
        params = solver._contact.gs_params
        sweeps = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        args = (t["b"], t["x0"], t["pin_mask"], t["pin_target"], obs, s.gs_omega,
                s.gs_max_iters, s.gs_tol)

        def kern():
            return cuda_gs.gs_solve(data, *args, sweeps, params=params)

        def plain():
            return gs.solve(data.ell_cols, data.ell_vals, data.diag, data.colors,
                            data.colors_mask, *args[:5], None, None, *args[5:],
                            may_have_dyn=False)

        def run(form, lib):
            if lib is None:
                return cuda_gs.gs_solve(data, *args, sweeps, params=params, form=form)
            return cuda_gs._launch(data, *args[:6], t["sweeps"], s.gs_tol, sweeps, params,
                                   lib=lib, form=form)

        p1, k1, k2, p2 = (events_ms(torch, plain, 1), events_ms(torch, kern, 20),
                          events_ms(torch, kern, 20), events_ms(torch, plain, 1))
        n = int(t["b"].shape[0])
        forms = h_forms(n, t["b"].dtype)
        calls = [(("kernel", f), lambda f=f: run(f, None)) for f in forms]
        if DEVICE == "cuda":
            lib = floor_library()
            calls += [(("floor", f), lambda f=f: run(f, lib)) for f in forms]
        us = queued_us(torch, calls + calls[::-1], 10)
        by_form = {f: dict(ms=us[("kernel", f)] * 1e-3,
                           floor_ms=(us[("floor", f)] * 1e-3 if ("floor", f) in us else None),
                           ms_per_sweep=us[("kernel", f)] * 1e-3 / max(t["sweeps"], 1))
                   for f in forms}
        # an exact obstacle's walk at every group size in the chosen form, in
        # turns
        variants = {}
        if DEVICE == "cuda" and any(is_exact(o) for o in obs):
            vcalls = [(label, lambda kw=kw: cuda_gs.gs_solve(data, *args, sweeps, params=params,
                                                              **kw))
                      for label, kw in h_variants()]
            variants = {k: v * 1e-3 for k, v in queued_us(torch, vcalls + vcalls[::-1],
                                                          5).items()}
        n_bytes, ops = h_bytes_ops(data, t["sweeps"], 4)
        bound_ms, bound_by = bound_of(n_bytes, ops)
        form = h_chosen(n, t["b"].dtype)
        prof_ms, ms = profiler_or_queued(torch, kern, "gs_kernel", by_form[form]["ms"])
        out[f"gs_solve@{name}"] = dict(
            ms=ms, profiler_ms=prof_ms, events_ms=min(k1, k2), plain_ms=min(p1, p2), readings=[p1, k1, k2, p2],
            form=form, forms=by_form, floor_ms=by_form[form]["floor_ms"],
            sweeps=t["sweeps"], ms_per_sweep=ms / max(t["sweeps"], 1), bytes=n_bytes,
            operations=ops, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            max_abs_err=t["max_abs_err"], colors=int(data.colors.shape[0]),
            variants=variants)
    for name, t in gpen_timing.items():
        s = t["solver"].m_settings
        trips = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
        ins = (t["data"], t["hits"], t["ck"], t["b"], t["x0"], t["y"], s.pcg_tol, s.pcg_max_iters)

        def kern():
            return alcg.solve(*ins, trips)

        def plain():
            return alcg.solve_plain(*ins)

        _, b_hat, pen_diag, _ = alcg._setup(t["hits"], t["ck"], t["b"], t["y"])
        pn = alcg.penalty_vectors(t["hits"], t["ck"], t["b"].shape[0])

        def run(form, lib, its):
            if lib is None:
                return cuda_pcg.pcg_solve_penalty(t["data"], b_hat, t["x0"], s.pcg_tol,
                                                  s.pcg_max_iters, trips, pn, pen_diag, form=form)
            return cuda_pcg._launch(t["data"], b_hat, t["x0"], s.pcg_tol, its, None,
                                    (pn, pen_diag), None, lib=lib, form=form)

        a = csr_of(torch, t["solver"], torch.float32)
        p1, k1, k2, p2 = (events_ms(torch, plain, 2), events_ms(torch, kern, 20),
                          events_ms(torch, kern, 20), events_ms(torch, plain, 2))
        spmv = events_ms(torch, lambda: torch.sparse.mm(a, t["b"]), 200)
        forms = g_form_times(torch, run, t["data"], t["b"].dtype, t["trips"])
        n_bytes, ops = pcg_bytes_ops(t["data"], t["trips"])
        vec = 3 * t["data"].n * 4
        n_bytes += 2 * vec  # pn and the per-component inverse, read once
        ops += (t["trips"] + 1) * 3 * t["data"].n * 4  # pn (pn . v) per apply
        bound_ms, bound_by = bound_of(n_bytes, ops)
        form = g_blocks(t["data"], t["b"].dtype)[0]
        prof_ms, ms = profiler_or_queued(torch, kern, "pcg_kernel", forms[form]["ms"])
        out[f"pcg_solve_penalty@{name}"] = dict(
            ms=ms, profiler_ms=prof_ms, events_ms=min(k1, k2), plain_ms=min(p1, p2), readings=[p1, k1, k2, p2],
            form=form, forms=forms, floor_ms=forms[form]["floor_ms"],
            trips=t["trips"], ms_per_trip=ms / max(t["trips"], 1), bytes=n_bytes,
            operations=ops, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=spmv * t["trips"], library_spmv_ms=spmv, max_abs_err=t["max_abs_err"])
    for k, v in out.items():
        its = v.get("sweeps", v.get("trips"))
        per_form = "; ".join(
            f"{f} {w['ms'] * 1e3:.1f} us, floor "
            + ("n/a" if w["floor_ms"] is None else f"{w['floor_ms'] * 1e3:.1f} us")
            for f, w in v["forms"].items())
        log(f"time {k}: {v['ms'] * 1e3:.1f} us per solve on the device in the {v['form']} form "
            f"({'torch.profiler' if v['profiler_ms'] is not None else 'queued CUDA events'}; "
            f"{v['events_ms'] * 1e3:.1f} by CUDA events), {its} sweeps/trips; by queued events "
            f"{per_form}; plain {v['plain_ms'] * 1e3:.1f} us; library "
            f"{'none' if v['library_ms'] is None else '%.2f us' % (v['library_ms'] * 1e3)}; bound "
            f"{v['bound_ms'] * 1e3:.3f} us by {v['bound_by']} [{gpu}]")
        if v.get("variants"):
            log(f"time {k}, the exact walk by queued events: "
                + "; ".join(f"{n} {w * 1e3:.1f} us" for n, w in v["variants"].items())
                + f" [{gpu}]")
    return out


def path_shape_cases(torch, res):
    """The kernels of the PCG, contact and Anderson paths at those paths'
    shapes where no earlier case has them (name@path), float32, main-path
    inputs from a generator of their own: A's stencil entry and C on the 160k
    beam's lattice (176,640 lanes, 35,721 vertices) and on the torus_pcg20k
    ring, B on the ring, E's stencil entry on the 160x160 sheet (51,842
    lanes); on the contact paths' 60x15x15 beam (101,250 lanes) A's linear
    stencil entry and C, and for floor_alpcg67k_aa4 the standalone B and A's
    linear rows entry with u = 0. Held against plain here (C and B exact, A
    under LANE_TOL, E under F32_TOL_STENCIL; the ring's results come from
    ring_checks) and returned as kernel_cases entries."""
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil, cuda_tri_local_step
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain, prox_tet_hyper_tuple
    from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain
    from admm_elastic_tpu_torch.system import elements as el

    f32 = torch.float32
    rng = np.random.default_rng(8)
    cases = {}

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=DEVICE, dtype=f32)

    beam = make_tet_blocks(*PCG_SCENES["beam_pcg160k"]["dims"])
    bb = el.build_tet_batch(beam.vertices, beam.tets, Lame.soft_rubber(), NH, device=DEVICE,
                            dtype=f32, lattice_dims=beam.lattice_dims)
    ring_mesh, rb = ring_batch(torch, f32, PCG_SCENES["torus_pcg20k"]["ring"], 0)
    pitch = 0.7 / PCG_SCENES["torus_pcg20k"]["ring"][1]
    for label, mesh, b, noise in (("beam_pcg160k", beam, bb, 0.05),
                                  ("torus_pcg20k", ring_mesh, rb, 0.05 * pitch)):
        x = dev(mesh.vertices + noise * rng.standard_normal(mesh.vertices.shape))
        u = dev(0.05 * rng.standard_normal((9, b.n)))
        n = len(mesh.vertices)
        dx = cuda_stencil.tet_Dx_rows(x, b)
        params = (b.mu, b.lam, b.kappa, b.bulk)
        base, n_vblock = b.stencil[0], len(mesh.vertices)
        trips = {}
        prox_tet_hyper_tuple(tuple(dx + u), NH, *params, trips=trips)
        ops = (tet_operations(NH, b.n, True, trips)
               + plain_flops(torch, lambda x=x, b=b: st.tet_Dx_rows_plain(x, b)))
        if label == "beam_pcg160k":
            c = cuda_stencil.tet_rhs_rows(dx, u, b, n)
            need(bool(torch.equal(c, st.tet_rhs_rows_plain(dx, u, b, n))),
                 f"C@{label}: not exact against plain")
            res["f32"][f"tet_rhs_rows@{label}"] = dict(
                max_abs_err=0.0, exact=True, plan=list(cuda_stencil.rhs_plan_of(b, 4)))
            def rerun(lanes, dx=dx, u=u, params=params):
                args = (dx[:, lanes] * dev(1.0 + 1e-5 * rng.standard_normal((9, len(lanes)))),
                        u[:, lanes]) + tuple(a[lanes] for a in params)
                return (cuda_local_step.local_step_tet_hyper(*args, model=NH),
                        local_step_plain(*args, model=NH))

            k = cuda_local_step.local_step_tet_stencil(x, u, b)
            e = tet_errs(torch, k, local_step_plain(dx, u, *params, model=NH), "f32",
                         f"A[{NH}] stencil entry {label}", rerun=rerun)
            res["f32"][f"local_step_tet_stencil[{NH}]@{label}"] = dict(e, max_abs_err=e["max"])
        else:
            cases[f"tet_Dx_rows ring@{label}"] = (
                lambda x=x, b=b: cuda_stencil.tet_Dx_rows(x, b),
                lambda x=x, b=b: st.tet_Dx_rows_plain(x, b),
                [x[base:base + n_vblock], b.st_dl, b.st_par, b.st_dead], 200, 5)
        cases[f"tet_rhs_rows@{label}"] = (
            lambda dx=dx, u=u, b=b, n=n: cuda_stencil.tet_rhs_rows(dx, u, b, n),
            lambda dx=dx, u=u, b=b, n=n: st.tet_rhs_rows_plain(dx, u, b, n),
            [dx, u, b.weight, b.st_dl, b.st_par], 200, 5)
        cases[f"local_step_tet_stencil[{NH}]@{label}"] = (
            lambda x=x, u=u, b=b: cuda_local_step.local_step_tet_stencil(x, u, b),
            lambda dx=dx, u=u, params=params: local_step_plain(dx, u, *params, model=NH),
            [x[base:base + n_vblock], b.st_dl, b.st_par, b.st_dead, u] + list(params), 50, 2,
            ops)
    p = PCG_SCENES["cloth_ls0_160"]
    verts, tris, _, _ = cloth_sheet(p["nx"], p["ny"])
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    lame.limit_min, lame.limit_max = p["limits"]
    tb = el.build_tri_batch(verts, tris, lame, device=DEVICE, dtype=f32)
    xs = dev(verts + 0.02 * rng.standard_normal(verts.shape))
    ut = dev(0.02 * rng.standard_normal((6, tb.n)))
    k = cuda_tri_local_step.local_step_tri_stencil(xs, ut, tb)
    dxt = st.tri_Dx_rows(xs, tb)
    e = direct_errs(torch, k, local_step_tri_plain(dxt, ut, tb.limit_min, tb.limit_max), "f32",
                    "E stencil entry cloth_ls0_160")
    res["f32"]["local_step_tri_stencil@cloth_ls0_160"] = dict(e, max_abs_err=e["max"])
    cases["local_step_tri_stencil@cloth_ls0_160"] = (
        lambda: cuda_tri_local_step.local_step_tri_stencil(xs, ut, tb),
        lambda: local_step_tri_plain(st.tri_Dx_rows(xs, tb), ut, tb.limit_min, tb.limit_max),
        [xs, tb.st_dl, tb.st_dead, ut, tb.limit_min, tb.limit_max], 200, 5)
    # the contact paths' 67k beam (60x15x15, linear: A's linear stencil entry,
    # C; on the Anderson path B and A's rows entry), 101,250 lanes, 15,616
    # vertices
    cb = make_tet_blocks(*CONTACT_SCENES["floor_uzawa67k"]["dims"])
    lb = el.build_tet_batch(cb.vertices, cb.tets, Lame.soft_rubber(), "linear", device=DEVICE,
                            dtype=f32, lattice_dims=cb.lattice_dims)
    x = dev(cb.vertices + 0.05 * rng.standard_normal(cb.vertices.shape))
    u = dev(0.05 * rng.standard_normal((9, lb.n)))
    n = len(cb.vertices)
    dx = cuda_stencil.tet_Dx_rows(x, lb)
    params = (lb.mu, lb.lam, lb.kappa, lb.bulk)
    base = lb.stencil[0]
    c = cuda_stencil.tet_rhs_rows(dx, u, lb, n)
    need(bool(torch.equal(c, st.tet_rhs_rows_plain(dx, u, lb, n))),
         "C@floor_uzawa67k: not exact against plain")
    res["f32"]["tet_rhs_rows@floor_uzawa67k"] = dict(max_abs_err=0.0, exact=True)
    k = cuda_local_step.local_step_tet_stencil(x, u, lb)
    e = tet_errs(torch, k, local_step_plain(dx, u, *params, model="linear"), "f32",
                 "A[linear] stencil entry floor_uzawa67k")
    res["f32"]["local_step_tet_stencil[linear]@floor_uzawa67k"] = dict(e, max_abs_err=e["max"])
    cases["tet_rhs_rows@floor_uzawa67k"] = (
        lambda: cuda_stencil.tet_rhs_rows(dx, u, lb, n),
        lambda: st.tet_rhs_rows_plain(dx, u, lb, n),
        [dx, u, lb.weight, lb.st_dl, lb.st_par], 200, 5)
    cases["local_step_tet_stencil[linear]@floor_uzawa67k"] = (
        lambda: cuda_local_step.local_step_tet_stencil(x, u, lb),
        lambda: local_step_plain(dx, u, *params, model="linear"),
        [x[base:base + n], lb.st_dl, lb.st_par, lb.st_dead, u] + list(params), 50, 2,
        tet_operations("linear", lb.n, True, None)
        + plain_flops(torch, lambda: st.tet_Dx_rows_plain(x, lb)))
    # the same beam as floor_alpcg67k_aa4's Anderson iterations launch its
    # kernels: the standalone B (D x for g(v) and v0) and A's linear rows
    # entry with u = 0 (the prox of the Anderson iterate v)
    need(bool(torch.equal(dx, st.tet_Dx_rows_plain(x, lb))),
         "B@floor_alpcg67k_aa4: not exact against plain")
    res["f32"]["tet_Dx_rows@floor_alpcg67k_aa4"] = dict(max_abs_err=0.0, exact=True)
    u0 = torch.zeros_like(u)

    def rerun(lanes):
        args = (dx[:, lanes] * dev(1.0 + 1e-5 * rng.standard_normal((9, len(lanes)))),
                u0[:, lanes]) + tuple(a[lanes] for a in params)
        return (cuda_local_step.local_step_tet_hyper(*args, model="linear"),
                local_step_plain(*args, model="linear"))

    k = cuda_local_step.local_step_tet_hyper(dx, u0, *params, model="linear")
    e = tet_errs(torch, k, local_step_plain(dx, u0, *params, model="linear"), "f32",
                 "A[linear] rows entry floor_alpcg67k_aa4", rerun=rerun)
    res["f32"]["local_step_tet_hyper[linear]@floor_alpcg67k_aa4"] = dict(e, max_abs_err=e["max"])
    cases["tet_Dx_rows@floor_alpcg67k_aa4"] = (
        lambda: cuda_stencil.tet_Dx_rows(x, lb),
        lambda: st.tet_Dx_rows_plain(x, lb),
        [x[base:base + n], lb.st_dl, lb.st_par, lb.st_dead], 200, 5)
    cases["local_step_tet_hyper[linear]@floor_alpcg67k_aa4"] = (
        lambda: cuda_local_step.local_step_tet_hyper(dx, u0, *params, model="linear"),
        lambda: local_step_plain(dx, u0, *params, model="linear"), [dx, u0], 50, 2,
        tet_operations("linear", lb.n, True, None))
    log("kernels at the PCG and contact paths' shapes: " + json.dumps(
        {k: v["max_abs_err"] for k, v in res["f32"].items() if "@" in k and (
            "pcg" in k or "67k" in k) or k.endswith("cloth_ls0_160")}))
    return cases


# The one-tet scene of tests/test_lineartet.py (test_lineartet.cpp:165-323).
ONE_TET_VERTS = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]], dtype=np.float64)
ONE_TET = np.array([[0, 1, 2, 3]])
ONE_TET_PULLED_X = 52.2321  # the pulled vertex's golden x, +-1e-4 beyond 20 iterations
# The inverted tet's volume error after 10 steps, per ADMM iteration count 10,
# 20, ..., 90 (tests/test_lineartet.py's counts): the JAX Solver with
# set_svd_impl("jacobi") (its SoA path, the arithmetic the port repeats),
# float64. The reference restores the volume to
# 1e-6 (and the JAX package's CPU default, a LAPACK SVD, to -4.4e-7), but the
# pose inverted at [1, 1, 1] is symmetric: F^T F gets bitwise equal diagonal
# entries and the Jacobi SVD stalls on them (ROADMAP Queue 3).
JAX_JACOBI_VOL_ERR = [1.9386215728819933e-04, 1.1726816286503072e-04, 1.942653552083895e-04,
                      2.7299505383290845e-04, 3.31037040131571e-04, 3.6852838534282006e-04,
                      3.869666055658638e-04, 3.876863794058938e-04, 3.7246462209955533e-04]
ONE_TET_VOL_TOL = 1e-9  # on the volume error, against JAX_JACOBI_VOL_ERR


def one_tet_solver(lame, device=None, **settings):
    from admm_elastic_tpu_torch import Settings, Solver

    s = Solver(device=device or DEVICE)
    s.add_nodes(ONE_TET_VERTS, np.ones(4))
    s.add_tet_energies(ONE_TET_VERTS, ONE_TET, lame)
    need(s.initialize(Settings(verbose=0, linsolver=0, gravity=0.0, dtype=np.float64,
                               **settings)), "one tet: initialize failed")
    need(s.system.tets[0].stencil is None, "one tet: not a gather family")
    return s


def one_tet_convergence(device=None):
    """The pulled vertex converges monotonically to ONE_TET_PULLED_X, at every
    4th ADMM iteration count from 5, as tests/test_lineartet.py (each count
    re-initializes, sets x and changes admm_iters: on the card, a capture
    each)."""
    from admm_elastic_tpu_torch import Lame

    s = one_tet_solver(Lame.from_youngs_poisson(500000, 0.25), device, timestep_s=1.0 / 24.0)
    init_x = s.x.copy()
    last, got = -1.0, {}
    for it in range(5, 100, 4):
        s.m_settings.admm_iters = it
        s.x = init_x
        need(s.initialize(), "one tet: initialize failed")
        xx = s.x
        xx[3] = [200.0, 0.0, 0.0]
        s.x = xx
        s.step()
        new = float(s.x[3][0])
        got[it] = new
        err = (ONE_TET_PULLED_X - new) ** 2
        if it > 20:
            need(abs(ONE_TET_PULLED_X - new) < 1e-4, f"one tet, {it} iterations: x = {new}")
        elif last >= 1e-8:
            need(err <= last * (1 + 1e-12), f"one tet, {it} iterations: no monotone convergence")
        last = err
    return got


def one_tet_inversion(device=None):
    """The tet inverted at [1, 1, 1] comes back in 10 steps, with the volume
    errors of JAX_JACOBI_VOL_ERR (to ONE_TET_VOL_TOL)."""
    from admm_elastic_tpu_torch import Lame
    from admm_elastic_tpu_torch.geometry.mesh import tet_volumes

    s = one_tet_solver(Lame(mu=100.0, lam=100.0), device, timestep_s=0.7)
    init_x = s.x.copy()
    target = tet_volumes(init_x, ONE_TET)[0]
    got = {}
    for iters, want in zip(range(10, 100, 10), JAX_JACOBI_VOL_ERR):
        s.m_settings.admm_iters = iters
        s.x = init_x
        need(s.initialize(), "one tet: initialize failed")
        xx = s.x
        xx[0] = [1.0, 1.0, 1.0]
        s.x = xx
        need(tet_volumes(s.x, ONE_TET)[0] < 0, "one tet: not inverted")
        s.run(10)
        err = float(tet_volumes(s.x, ONE_TET)[0] - target)
        got[iters] = err
        need(abs(err - want) < ONE_TET_VOL_TOL,
             f"one tet, {iters} iterations: volume error {err}, the JAX package's {want}")
    return got


def invalidation_checks(torch):
    """The captured step never goes stale, on the pinned bench beam: set_pins
    between two runs copies moved targets in place (no new capture) and the
    pinned vertices follow; a new x and v (the setters) take effect at the
    next run, which then matches the eager loop from them; a change of
    admm_iters, of gravity and initialize() each give a new capture, in
    whose warm-up step and capture the wrapper of kernel A's stencil entry is
    called admm_iters times each, and whose replays launch it admm_iters
    times a step."""
    solver, mesh, g, pins = make_solver(NH)
    out = {}
    solver.run(1)
    graph = solver._graph
    need(graph is not None, "no graph after run(1)")
    tgt = solver.x[pins] + np.array([0.1, 0.05, 0.0])
    solver.set_pins(pins, tgt)
    solver.run(3)
    need(solver._graph is graph, "set_pins captured the step anew")
    out["moved_pins_dev"] = float(np.abs(solver.x[pins] - tgt).max())
    need(out["moved_pins_dev"] < 1e-3, f"moved pins not followed: {out['moved_pins_dev']}")

    rng = np.random.default_rng(5)
    xs = solver.x + 0.02 * rng.standard_normal(solver.x.shape)
    vs = 0.1 * rng.standard_normal(xs.shape)
    solver.x, solver.v = xs, vs
    solver.run(1)
    x_graph = solver.state.x.clone()
    need(solver._graph is graph, "setting x and v captured the step anew")
    solver.x, solver.v = xs, vs
    solver._run_eager(1)
    out["setters_vs_eager"] = dict(bitwise=bool(torch.equal(solver.state.x, x_graph)),
                                   rel_err=rel_err(x_graph.cpu().numpy(), solver.x))
    need(out["setters_vs_eager"]["bitwise"]
         or out["setters_vs_eager"]["rel_err"] <= GRAPH_EAGER_TOL,
         f"after the setters the graph step is off the eager one: {out['setters_vs_eager']}")

    key = f"local_step_tet_stencil[{NH}]"
    graphs = [graph]
    for label, change in (("admm_iters", lambda: setattr(solver.m_settings, "admm_iters", 5)),
                          ("gravity", lambda: setattr(solver.m_settings, "gravity", -4.9)),
                          ("initialize", lambda: need(solver.initialize(), "initialize failed"))):
        change()
        reset_counts()
        solver.run(0)
        need(all(solver._graph is not old for old in graphs), f"{label}: no new capture")
        graphs.append(solver._graph)
        iters = solver.m_settings.admm_iters
        called = read_counts(NH)[key]
        replayed = counted_window(torch, label, lambda: solver.run(2), {key: 2 * iters},
                                  model=NH)[key]
        need(called == 2 * iters and read_counts(NH)[key] == called,
             f"{label}: {key} called {called} times by the warm-up step and the capture "
             f"and {read_counts(NH)[key] - called} times by the replays, expected {2 * iters}, 0")
        need(np.isfinite(solver.x).all(), f"{label}: non-finite state")
        out[f"recaptured_on_{label}"] = dict(wrapper_calls=called, launches_by_two_steps=replayed)
    out["frozen"] = frozen_checks(torch)
    log("graph invalidation " + json.dumps(out))
    return out


def frozen_checks(torch):
    """After a graph run of cloth_wind40 the state is a snapshot of the
    graph's buffers, not the buffers themselves, and it, the system, its
    batches and the wind are frozen: an assignment to a field raises
    dataclasses.FrozenInstanceError (as in the JAX package), where it would
    have gone unseen by the replays; the x setter is honored by the next run,
    which matches the eager loop from the same x and v."""
    from admm_elastic_tpu_torch.system.system import SimState

    solver, _, _ = make_cloth_solver("cloth_wind40")
    solver.run(2)
    graph = solver._graph
    need(solver.state is not graph.state and solver.state.x is not graph.state.x,
         "after a run the state is the graph's own buffers")
    wind, b = solver.ext_forces[0], solver.system.tris[0]
    raised = []
    for label, target, field, value in (
            ("solver.state.x", solver.state, "x", solver.state.x.clone()),
            ("wind.direction", wind, "direction", wind.direction * 2),
            ("wind.alpha_n", wind, "alpha_n", 1.0),
            ("TriBatch.limit_min", b, "limit_min", b.limit_min.clone()),
            ("System.dt", solver.system, "dt", 1.0)):
        try:
            setattr(target, field, value)
        except dataclasses.FrozenInstanceError:
            raised.append(label)
        else:
            raise SmokeFailure(f"{label} = ... did not raise after a graph run")
    x, v = solver.x + 0.01, solver.v
    solver.x = x
    solver.run(3)
    need(solver._graph is graph, "the x setter captured the step anew")
    state0 = SimState(x=torch.as_tensor(x, device=DEVICE, dtype=torch.float32),
                      v=torch.as_tensor(v, device=DEVICE, dtype=torch.float32),
                      y=solver.state.y.clone(), prev_active=solver.state.prev_active.clone())
    eager = graph_vs_eager(torch, "x setter after a graph run", solver, state0, 3,
                           solver.state.x.clone())
    return dict(raised=raised, setter_vs_eager=eager)


# --- the solver extras: kernel I, Anderson, the logged and profiled steps, checkpoints ----

# Kernel I's shapes: the 40x40 sheet of cloth_wind40_seq (3,200 triangles,
# 1,681 vertices, 236 levels of at most 20: v, the geometry and the ids fit
# one block's shared memory) and the 160x160 sheet (51,200 triangles, 25,921
# vertices, 956 levels of at most 80: they do not).
WIND_SHEETS = (40, 160)
WIND_SHEET_LABELS = tuple(f"wind_seq@{2 * nx * nx}" for nx in WIND_SHEETS)
# kernel_i_checks runs the lists of more triangles than this in float32 only:
# the plain scan of a 51,200-triangle list takes some 19 s on the card, and
# the float64 bits are held on the 3,200-triangle sheet, the fan and the
# repeated vertices (a depth cut that keeps the run under 900 s with the
# self-collision paths)
WIND_F64_MAX_TRIANGLES = 3200
WIND_ALPHA, WIND_DT = 1000.0, 1.0 / 24.0
# The lists beyond the sheets (wind_lists): the 160x160 sheet's triangles in
# a shuffled order (28 levels of up to 3,963 triangles, wider than a block), a
# fan of WIND_FAN triangles on one vertex (as many levels of one triangle) and
# the 4x4 sheet with two triangles of a repeated vertex among its own (their
# force is 0).
WIND_FAN = 200
# The operations of one triangle in csrc/wind_seq.cu: the mean 9, the
# relative velocity 3, the edges 6, the cross product 9, the norm 6, the
# normal 3, the area 2, v_n 5, the force's scalar 3 and vector 9, the adds 9.
WIND_OPS = 64


def wind_inputs(torch, nx, dtype):
    """The nx x nx sheet's triangles on the card, its positions jittered and
    small velocities (seeded), and the wind's direction, as kernel I takes
    them (as tests/test_torch_cuda_extras.py makes them)."""
    verts, tris, _, _ = cloth_sheet(nx, nx)
    rng = np.random.default_rng(nx)
    x = verts + 0.05 * rng.standard_normal(verts.shape)
    v = 0.01 * rng.standard_normal(verts.shape)
    t = dict(dtype=dtype, device=DEVICE)
    return (torch.as_tensor(tris, device=DEVICE), torch.tensor([0.05, 0.1, 0.02], **t),
            torch.as_tensor(x, **t), torch.as_tensor(v, **t))


def wind_fan(k):
    """k triangles (0, i, i + 1) around vertex 0, a jittered ring (seeded):
    (vertices [k + 2, 3], triangles [k, 3])."""
    rng = np.random.default_rng(k)
    ang = np.linspace(0.0, 2.0 * np.pi, k + 1)
    ring = np.stack([np.cos(ang), 0.1 * rng.standard_normal(k + 1), np.sin(ang)], axis=1)
    tris = np.stack([np.zeros(k, np.int64), np.arange(1, k + 1), np.arange(2, k + 2)], axis=1)
    return np.concatenate([np.zeros((1, 3)), ring]), tris


def wind_repeated():
    """The 4x4 sheet's triangles with (3, 3, 7) and (5, 9, 9) among them."""
    verts, tris, _, _ = cloth_sheet(4, 4)
    tris = np.insert(tris, [10, 20], [[3, 3, 7], [5, 9, 9]], axis=0)
    return verts, tris


def wind_lists(torch, dtype):
    """[(label, tris, direction, x, v)] of kernel I's checks: the WIND_SHEETS,
    the 160x160 sheet shuffled, the fan and the repeated vertices, each
    positions jittered and velocities small (seeded), on DEVICE."""
    out = []
    for nx in WIND_SHEETS:
        tris, d, x, v = wind_inputs(torch, nx, dtype)
        out.append((f"wind_seq@{tris.shape[0]}", tris, d, x, v))
    perm = np.random.default_rng(7).permutation(tris.shape[0])
    out.append((f"wind_seq@{tris.shape[0]} shuffled", tris[torch.as_tensor(perm, device=DEVICE)],
                d, x, v))
    t = dict(dtype=dtype, device=DEVICE)
    for label, (verts, tri) in ((f"wind_seq fan@{WIND_FAN}", wind_fan(WIND_FAN)),
                                ("wind_seq repeated@34", wind_repeated())):
        rng = np.random.default_rng(len(tri))
        out.append((label, torch.as_tensor(tri, device=DEVICE), d,
                    torch.as_tensor(verts + 0.05 * rng.standard_normal(verts.shape), **t),
                    torch.as_tensor(0.01 * rng.standard_normal(verts.shape), **t)))
    return out


def wind_bytes_ops(w, n, itemsize):
    """Kernel I's least bytes (the triangles, x and v read once, v written
    once, the direction) and operations for w triangles on n vertices. The
    level schedule is this design's input, not the function's: it is not
    counted."""
    return w * 3 * 8 + 3 * n * 3 * itemsize + 3 * itemsize, WIND_OPS * w


def kernel_i_checks(torch, gpu):
    """Kernel I against its plain version on the card (wind_seq_plain, the
    scan: the same IEEE-rounded operations in the same order) on wind_lists
    in float32 and float64 (the 51,200-triangle lists in float32 only,
    WIND_F64_MAX_TRIANGLES), in each form that takes the shape: bit for bit,
    finite, the velocities kicked; the level walk in plain PyTorch
    (wind_seq_levels_plain) bit for bit the scan too; a form that cannot take
    the shape raises. Timing (on the card), float32 and float64: each form by
    CUDA events, its latency floor (the same levels in the floor build,
    FLOOR_DEFINES: the loads and stores of v and the barriers, no
    arithmetic), the plain scan's one call on the host's clock around a
    synchronize, and the bound. Returns (checks, timing)."""
    from admm_elastic_tpu_torch.ops import _build, cuda_wind

    checks, timing = {}, {}
    on_card = DEVICE == "cuda"
    optin = _build.library().admm_smem_optin() if on_card else 232448
    floor = floor_library() if on_card else None
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for label, tris, d, x, v in wind_lists(torch, dtype):
            if dname == "f64" and tris.shape[0] > WIND_F64_MAX_TRIANGLES:
                continue
            sched = cuda_wind.bake_schedule(tris, tris.device)
            w, n, item = tris.shape[0], x.shape[0], x.element_size()
            t0 = time.perf_counter()
            want = cuda_wind.wind_seq_plain(tris, d, WIND_ALPHA, WIND_DT, x, v)
            if on_card:
                torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            need(bool(torch.isfinite(want).all()) and not bool(torch.equal(want, v)),
                 f"{label} {dname}: the plain version kicked nothing")
            walked = cuda_wind.wind_seq_levels_plain(sched, tris, d, WIND_ALPHA, WIND_DT, x, v)
            levels_bitwise = bool(torch.equal(walked, want))
            need(levels_bitwise or not on_card, f"{label} {dname}: the plain level walk is "
                 f"{float((walked - want).abs().max()):.3e} off the scan")
            chosen = cuda_wind.i_form(n, w, item, optin)
            forms = {}
            for form in cuda_wind.FORMS:
                call = functools.partial(cuda_wind.wind_seq, tris, d, WIND_ALPHA, WIND_DT, x, v,
                                         sched, form=form)
                try:
                    cuda_wind.i_form(n, w, item, optin, form)
                except ValueError:
                    if on_card:  # the plain version takes no form
                        try:
                            call()
                        except ValueError:
                            continue
                        raise SmokeFailure(f"{label} {dname}: the {form} form took the shape")
                    continue
                got = call()
                need(bool(torch.equal(got, want)),
                     f"{label} {dname} {form}: kernel I is "
                     f"{float((got - want).abs().max()):.3e} off its plain version")
                entry = dict(bitwise=True)
                if on_card:
                    got = queued_us(torch, [("ms", call), ("floor_ms", functools.partial(
                        call, lib=floor))] * 2, 3)
                    entry.update({k: us * 1e-3 for k, us in got.items()})
                forms[form] = entry
            checks[f"{label} {dname}"] = dict(
                triangles=w, vertices=n, levels=sched.n_levels, widest=sched.widest,
                form=chosen, forms=sorted(forms), max_abs_err=0.0,
                levels_plain_bitwise=levels_bitwise)
            nbytes, ops = wind_bytes_ops(w, n, item)
            bound_ms, bound_by = bound_of(nbytes, ops)
            timing[f"{label} {dname}"] = dict(
                triangles=w, vertices=n, levels=sched.n_levels, widest=sched.widest,
                form=chosen, forms=forms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, operations=ops, library_ms=None)
            if on_card:
                log(f"time {label} {dname}: " + ", ".join(
                    f"{f} {e['ms'] * 1e3:.1f} us (floor {e['floor_ms'] * 1e3:.1f} us)"
                    for f, e in forms.items())
                    + f"; plain {plain_ms:.1f} ms (one call); bound {bound_ms * 1e3:.3f} us "
                    f"by {bound_by}; {sched.n_levels} levels of at most {sched.widest} [{gpu}]")
            log(f"{label} {dname}: kernel I bit for bit its plain version in {sorted(forms)} "
                f"({w} triangles, {n} vertices, {sched.n_levels} levels, chosen {chosen}); the "
                f"plain level walk {'bit for bit' if levels_bitwise else 'NOT bitwise'} the scan")
    return checks, timing


def variant_device_ops(torch, solver, base):
    """device_ops of one replayed step of a variant path's solver and of its
    base scene's (a solver of its own, 8 steps in)."""
    base.run(8)
    it = solver.m_settings.admm_iters
    return dict(device=device_ops(torch, lambda: solver.run(1), it),
                device_plain=device_ops(torch, lambda: base.run(1), it))


def aa_path(torch, name):
    """beam_aa4 or cloth_aa4 (VARIANT_SCENES: aa_window=4) through the
    captured step against its golden: every ADMM iteration launches the rows
    entry of kernel A (tets) or E (the sheet) with u = 0 (the prox of v), and
    D x runs once more per step than the iterations (v0 = D x_bar; the
    standalone kernel B on the lattice, tri_Dx_rows on the sheet); no stencil
    entry runs. Then the device operations per iteration of a replayed step,
    beside the base path's."""
    base_name = variant_of(name)[0]
    steps = 8
    if base_name == "beam":
        solver, _, g, pins = make_solver(NH, name=name)
        base = make_solver(NH)[0]
        it = solver.m_settings.admm_iters
        iters = steps * it
        kernels = [f"local_step_tet_hyper[{NH}]", "tet_Dx_rows", "tet_rhs_rows"]
        counts = {f"local_step_tet_hyper[{NH}]": iters, "tet_Dx_rows": iters + steps,
                  "tet_rhs_rows": iters, f"local_step_tet_stencil[{NH}]": 0}
        model = NH
    else:
        solver, g, pins = make_cloth_solver(name)
        base = make_cloth_solver(base_name)[0]
        it = solver.m_settings.admm_iters
        iters = steps * it
        kernels = ["local_step_tri"]
        # the plain tri_Dx_rows is called by the warm-up step and the capture
        counts = {"local_step_tri": iters, "local_step_tri_stencil": 0,
                  "tri_Dx_rows": 2 * (it + 1)}
        model = None
    need(solver.m_settings.aa_window == AA_WINDOW and int(g["steps"][-1]) == steps,
         f"{name}: not the Anderson path of its golden")
    x0, x8, res = drive_path(torch, name, solver, g, pins, kernels, model=model,
                             step_counts=counts)
    if base_name == "beam":
        res.update(check_sag(name, x0, x8))
    else:
        need(x8[:, 1].min() < -1e-3, f"{name}: the sheet did not sag")
    res.update(variant_device_ops(torch, solver, base))
    log(f"{name}: the steps launch {kernels[0]} {iters} times; device per iteration "
        f"{json.dumps(res['device'])}, the base path's {json.dumps(res['device_plain'])}")
    return solver, res


def aa_wins_check(torch):
    """tests/test_anderson.py:53-91 on the card in float64: the 10x3x3
    neo-Hookean beam, one step of 10 ADMM iterations with aa_window=4 below
    half the plain step's error against a 600-iteration step (the eager loop;
    the two 10-iteration steps through the captured step)."""
    from admm_elastic_tpu_torch import Lame, Settings, Solver, binding
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

    def build(aa, iters):
        mesh = make_tet_blocks(10, 3, 3)
        mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
        s = Solver(device=DEVICE)
        binding.add_tetmesh(s, mesh, Lame.soft_rubber(), verbose=False)
        s.set_pins([int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]])
        need(s.initialize(Settings(verbose=0, admm_iters=iters, linsolver=0, gravity=-9.8,
                                   dtype=np.float64, direct_mode="inv", aa_window=aa)),
             "initialize failed")
        return s

    ref = build(0, 600)
    ref._run_eager(1)
    errs = {}
    for aa in (0, AA_WINDOW):
        s = build(aa, 10)
        s.run(1)
        errs[aa] = float(np.linalg.norm(ref.x - s.x))
    need(np.isfinite(errs[AA_WINDOW]) and errs[AA_WINDOW] < 0.5 * errs[0],
         f"aa_window={AA_WINDOW} does not halve the plain error: {errs}")
    log(f"Anderson (float64, 10 iterations): error against the converged step "
        f"{errs[AA_WINDOW]:.3e} with aa_window={AA_WINDOW}, {errs[0]:.3e} without "
        f"({errs[0] / errs[AA_WINDOW]:.1f}x)")
    return dict(err_plain=errs[0], err_aa=errs[AA_WINDOW], ratio=errs[0] / errs[AA_WINDOW])


# The logged step once per linsolver (scene, steps before it: the contact
# scenes after landing, so that contacts are active; log_inner_iters, 0 for
# the solver's max iterations). The torus traces 300 CG trips: its
# pcg_max_iters of 60 stops the Jacobi CG on the stiff ring at a fall of some
# 27x, and tests/test_solverlog.py's assertion needs a curve that reaches the
# noise floor (at 300 every solve of its first step falls below 1e-10 of its
# start, the port on the CPU).
LOGGED_SCENES = {0: ("beam", 0, 0), 3: ("torus_pcg20k", 0, 300),
                 1: ("floor_gs5k", LANDING_STEP, 0), 2: ("floor_uzawa5k", LANDING_STEP, 0),
                 4: ("floor_alpcg67k", LANDING_STEP, 0)}
# The card's logged step against the same logged step of a Solver(device="cpu")
# from the same state, both in float64 (the scene initialized again in
# float64): in float32 the torus's 300 CG trips follow each device's own
# rounding, and the two curves parted by 0.36 of their start at some trip
# while both fell to 1e-9 (on an H100, PERF.md §6). Each trace within
# LOGGED_TRACE_TOL of its row's largest value (each device sums its dots in
# its own order), x within LOGGED_X_TOL of max |x|. The direct solve's
# residual is rounding noise on both and is held to be finite alone. Uzawa:
# the first solve's trace alone, and x under the Uzawa path's bound: the Schur
# CG puts the contact vertices on the floor within rounding, and whether the
# next detection finds them below it is a last-bit coin flip per device
# (tests/test_torch_logging.py), after which the iterations part.
LOGGED_TRACE_TOL = 1e-6
LOGGED_X_TOL = 1e-8


def logged_scene(name, device):
    """A LOGGED_SCENES scene on `device`, initialized again in float64."""
    if name == "beam":
        s = make_solver(NH, device=device)[0]
    elif name in PCG_SCENES:
        s = pcg_scene(name, torch_api(device))[0]
    else:
        s = contact_scene(name, torch_api(device))
    need(s.initialize(dataclasses.replace(s.m_settings, dtype=np.float64)),
         f"{name}: initialize failed")
    return s


# Gauss-Seidel's first solve on floor_gs5k after landing floors at the
# projection equilibrium, 0.2 of its start (the port on the CPU, alike with
# 30, 100 and 300 sweeps): it must fall, where tests/test_solverlog.py's
# dropped box, whose first solve starts far from equilibrium, falls 10x.
GS_FIRST_FALL = 1.0


def solverlog_assertions(ls, r, f64=False, gs_fall=0.1):
    """tests/test_solverlog.py's assertions on one step's residual traces r
    [admm_iters, n_inner], its absolute slacks (1e-12 and the like, for
    float64) taken as 1e-6 of the largest residual in float32; gs_fall the
    fall of Gauss-Seidel's first solve (0.1 there)."""
    slack = (lambda a: a) if f64 else (lambda a: max(a, 1e-6 * float(np.abs(r).max())))
    if ls == 3:
        return bool(np.all(r[:, -1] <= 1e-6 * r[:, 0] + slack(1e-12)))
    if ls == 1:
        return bool(r[0, -1] < gs_fall * r[0, 0]
                    and np.all(r[:, -1] <= 1.1 * r[:, 0] + slack(1e-9)))
    if ls == 2:
        return bool(np.all(np.diff(r, axis=1) <= slack(1e-12) + 0.5 * r[:, :-1])
                    and np.all(r[:, -1] <= r[:, 0] + slack(1e-15)) and r.max() > 0)
    if ls == 4:
        nz = r[:, 0] > 1e-12
        return bool(np.all(r[nz, -1] <= 1e-4 * r[nz, 0] + slack(1e-10)))
    return True


def logged_checks(torch):
    """The logged step (log_inner: step() routes to step_logged) once per
    linsolver on LOGGED_SCENES in float64, on the card and on a
    Solver(device="cpu") from the same state: the traces' shape [admm_iters, n_inner], all finite,
    tests/test_solverlog.py's assertions (solverlog_assertions), and the card
    against the CPU under LOGGED_TRACE_TOL / LOGGED_X_TOL."""
    from admm_elastic_tpu_torch.system.system import SimState

    out = {}
    for ls, (name, before, n_log) in LOGGED_SCENES.items():
        card = logged_scene(name, DEVICE)
        card.run(before)
        cpu = logged_scene(name, "cpu")
        cpu.state = SimState(**{f: getattr(card.state, f).cpu().clone()
                                for f in ("x", "v", "y", "prev_active")})
        logs, wall = [], []
        for s in (card, cpu):
            need(s.m_settings.linsolver == ls, f"{name}: linsolver {s.m_settings.linsolver}")
            s.m_settings.log_inner = True
            s.m_settings.log_inner_iters = n_log
            t0 = time.perf_counter()
            logs.append(s.step())
            wall.append(time.perf_counter() - t0)
            s.m_settings.log_inner = False
        lc, lh = logs
        r = lc.residuals
        n_inner = n_log or {0: 1, 1: card.m_settings.gs_max_iters,
                            2: card.m_settings.uzawa_max_iters, 3: card.m_settings.pcg_max_iters,
                            4: card.m_settings.pcg_max_iters}[ls]
        need(r.shape == (card.m_settings.admm_iters, n_inner) and np.isfinite(r).all()
             and lc.final_r == float(r[-1, -1]),
             f"{name}: logged traces of shape {r.shape}, finite {np.isfinite(r).all()}")
        need(solverlog_assertions(ls, r, f64=True, gs_fall=GS_FIRST_FALL),
             f"{name}: the traces fail tests/test_solverlog.py's "
             f"assertions: first solve {r[0].tolist()}")
        rows = 1 if ls == 2 else r.shape[0]
        scale = np.maximum(np.abs(lh.residuals[:rows]).max(axis=1, keepdims=True), 1e-30)
        trace_err = (0.0 if ls == 0 else
                     float((np.abs(r[:rows] - lh.residuals[:rows]) / scale).max()))
        x_err = rel_err(card.x, cpu.x)
        x_tol = CONTACT_STEP_TOL[name][1] if ls == 2 else LOGGED_X_TOL
        log(f"logged step ls={ls} on {name}: traces {r.shape}, first solve "
            f"{r[0, 0]:.3e} -> {r[0, -1]:.3e}, final_r {lc.final_r:.3e}; against the CPU: "
            f"trace {trace_err:.3e} (bound {LOGGED_TRACE_TOL}, {rows} rows), x {x_err:.3e} "
            f"(bound {x_tol}); {wall[0]:.2f} s on {DEVICE}, {wall[1]:.2f} s on the CPU")
        need(trace_err <= LOGGED_TRACE_TOL and x_err <= x_tol,
             f"{name}: the card's logged step is off the CPU's: trace {trace_err}, x {x_err}")
        out[name] = dict(linsolver=ls, shape=list(r.shape), final_r=lc.final_r,
                         first_solve=[float(r[0, 0]), float(r[0, -1])], trace_err=trace_err,
                         trace_rows=rows, x_err=x_err, card_s=wall[0], cpu_s=wall[1])
    return out


def profiled_checks(torch):
    """The profiled step (verbose=2: step() routes to step_profiled) on the
    bench beam and on floor_gs5k after landing: x bitwise the eager step's
    (_run_eager(1)) from the same state, every phase > 0 and their sum within
    step_ms."""
    out = {}
    for name in ("beam", "floor_gs5k"):
        s = make_solver(NH)[0] if name == "beam" else contact_scene(name, torch_api())
        if name != "beam":
            s.run(LANDING_STEP)
        state0 = s.state.clone()
        s._run_eager(1)
        x_eager = s.state.x.clone()
        s.state = state0.clone()
        s.m_settings.verbose = 2
        rt = s.step()
        s.m_settings.verbose = 0
        phases = dict(local_ms=rt.local_ms, collision_ms=rt.collision_ms,
                      global_ms=rt.global_ms)
        need(bool(torch.equal(s.state.x, x_eager)),
             f"{name}: the profiled step is not the eager step bit for bit")
        need(min(phases.values()) > 0 and sum(phases.values()) <= rt.step_ms,
             f"{name}: profiled phases {phases} against step_ms {rt.step_ms}")
        log(f"profiled step on {name}: bitwise the eager step; " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()) + f" of step_ms {rt.step_ms:.3f}, "
            f"inner iterations {rt.inner_iters}")
        out[name] = dict(phases, step_ms=rt.step_ms, inner_iters=rt.inner_iters, bitwise=True)
    return out


def checkpoint_checks(torch):
    """On the bench beam through the captured step: a kept solver.state is a
    snapshot (st0 after run(0), step 0: a step from it leaves it as it was,
    and st0 restored steps bit for bit as before); tests/test_utils.py:22-40's
    bitwise replay from a checkpoint (utils/checkpoint.py); the card's file
    loads on the CPU bit for bit; and the cost of the snapshot, the two
    device copies of x, v, y and prev_active a step() or run(n) makes where
    the caller assigned a state, and a step() with and without the copy in
    (CUDA events)."""
    import tempfile

    from admm_elastic_tpu_torch.utils import checkpoint as ck

    s = make_solver(NH)[0]
    s.run(0)
    st0 = s.state
    ref = st0.clone()
    s.step()
    x1 = s.state.x.clone()
    fields = ("x", "v", "y", "prev_active")
    need(all(bool(torch.equal(getattr(st0, f), getattr(ref, f))) for f in fields),
         "a kept state was written by the step after it")
    s.state = st0
    s.step()
    need(bool(torch.equal(s.state.x, x1)), "a kept state does not restore the step")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        s.run(3)
        ck.save_state(path, s.state)
        x3 = s.x
        s.step()
        s.state = ck.load_state(path, device=DEVICE)
        need(np.array_equal(s.x, x3), "the loaded state is not the saved one")
        s.step()
        x4 = s.x
        s.state = ck.load_state(path, device=DEVICE)
        s.step()
        need(np.array_equal(s.x, x4), "the step from a checkpoint does not repeat bit for bit")
        cpu = ck.load_state(path, device="cpu")
        need(np.array_equal(cpu.x.numpy(), x3) and cpu.x.device.type == "cpu",
             "the card's checkpoint does not load on the CPU")
    out = dict(snapshot=True, replay_bitwise=True, loads_on_cpu=True)
    if DEVICE == "cuda":
        g = s._step_graph()

        def copies():
            for f in fields:
                getattr(g.state, f).copy_(getattr(s.state, f))
            return g.state.clone()

        def assigned_step():
            s.state = dataclasses.replace(s.state)  # another object, the same tensors
            s.step()

        # the copies alone, and a whole step() on the state the last one
        # handed out (one copy, out) against one on an assigned state (two),
        # in turns
        out["snapshot_copies_us"] = events_ms(torch, copies, 200) * 1e3
        steps = in_turns([("kept", s.step), ("assigned", assigned_step)],
                         lambda call: events_ms(torch, call, 200) * 1e3)
        out["step_us"] = steps
        log(f"the kept state's snapshot: {out['snapshot_copies_us']:.2f} us for both copies of "
            f"x, v, y, prev_active; step() on the handed state "
            + ", ".join(f"{t:.2f}" for t in steps["kept"]) + " us, on an assigned state "
            + ", ".join(f"{t:.2f}" for t in steps["assigned"])
            + " us (in turns; the bench beam, CUDA events)")
    log("checkpoint: a kept state is a snapshot; the replay from a checkpoint repeats bit "
        "for bit; the card's file loads on the CPU")
    return out


def extras_checks(torch):
    """The checks of the solver extras beyond their paths: Anderson's gain,
    the logged and profiled steps, checkpoints and the snapshot."""
    return dict(aa_wins=aa_wins_check(torch), logged=logged_checks(torch),
                profiled=profiled_checks(torch), checkpoint=checkpoint_checks(torch))


def variant_turns(torch, gpu):
    """Each variant path's rollout rate beside its base path's, through the
    captured step, in turns (base, variant, variant, base), on solvers of
    their own."""
    def solver_of(name):
        base = variant_of(name)[0]
        if base == "beam":
            return make_solver(NH, name=None if name == base else name)[0]
        if base in CLOTH_SCENES:
            return make_cloth_solver(name)[0]
        return contact_scene(name, torch_api())

    out = {}
    for name in AA_PATHS + (WIND_SEQ_PATH,):
        base = variant_of(name)[0]
        pair = {base: solver_of(base), name: solver_of(name)}
        out[name] = in_turns([(k, lambda k=k: rollout_rate(pair[k])) for k in pair],
                             lambda call: call())
        log(f"rollout {name} against {base}: " + "; ".join(
            f"{k} " + ", ".join(f"{r['admm_iters_per_s']:.1f}" for r in v)
            for k, v in out[name].items()) + f" ADMM iters/s (in turns) [{gpu}]")
    return out


def wind_form_turns(torch, gpu):
    """What kernel I's form moves end to end: cloth_wind40_seq captured with
    kernel I in the form its wrapper chooses (SHARED on this sheet) and once
    more with it held to GLOBAL, on solvers of their own; their rollout rates
    in turns (chosen, GLOBAL, GLOBAL, chosen, twice over), and the captured
    step's device time by CUDA events over 200 replays, in the same turns."""
    from admm_elastic_tpu_torch.ops import cuda_wind

    chosen = make_cloth_solver(WIND_SEQ_PATH)[0]
    chosen.run(0)
    i_form = cuda_wind.i_form
    cuda_wind.i_form = lambda n, w, itemsize, optin, want=None: i_form(n, w, itemsize, optin,
                                                                       want or "global")
    try:
        held = make_cloth_solver(WIND_SEQ_PATH)[0]
        held.run(0)  # the capture: no replay calls the wrapper again
    finally:
        cuda_wind.i_form = i_form
    pair = {"chosen": chosen, "global": held}
    out = {f"{k} rates": v for k, v in in_turns(
        [(k, lambda k=k: rollout_rate(pair[k])) for k in pair] * 2, lambda call: call()).items()}
    if DEVICE == "cuda":
        out.update({f"{k} step_ms": v for k, v in in_turns(
            [(k, lambda k=k: events_ms(torch, pair[k]._graph.graph.replay, 200)) for k in pair],
            lambda call: call()).items()})
    log(f"rollout {WIND_SEQ_PATH}, kernel I in its chosen form against GLOBAL: "
        + "; ".join(f"{k} " + ", ".join(f"{r['admm_iters_per_s']:.1f}" for r in out[f"{k} rates"])
                    for k in pair) + " ADMM iters/s (in turns); "
        + "; ".join(f"{k} " + ", ".join(f"{t * 1e3:.1f}" for t in out.get(f"{k} step_ms", []))
                    for k in pair) + f" us a replayed step [{gpu}]")
    return out


# --- phase 5: timing ---------------------------------------------------------------------

def rollout_rate(solver, eager=False):
    """ADMM iterations/s over a rollout of at least TARGET_S: run(n), the
    captured step's replays, or with eager the eager loop (_run_eager)."""
    advance = solver._run_eager if eager else solver.run
    n_steps = 5
    while True:
        t0 = time.perf_counter()
        advance(n_steps)  # both synchronize before they return
        wall = time.perf_counter() - t0
        if wall >= TARGET_S:
            break
        n_steps = max(n_steps + 1, int(n_steps * max(2.0, 1.2 * TARGET_S / wall)))
    need(np.isfinite(solver.x).all(), "non-finite state after the timed rollout")
    iters = n_steps * solver.m_settings.admm_iters
    return dict(rollout_steps=n_steps, wall_s=wall, admm_iters_per_s=iters / wall,
                step_ms=wall / n_steps * 1e3)


def two_launch_local_step(system, x, u):
    """The local step as it ran before D x moved into its launch (system.Dx,
    then each family's rows entry, then the pins): timed beside
    system.local_step within one run, it is used by no path."""
    from admm_elastic_tpu_torch.system import system as sysm

    dix = sysm.Dx(system, x)
    out = [b.local_step_rows(d, ui)
           for b, d, ui in zip(tuple(system.tets) + tuple(system.tris), dix, u)]
    if system.pins is not None:
        zi = system.pins.prox(dix[-1] + u[-1])
        out.append((zi, u[-1] + dix[-1] - zi))
    return out


def step_phases(torch, solver):
    """Mean ms of each phase of one ADMM iteration of the beam, isolated (CUDA events)."""
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil
    from admm_elastic_tpu_torch.solvers import direct
    from admm_elastic_tpu_torch.system import system as sysm

    system, data = solver.system, solver._solve_data
    b0 = system.tets[0]
    x = solver.state.x
    z = sysm.zeros_like_Dx(system, x.dtype, x.device)
    u = [torch.zeros_like(zi) for zi in z]
    dix = cuda_stencil.tet_Dx_rows(x, b0)
    zt, ut = cuda_local_step.local_step_tet_hyper(dix, u[0], b0.mu, b0.lam, b0.kappa, b0.bulk)
    z[0], u[0] = zt, ut
    b = sysm.rhs(system, system.masses[:, None] * x, z, u)
    xs = direct.solve(data, b)
    reps = 200
    return {
        "Dx (kernel B, standalone: not in the step)": events_ms(
            torch, lambda: cuda_stencil.tet_Dx_rows(x, b0), reps),
        "local step, rows entry (kernel A; not in the step)": events_ms(
            torch, lambda: cuda_local_step.local_step_tet_hyper(
                dix, u[0], b0.mu, b0.lam, b0.kappa, b0.bulk), reps),
        "local step, stencil entry (kernel A computing D x)": events_ms(
            torch, lambda: cuda_local_step.local_step_tet_stencil(x, u[0], b0), reps),
        "rhs D^T W^2 (kernel C)": events_ms(
            torch, lambda: cuda_stencil.tet_rhs_rows(z[0], u[0], b0, system.n_verts), reps),
        "local step, whole (stencil entry + pins)": events_ms(
            torch, lambda: sysm.local_step(system, x, z, u), reps),
        "local step by two launches (B + rows entry + pins; not in the step)": events_ms(
            torch, lambda: two_launch_local_step(system, x, u), reps),
        "rhs, whole (C + pins + M x_bar)": events_ms(
            torch, lambda: sysm.rhs(system, x, z, u), reps),
        "direct.solve (GEMM)": events_ms(torch, lambda: direct.solve(data, b), reps),
        "direct.polish": events_ms(torch, lambda: direct.polish(data, xs, b), reps),
        "ADMM iteration": events_ms(torch, lambda: solver._apply_Ainv(
            sysm.rhs(system, x, *sysm.local_step(system, x, z, u))), reps),
    }


def cloth_phases(torch, solver):
    """The same for one ADMM iteration of the cloth step, and the wind force
    where the scene has one (once per step, not per iteration)."""
    from admm_elastic_tpu_torch.ops import cuda_tri_local_step
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.solvers import direct
    from admm_elastic_tpu_torch.system import system as sysm

    system, data = solver.system, solver._solve_data
    b0 = system.tris[0]
    x, v = solver.state.x, solver.state.v
    z = sysm.zeros_like_Dx(system, x.dtype, x.device)
    u = [torch.zeros_like(zi) for zi in z]
    dix = st.tri_Dx_rows(x, b0)
    z[0], u[0] = cuda_tri_local_step.local_step_tri(dix, u[0], b0.limit_min, b0.limit_max)
    b = sysm.rhs(system, system.masses[:, None] * x, z, u)
    xs = direct.solve(data, b)
    reps = 200
    out = {
        "tri_Dx_rows (plain PyTorch; not in the step)": events_ms(
            torch, lambda: st.tri_Dx_rows(x, b0), reps),
        "local step, rows entry (kernel E; not in the step)": events_ms(
            torch, lambda: cuda_tri_local_step.local_step_tri(
                dix, u[0], b0.limit_min, b0.limit_max), reps),
        "local step, stencil entry (kernel E computing D x)": events_ms(
            torch, lambda: cuda_tri_local_step.local_step_tri_stencil(x, u[0], b0), reps),
        "tri_Dt_rows (plain PyTorch)": events_ms(
            torch, lambda: st.tri_Dt_rows(z[0], b0, system.n_verts), reps),
        "local step, whole (stencil entry + pins)": events_ms(
            torch, lambda: sysm.local_step(system, x, z, u), reps),
        "local step by tri_Dx_rows + rows entry + pins (not in the step)": events_ms(
            torch, lambda: two_launch_local_step(system, x, u), reps),
        "rhs, whole (D^T + pins + M x_bar)": events_ms(
            torch, lambda: sysm.rhs(system, x, z, u), reps),
        "direct.solve (GEMM)": events_ms(torch, lambda: direct.solve(data, b), reps),
        "direct.polish": events_ms(torch, lambda: direct.polish(data, xs, b), reps),
        "ADMM iteration": events_ms(torch, lambda: solver._apply_Ainv(
            sysm.rhs(system, x, *sysm.local_step(system, x, z, u))), reps),
    }
    for i, f in enumerate(solver.ext_forces):
        out[f"wind force {i} (once per step)"] = events_ms(
            torch, lambda f=f: f.project(system.dt, x, v, system.masses), reps)
    return out


def plain_flops(torch, fn):
    """Arithmetic operations fn() performs, counted as it runs: one per
    output element of every add / sub / mul / div / neg / sqrt / log / abs /
    max / min / clamp / reciprocal / sign (selects, compares and copies count
    nothing). For B, C and E, whose plain versions do their kernels'
    arithmetic and no more; the tet kernels are counted by tet_operations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "log", "abs", "maximum",
             "minimum", "clamp", "clamp_min", "clamp_max", "reciprocal", "sign", "sgn"}

    class Count(TorchDispatchMode):
        flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket.__name__.rstrip("_") in arith
                    and isinstance(out, torch.Tensor)):
                self.flops += out.numel()
            return out

    with Count() as mode:
        fn()
    return mode.flops


# Arithmetic operations of one lane of the tet kernels, counted by hand from
# csrc/prox_body.cuh with common subexpressions taken once and terms that a
# model makes zero left out (the plain versions compute f, g and h of a spline
# where one is used, and run every trip of both Newton loops on every lane,
# so their count says nothing of what the function needs). Every + - * /
# sqrt log abs max min sign counts one, which keeps the bound a lower one.
#   signed_svd3: F^T F 30; 8 sweeps x 3 rotations x 54 (theta 5, t 7, c and s
#   5, the two diagonal entries 13, the two off-diagonals 6, V 18); S 6; F V
#   45; U with its fallbacks 70; the two determinants and flips 32.
OPS_SVD = 30 + 8 * 3 * 54 + 6 + 45 + 70 + 32
OPS_LINEAR = 9 * 7  # 1/2 (U V^T + F)
OPS_COMPOSE = 4 + 3 * 18  # the collapse test, |s3|, U diag(s) V^T
OPS_DUAL = 18  # the rows entry: v = D x + u and u' = v - z
# psi, its gradient and its Hessian per model (Energy<T, MODEL>).
OPS_ENERGY = {NH: (17, 19, 29), "stvk": (21, 26, 35), "spline_nh": (32, 28, 51),
              "spline_stvk": (66, 72, 101), "spline_corot": (54, 57, 42)}
OPS_VALUE = 14  # prox_value around psi: the quadratic, the clamps
OPS_GRADIENT = 17  # around grad: k (s - s0), the active set, |g|^2
OPS_SEARCH = 85  # around hess: active set, damping, the 3x3 solve, |step|^2
OPS_CANDIDATE = 10  # s - t d clamped, t / 2


def tet_operations(model, lanes, rows, trips):
    """Operations the tet prox needs on `lanes` lanes whose Newton solve took
    `trips` (ops/hyper_soa.newton_soa: counted on this run's inputs)."""
    fixed = OPS_SVD + (OPS_DUAL if rows else 0)
    if model == "linear":
        return lanes * (fixed + OPS_LINEAR)
    psi, grad, hess = OPS_ENERGY[model]
    value = OPS_VALUE + psi
    return (lanes * (fixed + OPS_COMPOSE) + trips["gradients"] * (OPS_GRADIENT + grad)
            + trips["searches"] * (OPS_SEARCH + hess + value)
            + trips["candidates"] * (OPS_CANDIDATE + value))


def warp_chains(torch, model, lanes):
    """What the slowest thread of a warp runs, from the plain version's
    per-trip masks (newton_soa(trips={"lanes": []})): a warp of 32 lanes takes
    a Newton trip while any of its lanes is live, a search while any searches,
    and as many candidates as its slowest lane. The mean and the largest
    number of trips and of candidates over the warps, and the operations of a
    warp's chain as a share of the full chain (8 trips of 8 candidates, which
    every lane of the plain version runs), mean and largest."""
    def by_warp(m):
        a = torch.stack(m).cpu()
        need(a.shape[1] % 32 == 0, "lanes do not fill whole warps")
        return a.reshape(a.shape[0], -1, 32)

    live, search, tried = (by_warp([m[i] for m in lanes]) for i in range(3))
    psi, grad, hess = OPS_ENERGY[model]
    value = OPS_VALUE + psi
    fixed = OPS_SVD + OPS_DUAL + OPS_COMPOSE
    per_trip = (OPS_GRADIENT + grad, OPS_SEARCH + hess + value, OPS_CANDIDATE + value)
    full = fixed + len(lanes) * (per_trip[0] + per_trip[1] + 8 * per_trip[2])
    trips = live.any(dim=2).sum(dim=0).double()
    searches = search.any(dim=2).sum(dim=0).double()
    cands = (tried.double() * search).amax(dim=2).sum(dim=0)
    chain = (fixed + trips * per_trip[0] + searches * per_trip[1] + cands * per_trip[2]) / full
    return dict(full_chain_operations=full,
                trips_mean=float(trips.mean()), trips_max=float(trips.max()),
                warps_at_max_trips=int((trips == trips.max()).sum()),
                candidates_mean=float(cands.mean()), candidates_max=float(cands.max()),
                chain_mean=float(chain.mean()), chain_max=float(chain.max()))


def measure(torch, kern, plain, reads, reps_kernel, reps_plain, operations=None):
    """A kernel against its plain version (CUDA events; plain, kernel, kernel,
    plain: the two readings of each show the drift) and its bound: the bytes
    of `reads` and of the kernel's outputs, each moved once, over the card's
    memory rate, against `operations` (the plain version's where none are
    given) over its float32 rate."""
    p1 = events_ms(torch, plain, reps_plain)
    k1 = events_ms(torch, kern, reps_kernel)
    k2 = events_ms(torch, kern, reps_kernel)
    p2 = events_ms(torch, plain, reps_plain)
    outs = kern()
    outs = outs if isinstance(outs, tuple) else (outs,)
    n_bytes = sum(t.numel() * t.element_size() for t in list(reads) + list(outs))
    flops = plain_flops(torch, plain) if operations is None else operations
    bound_ms, bound_by = bound_of(n_bytes, flops)
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), readings=[p1, k1, k2, p2],
                bytes=n_bytes, operations=flops, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def prox_turn_cases(torch, model, zi, params, trips):
    """Kernel D (or F) and kernel A's rows entry on the same values (as rows
    with u = 0) at the beam's 7,680 lanes and tiled TILES times, float32:
    size label -> lanes, [(label, call)] (the rows entry, then D / F) to be
    timed in turns, and the bytes and operations of each (the Newton trips of
    the beam's values, times TILES)."""
    from admm_elastic_tpu_torch.ops import cuda_local_step

    out = {}
    for label, reps in (("7680 lanes", 1), (f"{TILES * zi.shape[0]} lanes", TILES)):
        zt = tiled(zi, reps)
        pt = tuple(tiled(p, reps) for p in params)
        rows = zt.reshape(-1, 9).T.contiguous()
        u0 = torch.zeros_like(rows)
        lanes = zt.shape[0]
        lane_params = [] if model == "linear" else list(pt)
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
        trips_t = {k: v * reps for k, v in trips.items()}
        calls = [("rows entry", lambda rows=rows, u0=u0, pt=pt: cuda_local_step.local_step_tet_hyper(
                     rows, u0, *pt, model=model)),
                 ("prox", lambda zt=zt, pt=pt: prox_call(zt, pt, model))]
        out[label] = dict(
            lanes=lanes, calls=calls,
            bytes={"prox": nbytes([zt, zt] + lane_params),
                   "rows entry": nbytes([rows, u0, rows, u0] + lane_params)},
            operations={"prox": tet_operations(model, lanes, False, trips_t),
                        "rows entry": tet_operations(model, lanes, True, trips_t)})
    return out


def kernel_cases(torch):
    """Every kernel at the shapes of the paths, float32, on main-path inputs:
    name -> (kernel call, plain call, tensors read, kernel reps, plain reps[,
    operations]); kernel C's two branches, [(label, call)]; the warps' chains
    of A by model (warp_chains); and, per local step, its rows entry (D x given)
    and its stencil entry (D x computed by the lane) on the same inputs,
    [(label, call)], to be timed in turns: the difference is what D x costs
    inside the launch. A stencil entry's bytes are its own: x, the stencil
    fields, u and the lane parameters in, z and u' out, no D x rows."""
    from admm_elastic_tpu_torch.ops import (cuda_local_step, cuda_prox, cuda_stencil,
                                            cuda_tri_local_step)
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import (local_step_plain, prox_plain,
                                                      prox_tet_hyper_tuple)
    from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

    f32 = torch.float32
    mesh, b = beam_batch(torch, f32)
    n = mesh.vertices.shape[0]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                        device=DEVICE, dtype=f32)
    dix = cuda_stencil.tet_Dx_rows(x, b)
    u = torch.as_tensor(0.05 * rng.standard_normal((9, b.n)), device=DEVICE, dtype=f32)
    zi = dix.T.reshape(-1, 3, 3).contiguous()
    base, cells, n_vblock = b.stencil[0], b.st_par.shape[0], b.stencil[1] * b.stencil[2] * b.stencil[3]
    need(cells * 5 == b.n, "stencil cells and lanes disagree")
    cases = {
        "tet_Dx_rows": (
            lambda: cuda_stencil.tet_Dx_rows(x, b), lambda: st.tet_Dx_rows_plain(x, b),
            [x[base:base + n_vblock], b.st_dl, b.st_par, b.st_dead], 500, 50),
        "tet_rhs_rows": (
            lambda: cuda_stencil.tet_rhs_rows(dix, u, b, n),
            lambda: st.tet_rhs_rows_plain(dix, u, b, n),
            [dix, u, b.weight, b.st_dl, b.st_par], 500, 50),
    }
    c_branches = [(branch, lambda branch=branch: cuda_stencil.tet_rhs_rows(
        dix, u, b, n, branch=branch)) for branch in ("wide", "tiled")]
    chains, pairs, prox_turns = {}, {}, {}
    dx_ops = plain_flops(torch, lambda: st.tet_Dx_rows_plain(x, b))

    def tet_cases(model, bm):
        args = (dix, u, bm.mu, bm.lam, bm.kappa, bm.bulk)
        params = [] if model == "linear" else [bm.mu, bm.lam, bm.kappa, bm.bulk]
        # The Newton trips of these inputs: A's prox sees D x + u, D's sees D x.
        trips = {}
        for rows, f in ((True, dix + u), (False, dix)):
            trips[rows] = {"lanes": []} if rows else {}
            if model != "linear":
                prox_tet_hyper_tuple(tuple(f), model, *args[2:], trips=trips[rows])
        masks = trips[True].pop("lanes")
        ops = {rows: tet_operations(model, b.n, rows, trips[rows]) for rows in trips}
        log(f"trips {model}: " + json.dumps({"rows": trips[True], "[T,3,3]": trips[False]}))
        if model != "linear":
            chains[model] = warp_chains(torch, model, masks)
            log(f"warp chains {model} (rows): " + json.dumps(chains[model]))
        cases[f"local_step_tet_hyper[{model}]"] = (
            lambda: cuda_local_step.local_step_tet_hyper(*args, model=model),
            lambda: local_step_plain(*args, model=model), [dix, u] + params, 200, 3, ops[True])
        cases[f"local_step_tet_stencil[{model}]"] = (
            lambda: cuda_local_step.local_step_tet_stencil(x, u, bm),
            lambda: local_step_plain(st.tet_Dx_rows_plain(x, bm), *args[1:], model=model),
            [x[base:base + n_vblock], bm.st_dl, bm.st_par, bm.st_dead, u] + params, 200, 3,
            ops[True] + dx_ops)
        pairs[f"local_step_tet[{model}]"] = [
            ("rows entry", cases[f"local_step_tet_hyper[{model}]"][0]),
            ("stencil entry", cases[f"local_step_tet_stencil[{model}]"][0])]
        if model == "linear":
            cases["prox_tet_linear"] = (
                lambda: cuda_prox.prox_tet_linear(zi),
                lambda: prox_plain(zi, model, None, None, None, None), [zi], 200, 3, ops[False])
        else:
            cases[f"prox_tet_hyper[{model}]"] = (
                lambda: cuda_prox.prox_tet_hyper(zi, model, *args[2:]),
                lambda: prox_plain(zi, model, *args[2:]), [zi] + params, 200, 3, ops[False])
        prox_turns[model] = prox_turn_cases(torch, model, zi, args[2:], trips[False])

    for model in TET_MODELS:
        tet_cases(model, beam_batch(torch, f32, model)[1])
    verts, tb = cloth_batch(torch, f32)
    xs = torch.as_tensor(verts + 0.02 * rng.standard_normal(verts.shape), device=DEVICE,
                         dtype=f32)
    e_args = (st.tri_Dx_rows(xs, tb),
              torch.as_tensor(0.02 * rng.standard_normal((6, tb.n)), device=DEVICE, dtype=f32),
              tb.limit_min, tb.limit_max)
    cases["local_step_tri"] = (
        lambda: cuda_tri_local_step.local_step_tri(*e_args),
        lambda: local_step_tri_plain(*e_args), list(e_args), 500, 50)
    cases["local_step_tri_stencil"] = (
        lambda: cuda_tri_local_step.local_step_tri_stencil(xs, e_args[1], tb),
        lambda: local_step_tri_plain(st.tri_Dx_rows(xs, tb), *e_args[1:]),
        [xs, tb.st_dl, tb.st_dead] + list(e_args[1:]), 500, 50)
    pairs["local_step_tri"] = [("rows entry", cases["local_step_tri"][0]),
                               ("stencil entry", cases["local_step_tri_stencil"][0])]
    # The rows entries at the shapes of the gather paths (name@path), on D x
    # gathered from a perturbed rest pose, from a generator of their own.
    rng_g = np.random.default_rng(6)
    for scene, (verts, gb, noise) in gather_batches(torch, f32).items():
        xg = torch.as_tensor(verts + noise * rng_g.standard_normal(verts.shape), device=DEVICE,
                             dtype=f32)
        dixg = gb.Dx_rows(xg)
        key = gather_key(scene, gb)
        if key == "local_step_tri":
            ug = torch.as_tensor(0.02 * rng_g.standard_normal((6, gb.n)), device=DEVICE,
                                 dtype=f32)
            ga = (dixg, ug, gb.limit_min, gb.limit_max)
            cases[f"{key}@{scene}"] = (
                lambda ga=ga: cuda_tri_local_step.local_step_tri(*ga),
                lambda ga=ga: local_step_tri_plain(*ga), list(ga), 500, 50)
            continue
        ug = torch.as_tensor(0.05 * rng_g.standard_normal((9, gb.n)), device=DEVICE, dtype=f32)
        ga, model = (dixg, ug, gb.mu, gb.lam, gb.kappa, gb.bulk), gb.model
        trips = {}
        if model != "linear":
            prox_tet_hyper_tuple(tuple(dixg + ug), model, *ga[2:], trips=trips)
        cases[f"{key}@{scene}"] = (
            lambda ga=ga, model=model: cuda_local_step.local_step_tet_hyper(*ga, model=model),
            lambda ga=ga, model=model: local_step_plain(*ga, model=model),
            [dixg, ug] + ([] if model == "linear" else list(ga[2:])), 200, 3,
            tet_operations(model, gb.n, True, trips))
    return cases, c_branches, chains, pairs, prox_turns


def kernel_times(torch, cases):
    """Every kernel against its plain version and its bound. No single PyTorch
    call computes any of these functions but B's and C's (stencil_library_times;
    a batched torch.linalg.svd is not the signed SVD plus the Newton solve), so
    library_ms is null here."""
    return {name: measure(torch, *case) for name, case in cases.items()}


# The shapes at which kernels B and C are timed beside one torch.sparse.mm call:
# the bench beam's and beam_pcg160k's lattices.
LIBRARY_SHAPES = {"beam": (40, 5, 5), "beam_pcg160k": PCG_SCENES["beam_pcg160k"]["dims"]}


def stencil_csr(torch, b, n):
    """D of a stencil family as CSR matrices, float32 on the card: D [3 T, N]
    (row j * T + t: column j of lane t's deformation gradient, so that D x for
    x [N, 3] holds F[t, i, j] at [j * T + t, i]) and D^T W^2 [N, 3 T]."""
    inds = b.inds.cpu().numpy().astype(np.int64)
    dl = b.Dlocal.double().cpu().numpy()  # [T, 4, 3]
    w2 = (b.weight.double() ** 2).cpu().numpy()
    t = inds.shape[0]
    lane, corner, col = np.meshgrid(np.arange(t), np.arange(4), np.arange(3), indexing="ij")
    rows = (col * t + lane).ravel()
    cols = inds[lane, corner].ravel()
    vals = dl[lane, corner, col].ravel()
    keep = vals != 0.0  # dead lanes have Dlocal 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    def csr(r, c, v, shape):
        coo = torch.sparse_coo_tensor(np.stack([r, c]), v, shape, dtype=torch.float64)
        return coo.coalesce().to_sparse_csr().to(device=DEVICE, dtype=torch.float32)

    return (csr(rows, cols, vals, (3 * t, n)),
            csr(cols, rows, vals * w2[rows % t], (n, 3 * t)))


def stencil_library_times(torch, gpu, reps=200):
    """Kernels B and C against one torch.sparse.mm call that computes the same
    function on the same inputs (D x with D as CSR; D^T W^2 r with D^T W^2 as
    CSR and r = z - u formed beforehand, in the rows' [3 T, 3] layout; the
    layouts are transposes of the kernels' rows), at LIBRARY_SHAPES, float32,
    CUDA events (kernel, library, library, kernel; at the beam's shape both
    calls take less device time than the host's enqueue) and queued behind a
    sleep kernel (queued_us: the device's time): shape -> {"tet_Dx_rows",
    "tet_rhs_rows"} -> ms, library_ms, queued_us, library_queued_us and the
    largest gap between the two results relative to the kernel's largest
    entry."""
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.ops import cuda_stencil
    from admm_elastic_tpu_torch.system import elements as el

    f32 = torch.float32
    out = {}
    rng = np.random.default_rng(9)
    for shape, dims in LIBRARY_SHAPES.items():
        mesh = make_tet_blocks(*dims)
        n = mesh.vertices.shape[0]
        b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), NH, device=DEVICE,
                               dtype=f32, lattice_dims=mesh.lattice_dims)
        x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                            device=DEVICE, dtype=f32)
        z = cuda_stencil.tet_Dx_rows(x, b)
        u = torch.as_tensor(0.05 * rng.standard_normal((9, b.n)), device=DEVICE, dtype=f32)
        d_csr, dtw2_csr = stencil_csr(torch, b, n)
        t = b.n
        r = (z - u).reshape(3, 3, t).permute(1, 2, 0).reshape(3 * t, 3).contiguous()
        # B writes the identity on a dead lane (weight 0), D x 0: compared on
        # the live lanes
        live = (b.st_dead == 0).repeat(t // b.st_dead.shape[0]).repeat(3)
        pairs = {
            "tet_Dx_rows": (lambda: cuda_stencil.tet_Dx_rows(x, b),
                            lambda: torch.sparse.mm(d_csr, x),
                            lambda k: k.reshape(3, 3, t).permute(1, 2, 0).reshape(3 * t, 3)[live],
                            lambda y: y[live]),
            "tet_rhs_rows": (lambda: cuda_stencil.tet_rhs_rows(z, u, b, n),
                             lambda: torch.sparse.mm(dtw2_csr, r), lambda k: k, lambda y: y),
        }
        out[shape] = {}
        for name, (kern, lib, layout, lib_layout) in pairs.items():
            k1 = events_ms(torch, kern, reps)
            l1 = events_ms(torch, lib, reps)
            l2 = events_ms(torch, lib, reps)
            k2 = events_ms(torch, kern, reps)
            # the device's own time: the same calls queued behind a sleep kernel
            q = queued_us(torch, [("kernel", kern), ("library", lib)], 50)
            want = layout(kern())
            got = lib_layout(lib())
            gap = float((got - want).abs().max() / want.abs().max())
            need(gap < 1e-5, f"{name}@{shape}: torch.sparse.mm parts from the kernel by {gap}")
            out[shape][name] = dict(ms=min(k1, k2), library_ms=min(l1, l2),
                                    readings=[k1, l1, l2, k2], queued_us=q["kernel"],
                                    library_queued_us=q["library"], rel_gap=gap, lanes=t,
                                    vertices=n, nnz=int(d_csr.values().numel()))
            log(f"time {name}@{shape}: kernel {min(k1, k2) * 1e3:.1f} us, torch.sparse.mm "
                f"{min(l1, l2) * 1e3:.1f} us (CUDA events); queued {q['kernel']:.2f} and "
                f"{q['library']:.2f} us ({t} lanes, {n} vertices; results {gap:.1e} apart) "
                f"[{gpu}]")
    return out


def in_turns(calls, read):
    """read(call) for each of [(label, call)] in their order and then in the
    reverse order (kernel C: wide, tiled, tiled, wide), so that a drift within
    the run shows: label -> [first reading, second reading]."""
    got = {label: [] for label, _ in calls}
    for label, call in calls + calls[::-1]:
        got[label].append(read(call))
    return got


def profile_kernels(torch, cases, c_branches, pairs, prox_turns, gpu, reps=20):
    """torch.profiler over `reps` launches of each kernel, of kernel C's two
    branches (in turns), of each local step's rows entry and stencil entry (in
    turns), of kernels D and F beside kernel A's rows entry on the same
    values at both sizes (prox_device_times), and of the
    empty kernel: device time per launch, without the host's enqueue time
    that CUDA events include. The empty kernel's is the floor under any
    launch. Writes kernel_profile.json into OUT_DIR."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from admm_elastic_tpu_torch.ops import cuda_stencil

    def device_us(kern, name):
        # The profiler now and then returns a window with events missing: such
        # a window is taken again, and three short windows in a row fail the run.
        for _ in range(3):
            kern()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    kern()
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
            if len(us) >= reps:
                return sum(us) / reps, len(us) / reps
            log(f"profiler saw {len(us)} device events for {name}; the window is taken again")
        raise SmokeFailure(f"profiler saw {len(us)} device events for {name}, three times")

    out = {}
    for name, (kern, *_rest) in cases.items():
        us, ops = device_us(kern, name)
        out[name] = dict(device_us=us, device_ops_per_call=ops)
        log(f"device time {name}: {us:.2f} us per call ({ops:.1f} device ops) [{gpu}]")
    floor = [device_us(lambda: cuda_stencil.empty_launch(DEVICE), "the empty kernel")[0]
             for _ in range(2)]
    log(f"device time of an empty kernel (the launch floor): {floor[0]:.2f}, {floor[1]:.2f} us "
        f"[{gpu}]")
    by_branch = in_turns(c_branches, lambda call: device_us(call, "a branch of C")[0])
    for label, (first, second) in by_branch.items():
        log(f"device time tet_rhs_rows {label}: {first:.2f}, {second:.2f} us per call [{gpu}]")
    by_entry = {}
    for name, calls in pairs.items():
        by_entry[name] = in_turns(calls, lambda call: device_us(call, f"an entry of {name}")[0])
        rows, fused = by_entry[name]["rows entry"], by_entry[name]["stencil entry"]
        log(f"device time {name}: rows entry {rows[0]:.2f}, {rows[1]:.2f}, stencil entry "
            f"{fused[0]:.2f}, {fused[1]:.2f} us per call: D x inside the launch costs "
            f"{min(fused) - min(rows):.2f} us [{gpu}]")
    prox = prox_device_times(torch, gpu, prox_turns, reps)
    os.makedirs(OUT_DIR, exist_ok=True)
    res = dict(gpu=gpu, kernels=out, launch_floor_us=floor, rhs_branches_us=by_branch,
               entries_us=by_entry, prox_us=prox)
    with open(os.path.join(OUT_DIR, "kernel_profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def bound_of(nbytes, operations):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its float32 rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, operations / PEAK_F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def prox_event_times(torch, gpu, prox_turns, reps=20):
    """Kernels D and F at the throughput size (CUDA events, which read the
    device there: a launch takes longer than its enqueue) against kernel A's
    rows entry on the same values, in turns (rows entry, prox, prox, rows
    entry): model -> ms, rows_ms, the readings, and each one's bound."""
    out = {}
    for model, sizes in prox_turns.items():
        label = [k for k in sizes if k != "7680 lanes"][0]
        c = sizes[label]
        got = in_turns(c["calls"], lambda call: events_ms(torch, call, reps))
        res = dict(lanes=c["lanes"], ms=min(got["prox"]),
                   rows_ms=min(got["rows entry"]), readings=got)
        for who, key in (("prox", ""), ("rows entry", "rows_")):
            res[key + "bound_ms"], res[key + "bound_by"] = bound_of(c["bytes"][who],
                                                                    c["operations"][who])
        out[model] = res
        log(f"time {'F' if model == 'linear' else 'D'}[{model}] at {label}: "
            f"{res['ms'] * 1e3:.1f} us (bound {res['bound_ms'] * 1e3:.2f} us by {res['bound_by']}); "
            f"kernel A's rows entry on the same values {res['rows_ms'] * 1e3:.1f} us (bound "
            f"{res['rows_bound_ms'] * 1e3:.2f} us); readings {json.dumps(got)} [{gpu}]")
    return out


def prox_device_times(torch, gpu, prox_turns, reps=20):
    """torch.profiler device time per launch of kernel A's rows entry and of
    D / F on the same values, at both sizes: one window
    per model and size, the calls in order and then in the reverse order,
    reps launches each, read back in the order they ran (each call launches
    one kernel). A window that lost events is taken again, three times at
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for model, sizes in prox_turns.items():
        out[model] = {}
        for label, c in sizes.items():
            seq = c["calls"] + c["calls"][::-1]
            for attempt in range(3):
                for _, call in c["calls"]:
                    call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _, call in seq:
                        for _ in range(reps):
                            call()
                    torch.cuda.synchronize()
                ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                             and wrapper_of_symbol(e.name) is not None),
                            key=lambda e: e.time_range.start)
                if len(ev) == len(seq) * reps:
                    break
                log(f"profiler saw {len(ev)} of {len(seq) * reps} launches of {model} at {label}"
                    + ("; the window is taken again" if attempt < 2 else ""))
            else:
                raise SmokeFailure(f"profiler lost launches of {model} at {label}, three times")
            got = {name: [] for name, _ in c["calls"]}
            for i, (name, _) in enumerate(seq):
                chunk = ev[i * reps:(i + 1) * reps]
                got[name].append(sum(e.time_range.elapsed_us() for e in chunk) / reps)
            best = {name: min(v) for name, v in got.items()}
            res = dict(lanes=c["lanes"], device_us=got, prox_us=best["prox"],
                       rows_us=best["rows entry"])
            for who, key in (("prox", ""), ("rows entry", "rows_")):
                ms, res[key + "bound_by"] = bound_of(c["bytes"][who], c["operations"][who])
                res[key + "bound_us"] = ms * 1e3
            out[model][label] = res
            log(f"device time {'F' if model == 'linear' else 'D'}[{model}] at {label}: "
                + ", ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in got.items())
                + f" us per launch (in turns); D / F {res['prox_us']:.2f} us against "
                f"a bound of {res['bound_us']:.3f} us by {res['bound_by']}, the rows entry "
                f"{res['rows_us']:.2f} us against {res['rows_bound_us']:.3f} [{gpu}]")
    return out


def profile_step(torch, solver, gpu, tag, n_steps=5, eager=False, per_iter=None):
    """torch.profiler over n_steps of the rollout: run (the captured step's
    replays), or with eager the eager loop: device busy time, idle share,
    device operations per ADMM iteration and time by kernel name. Writes
    step_profile_<tag>[_eager].json (and the graph run's Chrome trace) into
    OUT_DIR. per_iter: the launches of each port kernel per ADMM iteration
    where that is not one (Uzawa's predicated trips), in the replays and in
    the eager loop alike."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    advance = solver._run_eager if eager else solver.run
    advance(2)
    iters = n_steps * solver.m_settings.admm_iters

    def counted_as_expected(ports):
        if not ports:
            return False
        if per_iter is None:
            return all(v == iters for v in ports.values())
        return all(ports.get(k, 0) == per_iter.get(k, 1) * iters
                   for k in set(ports) | set(per_iter))

    # The port's kernels launch per_iter times (once by default) per ADMM
    # iteration: a window that counts fewer lost events and is taken again.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            advance(n_steps)  # synchronizes before it returns
            wall_us = (time.perf_counter() - t0) * 1e6
        ports = port_kernel_counts(prof.events())
        if counted_as_expected(ports):
            break
        log(f"profile {tag}: the window counted {ports}, expected {iters} iterations of "
            f"{per_iter or 'one each'}; it is taken again")
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    how = "eager loop" if eager else "graph replays"
    need(counted_as_expected(ports),
         f"profile {tag}: the port's kernels counted {ports} three times, expected {iters} "
         f"iterations of {per_iter or 'one each'}")
    by_name = {}
    for e in events:
        cnt_us = by_name.setdefault(e.name, [0, 0.0])
        cnt_us[0] += 1
        cnt_us[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    res = dict(gpu=gpu, path=tag, mode="eager" if eager else "graph", steps=n_steps,
               admm_iters=iters, wall_us=wall_us, wall_us_per_step=wall_us / n_steps,
               busy_us=busy_us, busy_us_per_step=busy_us / n_steps,
               idle_share=1.0 - busy_us / wall_us,
               device_ops_per_admm_iter=len(events) / iters,
               by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    os.makedirs(OUT_DIR, exist_ok=True)
    name = f"step_profile_{tag}{'_eager' if eager else ''}"
    if not eager and tag not in CONTACT_SCENES:
        # (a contact path's trace runs to tens of MB: the output directory
        # that a remote run brings back is limited)
        prof.export_chrome_trace(os.path.join(OUT_DIR, f"step_trace_{tag}.json"))
    with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"profile {tag}, {n_steps} steps ({how}): wall {wall_us:.1f} us, device busy "
        f"{busy_us:.1f} us ({res['busy_us_per_step']:.1f} us per step), idle share "
        f"{res['idle_share']:.3f}, {res['device_ops_per_admm_iter']:.1f} device ops per ADMM "
        f"iteration [{gpu}]")
    for name, (cnt, us) in list(res["by_name"].items())[:12]:
        log(f"  {us:9.1f} us {cnt:5d}x {name[:90]}")
    return res


PROFILED = ("beam", "cloth_limit40", "cloth_wind40", "beam_gather") + PCG_PATHS + CONTACT_PATHS


def step_profiles(torch, gpu):
    """profile_step of each PROFILED path, graph replays and eager loop, on
    solvers of their own (a contact path's from its landed state, after
    LANDING_STEP steps): the --profile phase, run by main in a process of its
    own whose profiler has opened no window before."""
    out = {}
    for tag in PROFILED:
        if tag == "beam":
            solver = make_solver(NH)[0]
        elif tag in CLOTH_SCENES:
            solver = make_cloth_solver(tag)[0]
        elif tag in GATHER_SCENES:
            solver = make_gather_solver(tag)[0]
        elif tag in PCG_SCENES:
            solver = pcg_scene(tag, torch_api())[0]
        else:
            solver = contact_scene(tag, torch_api())
            solver.run(LANDING_STEP)
        per_iter = ({k: v for k, v in contact_counts(tag, 1)[0].items() if v}
                    if tag in CONTACT_SCENES else None)
        out[tag] = dict(graph=profile_step(torch, solver, gpu, tag, per_iter=per_iter),
                        eager=profile_step(torch, solver, gpu, tag, eager=True,
                                           per_iter=per_iter))
    return out


# The apps' holds against their goldens (tests/make_torch_golden.py, APP_RUNS).
# beams and trianglestrain: x at APP_STEPS within crossval's 1e-4 and 2e-3 of
# max |x| (benchmarks/crossval.py:299-302). The contact apps: x at step 1 within
# APP_FIRST_TOL (SELFCOLL_STEP_TOL's), then each later held step one step
# (run(1), the captured step) from the golden's state before it within
# APP_ONESTEP[name][step] of max |x|. Each bound is 3-5 times the larger of the
# port's one-step gap on the CPU and the golden's one-ulp control at that step
# (PERF.md §5): signorini (the floor's, the largest of the three obstacles',
# taken for all three) 1.56e-5 / 1.37e-6 at 8, 1.40e-6 / 1.07e-6 at 24; torus
# 3.53e-7 / 3.97e-7 at 17, 6.72e-2 / 6.70e-2 at 18 (the first self-contact: 192
# of Uzawa's 200 trips), 8.87e-8 / 1.77e-7 at 24; boxes 4.44e-6 / 3.64e-6 at 13
# (the first dynamic hit), 4.29e-6 / 2.56e-6 at 24.
#
# bunnyexpand is held so at steps 1 and 8 too, and tightly in float64
# (APP_F64_TOL). In float32 both packages' neo-Hookean prox leaves a collapsed
# tet at its inflation eps = 1e-6: at s = 1e-6 the Hessian's diagonal is some
# 7e22 and its determinant overflows, so every Newton candidate is NaN and is
# refused (ROADMAP Queue 3 item 17). The collapsed bunny stays some 1e-6 m
# across (float64: 0.81 m at step 1), and from the second ADMM iteration on a
# third to four fifths of its tets have their largest singular value within
# 0.1 % of eps, where the prox's collapse test flips on the last bits. Two
# roundings of one code part there as far as the port parts from the JAX
# package: the port's CPU and card runs by 4.61e-4 of max |x| at step 1, each
# from the JAX package by 5.07e-4 and 4.80e-4. The golden's one-ulp control
# reads 0 at step 1 (nextafter(0) is a denormal, which XLA's CPU flushes to 0,
# and a uniform shift is a translation that D x does not see) and 3.74e-4 at 8.
# The collapse's bound, 2e-3 (crossval's step-8 bound) at both steps, is some 4
# times those controls. The scramble is chaotic: the golden's one-ulp control
# moves step 1 by 7.71e-2 and step 8 by 2.64e-2, and its bounds are 4 times
# those, below the golden's own step (6.87e-1 and 1.57e-1 of max |x|), so a
# step that left x where it was fails them.
APP_FIRST_TOL = 1e-4
_SIGNORINI_ONESTEP = {8: 8e-5, 24: 8e-5}
APP_ONESTEP = {
    "bunnyexpand": {1: 2e-3, 8: 2e-3},
    "bunnyexpand_rand": {1: 0.3, 8: 0.1},
    "signorini": _SIGNORINI_ONESTEP,
    "signorini_sdf": _SIGNORINI_ONESTEP,
    "signorini_exact": _SIGNORINI_ONESTEP,
    "torus": {17: 2e-6, 18: 0.3, 24: 1e-6},
    "boxes": {13: 2e-5, 24: 2e-5},
}
# bunnyexpand in float64 against the JAX app in float64 on its Jacobi SVD (the
# golden app_bunnyexpand_f64): the collapse at steps 1 and 8 of its run, and one
# step of the scramble with 1, 2 and 3 ADMM iterations (-it), golden key ->
# bound of max |x|. The port reads 5.07e-12 and 4.47e-11 on the collapse on
# the CPU, 5.21e-12 and 5.00e-11 on the card (the JAX package's one-ulp
# control at step 8: 2.24e-12), and 7.15e-10, 2.52e-8 and 2.47e-6 on the
# scramble on the CPU, 5.35e-10, 1.31e-8 and 1.56e-6 on the card (the
# controls 2.50e-10, 1.23e-8 and 5.97e-7): a float64 rounding grows 30-100
# times an ADMM iteration in the tangle. The collapse is held to 1e-10, the
# scramble to some 6 times the CPU's reading.
APP_F64 = {"bunnyexpand": ("x1", "x8"), "bunnyexpand_rand": ("it1", "it2", "it3")}
APP_F64_TOL = {"x1": 1e-10, "x8": 1e-10, "it1": 4e-9, "it2": 1.5e-7, "it3": 1.5e-5}
APP_PIN_TOL = 1e-5  # m: beams' pinned vertices from their moving targets (3.2e-7 on the CPU)
# No tunnelling: the least y of a contact app's run (bench.py:67). The JAX
# package's own torus sinks to -1.1773 (ROADMAP Queue 3 item 18); its golden is
# held one step at a time and the port's run to this bound.
APP_FLOOR_BOUND = -1.1
APP_SCRAMBLE_BOUND = 50.0  # |x| below this times the scramble's max |x| (tests/
# test_inversion_recovery.py:86)
APP_SLIVERS = 3  # inverted tets beyond the golden's that float32 may flicker
# (tests/test_inversion_recovery.py:59-61)
# The kernels each app must launch (their wrappers' counts in its run): A's
# stencil entry (B's work inside it) and C on the lattices (beams, boxes), A's
# rows entry on the loaded meshes, E's stencil entry on the sheets, H on
# signorini (its MESH form on the slabs, which detects inside the sweeps:
# APP_MESH_KIND), K, L and H[DYN] for boxes, K, L's full C^T and M for the
# torus's Uzawa.
APP_KERNELS = {
    "beams": ("local_step_tet_stencil", "tet_rhs_rows"),
    "trianglestrain": ("local_step_tri_stencil",),
    "bunnyexpand": ("local_step_tet_hyper",),
    "bunnyexpand_rand": ("local_step_tet_hyper",),
    "signorini": ("local_step_tet_hyper", "gs_solve"),
    "signorini_sdf": ("local_step_tet_hyper", "gs_solve"),
    "signorini_exact": ("local_step_tet_hyper", "gs_solve"),
    "torus": ("local_step_tet_hyper", "dyn_detect", "ct_apply", "schur_trip"),
    "boxes": ("local_step_tet_stencil", "tet_rhs_rows", "dyn_detect", "gs_solve_dyn",
              "dyn_gather"),
}
# The obstacle of each signorini run, by its class and by the kind kernel H
# takes it as (cuda_obstacle.MESH_SDF, MESH_EXACT; the floor's 0).
APP_MESH_KIND = {"signorini": ("Floor", 0), "signorini_sdf": ("PassiveMeshSDF", 2),
                 "signorini_exact": ("PassiveMeshExact", 3)}


def app_main(torch, name, out_path):
    """main(argv) of one of APP_RUNS with --frames APP_FRAMES --out out_path:
    (its return code, its standard output, the solver of each Solver capture
    it made, the host-clock seconds of each Solver.step it called (each ends
    in a synchronisation), the wrappers' counts of its launches, from 0). Run
    as a user runs it: the default settings, on the card."""
    import contextlib
    import io

    from admm_elastic_tpu_torch.solver import Solver

    module, lead = APP_RUNS[name]
    captures, step_s = [], []
    capture, step = Solver._capture, Solver.step

    def counted(self, key):
        captures.append(self)
        return capture(self, key)

    def timed(self):
        t = time.perf_counter()
        out = step(self)
        step_s.append(time.perf_counter() - t)
        return out

    argv = list(lead) + ["--frames", str(APP_FRAMES), "--out", out_path]
    if DEVICE != "cuda":  # a rehearsal off the card
        argv.append("--cpu")
    buf = io.StringIO()
    Solver._capture, Solver.step = counted, timed
    reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rc = app_module(name).main(argv)
    finally:
        Solver._capture, Solver.step = capture, step
    return rc, buf.getvalue(), captures, step_s, wrapper_counts()


def app_one_steps(torch, name, g, steps, scene=None):
    """Each of `steps` one step (run(1)) from the golden's state before it, on
    `scene` or a new scene of the app's own builder: step -> the gap to the
    golden's x (of max |x|), its bound and the golden's one-ulp control."""
    solver = (scene or app_scene(name)).solver
    dev = solver.device
    out = {}
    for k in steps:
        solver.state = type(solver.state)(**{
            f: torch.as_tensor(g[f"s{k}_{f}"], device=dev) for f in
            ("x", "v", "y", "prev_active")})
        solver.run(1)
        x = solver.x
        bound = APP_ONESTEP[name][k]
        gap = rel_err(x, g[f"x{k}"])
        out[str(k)] = dict(rel_err=gap, bound=bound, control_rel_err=float(g[f"ctl{k}_gap"]),
                           finite=bool(np.isfinite(x).all()))
        need(np.isfinite(x).all() and gap <= bound,
             f"app {name} step {k}: one step from the golden's state {gap:.3e} of max |x| "
             f"(bound {bound}; the golden's one-ulp control {float(g[f'ctl{k}_gap']):.3e})")
    return out


def app_f64_holds(torch, name, device=None):
    """bunnyexpand's tight holds (APP_F64): the app's scene built in float64
    on `device` (the card unless named) against the JAX app's float64 run
    (the golden app_bunnyexpand_f64): the collapse's x after steps 1 and 8,
    or the scramble's x after one step with 1, 2 and 3 ADMM iterations from
    the golden's scrambled state. Golden key -> the gap of max |x|, its bound
    and the JAX package's one-ulp control (None at the all-zero state)."""
    g = golden("app_bunnyexpand_f64")
    out = {}
    if name == "bunnyexpand":
        solver = app_scene(name, device, dtype=np.float64).solver
        need(not np.any(solver.x), "app bunnyexpand float64: not collapsed to the origin")
        xs = []
        for _ in range(8):
            solver.step()
            xs.append(solver.x)
        got = {"x1": xs[0], "x8": xs[7]}
    else:
        got = {}
        for k in (1, 2, 3):
            solver = app_scene(name, device, dtype=np.float64, admm_iters=k).solver
            need(np.array_equal(solver.x, g["x0_rand"]),
                 "app bunnyexpand_rand float64: the scramble is not the golden's")
            solver.step()
            got[f"it{k}"] = solver.x
    for key in APP_F64[name]:
        gap, bound = rel_err(got[key], g[key]), APP_F64_TOL[key]
        ctl = float(g[f"ctl_{key}"]) if f"ctl_{key}" in g else None
        out[key] = dict(rel_err=gap, bound=bound, control_rel_err=ctl)
        need(np.isfinite(got[key]).all() and gap <= bound,
             f"app {name} float64 {key}: {gap:.3e} of max |x| off the JAX app (bound {bound}; "
             f"its one-ulp control {ctl})")
    return out


def app_trajectory_holds(name, xs, g, extra=None, dt=None):
    """beams and trianglestrain against their goldens: xs (x after steps 1,
    2, ...) at APP_STEPS within APP_STEPS_TOL, and beams' pins (extra, the
    scene's; dt its timestep) on their moving targets after every step in
    xs: (the gap by step, of max |x|; the pins' largest distance from their
    targets in m, or None)."""
    held = [int(k) for k in g["steps"]]
    need(held == list(APP_STEPS), f"app {name}: the golden holds {held}")
    gaps = {str(k): rel_err(xs[k - 1], g[f"x{k}"]) for k in held}
    for k, tol in zip(held, APP_STEPS_TOL):
        need(gaps[str(k)] <= tol,
             f"app {name} step {k}: {gaps[str(k)]:.3e} of max |x| off the golden (bound {tol})")
    off = None
    if name == "beams":
        from admm_elastic_tpu_torch.apps.beams import pin_targets

        off = max(float(np.abs(x[extra["pins"]] - pin_targets(extra, dt, f + 1)).max())
                  for f, x in enumerate(xs))
        need(off <= APP_PIN_TOL, f"app beams: a pin {off} m off its moving target")
    return gaps, off


def app_path(torch, name, gpu):
    """One of APP_RUNS through its main(argv) on the card (app_main), held to
    its golden and its invariants: one capture in the run, the app's kernels
    launched (APP_KERNELS), signorini's obstacle as kernel H takes it
    (APP_MESH_KIND), x at the held steps (APP_STEPS, APP_FIRST_TOL,
    APP_ONESTEP), bunnyexpand in float64 (app_f64_holds); beams' pins on their
    moving targets, a contact app no deeper than APP_FLOOR_BOUND, bunnyexpand
    finite everywhere with its inverted tets beside the golden's; its ADMM
    iterations per second on the host's clock, with the first frame (the
    capture) and without."""
    g = golden(f"app_{name}")
    os.makedirs(OUT_DIR, exist_ok=True)
    out_path = os.path.join(OUT_DIR, f"app_{name}.npz")
    t0 = time.perf_counter()
    rc, printed, captures, step_s, counts = app_main(torch, name, out_path)
    wall = time.perf_counter() - t0
    lines = [ln for ln in printed.splitlines() if ln.strip()]
    summary = [ln for ln in lines if "frames in" in ln or "min y" in ln or "inverted" in ln]
    need(rc == 0, f"app {name}: main returned {rc}")
    traj = np.load(out_path)["x"]
    need(traj.shape[0] == APP_FRAMES and traj.shape[1:] == g["x0"].shape,
         f"app {name}: trajectory of shape {traj.shape}")
    # one capture on the card; off it (a rehearsal) the steps run eagerly
    need(len(captures) == (1 if DEVICE == "cuda" else 0),
         f"app {name}: {len(captures)} graph captures in one run")
    missing = [k for k in APP_KERNELS[name] if counts.get(k, 0) <= 0]
    need(not missing, f"app {name}: no launch of {missing} ({counts})")
    mesh_kind = None
    if name in APP_MESH_KIND and captures:
        solver = captures[0]
        mesh_kind = ([type(o).__name__ for o in solver.obstacles],
                     list(solver._contact.gs_params[0]))
        need(mesh_kind == ([APP_MESH_KIND[name][0]], [APP_MESH_KIND[name][1]]),
             f"app {name}: kernel H took the obstacles {mesh_kind}")
    held = [int(k) for k in g["steps"]]
    iters = app_module(name).settings().admm_iters
    need(len(step_s) == APP_FRAMES, f"app {name}: {len(step_s)} steps")
    res = dict(argv=list(APP_RUNS[name][1]), frames=APP_FRAMES, held=held,
               captures=len(captures), obstacle_kinds=mesh_kind,
               wrapper_counts={k: v for k, v in counts.items() if v}, summary=summary,
               wall_s=wall, admm_iters=iters, step_s=step_s,
               admm_iters_per_s=APP_FRAMES * iters / sum(step_s),
               admm_iters_per_s_after_capture=(APP_FRAMES - 1) * iters / sum(step_s[1:]),
               first_step_s=step_s[0])
    need(np.isfinite(traj).all(), f"app {name}: a non-finite position")
    if name in ("beams", "trianglestrain"):
        scene = app_scene(name) if name == "beams" else None
        res["rel_err"], res["pin_off_m"] = app_trajectory_holds(
            name, traj, g, *((scene.extra, scene.solver.m_settings.timestep_s) if scene else ()))
    else:
        first = name in APP_CONTACT
        if first:
            res["rel_err"] = {"1": rel_err(traj[0], g["x1"])}
            need(res["rel_err"]["1"] <= APP_FIRST_TOL,
                 f"app {name} step 1: {res['rel_err']['1']:.3e} of max |x| off the golden")
        res["one_step"] = app_one_steps(torch, name, g, held[1:] if first else held)
    if name in APP_F64:
        res["f64"] = app_f64_holds(torch, name)
    if name in APP_CONTACT:
        res["min_y"], res["jax_min_y"] = float(traj[:, :, 1].min()), float(g["min_y"])
        need(res["min_y"] > APP_FLOOR_BOUND,
             f"app {name}: through the floor (least y {res['min_y']}, bound {APP_FLOOR_BOUND})")
    if APP_RUNS[name][0] == "bunnyexpand":
        from admm_elastic_tpu_torch.apps.bunnyexpand import inverted

        tets = app_scene(name).extra["tets"]
        res["inverted"], res["jax_inverted"] = inverted(traj[-1], tets), int(g["inverted"])
        if name == "bunnyexpand":
            need(res["inverted"] <= res["jax_inverted"] + APP_SLIVERS,
                 f"app {name}: {res['inverted']} inverted tets, the golden's {res['jax_inverted']}")
        else:
            bound = APP_SCRAMBLE_BOUND * float(np.abs(g["s1_x"]).max())
            need(float(np.abs(traj).max()) < bound, f"app {name}: |x| beyond {bound}")
    log(f"app {name}: {' | '.join(summary)}; holds {json.dumps(res.get('rel_err', {}))} "
        f"{json.dumps(res.get('one_step', {}))} {json.dumps(res.get('f64', {}))}; "
        f"{res['captures']} capture; "
        f"{res['admm_iters_per_s']:.1f} ADMM iters/s over its steps, "
        f"{res['admm_iters_per_s_after_capture']:.1f} after the first (the capture, "
        f"{res['first_step_s']:.3f} s), host clock [{gpu}]")
    return res


# --- scenario batching (parallel/batch.py; ROADMAP Queue 1 item 12) -----------------

# the golden scenes' place in the 1,024-scene sweep
BATCH_BEAM_AT = tuple(range(0, BATCH_BEAM_S, BATCH_BEAM_S // 8))
BATCH_CURVE = (1, 8, 64, 256, 1024)  # the scaling curve's batch sizes
BATCH_LANDED = 12  # steps after which crossval's batched scene rests on the floor
BATCH_WIDE_LANDED = 12  # steps after which BATCH_WIDE's beams rest on floor and slab
BATCH_WIDE_CURVE = (1, 8, 64)  # the full-width batches' sizes (batch_curve)
# The scene forms' wrappers: kernel name -> the ops module that holds it
BATCH_KERNELS = {
    "local_step_tet_hyper_scenes": "cuda_local_step",
    "local_step_tet_stencil_scenes": "cuda_local_step",
    "local_step_tri_stencil_scenes": "cuda_tri_local_step",
    "tet_rhs_rows_scenes": "cuda_stencil",
    "pcg_solve_scenes": "cuda_pcg",
    "pcg_solve_penalty_scenes": "cuda_pcg",
    "ct_apply_scenes": "cuda_uzawa",
    "schur_trip_scenes": "cuda_uzawa",
    "mesh_detect_scenes": "cuda_obstacle",
}
# which batch path launches each: its launches in the kernels line are that
# path's (the wrappers' counts of the warm-up and the capture of its graph)
BATCH_KERNEL_PATH = {
    "local_step_tet_hyper_scenes": "beam_sweep1024",
    "pcg_solve_scenes": "beam_sweep1024",
    "pcg_solve_penalty_scenes": "batched_contact_alpcg",
    "local_step_tri_stencil_scenes": "batch_cloth_sweep4",
    "local_step_tet_stencil_scenes": "batch_lattice_stencil",
    "tet_rhs_rows_scenes": "batch_lattice_stencil",
    "ct_apply_scenes": "batch_floor_uzawa5k",
    "schur_trip_scenes": "batch_floor_uzawa5k",
    "mesh_detect_scenes": "batch_slab_exact_alpcg5k",
}
# Which call of a scene form batch_kernel_cases holds (0: the first): L's
# third (a trip's C^T d; the first is C^T y, y often 0)
BATCH_CALL = {"ct_apply_scenes": 2}


def batch_sweep(name, n):
    """(scales, gravity) of n scenes of a BATCH_CURVE sweep: the beam's
    (beam_sweep), or the sheet's scales spread geometrically over 0.5-4 at
    gravity -9.8, batch_cloth_sweep4's four first where they fit."""
    if name == "batch_beam_sweep8":
        return beam_sweep(n)
    g = BATCH_SCENES[name]
    scales, gravity = np.geomspace(0.5, 4.0, n), np.full(n, -9.8)
    k = min(n, len(g["scales"]))
    scales[:k], gravity[:k] = np.asarray(g["scales"])[:k], np.asarray(g["gravity"])[:k]
    return scales, gravity


def beam_sweep(n):
    """The 1,024-scene sweep of the bench beam (or n scenes): scales spread
    geometrically over 0.25-4, gravity -9.8, batch_beam_sweep8's eight pairs
    at BATCH_BEAM_AT (where they fit)."""
    g = BATCH_SCENES["batch_beam_sweep8"]
    scales, gravity = np.geomspace(0.25, 4.0, n), np.full(n, -9.8)
    at = batch_at(n)
    scales[list(at)] = np.asarray(g["scales"])[:len(at)]
    gravity[list(at)] = np.asarray(g["gravity"])[:len(at)]
    return scales, gravity


def batch_at(n):
    return BATCH_BEAM_AT if n == BATCH_BEAM_S else tuple(range(min(n, 8)))


def batch_setup(torch, name, n=None, dtype=None, device=None, donate=False):
    """(solver, step, batch) of a BATCH_SCENES scene on the card (unless a
    device is named): the golden's sweep, or n scenes of batch_sweep; dtype
    overrides the scene's."""
    from admm_elastic_tpu_torch.parallel import batch as pb

    solver, scales, gravity = batch_scene(name, torch_api(device), dtype)
    if n is not None:
        scales, gravity = batch_sweep(name, n)
    step = pb.make_batched_step(solver, mesh=None, donate=donate)
    batch = pb.make_scenario_batch(solver, len(scales), stiffness_scale=scales, gravity=gravity)
    return solver, step, batch


def keep(v):
    """v, a tensor cloned (record_first)."""
    return v.clone() if hasattr(v, "clone") and hasattr(v, "data_ptr") else v


class record_first:
    """Within it, the arguments of one call of each named scene wrapper
    (BATCH_KERNELS; the first, or BATCH_CALL's) are kept in .args[name],
    their tensors cloned before the call (M updates its own in place); the
    calls go through."""

    def __init__(self, names):
        self.names, self.args, self.saved, self.calls = names, {}, {}, {}

    def __enter__(self):
        import importlib

        for name in self.names:
            mod = importlib.import_module(f"admm_elastic_tpu_torch.ops.{BATCH_KERNELS[name]}")
            fn = getattr(mod, name)
            self.saved[name] = (mod, fn)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                seen = self.calls.get(_name, 0)
                self.calls[_name] = seen + 1
                if seen == BATCH_CALL.get(_name, 0):
                    self.args[_name] = (tuple(keep(v) for v in a),
                                        {k: keep(v) for k, v in kw.items()})
                return _fn(*a, **kw)

            wrapped.launches = 0  # what the wrapper counts while it is replaced
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, fn) in self.saved.items():
            fn.launches += getattr(mod, name).launches
            setattr(mod, name, fn)


def scene_bitwise(torch, label, got, single):
    """got ([S, ...] tensors, a tuple of them, or with trips) scene by scene
    against single(i): torch.equal each."""
    got = got if isinstance(got, tuple) else (got,)
    for i in range(got[0].shape[0]):
        want = single(i)
        want = want if isinstance(want, tuple) else (want,)
        for a, w in zip(got, want):
            need(bool(torch.equal(a[i], w)), f"{label}: scene {i} differs from the single-scene "
                 f"kernel ({float((a[i].double() - w.double()).abs().max().item()):.3e})")


def batch_kernel_cases(torch, res, timing, label, name, n=None, dtype=None, steps=0):
    """The scene forms that a batch of `name` launches, each on the inputs of
    its first call in an eager step after `steps` steps, held bitwise, scene
    by scene, to the single-scene kernel on that scene's scaled inputs
    (A, C: the scaled material and weights; G: cuda_pcg.scaled), and G to its
    plain twin (solve_T_scenes / penalty_solve_scenes) within G's bounds."""
    import dataclasses

    from admm_elastic_tpu_torch.ops import (cuda_local_step, cuda_pcg, cuda_stencil,
                                            cuda_tri_local_step)
    from admm_elastic_tpu_torch.ops.hyper_soa import scaled_params
    from admm_elastic_tpu_torch.solvers import alcg, pcg

    solver, step, batch = batch_setup(torch, name, n, dtype)
    for _ in range(steps):
        batch = step.eager(batch)
    with record_first(list(BATCH_KERNELS)) as rec:
        step.eager(batch)
    dname = "f64" if batch.x.dtype == torch.float64 else "f32"
    for kname, (args, kw) in rec.args.items():
        key = f"{kname}@{label} {dname}"
        s_cnt = batch.n_scenes
        if kname == "local_step_tet_hyper_scenes":
            dix, u, mu, lam, kappa, scale = args[:6]
            model, iters = kw.get("model"), kw.get("n_iters")
            got = cuda_local_step.local_step_tet_hyper_scenes(*args, **kw)
            p = scaled_params(mu, lam, kappa, scale)
            scene_bitwise(torch, key, got, lambda i: cuda_local_step.local_step_tet_hyper(
                dix[i], u[i], *(a[i] for a in p), n_iters=iters, model=model))
            twin = cuda_local_step.local_step_scenes_plain(*args, **kw)
        elif kname == "local_step_tet_stencil_scenes":
            x, u, b, scale = args[:4]
            got = cuda_local_step.local_step_tet_stencil_scenes(*args, **kw)
            p = scaled_params(b.mu, b.lam, b.kappa, scale)
            scene_bitwise(torch, key, got, lambda i: cuda_local_step.local_step_tet_stencil(
                x[i], u[i], dataclasses.replace(b, mu=p[0][i], lam=p[1][i], kappa=p[2][i],
                                                bulk=p[3][i]), *args[4:]))
            from admm_elastic_tpu_torch.ops import stencil as st

            twin = cuda_local_step.local_step_scenes_plain(
                torch.stack([st.tet_Dx_rows_plain(xs, b) for xs in x]), u, b.mu, b.lam, b.kappa,
                scale, *args[4:], model=b.model)
        elif kname == "local_step_tri_stencil_scenes":
            x, u, b = args
            got = cuda_tri_local_step.local_step_tri_stencil_scenes(*args)
            scene_bitwise(torch, key, got,
                          lambda i: cuda_tri_local_step.local_step_tri_stencil(x[i], u[i], b))
            from admm_elastic_tpu_torch.ops import stencil as st
            from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

            twin = cuda_tri_local_step.local_step_tri_over_scenes(
                torch.stack([st.tri_Dx_rows(xs, b) for xs in x]), u, b.limit_min, b.limit_max,
                step=local_step_tri_plain)
        elif kname in LMJ_SCENES:
            lmj_case(torch, res, timing, key, kname, args, kw)
            continue
        elif kname == "tet_rhs_rows_scenes":
            z, u, b, n_verts, sq = args[:5]
            got = cuda_stencil.tet_rhs_rows_scenes(*args, **kw)
            scene_bitwise(torch, key, got, lambda i: cuda_stencil.tet_rhs_rows(
                z[i], u[i], dataclasses.replace(b, weight=b.weight * sq[i]), n_verts))
            from admm_elastic_tpu_torch.ops import stencil as st

            twin = (torch.stack([st.tet_rhs_rows_plain(z[i], u[i], dataclasses.replace(
                b, weight=b.weight * sq[i]), n_verts) for i in range(s_cnt)]),)
        else:  # kernel G, plain or penalty
            data, b_, x0, tol, max_iters, trips, scale = args[:7]
            pen = kname == "pcg_solve_penalty_scenes"
            t = torch.zeros((s_cnt,), dtype=torch.int32, device=DEVICE)
            call = (cuda_pcg.pcg_solve_penalty_scenes if pen else cuda_pcg.pcg_solve_scenes)
            got = call(data, b_, x0, tol, max_iters, t, scale, *args[7:], **kw)
            singles = []
            dn = kw.get("done")  # Uzawa's inner solves

            def single(i, dn=dn):
                ti = torch.zeros((1,), dtype=torch.int32, device=DEVICE)
                d = cuda_pcg.scaled(data, scale[i])
                if pen:
                    x = cuda_pcg.pcg_solve_penalty(d, b_[i], x0[i], tol, max_iters, ti,
                                                   args[7][i], args[8][i])
                else:
                    x = cuda_pcg.pcg_solve(d, b_[i], x0[i], tol, max_iters, ti,
                                           done=None if dn is None else dn[i:i + 1])
                singles.append(int(ti.item()))
                return x

            scene_bitwise(torch, key, got, single)
            need(t.cpu().tolist() == singles, f"{key}: trips {t.cpu().tolist()} against the "
                 f"single-scene solves' {singles}")
            if not pen and solver.m_settings.linsolver == 2:
                g_done_case(torch, res, f"pcg_solve_scenes[done]@{label} {dname}", data, b_, x0,
                            tol, max_iters, scale, single)
            if pen:
                xp, kp = alcg.penalty_solve_scenes(data, args[7], args[8], b_, x0, tol,
                                                   max_iters, scale)
            else:
                xp, kp = pcg.solve_T_scenes(lambda xT: data.apply_T(xT, scale),
                                            data.precondition_T(scale), b_, x0, tol, max_iters,
                                            done=dn)
            errs = [rel_err(got[i].double().cpu().numpy(), xp[i].double().cpu().numpy())
                    for i in range(s_cnt)]
            kg, kp = t.cpu().numpy(), kp.cpu().numpy()
            bound = PCG_F64_TOL if dname == "f64" else PCG_F32_TOL
            ok_trips = (np.array_equal(kg, kp) if dname == "f64" else
                        bool((np.abs(kg - kp) <= np.maximum(2, PCG_F32_TRIPS * kp)).all()))
            need(max(errs) <= bound and ok_trips,
                 f"{key}: against the plain twin {max(errs):.3e} (bound {bound}), trips "
                 f"{kg.tolist()[:16]} against {kp.tolist()[:16]}")
            form = g_blocks(data, b_.dtype)
            res[key] = dict(bitwise_per_scene=True, trips_equal=True, scenes=s_cnt,
                            form=form[0], blocks=form[1], threads=form[2],
                            trips_max=int(kg.max()), trips_mean=float(kg.mean()),
                            twin_rel_err=max(errs), twin_bound=bound,
                            max_abs_err=float((got - xp).abs().max().item()))
            timing[key] = dict(data=data, args=args, kw=kw, trips=kg, pen=pen, solver=solver,
                               scenes=s_cnt)
            log(f"{key}: bitwise per scene to the single-scene G on scaled data "
                f"({form[0]}, trips max {int(kg.max())} mean {kg.mean():.1f}), "
                f"{max(errs):.3e} against the twin")
            continue
        kind = ("C" if kname == "tet_rhs_rows_scenes" else
                "E" if kname.startswith("local_step_tri") else "A")
        got = got if isinstance(got, tuple) else (got,)
        err = twin_err(torch, key, got, twin, kind)
        res[key] = dict(bitwise_per_scene=True, scenes=s_cnt, max_abs_err=err)
        timing[key] = dict(args=args, kw=kw, scenes=s_cnt, name=kname)
        log(f"{key}: bitwise per scene to the single-scene kernel ({s_cnt} scenes)")
    return solver, step, batch


LMJ_SCENES = ("ct_apply_scenes", "schur_trip_scenes", "mesh_detect_scenes")


def lmj_case(torch, res, timing, key, kname, args, kw):
    """L's, M's or J's scene form on a call's inputs (args, kw), held bitwise
    to its plain twin (ct_plain_scenes, schur_trip_plain_scenes, the mesh
    obstacle's signed_distance_with_overflow(scenes=True) with its overflow)
    and, scene by scene, to the single-scene kernel on that scene's tensors
    (cuda_uzawa.scene_of's rows; J's overflow too)."""
    from admm_elastic_tpu_torch.ops import cuda_obstacle as co
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    if kname == "ct_apply_scenes":
        hits, ck, y, n = args[:4]
        slot_of = args[4] if len(args) > 4 else kw.get("slot_of")
        got = (cu.ct_apply_scenes(hits, ck, y, n, slot_of),)
        scene_bitwise(torch, key, got, lambda i: cu.ct_apply(cu.scene_of(hits, i), ck, y[i], n,
                                                             slot_of))
        twin = (cu.ct_plain_scenes(hits, ck, y, n),)
    elif kname == "schur_trip_scenes":
        hits, ck, state, (tiny, tol2) = args[0], args[1], args[2:9], args[9:11]
        got = cu.schur_trip_scenes(hits, ck, *(t.clone() for t in state), tiny, tol2)
        scene_bitwise(torch, key, got, lambda i: cu.schur_trip(
            cu.scene_of(hits, i), ck, *(t[i].clone() for t in state), tiny, tol2))
        twin = cu.schur_trip_plain_scenes(hits, ck, *state, tiny, tol2)
    else:
        obs, x = args[:2]
        ovf = torch.zeros_like(args[2])
        got = co.mesh_detect_scenes(obs, x, ovf)

        def single(i):
            o1 = torch.zeros((1,), dtype=torch.int32, device=x.device)
            out = co.mesh_detect(obs, x[i].contiguous(), o1)
            need(int(o1.item()) == int(ovf[i].item()), f"{key}: scene {i}'s overflow "
                 f"{int(ovf[i].item())} against the single-scene kernel's {int(o1.item())}")
            return out

        scene_bitwise(torch, key, got, single)
        dp, pp, np_, op = obs.signed_distance_with_overflow(x, scenes=True)
        twin = (dp, pp, np_, dp < 0.0)
        need(bool(torch.equal(op, ovf != 0)), f"{key}: overflow {ovf.tolist()} against the "
             f"twin's {op.tolist()}")
    for a, w in zip(got, twin):
        need(bool(torch.equal(a, w)), f"{key}: differs from its plain twin "
             f"({float((a.double() - w.double()).abs().max().item()):.3e})")
    s_cnt = int(got[0].shape[0])
    res[key] = dict(bitwise_per_scene=True, bitwise_twin=True, scenes=s_cnt, max_abs_err=0.0)
    if kname == "mesh_detect_scenes":
        res[key]["overflow"] = ovf.tolist()
    timing[key] = dict(args=args, kw=kw, scenes=s_cnt, name=kname)
    log(f"{key}: bitwise per scene to the single-scene kernel and to the plain twin "
        f"({s_cnt} scenes)")


def g_done_case(torch, res, key, data, b_, x0, tol, max_iters, scale, single):
    """G's scene form with a done flag a scene (Uzawa's predicated inner
    solve), every other scene's set: a set scene returns its x0 bit for bit
    and takes no trip, the others are bitwise the single-scene solve with
    its own done (single(i, dn))."""
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    s_cnt = b_.shape[0]
    dn = torch.arange(s_cnt, device=b_.device) % 2 == 1
    t = torch.zeros((s_cnt,), dtype=torch.int32, device=b_.device)
    got = cuda_pcg.pcg_solve_scenes(data, b_, x0, tol, max_iters, t, scale, done=dn)
    need(bool(torch.equal(got[dn], x0[dn])) and not bool(t[dn].any()),
         f"{key}: a done scene moved or took a trip")
    scene_bitwise(torch, key, got, lambda i: single(i, dn))
    xp, kp = pcg.solve_T_scenes(lambda xT: data.apply_T(xT, scale), data.precondition_T(scale),
                                b_, x0, tol, max_iters, done=dn)
    need(bool(torch.equal(xp[dn], x0[dn])) and bool(torch.equal(kp[dn], t[dn])),
         f"{key}: the twin's done scenes differ")
    res[key] = dict(bitwise_per_scene=True, scenes=s_cnt, done=dn.tolist(),
                    trips=t.tolist(), max_abs_err=float((got - xp).abs().max().item()))
    log(f"{key}: done scenes keep x0 with no trip, the others bitwise the single-scene G "
        f"(trips {t.tolist()[:8]})")


def tiled_scenes(torch, t, s_cnt, scale_step):
    """A scene tensor [S0, ...] tiled to s_cnt scenes, scene j from scene
    j mod S0, scaled by 1 + j scale_step where it is floating (so that no two
    scenes are alike)."""
    idx = torch.arange(s_cnt, device=t.device) % t.shape[0]
    out = t[idx].clone()
    if out.is_floating_point() and scale_step:
        f = 1.0 + scale_step * torch.arange(s_cnt, device=t.device, dtype=out.dtype)
        out = out * f.reshape((-1,) + (1,) * (out.ndim - 1))
    return out


def scene_size_checks(torch, res, timing):
    """L's, M's and J's scene forms and G's done at S = 1, 4, 64 and at one
    more scene than the card holds blocks of M's (J's) scene form at once
    (each team then takes two scenes), on the wide paths' recorded inputs
    tiled to S scenes (tiled_scenes; M with every fifth scene done, J's near
    lanes cut to a quarter of the query set, so that the scenes compact
    differently and some overflow): each bitwise its twin and, scene by
    scene, its single-scene kernel (lmj_case)."""
    import dataclasses

    from admm_elastic_tpu_torch.ops import cuda_obstacle as co
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    from admm_elastic_tpu_torch.ops import cuda_pcg

    for key, t in list(timing.items()):
        kname, path = key.partition("@")[0], key.partition("@")[2]
        if path.rpartition(" ")[0] not in BATCH_WIDE:
            continue
        args, kw = t["args"], t["kw"]
        if kname == "pcg_solve_scenes" and t["solver"].m_settings.linsolver == 2:
            data, b_, x0, tol, its, _, scale = args[:7]
            for s_cnt in (1, 64):
                bb, xx = (tiled_scenes(torch, a, s_cnt, 1.0 / 64) for a in (b_, x0))
                ss = tiled_scenes(torch, scale, s_cnt, 0.0)

                def single(i, dn, bb=bb, xx=xx, ss=ss):
                    ti = torch.zeros((1,), dtype=torch.int32, device=bb.device)
                    return cuda_pcg.pcg_solve(cuda_pcg.scaled(data, ss[i]), bb[i], xx[i], tol,
                                              its, ti, done=dn[i:i + 1])

                g_done_case(torch, res, f"pcg_solve_scenes[done]@{path} S={s_cnt}", data, bb,
                            xx, tol, its, ss, single)
            continue
        if kname not in LMJ_SCENES:
            continue
        x_lead = args[1] if kname == "mesh_detect_scenes" else args[2]
        most = (co.scene_max_blocks(x_lead.device, x_lead.dtype) if kname == "mesh_detect_scenes"
                else cu.scene_max_blocks(x_lead.device, x_lead.dtype))
        for s_cnt in (1, 4, 64, most + 1):
            if kname == "mesh_detect_scenes":
                obs = args[0]
                obs = dataclasses.replace(obs, near_lanes=max(1, args[1].shape[1] // 4))
                x = tiled_scenes(torch, args[1], s_cnt, 0.0)
                x[:, :, 1] -= 0.002 * torch.arange(s_cnt, device=x.device, dtype=x.dtype)[:, None]
                new = (obs, x, torch.zeros((s_cnt,), dtype=torch.int32, device=x.device))
            else:
                hits = args[0]
                rows = {f: tiled_scenes(torch, getattr(hits, f), s_cnt, 0.0)
                        for f in ("p_mask", "p_normal", "p_point", "d_mask", "d_face",
                                  "d_barys", "d_normal", "overflow")}
                hits = dataclasses.replace(hits, **rows)
                if kname == "ct_apply_scenes":
                    new = (hits, args[1], tiled_scenes(torch, args[2], s_cnt, 1.0 / 64),
                           *args[3:])
                else:
                    state = [tiled_scenes(torch, a, s_cnt, 1.0 / 64) for a in args[2:9]]
                    state[6] = torch.arange(s_cnt, device=state[6].device) % 5 == 4
                    new = (hits, args[1], *state, *args[9:])
            lmj_case(torch, res, {}, f"{key} S={s_cnt}", kname, new, kw)


def twin_err(torch, label, got, twin, kind):
    """max |kernel - plain twin| over the outputs, held to the bounds of the
    single-scene checks: A per lane to LANE_TOL's stress bound (float64 1e-8),
    E absolute and C relative to max(1, max |plain|) to F32_TOL_STENCIL
    (float64 F64_TOL)."""
    f64 = got[0].dtype == torch.float64
    err = max(float((a.double() - w.double()).abs().max().item()) for a, w in zip(got, twin))
    scale = max(1.0, max(float(w.abs().max().item()) for w in twin)) if kind == "C" else 1.0
    bound = ((LANE_TOL[("f64", "stress")] if f64 else LANE_TOL[("f32", "stress")])
             if kind == "A" else (F64_TOL if f64 else F32_TOL_STENCIL) * scale)
    need(err <= bound, f"{label}: {err:.3e} from the plain twin (bound {bound:.3e})")
    return err


def batch_kernel_checks(torch):
    """Every scene form on the batch paths' inputs (batch_kernel_cases): the
    beam sweep at S = 1,024 in float32 and float64 (A's rows entry, G's
    CLUSTER form), crossval's batched scene landed on the floor (G's penalty
    form, float32 and float64), the cloth sheet (E's entries, G), the
    20x20x20 lattice (A's stencil entry, C, G's GRID form a scene at a time,
    float32 and float64). Returns (results, timing inputs)."""
    res, timing = {}, {}
    for label, name, n, dtype, steps in (
            ("beam_sweep1024", "batch_beam_sweep8", BATCH_BEAM_S, None, 1),
            ("beam_sweep1024", "batch_beam_sweep8", BATCH_BEAM_S, np.float64, 1),
            ("batched_contact_alpcg", "batched_contact_alpcg", None, None, BATCH_LANDED),
            ("batched_contact_alpcg", "batched_contact_alpcg", None, np.float64, BATCH_LANDED),
            ("batch_cloth_sweep4", "batch_cloth_sweep4", None, None, 1),
            ("batch_lattice_stencil", "batch_lattice_stencil", None, None, 1),
            ("batch_lattice_stencil", "batch_lattice_stencil", None, np.float64, 1),
            # L, M and G's done on Uzawa's batches, J on the exact
            # slabs', past landing
            ("batch_floor_uzawa5k", "batch_floor_uzawa5k", None, None, BATCH_WIDE_LANDED),
            ("batch_floor_uzawa5k", "batch_floor_uzawa5k", None, np.float64, BATCH_WIDE_LANDED),
            ("batch_slab_exact_alpcg5k", "batch_slab_exact_alpcg5k", None, None,
             BATCH_WIDE_LANDED),
            ("batch_slab_exact_alpcg5k", "batch_slab_exact_alpcg5k", None, np.float64,
             BATCH_WIDE_LANDED),
            ("batched_contact_uzawa", "batched_contact_uzawa", None, None, BATCH_LANDED),
            ("batch_exactmesh_alpcg", "batch_exactmesh_alpcg", None, None, 8),
            ("batch_exactmesh_uzawa", "batch_exactmesh_uzawa", None, None, 5)):
        batch_kernel_cases(torch, res, timing, label, name, n, dtype, steps)
    scene_size_checks(torch, res, timing)
    return res, timing


def batch_path(torch, label, name, n=None):
    """A batch through its entry points (make_batched_step, graph replays)
    against its golden: the wrappers' counts from 0 around the first call
    (warm-up and capture); the golden's scenes at its held steps within
    BATCH_STEP_TOL of max |x| (a scene of BATCH_WIDE at each held step after
    the first one step from the golden's stored batch, beside the JAX
    package's own one-ulp control); every scene finite, overflow scene by
    scene the golden's; the graph rollout bitwise the eager loop; for the beam
    the pinned face at its target after 8 steps and the 8 scenes bitwise those
    of an 8-scene batch; for a contact scene no vertex below
    BATCH_FLOOR_BOUND."""
    from admm_elastic_tpu_torch.parallel import batch as pb

    g = golden(name)
    steps = batch_steps(name)
    onestep = BATCH_SCENES[name].get("onestep", False)
    t0 = time.perf_counter()
    solver, step, batch = batch_setup(torch, name, n)
    at = list(batch_at(batch.n_scenes)) if n else list(range(batch.n_scenes))
    eager = batch
    reset_counts()
    xs, ovfs, min_y = {}, {}, np.inf
    for k in range(1, max(steps) + 1):
        batch = step(batch)
        if k == 1:
            counts = {kname: v for kname, v in wrapper_counts().items() if v}
        if k in steps:
            xs[k], ovfs[k] = batch.x.clone(), batch.overflow.clone()
        min_y = min(min_y, float(batch.x[..., 1].min().item()))
    for k in range(1, max(steps) + 1):
        eager = step.eager(eager)
        if k in steps:
            need(bool(torch.equal(xs[k], eager.x)),
                 f"{label}: the graph's step {k} differs from the eager loop's")
    out = dict(scenes=batch.n_scenes, launches=counts, graph_vs_eager_bitwise=True)
    for i, (k, bound) in enumerate(zip(steps, BATCH_STEP_TOL[name])):
        need(np.isfinite(xs[k].double().cpu().numpy()).all(), f"{label}: non-finite at step {k}")
        x, ovf = xs[k][at], ovfs[k][at]
        if onestep and i > 0:  # one step from the golden's batch before step k
            dtype = batch.x.dtype
            start = pb.ScenarioBatch(
                **{f: torch.as_tensor(g[f"s{k}_{f}"]).to(DEVICE)
                   for f in ("x", "v", "y", "prev_active", "overflow")},
                stiffness_scale=torch.as_tensor(g["scales"], dtype=dtype, device=DEVICE),
                gravity=torch.as_tensor(g["gravity"], dtype=dtype, device=DEVICE))
            one = step(start)
            out[f"step{k}_rollout_rel_err"] = rel_err(x.double().cpu().numpy(),
                                                      g[f"x{k}"].astype(np.float64))
            x, ovf = one.x, one.overflow
            out[f"step{k}_jax_one_ulp_control"] = float(g[f"ctl{k}_gap"])
        err = rel_err(x.double().cpu().numpy(), g[f"x{k}"].astype(np.float64))
        out[f"step{k}_rel_err"], out[f"step{k}_bound"] = err, bound
        need(err <= bound, f"{label}: step {k} {err:.3e} from the golden (bound {bound})")
        want = g[f"ovf{k}"] if f"ovf{k}" in g else np.zeros(len(at), bool)
        need(np.array_equal(ovf.cpu().numpy(), want),
             f"{label}: overflow {ovf.cpu().tolist()} at step {k}, the golden's {want.tolist()}")
    x8 = xs[max(steps)].double().cpu().numpy()
    if name == "batch_beam_sweep8":
        pins = np.where(solver.x[:, 0] < 1e-9)[0]
        drift = float(np.abs(x8[:, pins] - solver.x[pins][None]).max())
        out["pin_drift"] = drift
        need(drift <= BATCH_PIN_TOL, f"{label}: pinned face {drift:.3e} from its target")
        if batch.n_scenes > 8:  # an 8-scene batch of the same 8 scenes, bitwise
            step8 = pb.make_batched_step(solver, mesh=None, donate=False)
            b8 = pb.make_scenario_batch(solver, 8, stiffness_scale=g["scales"],
                                        gravity=g["gravity"])
            for _ in range(max(steps)):
                b8 = step8(b8)
            need(bool(torch.equal(b8.x, xs[max(steps)][at])),
                 f"{label}: the 8 scenes differ from an 8-scene batch's")
            out["s8_bitwise"] = True
    if solver.obstacles:
        out["min_y"], out["floor_bound"] = min_y, batch_floor_bound(g)
        need(min_y > out["floor_bound"], f"{label}: a vertex at y = {min_y} (bound "
             f"{out['floor_bound']})")
    out["trips_last_step"] = step.trips.cpu().tolist()[:16]
    out["seconds"] = time.perf_counter() - t0
    log(f"{label}: {json.dumps({k: v for k, v in out.items() if k != 'launches'})}")
    log(f"{label}: launches {json.dumps(counts)}")
    return solver, step, out


def batch_floor_bound(g):
    """The least y a contact batch may reach: BATCH_FLOOR_BOUND, or where the
    JAX package's own rollout goes lower (its golden's min_y over the held
    run), that less BATCH_FLOOR_SLACK: batch_slab_exact_alpcg5k's softest
    scene (scale 0.5, AL-PCG's one pass an ADMM iteration) sinks to -1.11689
    in the JAX package at step 12, and the port with it."""
    if "min_y" not in g:
        return BATCH_FLOOR_BOUND
    return min(BATCH_FLOOR_BOUND, float(g["min_y"].min()) - BATCH_FLOOR_SLACK)


def batch_alone_bitwise(torch, name, n, steps):
    """The golden's scenes of a BATCH_WIDE scene in a batch of n (batch_sweep:
    they lead it) after `steps` graph steps, bitwise the same scenes batched
    alone."""
    from admm_elastic_tpu_torch.parallel import batch as pb

    t0 = time.perf_counter()
    solver, step, big = batch_setup(torch, name, n)
    g = BATCH_SCENES[name]
    alone = pb.make_scenario_batch(solver, len(g["scales"]), stiffness_scale=g["scales"],
                                   gravity=g["gravity"])
    step_alone = pb.make_batched_step(solver, mesh=None, donate=False)
    for _ in range(steps):
        big, alone = step(big), step_alone(alone)
    k = alone.n_scenes
    same = bool(torch.equal(big.x[:k], alone.x)) and bool(torch.equal(big.y[:k], alone.y))
    need(same, f"{name}: its {k} scenes in a batch of {n} differ from the same scenes alone "
         f"after {steps} steps")
    log(f"{name}: its {k} scenes in a batch of {n} bitwise the same scenes alone after {steps} "
        f"steps ({time.perf_counter() - t0:.1f} s)")
    return dict(scenes=n, alone=k, steps=steps, bitwise=True)


def batch_rate(torch, step, batch, iters):
    """Total ADMM iterations/s of graph replays over a rollout of at least
    TARGET_S (S x admm_iters x steps / s)."""
    batch = step(batch)
    torch.cuda.synchronize()
    n_steps = 2
    while True:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batch = step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if wall >= TARGET_S:
            break
        n_steps = max(n_steps + 1, int(n_steps * max(2.0, 1.2 * TARGET_S / wall)))
    need(bool(torch.isfinite(batch.x).all()), "non-finite batch after the timed rollout")
    total = batch.n_scenes * iters * n_steps
    return dict(scenes=batch.n_scenes, steps=n_steps, wall_s=wall,
                admm_iters_per_s=total / wall, step_ms=wall / n_steps * 1e3)


def batch_profile(torch, step, batch, iters, n_steps=5):
    """torch.profiler over n_steps graph replays of a batch, as profile_step
    reads a path: device ops, busy and wall µs per ADMM iteration, the idle
    share 1 - busy / wall (wall over the window, synchronised at its end)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ev)
    k = n_steps * iters
    return dict(ops_per_iter=len(ev) / k, busy_us_per_iter=busy_us / k,
                wall_us_per_iter=wall_us / k, window_idle_share=1.0 - busy_us / wall_us)


def batch_curve(torch, gpu):
    """The beam's and the cloth sheet's sweeps: total ADMM iterations/s at
    each BATCH_CURVE size (BATCH_WIDE's at BATCH_WIDE_CURVE's; a batch of its
    own, donated, through graph replays), and at S = 8 and the largest the
    device ops and busy time per ADMM
    iteration (torch.profiler, 5 steps, after a warm-up window that sets
    CUPTI up) and the idle share 1 - busy / wall over that window, beside
    rollout_idle_share: 1 - busy / the timed rollout's wall per ADMM
    iteration."""
    profiler_warmup(torch)
    out = {}
    for name in ("batch_beam_sweep8", "batch_cloth_sweep4") + BATCH_WIDE:
        out[name] = {}
        sizes = BATCH_WIDE_CURVE if name in BATCH_WIDE else BATCH_CURVE
        for n in sizes:
            solver, step, batch = batch_setup(torch, name, n, donate=True)
            iters = solver.m_settings.admm_iters
            r = batch_rate(torch, step, batch, iters)
            if n in (8, sizes[-1]) and DEVICE == "cuda":
                r.update(batch_profile(torch, step, batch, iters))
                r["idle_share"] = r["window_idle_share"]
                r["rollout_idle_share"] = (1.0 - r["busy_us_per_iter"]
                                           / (r["step_ms"] * 1e3 / iters))
            out[name][n] = r
            log(f"batch curve {name} S={n}: {r['admm_iters_per_s']:.1f} ADMM iters/s in all, "
                f"{r['step_ms']:.3f} ms/step"
                + (f", {r['ops_per_iter']:.1f} device ops and {r['busy_us_per_iter']:.1f} us "
                   f"busy an ADMM iteration, idle {r['idle_share']:.3f} (by the rollout's wall "
                   f"{r['rollout_idle_share']:.3f})" if "ops_per_iter" in r else "")
                + f" [{gpu}]")
            del solver, step, batch
            torch.cuda.empty_cache()
    return out


def batch_kernel_times(torch, timing, gpu):
    """Each scene form's time per launch at its path's S (CUDA events) beside
    its plain twin on the card, its bound for all S scenes (bytes and
    operations, bound_of; G's by pcg_scenes_bytes_ops, the shared operator
    once per trip of the longest-running scene) and a library call:
    torch.sparse.mm of A as CSR on
    every scene's right-hand side as columns, times the mean trips, for G;
    one torch.sparse.mm of D^T W^2 as CSR on every scene's rows for C."""
    import importlib

    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_pcg, cuda_tri_local_step
    from admm_elastic_tpu_torch.ops.hyper_soa import scaled_params
    from admm_elastic_tpu_torch.ops.prox import TET_LINEAR
    from admm_elastic_tpu_torch.ops.hyper_soa import prox_tet_hyper_tuple
    from admm_elastic_tpu_torch.solvers import alcg, pcg

    out = {}
    for key, t in timing.items():
        kname = key.partition("@")[0]
        if key.endswith("f64"):
            continue
        if kname in LMJ_SCENES:
            out[key] = lmj_times(torch, kname, t["args"], t["kw"])
        elif kname.startswith("pcg_solve"):
            data, args, kw = t["data"], t["args"], t["kw"]
            b_, x0, tol, its, scale = args[1], args[2], args[3], args[4], args[6]
            trips = torch.zeros((b_.shape[0],), dtype=torch.int32, device=b_.device)
            diag = cuda_pcg.scaled_diag(data, scale)
            if t["pen"]:
                def kern():
                    return cuda_pcg.pcg_solve_penalty_scenes(data, b_, x0, tol, its, trips, scale,
                                                             args[7], args[8], diag=diag)

                def plain():
                    return alcg.penalty_solve_scenes(data, args[7], args[8], b_, x0, tol, its,
                                                     scale)
            else:
                def kern():
                    return cuda_pcg.pcg_solve_scenes(data, b_, x0, tol, its, trips, scale,
                                                     diag=diag)

                def plain():
                    return pcg.solve_T_scenes(lambda xT: data.apply_T(xT, scale),
                                              data.precondition_T(scale), b_, x0, tol, its)
            n_bytes, ops = pcg_scenes_bytes_ops(data, t["trips"], t["pen"])
            a = csr_of(torch, t["solver"], b_.dtype)
            rhs = b_.permute(1, 0, 2).reshape(data.n, -1).contiguous()
            lib = events_ms(torch, lambda: torch.sparse.mm(a, rhs), 20) * float(t["trips"].mean())
            ms = min(events_ms(torch, kern, 5), events_ms(torch, kern, 5))
            plain_ms = events_ms(torch, plain, 1)
            bound_ms, bound_by = bound_of(n_bytes, ops)
            out[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=lib, bytes=n_bytes, operations=ops, scenes=t["scenes"],
                            trips_max=int(t["trips"].max()),
                            trips_mean=float(t["trips"].mean()),
                            launches_per_call=1 if g_blocks(data, b_.dtype)[0] == "cluster"
                            else t["scenes"])
        else:
            args, kw = t["args"], t["kw"]
            fn = getattr(importlib.import_module(
                f"admm_elastic_tpu_torch.ops.{BATCH_KERNELS[kname]}"), kname)
            ops = None
            if kname == "local_step_tet_hyper_scenes":
                dix, u, mu, lam, kappa, scale = args[:6]
                model = kw.get("model")
                trips = {}
                lanes = (dix + u).permute(1, 0, 2).reshape(9, -1)
                p = [a.reshape(-1) for a in scaled_params(mu, lam, kappa, scale)]
                if model != TET_LINEAR:
                    prox_tet_hyper_tuple(tuple(lanes), model, *p, trips=trips)
                ops = tet_operations(model, lanes.shape[1], True, trips)
                plain = lambda: cuda_local_step.local_step_scenes_plain(*args, **kw)  # noqa: E731
                reads = [dix, u, mu, lam, kappa, scale]
            elif kname == "local_step_tet_stencil_scenes":
                from admm_elastic_tpu_torch.ops import stencil as st

                x, u, b, scale = args[:4]
                trips = {}
                dix = torch.stack([st.tet_Dx_rows_plain(xs, b) for xs in x])
                lanes = (dix + u).permute(1, 0, 2).reshape(9, -1)
                p = [a.reshape(-1) for a in scaled_params(b.mu, b.lam, b.kappa, scale)]
                if b.model != TET_LINEAR:
                    prox_tet_hyper_tuple(tuple(lanes), b.model, *p, trips=trips)
                ops = tet_operations(b.model, lanes.shape[1], True, trips)
                plain = lambda x=x, u=u, b=b, scale=scale: cuda_local_step.local_step_scenes_plain(  # noqa: E731,E501
                    torch.stack([st.tet_Dx_rows_plain(xs, b) for xs in x]), u, b.mu, b.lam,
                    b.kappa, scale, *args[4:], model=b.model)
                reads = [x, b.st_dl, b.st_par, b.st_dead, u, b.mu, b.lam, b.kappa, scale]
            elif kname == "local_step_tri_stencil_scenes":
                from admm_elastic_tpu_torch.ops import stencil as st
                from admm_elastic_tpu_torch.ops.soa import local_step_tri_plain

                x, u, b = args
                plain = lambda x=x, u=u, b=b: cuda_tri_local_step.local_step_tri_over_scenes(  # noqa: E731,E501
                    torch.stack([st.tri_Dx_rows(xs, b) for xs in x]), u, b.limit_min,
                    b.limit_max, step=local_step_tri_plain)
                reads = [x, b.st_dl, b.st_dead, u, b.limit_min, b.limit_max]
            else:  # C
                import dataclasses

                from admm_elastic_tpu_torch.ops import stencil as st

                z, u, b, n_verts, sq = args[:5]
                plain = lambda z=z, u=u, b=b, n=n_verts, sq=sq: torch.stack([  # noqa: E731
                    st.tet_rhs_rows_plain(z[i], u[i], dataclasses.replace(
                        b, weight=b.weight * sq[i]), n) for i in range(z.shape[0])])
                reads = [z, u, b.weight, sq, b.st_dl, b.st_par]
            # the tet scene forms' operations counted by tet_operations, E's and
            # C's as their plain twins do them (plain_flops)
            m = measure(torch, lambda fn=fn, args=args, kw=kw: fn(*args, **kw), plain, reads,
                        50, 1, operations=ops)
            if kname == "tet_rhs_rows_scenes":
                m["library_ms"] = batch_c_library(torch, args)
            out[key] = m
        out[key]["scenes"] = t["scenes"]
        log(f"time {key}: kernel {out[key]['ms'] * 1e3:.1f} us, plain "
            f"{out[key]['plain_ms'] * 1e3:.1f} us, bound {out[key]['bound_ms'] * 1e3:.3f} us by "
            f"{out[key]['bound_by']}, library "
            + (f"{out[key]['library_ms'] * 1e3:.1f} us" if out[key]["library_ms"] else "none")
            + f" [{gpu}]")
    return out


def lmj_times(torch, kname, args, kw):
    """L's, M's or J's scene form on a batch path's inputs: the device time a
    launch, queued behind a sleep kernel (queued_us; CUDA events around each
    call beside it, which at these sizes read the host's enqueue), the plain
    twin's by CUDA events; the bound for all S scenes (the sum of
    each scene's schur_bytes_ops or mesh_bytes_ops); L's library yardstick one
    index_add_ of every scene's terms into zeros [S N, 3] (float atomics; never
    in the port; queued too, with the zeros' copy), none for M and J. M runs on copies of the trip's state with
    tiny and tol^2 at 0, so that no launch finds its scene done."""
    from admm_elastic_tpu_torch.ops import cuda_obstacle as co
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    lib = None
    if kname == "mesh_detect_scenes":
        obs, x = args[:2]
        ovf = torch.zeros_like(args[2])
        kern = lambda: co.mesh_detect_scenes(obs, x, ovf)  # noqa: E731
        plain = lambda: obs.signed_distance_with_overflow(x, scenes=True)  # noqa: E731
        per = [mesh_bytes_ops(torch, obs, x[i], x.element_size()) for i in range(x.shape[0])]
        s_cnt = x.shape[0]
    else:
        hits, ck = args[:2]
        s_cnt = hits.p_mask.shape[0]
        if kname == "ct_apply_scenes":
            y, n = args[2], args[3]
            slot_of = args[4] if len(args) > 4 else kw.get("slot_of")
            kern = lambda: cu.ct_apply_scenes(hits, ck, y, n, slot_of)  # noqa: E731
            plain = lambda: cu.ct_plain_scenes(hits, ck, y, n)  # noqa: E731
            h = hits.p_mask.shape[1]
            src = ((ck * torch.where(hits.p_mask, y[:, :h], 0.0))[..., None]
                   * hits.p_normal).reshape(-1, 3)
            vid = hits.p_vidx if not hits.dense else torch.arange(h, device=y.device)
            idx = (vid[None, :] + n * torch.arange(s_cnt, device=y.device)[:, None]).reshape(-1)
            zeros = torch.zeros((s_cnt * n, 3), dtype=y.dtype, device=y.device)
            lib = queued_us(torch, [("lib", lambda: zeros.clone().index_add_(0, idx, src))],
                            20)["lib"] * 1e-3
            item, trip = y.element_size(), False
        else:
            q2, state = args[2], [a.clone() for a in args[3:9]]
            n = q2.shape[1]
            kern = lambda: cu.schur_trip_scenes(hits, ck, q2, *state, 0.0, 0.0)  # noqa: E731
            plain = lambda: cu.schur_trip_plain_scenes(hits, ck, *args[2:11])  # noqa: E731
            item, trip = q2.element_size(), True
        per = [schur_bytes_ops(cu.scene_of(hits, i), n, item, trip) for i in range(s_cnt)]
    nbytes, ops = sum(p[0] for p in per), sum(p[1] for p in per)
    p1, k1, k2, p2 = (events_ms(torch, plain, 2), events_ms(torch, kern, 20),
                      events_ms(torch, kern, 20), events_ms(torch, plain, 2))
    queued = queued_us(torch, [("kernel", kern)], 20)["kernel"] * 1e-3
    bound_ms, bound_by = bound_of(nbytes, ops)
    return dict(ms=queued, events_ms=min(k1, k2), plain_ms=min(p1, p2),
                readings=[p1, k1, k2, p2], bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                bytes=nbytes, operations=ops, scenes=s_cnt)


def batch_c_library(torch, args):
    """One torch.sparse.mm of D^T W^2 (the family's, unscaled) as CSR on
    every scene's rows z - u as columns (stencil_csr's layout): the library
    yardstick of C's scene form."""
    z, u, b, n_verts = args[:4]
    s_cnt, t = z.shape[0], z.shape[2]
    w2d = stencil_csr(torch, b, n_verts)[1]
    g = (z - u).reshape(s_cnt, 3, 3, t).permute(2, 3, 0, 1).reshape(3 * t, 3 * s_cnt)
    g = g.to(torch.float32).contiguous()
    return events_ms(torch, lambda: torch.sparse.mm(w2d, g), 20)


def batch_rows(batch):
    """The kernels line's rows of the scene forms (batch_phase's results): a
    row per kernel, an entry per batch path whose inputs it was timed on (at
    that path's S); "main" where that path launches it, with the path's
    launches (the wrappers' counts of the warm-up and the capture of its
    graph: each call of a CLUSTER form or of a scene form of A, C, E is one
    launch for all scenes, the GRID form one launch a scene)."""
    scene_src = {"local_step_tet_hyper_scenes": "local_step_tet_hyper",
                 "local_step_tet_stencil_scenes": "local_step_tet_hyper",
                 "local_step_tri_stencil_scenes": "local_step_tri",
                 "tet_rhs_rows_scenes": "tet_rhs_rows", "pcg_solve_scenes": "pcg_solve",
                 "pcg_solve_penalty_scenes": "pcg_solve_penalty",
                 "ct_apply_scenes": "ct_apply", "schur_trip_scenes": "schur_trip",
                 "mesh_detect_scenes": "mesh_detect"}
    rows = []
    for kname, base in scene_src.items():
        keys = [k for k in batch["times"] if k.partition("@")[0] == kname]
        ents = []
        for key in keys:
            entry = key.partition("@")[0]
            path = key.partition("@")[2].rpartition(" ")[0]
            launches = batch["paths"].get(path, {}).get("launches", {}).get(entry, 0)
            t, c = batch["times"][key], batch["checks"][key]
            ents.append(dict(
                entry=entry, path=path if launches else None, case=key, main=launches > 0,
                launches=launches, scenes=t["scenes"], max_abs_err=c["max_abs_err"],
                **{f: t.get(f) for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "trips_max", "trips_mean", "launches_per_call")},
                **{f: c[f] for f in ("form", "blocks", "threads") if f in c}))
        ents.sort(key=lambda e: (not e["main"], e["path"] != BATCH_KERNEL_PATH.get(kname),
                                 e["case"]))
        src, rep = REPLACES[base]
        rows.append(dict(ents[0], name=kname, route="cuda", source=src, replaces=rep,
                         entries=ents))
    return rows


def batch_phase(torch, gpu):
    """The scenario batches: the scene forms' checks, the four batch paths
    against their goldens, the scaling curve, the scene forms' times.
    Returns its results (main writes them into the kernels line)."""
    t0 = time.perf_counter()
    checks, timing = batch_kernel_checks(torch)
    stamp(t0, "batch: scene forms against single-scene kernels and twins")
    paths = {}
    runs = (("beam_sweep1024", "batch_beam_sweep8", BATCH_BEAM_S),
            ("batched_contact_alpcg", "batched_contact_alpcg", None),
            ("batched_contact_alpcg_f64", "batched_contact_alpcg_f64", None),
            ("batch_cloth_sweep4", "batch_cloth_sweep4", None),
            ("batch_lattice_stencil", "batch_lattice_stencil", None)) + tuple(
        (name, name, None) for name in BATCH_WIDE + (
            "batched_contact_uzawa", "batched_contact_uzawa_f64", "batch_exactmesh_alpcg",
            "batch_exactmesh_alpcg4", "batch_exactmesh_uzawa"))
    for label, name, n in runs:
        _, _, paths[label] = batch_path(torch, label, name, n)
        stamp(t0, f"batch: {label}")
    alone = {name: batch_alone_bitwise(torch, name, BATCH_WIDE_CURVE[-1], BATCH_WIDE_LANDED)
             for name in BATCH_WIDE}
    stamp(t0, "batch: the golden scenes of 64 alone")
    curve = batch_curve(torch, gpu)
    stamp(t0, "batch: scaling curve")
    times = batch_kernel_times(torch, timing, gpu)
    stamp(t0, "batch: kernel times")
    log(f"the batch phase: {time.perf_counter() - t0:.1f} s")
    return dict(checks=checks, paths=paths, alone=alone, curve=curve, times=times)


def apps_phase(torch, gpu):
    """Every run of APP_RUNS (app_path): name -> its result. Run by main in a
    process of its own (--apps)."""
    t0 = time.perf_counter()
    out = {}
    for name in APP_RUNS:
        out[name] = app_path(torch, name, gpu)
        stamp(t0, f"apps: {name}")
    log(f"the apps' phase: {time.perf_counter() - t0:.1f} s")
    return out


def path_phase(torch, gpu):
    """The graph's invalidation checks (counted windows too); every path
    through the graph against its golden, each driven once in one window
    with its replays' launches counted on the device (drive_path); bench.py's
    contact sanity; the one-tet goldens through the graph; then
    every path's rollout rate, once in that order and once more in the
    reverse order (two readings apart in time tell a path's rate from its
    place in line): (paths, rates, checks). Run by main in a process of its
    own (--paths)."""
    paths, rates, solvers = {}, {}, {}
    t0 = time.perf_counter()
    profiler_warmup(torch)
    # the graph's invalidation checks first: late in a long process
    # torch.profiler has dropped one record of their counted window, three
    # times running (PERF.md §7)
    invalidation = invalidation_checks(torch)
    stamp(t0, "paths: invalidation checks")
    solvers["beam"], paths["beam"] = beam_path(torch, NH)
    for name in CLOTH_SCENES:
        solvers[name], paths[name] = cloth_path(torch, name)
    _, paths[FREE_BEAM] = free_beam_path(torch)
    for model in BEAM_MODELS:
        label = path_label(model)
        solvers[label], paths[label] = beam_path(torch, model)
    for name in GATHER_SCENES:
        solvers[name], paths[name] = gather_path(torch, name)
    stamp(t0, "paths: beams, cloth, gather")
    for name in PCG_PATHS:
        solvers[name], paths[name] = pcg_path(torch, name)
    stamp(t0, "paths: PCG")
    for name in CONTACT_PATHS + MESH_PATHS:
        solvers[name], paths[name] = contact_path(torch, name)
        stamp(t0, f"paths: {name}")
    for name in AA_PATHS:
        drive = contact_path if variant_of(name)[0] in CONTACT_SCENES else aa_path
        solvers[name], paths[name] = drive(torch, name)
    solvers[WIND_SEQ_PATH], paths[WIND_SEQ_PATH] = cloth_path(torch, WIND_SEQ_PATH)
    stamp(t0, "paths: Anderson, sequential wind")
    for name in SELFCOLL_PATHS:
        solvers[name], paths[name] = selfcoll_path(torch, name)
        stamp(t0, f"paths: {name}")
    sanity = bench_contact_sanity(torch)
    stamp(t0, "paths: bench.py's contact sanity")
    checks = dict(bench_contact_sanity=sanity, extras=extras_checks(torch),
                  graph=dict(invalidation=invalidation,
                             one_tet_convergence=one_tet_convergence(),
                             one_tet_inversion=one_tet_inversion()))
    log("one tet through the graph: " + json.dumps(
        {k: checks["graph"][k] for k in ("one_tet_convergence", "one_tet_inversion")}))
    stamp(t0, "paths: extras, one tet")
    for again, order in ((False, list(solvers)), (True, list(reversed(solvers)))):
        for label in order:
            r = rollout_rate(solvers[label])
            if again:
                rates[label]["again"] = r
            else:
                rates[label] = r
            log(f"rollout {label}{' (again, reverse order)' if again else ''}: "
                f"{r['rollout_steps']} steps in {r['wall_s']:.3f} s: "
                f"{r['admm_iters_per_s']:.1f} ADMM iters/s, {r['step_ms']:.3f} ms/step [{gpu}]")
    log(f"the paths' phase: {time.perf_counter() - t0:.1f} s")
    return paths, rates, checks


def host_timing(torch, gpu, cases, c_branches, prox_turns):
    """The measurements on the host's clock, on solvers of their own: the
    captured step against the eager loop in turns (graph, eager, eager,
    graph) for the beam, cloth_limit40, beam_gather and the PCG paths; then the phases of
    the beam and cloth steps on the stepped states, each kernel against its
    plain version, B and C beside one torch.sparse.mm call
    (stencil_library_times), C's two branches in turns, and D and F at the
    throughput size beside kernel A's rows entry (CUDA events)."""
    solvers = {"beam": make_solver(NH)[0], "beam_gather": make_gather_solver("beam_gather")[0]}
    solvers.update({n: make_cloth_solver(n)[0] for n in CLOTH_SCENES})
    solvers.update({n: pcg_scene(n, torch_api())[0] for n in PCG_PATHS})
    solvers.update({n: contact_scene(n, torch_api()) for n in CONTACT_PATHS})
    turns = {}
    for label in ("beam", "cloth_limit40", "beam_gather") + PCG_PATHS + CONTACT_PATHS:
        turns[label] = in_turns([("graph", lambda label=label: rollout_rate(solvers[label])),
                                 ("eager", lambda label=label: rollout_rate(solvers[label],
                                                                            eager=True))],
                                lambda call: call())
        log(f"rollout {label}: graph " + ", ".join(
            f"{r['admm_iters_per_s']:.1f}" for r in turns[label]["graph"]) + " and eager "
            + ", ".join(f"{r['admm_iters_per_s']:.1f}" for r in turns[label]["eager"])
            + f" ADMM iters/s (in turns) [{gpu}]")
    solvers["cloth_wind40"].run(8)
    phases = {"beam": step_phases(torch, solvers["beam"])}
    phases.update({n: cloth_phases(torch, solvers[n]) for n in CLOTH_SCENES})
    for label, ph in phases.items():
        for k, v in ph.items():
            log(f"phase {label}: {k}: {v * 1e3:.1f} us [{gpu}]")
    library = stencil_library_times(torch, gpu)
    times = kernel_times(torch, cases)
    for k, v in times.items():
        log(f"time {k}: kernel {v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us, "
            f"bound {v['bound_ms'] * 1e3:.3f} us by {v['bound_by']} "
            f"({v['bytes']} B, {v['operations']} operations) [{gpu}]")
    by_branch = in_turns(c_branches, lambda call: events_ms(torch, call, 200))
    for label, (first, second) in by_branch.items():
        log(f"time tet_rhs_rows {label}: {first * 1e3:.1f}, {second * 1e3:.1f} us "
            f"(CUDA events, in turns) [{gpu}]")
    return turns, phases, times, library, by_branch, prox_event_times(torch, gpu, prox_turns)


def main():
    import argparse

    # torch.profiler tears CUPTI down at the end of each window and sets it up
    # again in the next, which it turns off itself where it captures CUDA
    # graphs (torch/profiler/profiler.py: a re-initialisation among captured
    # graphs fails); this script captures many graphs and opens windows after
    # them. Set before torch is imported; the child processes inherit it.
    os.environ["TEARDOWN_CUPTI"] = "0"
    import torch

    t_start = time.perf_counter()

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 steps of the beam and the cloth step with "
                         "torch.profiler (step_profile_*.json in the output directory)")
    ap.add_argument("--step-profiles", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--paths", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--apps", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--batch", action="store_true",
                    help="run the scenario batches' phase alone (it builds the kernels)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build, the kernels' checks against plain and their "
                         "device times: the short first run of a changed kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.exists(os.path.join(DATA, "torch_port_golden_beam.npz")):
        print(f"chip_smoke: no goldens under {DATA}; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.step_profiles:
        try:
            profiles = step_profiles(torch, environment(torch)["gpu"])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        with open(os.path.join(OUT_DIR, "step_profiles.json"), "w") as f:
            json.dump(profiles, f, indent=1)
        return 0
    if args.paths:
        try:
            paths, rates, graph_checks = path_phase(torch, environment(torch)["gpu"])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return PROFILER_SHORT_RC if isinstance(e, ProfilerShort) else 1
        with open(os.path.join(OUT_DIR, "paths.json"), "w") as f:
            json.dump(dict(paths=paths, rates=rates, checks=graph_checks), f, indent=1)
        return 0
    if args.apps:
        try:
            apps = apps_phase(torch, environment(torch)["gpu"])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        with open(os.path.join(OUT_DIR, "apps.json"), "w") as f:
            json.dump(apps, f, indent=1)
        return 0
    if args.batch:
        try:
            out = batch_phase(torch, environment(torch)["gpu"])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "batch.json"), "w") as f:
            json.dump(out, f, indent=1, default=str)
        return 0
    if os.path.exists(os.path.join(OUT_DIR, "chip_smoke.log")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke.log"))
    try:
        env = environment(torch)
        gpu = env["gpu"]
        built = build()
        stamp(t_start, "build")
        checks = gather_entry_checks(torch, stencil_entry_checks(torch, kernel_checks(torch)))
        checks = ring_checks(torch, checks)
        stamp(t_start, "kernels A-F against plain")
        checks["pcg"], pcg_timing = pcg_checks(torch)
        inner_checks, inner_timing = uzawa_inner_checks(torch)
        checks["pcg"].update(inner_checks)
        pcg_timing.update(inner_timing)
        stamp(t_start, "kernel G against plain")
        checks["gs"], h_timing = h_checks(torch)
        checks["gs_mesh"], h_mesh_timing = h_mesh_checks(torch)
        h_timing.update(h_mesh_timing)
        stamp(t_start, "kernel H against plain")
        checks["mesh_detect"], j_timing = kernel_j_checks(torch)
        checks["pcg_penalty"], gpen_timing = gpen_checks(torch)
        stamp(t_start, "kernels J and G's penalty form against plain")
        checks["wind_seq"], i_timing = kernel_i_checks(torch, gpu)
        stamp(t_start, "kernel I against plain")
        checks["dyn_detect"], k_timing = kernel_k_checks(torch)
        checks["dyn_solves"], hg_timing = hdyn_gdyn_checks(torch)
        stamp(t_start, "kernels K, L, H[DYN], G[DYN] against plain")
        checks["schur_trip"], u_timing = schur_trip_checks(torch)
        stamp(t_start, "kernels L (the trip's C^T) and M against plain")
        cases, c_branches, chains, pairs, prox_turns = kernel_cases(torch)
        cases.update(path_shape_cases(torch, checks))
        stamp(t_start, "the kernels' cases")
        profiles = {}
        if args.kernels_only:
            profiles["kernels"] = profile_kernels(torch, cases, c_branches, pairs, prox_turns,
                                                  gpu)
            pcg_times(torch, pcg_timing, gpu)
            contact_kernel_times(torch, h_timing, gpen_timing, gpu)
            kernel_j_times(torch, j_timing, gpu)
            selfcoll_kernel_times(torch, k_timing, hg_timing, gpu)
            schur_trip_times(torch, u_timing, gpu)
            log("kernel I: " + json.dumps(i_timing))
            log(gpu)
            return 0
        # What the host's clock times comes before the first profiler window,
        # so that no profiler state left in the process can slow the host;
        # after some 30 windows the profiler also began to drop events.
        turns, phases, times, library, by_branch, prox_big = host_timing(
            torch, gpu, cases, c_branches, prox_turns)
        stamp(t_start, "host timing")
        variant_rates = variant_turns(torch, gpu)
        wind_forms = wind_form_turns(torch, gpu)
        stamp(t_start, "variant and wind-form turns")
        env["profiler_warmup_events"] = profiler_warmup(torch)
        g_times = pcg_times(torch, pcg_timing, gpu)
        c_times = contact_kernel_times(torch, h_timing, gpen_timing, gpu)
        j_times = kernel_j_times(torch, j_timing, gpu)
        k_times = selfcoll_kernel_times(torch, k_timing, hg_timing, gpu)
        u_times = schur_trip_times(torch, u_timing, gpu)
        stamp(t_start, "kernel times")
        del pcg_timing, h_timing, gpen_timing, j_timing, k_timing, hg_timing, u_timing
        if args.profile:
            profiles["kernels"] = profile_kernels(torch, cases, c_branches, pairs, prox_turns,
                                                  gpu)

        # The paths and the graph's checks in a process of their own, whose
        # profiler has opened no window before: the counted windows do not
        # depend on what the checks above ran (late in one long process the
        # profiler dropped a graph replay's records: PERF.md §7).
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            for attempt in range(2):
                rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--paths"],
                                    cwd=HERE, timeout=900).returncode
                if rc != PROFILER_SHORT_RC or attempt:
                    break
                # a window short three times: taken again with the whole
                # phase in a fresh process, whose every window must count
                # in full as before
                log("the paths' process: a counted window came back short three times; "
                    "the phase runs again in a fresh process")
            need(rc == 0, f"the paths' process exited with {rc}")
            with open(os.path.join(OUT_DIR, "paths.json")) as f:
                saved = json.load(f)
            paths, rates, graph_checks = saved["paths"], saved["rates"], saved["checks"]
        else:  # a rehearsal off the card: in this process
            paths, rates, graph_checks = path_phase(torch, gpu)
        stamp(t_start, "the paths")
        # The six demo apps through their main(argv), in a process of their own
        # as the paths (apps_phase).
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--apps"],
                                cwd=HERE, timeout=900).returncode
            need(rc == 0, f"the apps' process exited with {rc}")
            with open(os.path.join(OUT_DIR, "apps.json")) as f:
                apps = json.load(f)
        else:  # a rehearsal off the card: in this process
            apps = apps_phase(torch, gpu)
        stamp(t_start, "the apps")
        # The scenario batches (batch_phase), in a process of their own as the apps.
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--batch"],
                                cwd=HERE, timeout=900).returncode
            need(rc == 0, f"the batch process exited with {rc}")
            with open(os.path.join(OUT_DIR, "batch.json")) as f:
                batch = json.load(f)
        else:  # a rehearsal off the card: in this process
            batch = json.loads(json.dumps(batch_phase(torch, gpu), default=str))
        stamp(t_start, "the batches")
        checks.update(graph_checks)
        for label, t in turns.items():
            rates[label]["graph_vs_eager"] = t
        if args.profile:
            # in a process of its own: after the paths' counted windows this
            # process's profiler began to drop events (one launch in 50)
            rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--step-profiles"],
                                cwd=HERE, timeout=900).returncode
            need(rc == 0, f"the step profiles' process exited with {rc}")
            with open(os.path.join(OUT_DIR, "step_profiles.json")) as f:
                profiles.update(json.load(f))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    # One row per TPU kernel (A and D per model). Its numbers are those of the
    # entry named under "entry", on the path that launches it: C on the
    # neo-Hookean beam, A, D and F on their model's beam, E on the
    # strain-limited sheet, B standalone on the unpinned beam. A, B and E list
    # every entry that does their work under "entries": the stencil entry that
    # the steps launch and the rows entry (A, E), the standalone kernel and
    # the neo-Hookean stencil entry (B); and the rows entries of A
    # (neo-Hookean, linear) and E as the gather paths' steps launch them,
    # timed at those paths' shapes.
    def entry(name, path):
        t = times[name]
        counted = name.partition("@")[0]
        return dict(entry=counted, path=path, launches=paths[path]["launches"].get(counted, 0),
                    wrapper_calls=paths[path]["wrapper_calls"].get(counted, 0),
                    max_abs_err=checks["f32"][name]["max_abs_err"], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    library_ms=t["library_ms"])

    kernels = []
    for name in times:
        base, _, model = name.partition("[")
        if base in STENCIL_ENTRY.values() or "@" in name:
            continue
        path = ("cloth_limit40" if base == "local_step_tri" else
                "beam[linear]" if base == "prox_tet_linear" else
                FREE_BEAM if base == "tet_Dx_rows" else path_label(model.rstrip("]") or NH))
        entries = [entry(name, path)]
        if base in STENCIL_ENTRY:
            entries.insert(0, entry(STENCIL_ENTRY[base] + name[len(base):], path))
        elif base == "tet_Dx_rows":
            entries.append(entry(f"{STENCIL_ENTRY['local_step_tet_hyper']}[{NH}]", "beam"))
        # the entries as the gather and PCG paths' steps launch them, at their
        # shapes (name@path): the rows entry, and the stencil entry
        stencil_name = STENCIL_ENTRY[base] + name[len(base):] if base in STENCIL_ENTRY else None
        entries += [entry(k, k.partition("@")[2]) for k in times
                    if "@" in k and k.partition("@")[0] in (name, stencil_name)]
        if name == f"local_step_tet_hyper[{NH}]":  # the bunny's shape, as bunny_nh's
            entries.append(entry(f"local_step_tet_hyper[{NH}]@bunny_nh", "bunny_pcg"))
        src, rep = REPLACES[base]
        row = dict(entries[0], name=name, route="cuda", source=src, replaces=rep, entries=entries)
        if name in library["beam"]:
            # one torch.sparse.mm call beside B and C at the bench beam's and
            # beam_pcg160k's shapes (stencil_library_times)
            row["library_ms"] = library["beam"][name]["library_ms"]
            row["library_by_shape"] = {shape: t[name] for shape, t in library.items()}
        if base == "tet_Dx_rows":
            # on the ring, B's work runs inside A's ring stencil entry; B alone
            # on the ring's shape, timed
            entries.append(entry(f"local_step_tet_stencil[{NH}]@torus_pcg20k", "torus_pcg20k"))
            ring = times["tet_Dx_rows ring@torus_pcg20k"]
            row["ring_standalone@torus_pcg20k"] = dict(
                {k: ring[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                max_abs_err=checks["f32"]["tet_Dx_rows@torus_pcg20k"]["max_abs_err"])
        if base in ("prox_tet_hyper", "prox_tet_linear"):
            # the throughput size (TILES x the beam's lanes), CUDA events
            big = prox_big[model.rstrip("]") or "linear"]
            row[f"at_{big['lanes']}_lanes"] = {k: big[k] for k in (
                "ms", "bound_ms", "bound_by", "rows_ms", "rows_bound_ms")}
        kernels.append(row)
    # Kernels G, its penalty form and H, which replace the JAX package's jnp
    # loops (no Pallas kernel): one entry per solve and form, the solve's time
    # in that form (queued CUDA events, in turns with the other form) beside
    # its latency floor; "main" the form the wrapper chooses there, whose
    # entry carries the path's launches (the other form's 0: it runs in the
    # checks and the timing only) and its torch.profiler time as
    # "profiler_ms". G: each PCG path's first solve, and Uzawa's inner solve
    # on floor_uzawa67k (its first solve and a Schur direction's, solve
    # "<path> schur"); H: floor_gs5k, sphere_gs; the penalty form:
    # floor_alpcg67k, each on its first-solve inputs at the landed state.
    def form_entries(kname, solve, path, t, err):
        out = []
        for form, f in t["forms"].items():
            main = form == t["form"]
            out.append(dict(
                entry=kname, path=path, solve=solve, form=form, main=main,
                launches=paths[path]["launches"].get(kname, 0) if main else 0,
                wrapper_calls=paths[path]["wrapper_calls"].get(kname, 0) if main else 0,
                max_abs_err=err, ms=f["ms"], floor_ms=f["floor_ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
                profiler_ms=t["profiler_ms"] if main else None,
                **{k: t[k] for k in ("trips", "sweeps") if k in t},
                **{k: f[k] for k in ("blocks", "threads", "ms_per_trip", "ms_per_sweep")
                   if k in f}))
        return sorted(out, key=lambda e: not e["main"])

    g_entries = [e for name in PCG_PATHS + ("floor_uzawa67k", "floor_uzawa67k schur")
                 for e in form_entries("pcg_solve", name, name.partition(" ")[0], g_times[name],
                                       checks["pcg"][name]["f32"]["max_abs_err"])]
    src, rep = REPLACES["pcg_solve"]
    kernels.append(dict(g_entries[0], name="pcg_solve", route="cuda", source=src, replaces=rep,
                        entries=g_entries))
    for kname, kpaths in (("gs_solve", ("floor_gs5k", "sphere_gs", "slab_sdf_gs5k",
                                        "slab_exact_gs5k", "exactmesh_deep_gs")),
                          ("pcg_solve_penalty", ("floor_alpcg67k",))):
        entries = [e for p in kpaths
                   for e in form_entries(kname, p, p, c_times[f"{kname}@{p}"],
                                         c_times[f"{kname}@{p}"]["max_abs_err"])]
        src, rep = REPLACES[kname]
        kernels.append(dict(entries[0], name=kname, route="cuda", source=src, replaces=rep,
                            entries=entries))
    # Kernel I, which replaces the JAX package's scan of the sequential wind (no
    # Pallas kernel): one entry per sheet and form, beside its latency floor;
    # "main" the form the wrapper chooses on cloth_wind40_seq's sheet, whose
    # entry carries the path's launches (the kernel's device counter) and
    # beside them profiler_launches, the records torch.profiler kept of them.
    i_entries = []
    for key, t in i_timing.items():
        label, dname = key.rsplit(" ", 1)
        if dname != "f32" or label not in WIND_SHEET_LABELS:
            continue
        for form, f in t["forms"].items():
            main = form == t["form"] and t["triangles"] == WIND_SEQ_TRIANGLES
            i_entries.append(dict(
                entry="wind_seq", path=WIND_SEQ_PATH if main else None, main=main,
                triangles=t["triangles"], vertices=t["vertices"], form=form,
                launches=paths[WIND_SEQ_PATH]["launches"].get("wind_seq", 0) if main else 0,
                profiler_launches=(paths[WIND_SEQ_PATH]["launches"].get(PROFILED_I, 0)
                                   if main else 0),
                wrapper_calls=(paths[WIND_SEQ_PATH]["wrapper_calls"].get("wind_seq", 0)
                               if main else 0),
                levels=t["levels"], widest=t["widest"],
                max_abs_err=checks["wind_seq"][key]["max_abs_err"], ms=f["ms"],
                floor_ms=f["floor_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None))
    i_entries.sort(key=lambda e: not e["main"])
    src, rep = REPLACES["wind_seq"]
    kernels.append(dict(i_entries[0], name="wind_seq", route="cuda", source=src, replaces=rep,
                        entries=i_entries))
    # Kernel J, which replaces the JAX package's jnp narrow phases of the mesh
    # obstacles (no Pallas kernel): one entry per detection timed on
    # slab_exact_alpcg67k's states (J_STEPS), compacted as the path runs it
    # and dense; "main" the compacted one at the landed step, whose entry
    # carries the path's launches (10 a step).
    jpath = "slab_exact_alpcg67k"
    j_entries = sorted((dict(
        entry="mesh_detect", path=jpath, case=k.partition("@")[2],
        main=k == f"mesh_detect@{jpath}@{J_STEPS[-1]}",
        launches=(paths[jpath]["launches"].get("mesh_detect", 0)
                  if k == f"mesh_detect@{jpath}@{J_STEPS[-1]}" else 0),
        wrapper_calls=(paths[jpath]["wrapper_calls"].get("mesh_detect", 0)
                       if k == f"mesh_detect@{jpath}@{J_STEPS[-1]}" else 0),
        **{f: t[f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "profiler_ms", "lanes", "evaluated", "candidates",
                             "near_lanes")}) for k, t in j_times.items()),
        key=lambda e: not e["main"])
    src, rep = REPLACES["mesh_detect"]
    kernels.append(dict(j_entries[0], name="mesh_detect", route="cuda", source=src,
                        replaces=rep, entries=j_entries))
    # Kernels K, L and the DYN forms of H and G (self-collision; no Pallas
    # original): one entry per timed shape; "main" the one whose path launches
    # it, with the path's launches and launches per step.
    def selfcoll_row(kname, shapes, path, err_of):
        steps = int(golden(path)["steps"][-1])
        ents = []
        for i, shape in enumerate(shapes):
            t = k_times[f"{kname}@{shape}"]
            main = i == 0
            launches = paths[path]["launches"].get(kname, 0) if main else 0
            ents.append(dict(
                entry=kname, path=path if main else None, case=shape, main=main,
                launches=launches, launches_per_step=launches / steps if main else 0,
                wrapper_calls=paths[path]["wrapper_calls"].get(kname, 0) if main else 0,
                max_abs_err=err_of(shape),
                **{f: t[f] for f in ("ms", "profiler_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms") if f in t}))
        src, rep_ = REPLACES[kname]
        return dict(ents[0], name=kname, route="cuda", source=src, replaces=rep_, entries=ents)

    k_labels = [k.partition("@")[2] for k in k_times if k.startswith("dyn_detect@")]
    gs8_first = [k for k in k_labels if k.startswith("boxes_gs8@")]
    k_order = gs8_first[:1] + [k for k in k_labels if k not in gs8_first[:1]]
    kernels.append(selfcoll_row("dyn_detect", k_order, "boxes_gs8",
                                lambda sh: checks["dyn_detect"][f"{sh} f32"]["max_abs_err"]))
    kernels.append(selfcoll_row("dyn_gather", k_order, "boxes_gs8",
                                lambda sh: checks["dyn_detect"][f"{sh} f32"]["l_max_abs_err"]))
    kernels.append(selfcoll_row("gs_solve_dyn", list(H_DYN_CASES), "boxes_gs8",
                                lambda sh: checks["dyn_solves"][f"gs_solve_dyn@{sh} f32"][
                                    "max_abs_err"]))
    kernels.append(selfcoll_row("pcg_solve_dyn", ["boxes_alpcg8"], "boxes_alpcg8",
                                lambda sh: checks["dyn_solves"][f"pcg_solve_dyn@{sh} f32"][
                                    "max_abs_err"]))
    # L's full C^T and M (Uzawa's Schur trip; no Pallas original): an entry
    # per UZAWA_PATHS state, each with its path's launches and launches per
    # step, "main" boxes_uzawa8's; M's with its latency floor
    for kname in ("ct_apply", "schur_trip"):
        ents = []
        for path in UZAWA_PATHS:
            t = u_times[f"{kname}@{path}"]
            launches = paths[path]["launches"].get(kname, 0)
            ents.append(dict(
                entry=kname, path=path, case=path, main=path == UZAWA_PATHS[0],
                launches=launches,
                launches_per_step=launches / int(golden(path)["steps"][-1]),
                wrapper_calls=paths[path]["wrapper_calls"].get(kname, 0),
                max_abs_err=checks["schur_trip"][f"{path} f32"]["max_abs_err"],
                **{f: t[f] for f in ("ms", "profiler_ms", "floor_ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms", "rows", "vertices")}))
        src, rep_ = REPLACES[kname]
        kernels.append(dict(ents[0], name=kname, route="cuda", source=src, replaces=rep_,
                            entries=ents))
    # every row's launches on the paths of this slice and the one before it
    # (Uzawa's, self-collision) and their launches per step
    new_paths = SELFCOLL_PATHS + tuple(p for p in UZAWA_PATHS if p not in SELFCOLL_PATHS)
    for row in kernels:
        names = sorted({e["entry"] for e in row["entries"]})
        row["launches_on_new_paths"] = {
            p: {n: paths[p]["launches"][n] for n in names if paths[p]["launches"].get(n)}
            for p in new_paths}
        row["launches_per_step_on_new_paths"] = {
            p: {n: v / int(golden(p)["steps"][-1]) for n, v in launches.items()}
            for p, launches in row["launches_on_new_paths"].items()}
    kernels += batch_rows(batch)
    # every row's launches in each app's run (the wrappers' counts: the
    # captured step's warm-up and capture, and the eager calls)
    for row in kernels:
        names = sorted({e["entry"] for e in row["entries"]})
        row["launches_on_apps"] = {
            a: {n: r["wrapper_counts"][n] for n in names if r["wrapper_counts"].get(n)}
            for a, r in apps.items()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(env=env, build=built, checks=checks, paths=paths, rollouts=rates,
                       apps=apps,
                       phases_ms=phases, kernel_times=times, rhs_branches_ms=by_branch,
                       prox_throughput_ms=prox_big, pcg_solve_ms=g_times,
                       contact_solve_ms=c_times, wind_seq_ms=i_timing, mesh_detect_ms=j_times,
                       selfcoll_ms=k_times, schur_trip_ms=u_times, batch=batch,
                       variant_rollouts=variant_rates, wind_seq_forms_end_to_end=wind_forms,
                       warp_chains=chains, profiles=profiles,
                       kernels=kernels), f, indent=1)
    for k in kernels:
        for e in k["entries"]:
            if e.get("main", True) and e["launches"] <= 0:
                print(f"chip_smoke: FAIL: kernel {k['name']}: {e['entry']} has no launch on "
                      f"{e['path']}", file=sys.stderr)
                return 1
    log(f"chip_smoke: wall time {time.perf_counter() - t_start:.1f} s, the kernels' build "
        "included")
    log(gpu)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
