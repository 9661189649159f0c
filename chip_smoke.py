#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card, nvcc and
PyTorch built for CUDA. JAX is not needed: the reference trajectory comes
from tests/data/torch_port_golden_beam.npz (written by
tests/make_torch_golden.py). Phases, each of which exits non-zero on
failure:

1. environment: GPU name and power limit, torch / CUDA / nvcc / Triton
   versions, TF32 flags (set off: the direct solve needs full FP32);
2. build the kernels of admm_elastic_tpu_torch/csrc with nvcc;
3. each kernel (A local step, B D x, C rhs) against its plain PyTorch
   version on the card at the bench shapes (7,680 lanes, 1,536 cells,
   1,476 vertices): float64 within 1e-10, float32 within the bounds below,
   all outputs finite, kernel C bitwise repeatable;
4. the slice: the bench scene (40x5x5 neo-Hookean beam, -x face pinned,
   float32, linsolver=0 "inv", 10 ADMM iterations, dt 1/24) built through
   binding.add_tetmesh -> set_pins -> initialize on cuda and stepped 8
   times; launch counts of all three kernels > 0; steps 1 and 8 within
   1e-4 and 2e-3 of the JAX golden (relative to max |x|); bench.py's
   sanity checks; the 8 steps run twice from one state bitwise equal;
5. timing: ADMM iterations/s over a rollout of at least 2 s, the step's
   phases, and each kernel's time against its plain version (CUDA events);
6. with --profile only: torch.profiler over 5 steps (device busy time,
   idle share, device operations per ADMM iteration, time by kernel).

The last lines are the GPU line, one JSON line of kernels, and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_golden_beam.npz")
OUT_DIR = os.path.join(HERE, "chiprun_out")

# Kernel-versus-plain bounds, on max |kernel - plain| <= tol * max(1, max |plain|)
# for B and C. float32: FMA contraction in the kernels versus separate
# rounding in the plain ops, over sums of at most 8 x 4 terms.
F64_TOL = 1e-10
F32_TOL_STENCIL = 1e-5
# Kernel A, absolute on z and u' (|z| ~ 1): float64 allclose(rtol=atol=1e-10)
# on main-path inputs. float32: median 1e-6, 99th percentile 2e-4, max 5e-2
# -- a last-ulp difference can flip the Newton backtracking accept test on
# the few lanes whose objective is flat to float32 precision
# (tests/test_torch_local_step.py states the same bounds against JAX).
# The stress recipe (inverted and x3-stretched F) holds float64 to the
# same flip-tolerant form with a 99th percentile of 1e-10.
A_MAX, A_P99_F32, A_MEDIAN_F32 = 5e-2, 2e-4, 1e-6
STEP1_TOL, STEP8_TOL = 1e-4, 2e-3
TARGET_S = 2.0
DEVICE = "cuda"

REPLACES = {
    "local_step_tet_hyper": ("admm_elastic_tpu_torch/csrc/local_step.cu",
                             "admm_elastic_tpu/ops/pallas_kernels.py:220"),
    "tet_Dx_rows": ("admm_elastic_tpu_torch/csrc/stencil.cu",
                    "admm_elastic_tpu/ops/pallas_stencil.py:164"),
    "tet_rhs_rows": ("admm_elastic_tpu_torch/csrc/stencil.cu",
                     "admm_elastic_tpu/ops/pallas_stencil.py:193"),
}


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def run_cmd(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise SmokeFailure(f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


# --- phase 1: environment ----------------------------------------------------

def environment(torch):
    gpu = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
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

def build():
    from admm_elastic_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    so = _build.build()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"build {secs:.1f} s -> {so.name}")
    for ln in ptxas:
        log(f"  ptxas {ln}")
    return dict(build_s=secs, library=so.name, ptxas=ptxas)


# --- shared scene helpers ----------------------------------------------------------

def bench_mesh():
    from admm_elastic_tpu_torch import binding
    from admm_elastic_tpu_torch.geometry.factory import make_tet_blocks

    g = np.load(GOLDEN)
    mesh = make_tet_blocks(*[int(d) for d in g["dims"]])
    mesh.flags = binding.NOSELFCOLLISION | binding.NEOHOOKEAN
    return mesh, g


def bench_batch(torch, dtype):
    from admm_elastic_tpu_torch.materials import Lame
    from admm_elastic_tpu_torch.system import elements as el

    mesh, _ = bench_mesh()
    b = el.build_tet_batch(mesh.vertices, mesh.tets, Lame.soft_rubber(), "neohookean",
                           device=DEVICE, dtype=dtype, lattice_dims=mesh.lattice_dims)
    return mesh, b


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


def stencil_err(torch, got, want):
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    return err, err / scale


# --- phase 3: kernels against their plain versions --------------------------------

def kernel_checks(torch):
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain

    rng = np.random.default_rng(0)
    res = {}
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        mesh, b = bench_batch(torch, dtype)
        n = mesh.vertices.shape[0]
        t = b.n
        x_np = mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape)
        x = torch.as_tensor(x_np, device=DEVICE, dtype=dtype)

        # B: D x
        got = cuda_stencil.tet_Dx_rows(x, b)
        want = st.tet_Dx_rows_plain(x, b)
        need(bool(torch.isfinite(got).all()), f"B {name}: non-finite output")
        eb, rb = stencil_err(torch, got, want)
        tol = F64_TOL if name == "f64" else F32_TOL_STENCIL
        need(rb <= tol, f"B {name}: rel err {rb:.3e} > {tol}")

        # A on main-path inputs: D x of a perturbed beam, small u.
        u = torch.as_tensor(0.05 * rng.standard_normal((9, t)), device=DEVICE, dtype=dtype)
        args = (got, u, b.mu, b.lam, b.kappa, b.bulk)
        za, ua = cuda_local_step.local_step_tet_hyper(*args)
        zp, up = local_step_plain(*args)
        a_main = local_step_errs(torch, (za, ua), (zp, up), name, "main-path")
        # A on the stress recipe (tests/test_pallas.py _random_f).
        f = np.eye(3)[None] + 0.4 * rng.standard_normal((t, 3, 3))
        f[::5] *= -1.0
        f[1::7] *= 3.0
        dix = torch.as_tensor(f.reshape(t, 9).T.copy(), device=DEVICE, dtype=dtype)
        args_s = (dix, torch.zeros_like(dix), b.mu, b.lam, b.kappa, b.bulk)
        a_stress = local_step_errs(torch, cuda_local_step.local_step_tet_hyper(*args_s),
                                   local_step_plain(*args_s), name, "stress")

        # C: D^T W^2 (z - u), twice bitwise equal
        z = torch.as_tensor(rng.standard_normal((9, t)), device=DEVICE, dtype=dtype)
        uu = torch.as_tensor(rng.standard_normal((9, t)), device=DEVICE, dtype=dtype)
        c1 = cuda_stencil.tet_rhs_rows(z, uu, b, n)
        c2 = cuda_stencil.tet_rhs_rows(z, uu, b, n)
        cp = st.tet_rhs_rows_plain(z, uu, b, n)
        need(bool(torch.isfinite(c1).all()), f"C {name}: non-finite output")
        need(bool(torch.equal(c1, c2)), f"C {name}: two runs differ")
        ec, rc = stencil_err(torch, c1, cp)
        need(rc <= tol, f"C {name}: rel err {rc:.3e} > {tol}")

        res[name] = dict(
            tet_Dx_rows=dict(max_abs_err=eb, rel_err=rb),
            local_step_tet_hyper=dict(main=a_main, stress=a_stress,
                                      max_abs_err=max(a_main["max"], a_stress["max"])),
            tet_rhs_rows=dict(max_abs_err=ec, rel_err=rc, bitwise_repeat=True),
        )
        log(f"kernels {name} " + json.dumps(res[name]))
    return res


def local_step_errs(torch, got, want, name, which):
    errs = []
    for g, w in zip(got, want):
        need(bool(torch.isfinite(g).all()), f"A {name} {which}: non-finite output")
        errs.append((g - w).abs().flatten())
    e = torch.cat(errs).double().cpu().numpy()
    scale = torch.cat([w.abs().flatten() for w in want]).double().cpu().numpy()
    out = dict(max=float(e.max()), p99=float(np.quantile(e, 0.99)),
               median=float(np.median(e)),
               lanes_over_1e_4=int((e > 1e-4).sum()))
    if name == "f64" and which == "main-path":
        need(bool((e <= F64_TOL + F64_TOL * scale).all()),
             f"A f64 main-path: {out} exceeds allclose(1e-10)")
    elif name == "f64":
        need(out["max"] < A_MAX and out["p99"] < F64_TOL, f"A f64 {which}: {out}")
    else:
        need(out["max"] < A_MAX and out["p99"] < A_P99_F32 and out["median"] < A_MEDIAN_F32,
             f"A f32 {which}: {out}")
    return out


# --- phase 4: the slice ------------------------------------------------------------------

def counters():
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil

    return {"local_step_tet_hyper": cuda_local_step.local_step_tet_hyper,
            "tet_Dx_rows": cuda_stencil.tet_Dx_rows,
            "tet_rhs_rows": cuda_stencil.tet_rhs_rows}


def make_solver(torch):
    from admm_elastic_tpu_torch import Lame, Settings, Solver, binding

    mesh, g = bench_mesh()
    solver = Solver(device=DEVICE)
    binding.add_tetmesh(solver, mesh, Lame.soft_rubber(), verbose=False)
    pins = [int(i) for i in np.where(mesh.vertices[:, 0] < 1e-9)[0]]
    need(pins == [int(i) for i in g["pins"]], "pinned set differs from the golden's")
    solver.set_pins(pins)
    settings = Settings(verbose=0, admm_iters=int(g["admm_iters"]), linsolver=0,
                        gravity=float(g["gravity"]), timestep_s=float(g["dt"]),
                        dtype=np.float32, direct_mode="inv")
    need(solver.initialize(settings), "initialize failed")
    return solver, mesh, g, pins


def slice_run(torch):
    from admm_elastic_tpu_torch.system.system import SimState

    solver, mesh, g, pins = make_solver(torch)
    state0 = SimState(x=solver.state.x.clone(), v=solver.state.v.clone())
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    solver.step()
    x1 = solver.x
    solver.run(7)
    x8_t = solver.state.x.clone()
    launches = {k: fn.launches for k, fn in cnt.items()}
    log("main-path launches " + json.dumps(launches))
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")
    x8 = x8_t.cpu().numpy()

    errs = {}
    for step, x in ((1, x1), (8, x8)):
        ref = g[f"x{step}"]
        need(x.shape == ref.shape and np.isfinite(x).all(), f"step {step}: bad state")
        errs[step] = float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-9))
    log(f"vs JAX golden: step1 {errs[1]:.3e} (bound {STEP1_TOL}), "
        f"step8 {errs[8]:.3e} (bound {STEP8_TOL})")
    need(errs[1] < STEP1_TOL and errs[8] < STEP8_TOL, f"trajectory off the golden: {errs}")

    # bench.py's sanity checks (bench.py:101-106)
    x0 = mesh.vertices
    pin_dev = float(np.abs(x8[pins] - x0[pins]).max())
    need(pin_dev < 1e-3, f"pins not held: {pin_dev}")
    need(-60.0 < x8[:, 1].min() < x0[:, 1].min(), "no sag?")

    solver.state = SimState(x=state0.x.clone(), v=state0.v.clone())
    solver.run(8)
    need(bool(torch.equal(solver.state.x, x8_t)), "8-step rollout not bitwise repeatable")
    return solver, dict(launches=launches, rel_err_step1=errs[1], rel_err_step8=errs[8],
                        pin_dev=pin_dev, min_y=float(x8[:, 1].min()), bitwise_repeat=True)


# --- phase 5: timing ---------------------------------------------------------------------

def rollout_rate(solver):
    n_steps = 20
    while True:
        t0 = time.perf_counter()
        solver.run(n_steps)  # run() synchronizes before it returns
        wall = time.perf_counter() - t0
        if wall >= TARGET_S:
            break
        n_steps = max(n_steps + 1, int(n_steps * max(2.0, 1.2 * TARGET_S / wall)))
    need(np.isfinite(solver.x).all(), "non-finite state after the timed rollout")
    iters = n_steps * solver.m_settings.admm_iters
    return dict(rollout_steps=n_steps, wall_s=wall, admm_iters_per_s=iters / wall,
                step_ms=wall / n_steps * 1e3)


def step_phases(torch, solver):
    """Mean ms of each phase of one ADMM iteration, isolated (CUDA events)."""
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
        "Dx (kernel B)": events_ms(torch, lambda: cuda_stencil.tet_Dx_rows(x, b0), reps),
        "local step (kernel A)": events_ms(torch, lambda: cuda_local_step.local_step_tet_hyper(
            dix, u[0], b0.mu, b0.lam, b0.kappa, b0.bulk), reps),
        "rhs D^T W^2 (kernel C)": events_ms(
            torch, lambda: cuda_stencil.tet_rhs_rows(z[0], u[0], b0, system.n_verts), reps),
        "local step, whole (B + A + pins)": events_ms(
            torch, lambda: sysm.local_step(system, x, z, u), reps),
        "rhs, whole (C + pins + M x_bar)": events_ms(
            torch, lambda: sysm.rhs(system, x, z, u), reps),
        "direct.solve (GEMM)": events_ms(torch, lambda: direct.solve(data, b), reps),
        "direct.polish": events_ms(torch, lambda: direct.polish(data, xs, b), reps),
        "ADMM iteration": events_ms(torch, lambda: solver._apply_Ainv(
            sysm.rhs(system, x, *sysm.local_step(system, x, z, u))), reps),
    }


def kernel_times(torch):
    """Each kernel against its plain version at bench shapes, float32."""
    from admm_elastic_tpu_torch.ops import cuda_local_step, cuda_stencil
    from admm_elastic_tpu_torch.ops import stencil as st
    from admm_elastic_tpu_torch.ops.hyper_soa import local_step_plain

    mesh, b = bench_batch(torch, torch.float32)
    n = mesh.vertices.shape[0]
    rng = np.random.default_rng(1)
    x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                        device=DEVICE, dtype=torch.float32)
    dix = cuda_stencil.tet_Dx_rows(x, b)
    u = torch.as_tensor(0.05 * rng.standard_normal((9, b.n)), device=DEVICE,
                        dtype=torch.float32)
    a_args = (dix, u, b.mu, b.lam, b.kappa, b.bulk)
    out = {}
    # plain, kernel, kernel, plain: the two readings of each show the drift
    pairs = {
        "local_step_tet_hyper": (lambda: cuda_local_step.local_step_tet_hyper(*a_args),
                                 lambda: local_step_plain(*a_args), 200, 5),
        "tet_Dx_rows": (lambda: cuda_stencil.tet_Dx_rows(x, b),
                        lambda: st.tet_Dx_rows_plain(x, b), 500, 50),
        "tet_rhs_rows": (lambda: cuda_stencil.tet_rhs_rows(dix, u, b, n),
                         lambda: st.tet_rhs_rows_plain(dix, u, b, n), 500, 50),
    }
    for name, (kern, plain, rk, rp) in pairs.items():
        p1 = events_ms(torch, plain, rp)
        k1 = events_ms(torch, kern, rk)
        k2 = events_ms(torch, kern, rk)
        p2 = events_ms(torch, plain, rp)
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), readings=[p1, k1, k2, p2])
    return out


def profile_step(torch, solver, gpu, n_steps=5):
    """torch.profiler over n_steps of the rollout: device busy time, idle
    share, device operations per ADMM iteration and time by kernel name.
    Writes chiprun_out/step_profile.json and the Chrome trace beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver.run(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run(n_steps)  # synchronizes before it returns
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    need(events, "profiler saw no device activity")
    by_name = {}
    for e in events:
        cnt_us = by_name.setdefault(e.name, [0, 0.0])
        cnt_us[0] += 1
        cnt_us[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in by_name.values())
    iters = n_steps * solver.m_settings.admm_iters
    res = dict(gpu=gpu, steps=n_steps, admm_iters=iters, wall_us=wall_us, busy_us=busy_us,
               idle_share=1.0 - busy_us / wall_us, device_ops_per_admm_iter=len(events) / iters,
               by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])))
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "step_trace.json"))
    with open(os.path.join(OUT_DIR, "step_profile.json"), "w") as f:
        json.dump(res, f, indent=1)
    log(f"profile {n_steps} steps: wall {wall_us:.1f} us, device busy {busy_us:.1f} us, "
        f"idle share {res['idle_share']:.3f}, {res['device_ops_per_admm_iter']:.1f} device "
        f"ops per ADMM iteration [{gpu}]")
    for name, (cnt, us) in list(res["by_name"].items())[:12]:
        log(f"  {us:9.1f} us {cnt:5d}x {name[:90]}")
    return res


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 steps with torch.profiler (chiprun_out/step_profile.json)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.exists(GOLDEN):
        print(f"chip_smoke: missing {GOLDEN}; run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        env = environment(torch)
        built = build()
        checks = kernel_checks(torch)
        solver, slice_res = slice_run(torch)
        rate = rollout_rate(solver)
        log(f"rollout {rate['rollout_steps']} steps in {rate['wall_s']:.3f} s: "
            f"{rate['admm_iters_per_s']:.1f} ADMM iters/s, {rate['step_ms']:.3f} ms/step "
            f"[{env['gpu']}]")
        phases = step_phases(torch, solver)
        for k, v in phases.items():
            log(f"phase {k}: {v * 1e3:.1f} us [{env['gpu']}]")
        times = kernel_times(torch)
        for k, v in times.items():
            log(f"time {k}: kernel {v['ms'] * 1e3:.1f} us, plain {v['plain_ms'] * 1e3:.1f} us "
                f"[{env['gpu']}]")
        if args.profile:
            profile_step(torch, solver, env["gpu"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1

    kernels = []
    for name, (src, rep) in REPLACES.items():
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=slice_res["launches"][name],
                            max_abs_err=checks["f32"][name]["max_abs_err"],
                            ms=times[name]["ms"], plain_ms=times[name]["plain_ms"]))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(env=env, build=built, checks=checks, slice=slice_res, rollout=rate,
                       phases_ms=phases, kernel_times=times, kernels=kernels), f, indent=1)
    log(env["gpu"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
