#!/usr/bin/env python3
"""Time kernels G (csrc/pcg.cu) and H (csrc/gs.cu) and the paths that run
them, in this checkout against another checkout of the repository, in
turns, on one CUDA card.

    python3 tools/pcg_turns.py OTHER [--rounds 1]

OTHER is the root of another checkout, for example a commit unpacked with
``git archive <commit> | tar -x -C build/other``. Each checkout runs in a
child process of its own, in the order this, other, other, this (``rounds``
times), with its own chip_smoke.py, package and kernel library. A child
reads, with that checkout's chip_smoke helpers:

- every solve of G and H on the paths' first-solve inputs: G on each of
  chip_smoke.PCG_PATHS (chip_smoke.first_solve), G as Uzawa's inner solve on
  floor_uzawa67k (its first solve and the first Schur direction's,
  uzawa_inner_checks), G's penalty form on floor_alpcg67k (gpen_checks), H
  on floor_gs5k and sphere_gs (h_checks): the kernel's device time per
  solve (torch.profiler, 20 launches), its trips or sweeps, and a digest of
  its x;
- every path's rollout: a digest of x after 8 steps (the PCG paths) or at
  each compared step (chip_smoke.CONTACT_COMPARE; sphere_gs's from its
  golden), each path built anew, then the rate of the captured step
  (chip_smoke.rollout_rate, at least 2 s) from there.

Prints one line per reading and child, whether the two checkouts' digests
agree (the same bits), and the card's name and power limit; writes
pcg_turns.json into chip_smoke.OUT_DIR.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTACT = ("floor_uzawa67k", "floor_alpcg67k", "floor_gs5k", "sphere_gs")


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _device_us(torch, fn, kernel, reps=20):
    """Device µs per launch of the kernel named by fn() (torch.profiler, reps
    launches); a window with launches missing is taken again, three at
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(us) == reps:
            break
    return sum(us) / max(len(us), 1), len(us)


def solves(torch, cs):
    """(label, fn(counter) -> x, kernel name) of every first solve of G and H."""
    from admm_elastic_tpu_torch.ops import cuda_gs, cuda_pcg
    from admm_elastic_tpu_torch.solvers import alcg

    out = []
    for name in cs.PCG_PATHS:
        solver, _ = cs.pcg_scene(name, cs.torch_api())
        s = solver.m_settings
        b, x0 = cs.first_solve(torch, solver)
        out.append((name, lambda t, d=solver._solve_data, b=b, x0=x0, s=s: cuda_pcg.pcg_solve(
            d, b, x0, s.pcg_tol, s.pcg_max_iters, t), "pcg_kernel"))
    _, inner = cs.uzawa_inner_checks(torch)
    for label, t in inner.items():
        out.append((label, lambda c, t=t: cuda_pcg.pcg_solve(
            t["data"], t["b"], t["x0"], t["tol"], t["max_iters"], c), "pcg_kernel"))
    _, pen = cs.gpen_checks(torch)
    t = pen["floor_alpcg67k"]
    s = t["solver"].m_settings
    out.append(("floor_alpcg67k", lambda c, t=t, s=s: alcg.solve(
        t["data"], t["hits"], t["ck"], t["b"], t["x0"], t["y"], s.pcg_tol, s.pcg_max_iters,
        c)[0], "pcg_kernel"))
    _, h = cs.h_checks(torch)
    for name, t in h.items():
        solver = t["solver"]
        s = solver.m_settings
        out.append((name, lambda c, t=t, s=s, solver=solver: cuda_gs.gs_solve(
            solver._solve_data, t["b"], t["x0"], t["pin_mask"], t["pin_target"],
            list(solver._contact.obstacles), s.gs_omega, s.gs_max_iters, s.gs_tol, c,
            params=solver._contact.gs_params), "gs_kernel"))
    return out


def rollouts(cs):
    """(path, a new solver of it, the steps whose x is digested)."""
    for name in cs.PCG_PATHS:
        yield name, lambda name=name: cs.pcg_scene(name, cs.torch_api())[0], (8,)
    for name in CONTACT:
        yield name, lambda name=name: cs.contact_scene(name, cs.torch_api()), tuple(
            int(k) for k in cs.golden(name)["steps"])


def child(root):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    for label, fn, kernel in solves(torch, cs):
        counter = torch.zeros((1,), dtype=torch.int32, device="cuda")
        x = fn(counter)
        torch.cuda.synchronize()
        counter.zero_()
        x = fn(counter)
        k = int(counter.item())
        us, seen = _device_us(torch, lambda: fn(counter), kernel)
        out[f"solve {label}"] = dict(us=us, launches_seen=seen, iters=k, x_sha=_digest(x))
    for name, make, steps in rollouts(cs):
        solver = make()
        shas = {}
        for k in range(1, steps[-1] + 1):
            solver.run(1)
            if k in steps:
                shas[k] = _digest(solver.state.x)
        rate = cs.rollout_rate(solver)
        out[f"path {name}"] = dict(step_ms=rate["step_ms"],
                                   admm_iters_per_s=rate["admm_iters_per_s"], x_sha=shas)
    print("PCG_TURNS " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    if not args.other:
        ap.error("name the other checkout")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    other = os.path.abspath(args.other)
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    readings = {"this": [], "other": []}
    for _ in range(args.rounds):
        for label, root in (("this", HERE), ("other", other), ("other", other), ("this", HERE)):
            env = dict(os.environ, PYTHONPATH=root)
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                                  cwd=root, env=env, capture_output=True, text=True)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("PCG_TURNS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(line[-1][len("PCG_TURNS "):])
            readings[label].append(got)
            for key, r in got.items():
                if key.startswith("solve "):
                    print(f"{label} {key}: {r['us']:.2f} us per solve ({r['iters']} trips or "
                          f"sweeps) [{gpu}]", flush=True)
                else:
                    print(f"{label} {key}: step {r['step_ms']:.4f} ms, "
                          f"{r['admm_iters_per_s']:.1f} ADMM iters/s [{gpu}]", flush=True)
    first = readings["other"][0]
    same = {key: all(r[key]["x_sha"] == first[key]["x_sha"]
                     for r in readings["this"] + readings["other"])
            for key in readings["this"][0] if key in first}
    for key, eq in same.items():
        what = "x" if key.startswith("solve ") else "x at the compared steps"
        print(f"{key}: {what} {'bitwise equal' if eq else 'DIFFER'} in the two checkouts",
              flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "pcg_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
