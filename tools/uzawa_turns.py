#!/usr/bin/env python3
"""Time Uzawa's paths, and kernels L (the trip's full C^T) and M (the trip's
update, csrc/uzawa.cu), in this checkout against another checkout of the
repository, in turns, on one CUDA card.

    python3 tools/uzawa_turns.py OTHER [--rounds 1] [--profile]

OTHER is the root of another checkout, for example the parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``. Each
checkout runs in a child process of its own, in the order this, other,
other, this (``rounds`` times), with its own chip_smoke.py, package and
kernel library. A child reads, float32, through that checkout's chip_smoke
helpers:

- boxes_uzawa8, floor_uzawa5k, floor_uzawa67k and, as the control without
  Uzawa, boxes_gs8 (PATHS): the captured step run to
  the golden's last step, a digest of x at each of its compared steps; the
  rate of the captured step (chip_smoke.rollout_rate); device operations and
  busy µs per ADMM iteration of one replayed step (chip_smoke.device_ops);
  with --profile the idle share of 5 replayed steps (torch.profiler: 1 - the
  device's busy time over the host's wall time);
- where the checkout has kernels L's full C^T and M (ops/cuda_uzawa.py): each
  at the three Uzawa paths' states (chip_smoke.schur_trip_times: queued CUDA
  events, torch.profiler, M's latency floor, the plain twins, the bounds,
  index_add_ beside L).

Prints one line per reading and child, whether the two checkouts' digests
agree (the Uzawa paths' x part by the order of the Schur dots, which this
checkout fixes; the control's must not), and the card's name and power
limit; writes uzawa_turns.json into chip_smoke.OUT_DIR. Exits 1 where the
control's digests differ.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("boxes_uzawa8", "floor_uzawa5k", "floor_uzawa67k", "boxes_gs8")
CONTROL = ("boxes_gs8",)  # no Schur trip: x must be bitwise the same in both checkouts


def _digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def idle_share(torch, solver, steps=5):
    """(idle share, device ops per ADMM iteration, busy µs per ADMM
    iteration) of `steps` replayed steps by torch.profiler: 1 - the device's
    busy time over the host's wall time around them."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solver.run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.run(steps)  # synchronizes before it returns
        wall_us = (time.perf_counter() - t0) * 1e6
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev)
    iters = steps * solver.m_settings.admm_iters
    return 1.0 - busy / wall_us, len(ev) / iters, busy / iters


def scene(cs, name):
    if name in cs.SELFCOLL_SCENES:
        return cs.boxes_scene(name, cs.torch_api())[0]
    return cs.contact_scene(name, cs.torch_api())


def child(root, profile):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    for name in PATHS:
        solver = scene(cs, name)
        steps = [int(k) for k in cs.golden(name)["steps"]]
        shas = {}
        for k in range(1, steps[-1] + 1):
            solver.run(1)
            if k in steps:
                shas[k] = _digest(solver.state.x)
        rate = cs.rollout_rate(solver)
        dev = cs.device_ops(torch, lambda: solver.run(1), solver.m_settings.admm_iters)
        r = dict(step_ms=rate["step_ms"], admm_iters_per_s=rate["admm_iters_per_s"], sha=shas,
                 ops_per_iter=dev["ops_per_iter"], busy_us_per_iter=dev["busy_us_per_iter"])
        if profile:
            r["idle_share"], r["profile_ops_per_iter"], r["profile_busy_us_per_iter"] = \
                idle_share(torch, solver)
        out[f"path {name}"] = r
        del solver
        torch.cuda.empty_cache()
    if hasattr(cs, "schur_trip_times"):
        _, timing = cs.schur_trip_checks(torch)
        gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
        for key, t in cs.schur_trip_times(torch, timing, gpu).items():
            out[f"kernel {key}"] = {k: v for k, v in t.items() if k not in ("bytes",)}
        del timing
    print("UZAWA_TURNS " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="also read each path's idle share over 5 replayed steps")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.profile)
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
            env = dict(os.environ, PYTHONPATH=root, TEARDOWN_CUPTI="0")
            cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
            proc = subprocess.run(cmd + (["--profile"] if args.profile else []), cwd=root,
                                  env=env, capture_output=True, text=True)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("UZAWA_TURNS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(line[-1][len("UZAWA_TURNS "):])
            readings[label].append(got)
            for key, r in got.items():
                if key.startswith("path "):
                    idle = ("" if "idle_share" not in r else
                            f", idle share {r['idle_share']:.3f}")
                    print(f"{label} {key}: {r['admm_iters_per_s']:.1f} ADMM iters/s (step "
                          f"{r['step_ms']:.4f} ms), {r['ops_per_iter']:.1f} device ops and "
                          f"{r['busy_us_per_iter']:.1f} busy us per iteration{idle} [{gpu}]",
                          flush=True)
                else:
                    prof = ("not measured" if r["profiler_ms"] is None
                            else f"{r['profiler_ms'] * 1e3:.2f} us")
                    floor = ("" if r.get("floor_ms") is None
                             else f", latency floor {r['floor_ms'] * 1e3:.2f} us")
                    lib = ("" if r["library_ms"] is None
                           else f", index_add_ {r['library_ms'] * 1e3:.2f} us")
                    print(f"{label} {key}: {r['ms'] * 1e3:.2f} us queued, {prof} by "
                          f"torch.profiler{floor}; plain {r['plain_ms'] * 1e3:.1f} us{lib}; "
                          f"bound {r['bound_ms'] * 1e3:.3f} us by {r['bound_by']} [{gpu}]",
                          flush=True)
    first = readings["other"][0]
    same = {}
    for key in readings["this"][0]:
        if key in first and "sha" in first[key]:
            shas = [r[key]["sha"] for r in readings["this"] + readings["other"]]
            same[key] = all(s == shas[0] for s in shas)
    for key, eq in same.items():
        note = "" if key[len("path "):] in CONTROL else " (Uzawa: the dots' order)"
        print(f"{key}: x {'bitwise equal' if eq else 'differs'} in the two checkouts{note}",
              flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "uzawa_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0 if all(same.get(f"path {p}", True) for p in CONTROL) else 1


if __name__ == "__main__":
    sys.exit(main())
