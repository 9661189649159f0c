#!/usr/bin/env python3
"""Time kernel J (csrc/obstacle.cu), kernel H (csrc/gs.cu) and the paths that
run them, in this checkout against another checkout of the repository, in
turns, on one CUDA card.

    python3 tools/j_turns.py OTHER [--rounds 1]

OTHER is the root of another checkout, for example the parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``. Each
checkout runs in a child process of its own, in the order this, other,
other, this (``rounds`` times), with its own chip_smoke.py, package and
kernel library. A child reads, with that checkout's chip_smoke helpers:

- kernel J on slab_exact_alpcg67k's golden states of steps 1 and 12
  (chip_smoke.J_STEPS), compacted as the path runs it (near_lanes 2,048)
  and dense (near_lanes 0), float32: the device µs per launch by
  torch.profiler (20 launches; the records it kept beside them) and by
  queued CUDA events (chip_smoke.queued_us), and a digest of the outputs;
- kernel H on the first solve of each GS path (H_PATHS: the landed state of
  chip_smoke.landed_solver, the deep scene's first step), no pins: µs per
  solve by torch.profiler and by queued CUDA events, its sweeps, a digest of
  its x;
- in a checkout whose wrappers take them, the variants of this one in turns
  (queued CUDA events): H's exact walk at every group size
  (chip_smoke.h_variants), J on grids capped at one and at half a block an
  SM;
- every path's rollout (ROLLOUTS): a digest of x at each compared step of
  its golden, then the rate of the captured step (chip_smoke.rollout_rate).

Prints one line per reading and child, whether the two checkouts' digests
agree (the same bits), and the card's name and power limit; writes
j_turns.json into chip_smoke.OUT_DIR. Exits 1 where a digest differs.
"""

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H_PATHS = ("slab_exact_gs5k", "slab_sdf_gs5k", "exactmesh_deep_gs", "floor_gs5k", "sphere_gs")
ROLLOUTS = H_PATHS + ("slab_exact_alpcg67k",)
J_PATH = "slab_exact_alpcg67k"


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _device_us(torch, fn, kernel, reps=20):
    """(device µs per launch, records kept) of the kernel named by fn()
    (torch.profiler over reps launches; a window with records missing is
    taken again, three at most, and the mean of those kept reported)."""
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


def j_cases(torch, cs):
    """(label, obstacle, x) of J's detections, float32, on the card."""
    import dataclasses

    exact = cs.mesh_obstacle(cs.CONTACT_SCENES[J_PATH]["obstacle"], cs.torch_api())
    out = []
    for k in cs.J_STEPS:
        x = torch.as_tensor(cs.golden(J_PATH)[f"x{k}"], dtype=torch.float32, device="cuda")
        for tag, obs in (("", exact), (" dense", dataclasses.replace(exact, near_lanes=0))):
            out.append((f"{J_PATH}@{k}{tag}", obs.to("cuda", torch.float32), x))
    return out


def h_calls(torch, cs):
    """(label, fn(counter) -> x, solver's obstacles) of H's first solves."""
    from admm_elastic_tpu_torch.ops import cuda_gs

    out = []
    for name in H_PATHS:
        solver = (cs.contact_scene(name, cs.torch_api()) if name == "exactmesh_deep_gs"
                  else cs.landed_solver(torch, name))
        b, x0 = cs.first_solve(torch, solver)
        s, data = solver.m_settings, solver._solve_data
        no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device="cuda")
        obs, params = list(solver._contact.obstacles), solver._contact.gs_params

        def solve(c, data=data, b=b, x0=x0, no_pin=no_pin, obs=obs, params=params, s=s, **kw):
            return cuda_gs.gs_solve(data, b, x0, no_pin, x0, obs, s.gs_omega, s.gs_max_iters,
                                    s.gs_tol, c, params=params, **kw)

        out.append((name, solve, obs))
    return out


def child(root):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_gs, cuda_obstacle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    ovf = torch.zeros((1,), dtype=torch.int32, device="cuda")
    grids = "blocks" in inspect.signature(cuda_obstacle.mesh_detect).parameters
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, obs, x in j_cases(torch, cs):
        def fn(obs=obs, x=x, **kw):
            return cuda_obstacle.mesh_detect(obs, x, ovf, **kw)

        res = fn()
        torch.cuda.synchronize()
        us, seen = _device_us(torch, fn, "mesh_detect_kernel")
        queued = cs.queued_us(torch, [("k", fn)], 10)["k"]
        out[f"J {label}"] = dict(us=us, records=seen, queued_us=queued, sha=_digest(*res))
        if grids:
            calls = [("chosen", fn)] + [(f"{nb} blocks", lambda nb=nb: fn(blocks=nb))
                                        for nb in (sms, sms // 2)]
            out[f"J {label} grids"] = cs.queued_us(torch, calls + calls[::-1], 10)
    for name, solve, obs in h_calls(torch, cs):
        counter = torch.zeros((1,), dtype=torch.int32, device="cuda")
        solve(counter)
        torch.cuda.synchronize()
        counter.zero_()
        x = solve(counter)
        k = int(counter.item())
        us, seen = _device_us(torch, lambda: solve(counter), "gs_kernel")
        queued = cs.queued_us(torch, [("k", lambda: solve(counter))], 10)["k"]
        out[f"H {name}"] = dict(us=us, records=seen, queued_us=queued, sweeps=k, sha=_digest(x))
        if "group" in inspect.signature(cuda_gs.gs_solve).parameters and any(
                cs.is_exact(o) for o in obs):
            calls = [(label, lambda kw=kw: solve(counter, **kw)) for label, kw in cs.h_variants()]
            out[f"H {name} variants"] = cs.queued_us(torch, calls + calls[::-1], 5)
    for name in ROLLOUTS:
        solver = cs.contact_scene(name, cs.torch_api())
        steps = [int(k) for k in cs.golden(name)["steps"]]
        shas = {}
        for k in range(1, steps[-1] + 1):
            solver.run(1)
            if k in steps:
                shas[k] = _digest(solver.state.x)
        rate = cs.rollout_rate(solver)
        out[f"path {name}"] = dict(step_ms=rate["step_ms"],
                                   admm_iters_per_s=rate["admm_iters_per_s"], sha=shas)
    print("J_TURNS " + json.dumps(out), flush=True)


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
            env = dict(os.environ, PYTHONPATH=root, TEARDOWN_CUPTI="0")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                                  cwd=root, env=env, capture_output=True, text=True)
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("J_TURNS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(line[-1][len("J_TURNS "):])
            readings[label].append(got)
            for key, r in got.items():
                if key.startswith("path "):
                    print(f"{label} {key}: step {r['step_ms']:.4f} ms, "
                          f"{r['admm_iters_per_s']:.1f} ADMM iters/s [{gpu}]", flush=True)
                elif "sha" in r:
                    print(f"{label} {key}: {r['us']:.2f} us a launch by torch.profiler "
                          f"({r['records']} of 20 records), {r['queued_us']:.2f} by queued "
                          f"events{'' if 'sweeps' not in r else ', %d sweeps' % r['sweeps']} "
                          f"[{gpu}]", flush=True)
                else:
                    print(f"{label} {key} by queued events: "
                          + "; ".join(f"{k} {v:.2f} us" for k, v in r.items()) + f" [{gpu}]",
                          flush=True)
    first = readings["other"][0]
    same = {key: all(r[key]["sha"] == first[key]["sha"]
                     for r in readings["this"] + readings["other"])
            for key in readings["this"][0] if key in first and "sha" in first[key]}
    for key, eq in same.items():
        print(f"{key}: {'bitwise equal' if eq else 'DIFFER'} in the two checkouts", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "j_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
