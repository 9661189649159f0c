#!/usr/bin/env python3
"""Time kernel G (csrc/pcg.cu) and the PCG paths of this checkout against
those of another checkout of the repository, in turns, on one CUDA card.

    python3 tools/pcg_turns.py OTHER [--rounds 1]

OTHER is the root of another checkout, for example a commit unpacked with
``git archive <commit> | tar -x -C build/other``. Each checkout runs in a
child process of its own, in the order this, other, other, this (``rounds``
times), with its own chip_smoke.py, package and kernel library. A child
builds each path of its chip_smoke.PCG_PATHS through chip_smoke.pcg_scene and
reads: kernel G's device time per solve on the path's first solve (the b and
x0 of chip_smoke.first_solve; torch.profiler, 20 launches) with its trips,
the rollout rate of the captured step (chip_smoke.rollout_rate, at
least 2 s), and a digest of G's first solve and of x after 8 steps of a
path built anew: the two checkouts' digests say whether they compute the
same bits. Prints one line per path and child, whether the digests agree,
and the card's name and power limit; writes pcg_turns.json into
chip_smoke.OUT_DIR.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t):
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def child(root):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_pcg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    for name in cs.PCG_PATHS:
        solver, _ = cs.pcg_scene(name, cs.torch_api())
        s = solver.m_settings
        b, x0 = cs.first_solve(torch, solver)
        trips = torch.zeros((1,), dtype=torch.int32, device="cuda")

        def kern():
            return cuda_pcg.pcg_solve(solver._solve_data, b, x0, s.pcg_tol, s.pcg_max_iters,
                                      trips)

        kern()
        torch.cuda.synchronize()
        trips.zero_()
        kern()
        k = int(trips.item())
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kern()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "pcg_kernel" in e.name]
        rate = cs.rollout_rate(solver)
        fresh, _ = cs.pcg_scene(name, cs.torch_api())
        b2, x2 = cs.first_solve(torch, fresh)
        xg = cuda_pcg.pcg_solve(fresh._solve_data, b2, x2, s.pcg_tol, s.pcg_max_iters, trips)
        fresh.run(8)
        out[name] = dict(g_us=sum(us) / max(len(us), 1), g_launches_seen=len(us), trips=k,
                         step_ms=rate["step_ms"], admm_iters_per_s=rate["admm_iters_per_s"],
                         g_x_sha=_digest(xg), x8_sha=_digest(fresh.state.x))
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
            for name, r in got.items():
                print(f"{label} {name}: G {r['g_us']:.2f} us per solve ({r['trips']} trips), "
                      f"step {r['step_ms']:.4f} ms, {r['admm_iters_per_s']:.1f} ADMM iters/s "
                      f"[{gpu}]", flush=True)
    same = {name: all(r[name][k] == readings["other"][0][name][k]
                      for r in readings["this"] + readings["other"] for k in ("g_x_sha", "x8_sha"))
            for name in readings["this"][0]}
    for name, eq in same.items():
        print(f"{name}: G's first solve and x after 8 steps {'bitwise equal' if eq else 'DIFFER'} "
              "in the two checkouts", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "pcg_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
