#!/usr/bin/env python3
"""Time kernel I (csrc/wind_seq.cu, the sequential wind) and the path that
runs it, in this checkout against another checkout of the repository, in
turns, on one CUDA card.

    python3 tools/i_turns.py OTHER [--rounds 1]

OTHER is the root of another checkout, for example the parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``. Each
checkout runs in a child process of its own, in the order this, other,
other, this (``rounds`` times), with its own chip_smoke.py, package and
kernel library. A child reads, with that checkout's helpers:

- kernel I through its wrapper (ops/cuda_wind.wind_seq, with the
  triangles' level schedule where the wrapper takes one) on the lists of
  lists(): the 40x40 and 160x160 sheets of chip_smoke.cloth_sheet, the
  160x160 sheet's triangles shuffled, a fan of 200 triangles on one vertex
  and the 4x4 sheet with two triangles of a repeated vertex, float32 and
  float64 (positions jittered, small velocities, seeded here, the same in
  both checkouts): device µs per launch by queued CUDA events
  (chip_smoke.queued_us) and a digest of the output;
- cloth_wind40_seq (chip_smoke.WIND_SEQ_PATH) through the captured step: a
  digest of x after each compared step of its golden (1 and 8), the rate of
  the captured step (chip_smoke.rollout_rate) and its replay's device time
  by CUDA events over 200 replays.

Prints one line per reading and child, whether the two checkouts' digests
agree (the same bits), and the card's name and power limit; writes
i_turns.json into chip_smoke.OUT_DIR. Exits 1 where a digest differs.
"""

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA, DT = 1000.0, 1.0 / 24.0
WIND = (0.05, 0.1, 0.02)


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lists(cs):
    """[(label, vertices [N, 3], triangles [W, 3])] of the timed lists."""
    out = []
    for nx in (40, 160):
        verts, tris, _, _ = cs.cloth_sheet(nx, nx)
        out.append((f"sheet{nx}", verts, tris))
    out.append(("shuffled160", verts, tris[np.random.default_rng(7).permutation(len(tris))]))
    k = 200
    ang = np.linspace(0.0, 2.0 * np.pi, k + 1)
    ring = np.stack([np.cos(ang), np.zeros(k + 1), np.sin(ang)], axis=1)
    out.append((f"fan{k}", np.concatenate([np.zeros((1, 3)), ring]),
                np.stack([np.zeros(k, np.int64), np.arange(1, k + 1), np.arange(2, k + 2)], 1)))
    verts, tris, _, _ = cs.cloth_sheet(4, 4)
    out.append(("repeated", verts, np.insert(tris, [10, 20], [[3, 3, 7], [5, 9, 9]], axis=0)))
    return out


def child(root):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_wind

    cs.DEVICE = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    scheduled = "schedule" in inspect.signature(cuda_wind.wind_seq).parameters
    out = {}
    for label, verts, tris_np in lists(cs):
        rng = np.random.default_rng(len(tris_np))
        x_np = verts + 0.05 * rng.standard_normal(verts.shape)
        v_np = 0.01 * rng.standard_normal(verts.shape)
        tris = torch.as_tensor(tris_np, device="cuda")
        extra = (cuda_wind.bake_schedule(tris, tris.device),) if scheduled else ()
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            t = dict(dtype=dtype, device="cuda")
            x, v = torch.as_tensor(x_np, **t), torch.as_tensor(v_np, **t)
            d = torch.tensor(WIND, **t)

            def call(x=x, v=v, d=d):
                return cuda_wind.wind_seq(tris, d, ALPHA, DT, x, v, *extra)

            got = call()
            torch.cuda.synchronize()
            us = cs.queued_us(torch, [("k", call)], 3)["k"]
            out[f"I {label} {dname}"] = dict(us=us, triangles=len(tris_np), sha=_digest(got))
    solver = cs.make_cloth_solver(cs.WIND_SEQ_PATH)[0]
    steps = [int(k) for k in cs.golden(cs.WIND_SEQ_PATH)["steps"]]
    shas = {}
    for k in range(1, steps[-1] + 1):
        solver.run(1)
        if k in steps:
            shas[k] = _digest(solver.state.x)
    rate = cs.rollout_rate(solver)
    step_us = cs.events_ms(torch, solver._graph.graph.replay, 200) * 1e3
    out[f"path {cs.WIND_SEQ_PATH}"] = dict(step_ms=rate["step_ms"], step_us=step_us,
                                           admm_iters_per_s=rate["admm_iters_per_s"], sha=shas)
    print("I_TURNS " + json.dumps(out), flush=True)


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
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("I_TURNS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(line[-1][len("I_TURNS "):])
            readings[label].append(got)
            for key, r in got.items():
                if key.startswith("path "):
                    print(f"{label} {key}: step {r['step_ms']:.4f} ms, {r['step_us']:.1f} us a "
                          f"replay, {r['admm_iters_per_s']:.1f} ADMM iters/s [{gpu}]", flush=True)
                else:
                    print(f"{label} {key}: {r['us']:.2f} us a launch by queued events "
                          f"({r['triangles']} triangles) [{gpu}]", flush=True)
    first = readings["other"][0]
    same = {key: all(r[key]["sha"] == first[key]["sha"]
                     for r in readings["this"] + readings["other"])
            for key in readings["this"][0] if key in first}
    for key, eq in same.items():
        print(f"{key}: {'bitwise equal' if eq else 'DIFFER'} in the two checkouts", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "i_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
