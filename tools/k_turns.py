#!/usr/bin/env python3
"""Time kernel K (csrc/self_collision.cu, the self-collision detection), and
the paths that run it, in this checkout against another checkout of the
repository, in turns, on one CUDA card.

    python3 tools/k_turns.py OTHER [--rounds 1]

OTHER is the root of another checkout, for example the parent commit
unpacked with ``git archive <commit> | tar -x -C build/parent``. Each
checkout runs in a child process of its own, in the order this, other,
other, this (``rounds`` times), with its own chip_smoke.py, package and
kernel library. A child reads, with that checkout's chip_smoke helpers,
float32:

- kernel K on boxes_gs8's golden state of step 9 (dense, two colliders),
  boxes_gs20's of step 12 (the broad phase) and the folded 8^3 block
  (chip_smoke.folded_case, dense), a detection as chip_smoke.k_detect makes
  it (over the collider table where the checkout builds one): the device
  µs a detection of K's kernels and of every other kernel in the window (the
  wrapper's PyTorch work) by torch.profiler, and the detection queued behind
  a sleep kernel by CUDA events (chip_smoke.queued_us); a digest of its rows
  and overflow flag;
- kernel L (csrc/dyn_rows.cuh) on boxes_gs8@9's rows, C^T y: device µs a
  launch by torch.profiler;
- every self-collision path's rollout (chip_smoke.SELFCOLL_PATHS, the
  captured step): a digest of x at each compared step of its golden, then
  the rate of the captured step (chip_smoke.rollout_rate).

Prints one line per reading and child, whether the two checkouts' digests
agree (the same bits), and the card's name and power limit; writes
k_turns.json into chip_smoke.OUT_DIR. Exits 1 where a digest differs.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

from k_anatomy import K_KERNELS, profile_split

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_STATES = (("boxes_gs8", 9), ("boxes_gs20", 12))


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _split(torch, fn):
    """(K's device µs a detection, its launches a detection, the other
    kernels' device µs a detection, their launches) of fn() by
    torch.profiler (k_anatomy.profile_split)."""
    split = profile_split(torch, fn, 20)
    k = [v for name, v in split.items() if name in K_KERNELS]
    o = [v for name, v in split.items() if name not in K_KERNELS]
    return (sum(v[0] for v in k), sum(v[1] for v in k), sum(v[0] for v in o),
            sum(v[1] for v in o))


def k_cases(torch, cs):
    """(label, colliders or their table, x, surf) of K's detections, float32."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    def cols_of(cols):
        cols = [c.to("cuda", torch.float32) for c in cols]
        return dyn.collider_table(cols) if hasattr(dyn, "collider_table") else cols

    out = []
    for name, step in K_STATES:
        solver, _ = cs.boxes_scene(name, cs.torch_api())
        x = torch.as_tensor(cs.golden(name)[f"x{step}"], device="cuda", dtype=torch.float32)
        c = solver._contact
        out.append((f"{name}@{step}", cols_of(c.colliders), x, c.surf))
    cols, x, surf = cs.folded_case(torch, cs.K_CASES_FOLD)
    out.append((f"folded{cs.K_CASES_FOLD}", cols_of(cols), x.to(torch.float32), surf))
    return out


def child(root):
    """Measure the checkout at root (run in a process of its own)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_dynamic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    out = {}
    for label, cols, x, surf in k_cases(torch, cs):
        def fn(cols=cols, x=x, surf=surf):
            return cs.k_detect(torch, cols, x, surf, plain=False)

        rows, flag = fn()
        torch.cuda.synchronize()
        k_us, k_n, o_us, o_n = _split(torch, fn)
        queued = cs.queued_us(torch, [("k", fn)], 10)["k"]
        out[f"K {label}"] = dict(us=k_us, launches=k_n, other_us=o_us, other_launches=o_n,
                                 queued_us=queued, hits=int(rows[0].sum().item()),
                                 sha=_digest(*rows, flag))
        if label.startswith("boxes_gs8"):
            hits = cs.rows_hits(torch, rows, surf, x.shape[0])
            base = torch.zeros_like(x)
            ck = torch.tensor(2.5, device="cuda", dtype=x.dtype)
            yd = torch.ones((hits.capacity,), device="cuda", dtype=x.dtype)
            l_us = cs.g_device_us(torch, lambda: cuda_dynamic.dyn_gather(
                hits, base, con.CT, ck, yd), 20, kernel="dyn_gather_kernel")
            out[f"L {label}"] = dict(us=l_us, entries=int(hits.d_start[-1].item()))
    for name in cs.SELFCOLL_PATHS:
        solver, _ = cs.boxes_scene(name, cs.torch_api())
        steps = [int(k) for k in cs.golden(name)["steps"]]
        shas = {}
        for k in range(1, steps[-1] + 1):
            solver.run(1)
            if k in steps:
                shas[k] = _digest(solver.state.x)
        rate = cs.rollout_rate(solver)
        out[f"path {name}"] = dict(step_ms=rate["step_ms"],
                                   admm_iters_per_s=rate["admm_iters_per_s"], sha=shas)
    print("K_TURNS " + json.dumps(out), flush=True)


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
            line = [ln for ln in proc.stdout.splitlines() if ln.startswith("K_TURNS ")]
            if proc.returncode != 0 or not line:
                print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
                return 1
            got = json.loads(line[-1][len("K_TURNS "):])
            readings[label].append(got)
            for key, r in got.items():
                if key.startswith("path "):
                    print(f"{label} {key}: step {r['step_ms']:.4f} ms, "
                          f"{r['admm_iters_per_s']:.1f} ADMM iters/s [{gpu}]", flush=True)
                elif key.startswith("K "):
                    print(f"{label} {key}: K {r['us']:.2f} us a detection by torch.profiler "
                          f"({r['launches']:g} launches), the wrapper's PyTorch work "
                          f"{r['other_us']:.2f} us ({r['other_launches']:g} launches), queued "
                          f"{r['queued_us']:.2f} us; {r['hits']} hits [{gpu}]", flush=True)
                else:
                    us = "not measured" if r["us"] is None else f"{r['us']:.2f} us"
                    print(f"{label} {key}: {us} a launch by torch.profiler, {r['entries']} "
                          f"entries [{gpu}]", flush=True)
    first = readings["other"][0]
    same = {key: all(r[key]["sha"] == first[key]["sha"]
                     for r in readings["this"] + readings["other"])
            for key in readings["this"][0] if key in first and "sha" in first[key]}
    for key, eq in same.items():
        print(f"{key}: {'bitwise equal' if eq else 'DIFFER'} in the two checkouts", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "k_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=other, readings=readings, bitwise=same), f, indent=1)
    print(gpu)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
