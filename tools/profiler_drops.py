#!/usr/bin/env python3
"""Does torch.profiler drop kernel records of a graph replay after kernel G's
CLUSTER form was captured into a CUDA graph in the same process?

    python3 tools/profiler_drops.py [--windows 10]

Run from the root of a checkout, on one CUDA card. Each condition runs in a
fresh process of its own: a prelude, then chip_smoke's counted window of the
unpinned bench beam (beam_free: two replays of its captured step, 20
launches each of two kernels and 40 of a third, counted on the device by
torch.profiler) taken --windows times from the same state, with no retake.
Preludes, on the first solves of the beam at the CLUSTER form's largest N
(chip_smoke.G_EDGE_SCENES, Jacobi and two-grid):

- none: G launched eagerly in both forms, nothing captured;
- grid: G's GRID form captured into a graph and replayed, on both solves;
- cluster: the same with the CLUSTER form;
- cluster x10: the CLUSTER captures ten times over;
- windows: no capture, then 30 profiler windows of G's eager launches (as
  chip_smoke.pcg_times takes them);
- cluster + windows: the CLUSTER captures, then those 30 windows.

Prints one line per condition with the card's name and power limit, and
writes profiler_drops.json into chip_smoke.OUT_DIR.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CONDITIONS = {  # label -> (form captured or None, captures of each solve, profiler windows)
    "none": (None, 0, 0),
    "grid": ("grid", 1, 0),
    "cluster": ("cluster", 1, 0),
    "cluster x10": ("cluster", 10, 0),
    "windows": (None, 0, 30),
    "cluster + windows": ("cluster", 1, 30),
}


def child(label, windows):
    """One condition in this process: its prelude, then the windows."""
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    form, captures, prof_windows = CONDITIONS[label]
    solver, _ = cs.pcg_scene("beam_g_edge_inside", cs.torch_api(), cs.G_EDGE_SCENES)
    s = solver.m_settings
    b, x0 = cs.first_solve(torch, solver)
    graphs = []  # kept alive, as chip_smoke's checks keep theirs until they return
    for pre in ("jacobi", "twogrid"):
        data = pcg.prepare(solver.system, torch.float32, precond=pre)
        want = {f: cuda_pcg.pcg_solve(data, b, x0, s.pcg_tol, s.pcg_max_iters, None, form=f)
                for f in ("grid", "cluster")}
        cs.need(torch.equal(want["grid"], want["cluster"]), f"{pre}: the forms differ")
        for _ in range(captures):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                xc = cuda_pcg.pcg_solve(data, b, x0, s.pcg_tol, s.pcg_max_iters, None, form=form)
            g.replay()
            torch.cuda.synchronize()
            cs.need(torch.equal(xc, want[form]), f"{pre}: the replay differs")
            graphs.append(g)
        for _ in range(prof_windows // 2):
            cs.g_device_us(torch, lambda: cuda_pcg.pcg_solve(data, b, x0, s.pcg_tol,
                                                              s.pcg_max_iters, None), 5)
    beam, _, g, _ = cs.make_solver(cs.NH, pinned=False)
    iters = int(g["steps"][-1]) * int(g["admm_iters"])
    expect = {f"local_step_tet_stencil[{cs.NH}]": iters, "tet_Dx_rows": iters,
              "tet_rhs_rows": 2 * iters}
    beam.run(0)
    state0 = beam.state.clone()

    def steps():
        for _ in range(int(g["steps"][-1])):
            beam.run(1)

    counts = []
    for _ in range(windows):
        beam.state = state0.clone()
        got = cs.device_launches(torch, steps, cs.NH)
        counts.append({k: got.get(k, 0) for k in expect})
    short = [c for c in counts if c != expect]
    return dict(expect=expect, windows=counts, short_windows=len(short),
                records_lost=sum(expect[k] - c[k] for c in short for k in expect))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--condition", choices=tuple(CONDITIONS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA card", file=sys.stderr)
        return 2
    if args.condition:
        print(json.dumps(child(args.condition, args.windows)))
        return 0
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    out = dict(gpu=gpu, conditions={})
    for label in CONDITIONS:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--condition", label,
                            "--windows", str(args.windows)], cwd=HERE, capture_output=True,
                           text=True, timeout=600)
        if r.returncode != 0:
            print(f"{label}: exited with {r.returncode}: {r.stderr[-2000:]}", flush=True)
            out["conditions"][label] = dict(rc=r.returncode)
            continue
        res = json.loads(r.stdout.strip().splitlines()[-1])
        out["conditions"][label] = res
        print(f"{label}: {res['short_windows']} of {args.windows} windows short, "
              f"{res['records_lost']} kernel records lost; "
              + " ".join(str(sum(c.values())) for c in res["windows"])
              + f" of {sum(res['expect'].values())} a window [{gpu}]", flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "profiler_drops.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
