#!/usr/bin/env python3
"""Time kernel H on floor_gs5k's first solve in several checkouts, in turns,
on one CUDA card.

    python3 tools/h_turns.py DIR [DIR ...]

Each DIR is the root of a checkout of the repository (this one is "."; the
parent commit unpacked with ``git archive <commit> | tar -x -C build/other``,
or a copy with one change under test). The checkouts run in the order given
and then in the reverse order, each in a child process of its own with its own
chip_smoke.py, package and kernel library: the landed floor_gs5k solver
(chip_smoke.landed_solver), its next first solve (chip_smoke.first_solve),
and kernel H's device time per solve by torch.profiler over 20 launches
(chip_smoke.g_device_us) and by CUDA events over 50 (chip_smoke.events_ms).
Prints one line per child, and the card's name and power limit.
"""

import json
import os
import subprocess
import sys

os.environ["TEARDOWN_CUPTI"] = "0"  # as chip_smoke.main sets it


def child(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_gs

    solver = cs.landed_solver(torch, "floor_gs5k")
    b, x0 = cs.first_solve(torch, solver)
    s, data = solver.m_settings, solver._solve_data
    no_pin = torch.zeros((x0.shape[0],), dtype=torch.bool, device=x0.device)
    sweeps = torch.zeros((1,), dtype=torch.int32, device=x0.device)
    obstacles, params = list(solver._contact.obstacles), solver._contact.gs_params

    def solve():
        return cuda_gs.gs_solve(data, b, x0, no_pin, x0, obstacles, s.gs_omega, s.gs_max_iters,
                                s.gs_tol, sweeps, params=params)

    prof_us = cs.g_device_us(torch, solve, 20, kernel="gs_kernel")
    events_us = cs.events_ms(torch, solve, 50) * 1e3
    print(json.dumps(dict(checkout=root, profiler_us=prof_us, events_us=events_us)), flush=True)


def main():
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
        return 0
    roots = sys.argv[1:]
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else f"{root}: exit {proc.returncode} {proc.stderr[-800:]}",
              flush=True)
        if proc.returncode != 0:
            return proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
