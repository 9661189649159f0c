#!/usr/bin/env python3
"""The most near lanes a mesh obstacle's detection sees on a path.

    python3 tools/mesh_near_lanes.py [--steps N] [--threads T] [name ...]

Run from the root of a checkout; needs no card and no JAX. Drives each named
scene of chip_smoke.CONTACT_SCENES (default: the mesh paths of the card,
chip_smoke.MESH_PATHS) on the port's CPU path for its steps (or N) and
records, for every detection of its mesh obstacle, how many lanes are near
(the lanes that near-lane compaction evaluates: SDF cell minimum < 0, or an
exact cell in the grid and tet-occupied). Under Gauss-Seidel a detection is one colour's pass over its
padded slots; the real slots are counted apart from the padding (row n at
the colour's tail). Prints one JSON line per scene: the largest counts over
the run beside near_lanes and the lanes of a detection, the detections
that overflowed, and the steps whose collision_overflow was set. A compaction that never overflows has
max_near (real) < near_lanes.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from admm_elastic_tpu_torch.collision import passive  # noqa: E402


def near_mask(obs, x):
    """The near lanes of obs at x [V, 3]."""
    p = x.reshape(-1, 3)
    if isinstance(obs, passive.PassiveMeshSDF):
        base, _ = obs.cells(p)
        return obs.minv[base] < 0
    cid, in_grid = obs.cells(p)
    return in_grid & (obs.tet_count[cid] > 0)


def measure(name, steps):
    solver = cs.contact_scene(name, cs.torch_api("cpu"))
    obs = [o for o in solver._contact.obstacles if isinstance(o, passive.MESH)][0]
    gs = solver.m_settings.linsolver == 1
    real = None
    if gs:
        real = solver._solve_data.colors_mask.sum(dim=1).tolist()
        n_colors = len(real)
    rec = dict(calls=0, max_near_real=0, max_near_all=0, overflow_calls=0, lanes=0)
    cls = type(obs)
    orig = cls.signed_distance_with_overflow

    def wrapped(self, x):
        out = orig(self, x)
        near = near_mask(self, x)
        k = rec["calls"]
        n_real = real[k % n_colors] if gs else near.shape[0]
        rec["calls"] += 1
        rec["lanes"] = int(near.shape[0])
        rec["max_near_real"] = max(rec["max_near_real"], int(near[:n_real].sum()))
        rec["max_near_all"] = max(rec["max_near_all"], int(near.sum()))
        rec["overflow_calls"] += int(bool(out[3]))
        return out

    cls.signed_distance_with_overflow = wrapped
    try:
        overflow_steps = []
        for step in range(steps):
            solver.step()
            if solver.runtime_data().collision_overflow:
                overflow_steps.append(step + 1)
    finally:
        cls.signed_distance_with_overflow = orig
    rec.update(scene=name, steps=steps, near_lanes=obs.near_lanes,
               solver_overflow_steps=overflow_steps,
               min_y=float(np.asarray(solver.x)[:, 1].min()),
               gs_colour_widths=None if not gs else [int(solver._solve_data.colors.shape[1])] + real)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cs.DEVICE = "cpu"
    for name in args.names or cs.MESH_PATHS:
        steps = args.steps or cs.contact_steps(name)[0]
        print(json.dumps(measure(name, steps)), flush=True)


if __name__ == "__main__":
    main()
