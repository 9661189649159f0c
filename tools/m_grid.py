#!/usr/bin/env python3
"""Time kernel M (csrc/uzawa.cu, Uzawa's Schur trip update) at each of its
grid sizes on one CUDA card, at the three Uzawa paths' states.

    python3 tools/m_grid.py [--reps 20]

At boxes_uzawa8's, floor_uzawa5k's and floor_uzawa67k's state
(chip_smoke.uzawa_state, float32, the first trip of a real solve: q2 from
the A^-1 apply of L's C^T d), M runs on copies of the trip's state reset
before each launch; each variant by queued CUDA events in turns with the
copies, behind a sleep kernel, one variant at a time (chip_smoke.queued_us,
less the copies' own queued time), and
by the latency-floor build (chip_smoke.floor_library, ADMM_M_FLOOR): M on
the wrapper's grid (ops/cuda_uzawa.m_blocks: a thread a row or an element
of x) and capped at 1, 2, 4, 8, 16 and 32 blocks. Every variant's outputs
are held bitwise to the plain twin's. Prints a line per state and variant
with the card's name and power limit, and writes m_grid.json into
chip_smoke.OUT_DIR.
"""

import argparse
import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = (1, 2, 4, 8, 16, 32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.collision import constraints as con
    from admm_elastic_tpu_torch.ops import cuda_uzawa as cu

    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    floor = cs.floor_library()
    out = {}
    for name in cs.UZAWA_PATHS:
        solver, b, x0, hits, y = cs.uzawa_state(torch, name)
        s, c = solver.m_settings, solver._contact
        n, h = b.shape[0], hits.capacity
        fi = np.finfo(np.float32)
        tol_c = max(fi.dtype.type(s.uzawa_tol), fi.dtype.type(64) * fi.eps)
        tiny, tol2 = float(fi.tiny), float(tol_c * tol_c)
        x = solver._uzawa_Ainv(b - cu.ct_apply(hits, c.ck, y, n, c.slot_of), x0, None)
        active = torch.cat([hits.p_mask, hits.d_mask])
        r = torch.where(active, torch.cat(con.C_apply(hits, c.ck, x))
                        - torch.cat(con.C_rhs(hits, c.ck)), 0.0)
        d = r.clone()
        done = torch.zeros((), dtype=torch.bool, device=b.device)
        k = torch.zeros((), dtype=torch.int32, device=b.device)
        q2 = solver._uzawa_Ainv(cu.ct_apply(hits, c.ck, d, n, c.slot_of), None, done)
        state = (x, y, r, d, k, done)
        want = cu.schur_trip_plain(hits, c.ck, q2, *state, tiny, tol2)
        copies = [t.clone() for t in state]

        def call(blocks, lib=None):
            for dst, src in zip(copies, state):
                dst.copy_(src)
            return cu.schur_trip(hits, c.ck, q2, *copies, tiny, tol2, lib=lib, blocks=blocks)

        copy = ("copy", lambda: [dst.copy_(src) for dst, src in zip(copies, state)])
        most = cu.max_blocks(b.device, b.dtype)
        res = {}
        for cap in (None,) + CAPS:
            label = "grid" if cap is None else f"grid of at most {cap}"
            got = call(cap)
            cs.need(all(bool(torch.equal(a, w)) for a, w in zip(got, want)),
                    f"M {name} {label}: not bit for bit its twin")
            # a variant at a time, so that the host's enqueue stays behind the
            # sleep kernel that heads the queue
            us = cs.queued_us(torch, [copy, ("m", functools.partial(call, cap)),
                                      ("floor", functools.partial(call, cap, floor))],
                              args.reps)
            blocks = cu.m_blocks(n, h, min(most, cap or most))
            res[label] = dict(us=us["m"] - us["copy"], floor_us=us["floor"] - us["copy"],
                              copy_us=us["copy"], blocks=blocks)
            print(f"M {name} ({2 * h} rows, {n} vertices) {label}: {res[label]['us']:.2f} us "
                  f"queued, latency floor {res[label]['floor_us']:.2f} us, "
                  f"{blocks} block(s) [{gpu}]", flush=True)
        out[name] = dict(rows=2 * h, vertices=n, variants=res)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "m_grid.json"), "w") as f:
        json.dump(dict(gpu=gpu, states=out), f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
