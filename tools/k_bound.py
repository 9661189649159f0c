#!/usr/bin/env python3
"""Kernel K's bound on tests/test_broadphase.py's folded block (the 8^3 block
folded onto itself, dense, one collider; chip_smoke.folded_case), float32,
from its shapes: the bytes and operations of chip_smoke.k_bytes_ops, the hits
from K's plain twin on the CPU.

    JAX_PLATFORMS=cpu python3 tools/k_bound.py [n]

Prints the bytes, the operations, the pair tests, the hits and the bound (the
larger of the bytes over chip_smoke.PEAK_BYTES_PER_S and the operations over
chip_smoke.PEAK_F32_FLOPS) in µs. Needs no card.
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    n = int(sys.argv[1]) if len(sys.argv) > 1 else cs.K_CASES_FOLD
    cs.DEVICE = "cpu"
    cols, x, surf = cs.folded_case(torch, n)
    cols = [c.to("cpu", torch.float32) for c in cols]
    x = x.to(torch.float32)
    rows, _ = cs.k_detect(torch, cols, x, surf, plain=True)
    hits = int(rows[0].sum())
    nbytes, ops, pairs = cs.k_bytes_ops(cols, x, surf, hits)
    bound_ms, by = cs.bound_of(nbytes, ops)
    print(f"K folded {n}^3 block, float32: {nbytes} bytes, {ops} operations ({pairs} pair "
          f"tests, {hits} hits x {int(cols[0].faces.shape[0])} faces); bound "
          f"{bound_ms * 1e3:.3f} us by {by}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
