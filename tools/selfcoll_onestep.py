#!/usr/bin/env python3
"""One step of the stacked boxes from the JAX package's own state, in both
packages, beside the JAX package's one-ulp control; on the CPU.

    JAX_PLATFORMS=cpu python3 tools/selfcoll_onestep.py LINSOLVER DTYPE [--steps 14]
                                                      [--svd jacobi|auto]

LINSOLVER is 1 (Gauss-Seidel), 2 (Uzawa) or 4 (AL-PCG), DTYPE f32 or f64. The
scene is tests/test_torch_selfcollision_paths.py's (two 3x3x3 boxes and a
floor, each box its own collider). The JAX package steps on its own; before
each of its steps the port takes its state (x, v, y, prev_active) and steps
once, and a second JAX solver steps once from the same state with x one ulp
up (np.nextafter). Prints per step the gap of each to the JAX package's x
(relative to max |x|), the inner iterations of the three, and the dynamic
hits each detects at its own state. --svd sets the JAX package's SVD
(set_svd_impl): "jacobi" (the default here) is the port's local-step body,
"auto" LAPACK on the CPU.

Where the port's gap is of the size of the control's, the port parts from the
JAX package no further than the JAX package parts from itself.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from admm_elastic_tpu.ops import prox as jprox  # noqa: E402
from test_torch_selfcollision_paths import (jax_hits, port_hits, stack_scene,  # noqa: E402
                                            take_jax_state)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("linsolver", type=int, choices=(1, 2, 4))
    ap.add_argument("dtype", choices=("f32", "f64"))
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--svd", choices=("jacobi", "auto"), default="jacobi")
    args = ap.parse_args()
    jprox.set_svd_impl(args.svd)
    dt = np.float64 if args.dtype == "f64" else np.float32
    js, ts, jc = (stack_scene(args.linsolver, dt, True), stack_scene(args.linsolver, dt, False),
                  stack_scene(args.linsolver, dt, True))
    print(f"linsolver {args.linsolver}, {args.dtype}, SVD {args.svd}: step, the port's one-step "
          "gap, the one-ulp control's, inner iterations (JAX, port, control), dynamic hits")
    for k in range(1, args.steps + 1):
        st = js.state
        take_jax_state(ts, js)
        xu = np.asarray(st.x)
        jc.state = dataclasses.replace(st, x=jnp.asarray(np.nextafter(xu, np.inf, dtype=xu.dtype)))
        for s in (js, ts, jc):
            s.step()
        xj = np.asarray(js.x, np.float64)
        m = np.abs(xj).max()
        port = np.abs(xj - ts.x).max() / m
        ctl = np.abs(xj - np.asarray(jc.x, np.float64)).max() / m
        inner = [s.runtime_data().inner_iters for s in (js, ts, jc)]
        hits = [jax_hits(js, js.state.x), port_hits(ts, ts.state.x), jax_hits(jc, jc.state.x)]
        print(f"{k:3d}  port {port:.3e}  control {ctl:.3e}  inner {inner}  hits {hits}",
              flush=True)


if __name__ == "__main__":
    main()
