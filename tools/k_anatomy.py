#!/usr/bin/env python3
"""Split a detection of kernel K (csrc/self_collision.cu, self-collision
detection) into its phases, on one CUDA card.

    python3 tools/k_anatomy.py [--root CHECKOUT] [--reps 20]

CHECKOUT is the root of a checkout of the repository (this one where not
named; for example the parent commit unpacked with ``git archive <commit> |
tar -x -C build/parent``): its package, chip_smoke.py and kernel library are
the ones measured. For boxes_gs8 at its golden's step 9 (dense: 772 queries
against 2,560 tets a box, two colliders) and boxes_gs20 at step 12 (the
broad phase: 4,804 queries, 40,000 tets a box), float32, a detection is
chip_smoke.k_detect over both colliders as the solver makes it (from
zeroed rows), and:

- by torch.profiler, over ``reps`` detections: the device µs a detection of
  each of K's kernels by name (dyn_frames_kernel, dyn_query_kernel,
  dyn_rank_kernel, dyn_face_kernel), their launches a detection, and the
  device µs and launches of every other kernel in the window (PyTorch's:
  the rows' zeros, the broad phase's key sort and, where the checkout's
  wrapper builds it, the candidate tensor);
- by CUDA events: the detection queued behind a sleep kernel
  (chip_smoke.queued_us, few enough detections that the sleep outlasts the
  host's enqueue); where the checkout's self_collision.cu takes
  ``ADMM_K_PHASES`` (launch its first n phases only), the same detection
  in the variant libraries of n = 1, 2, 3, so that each phase's time is the
  difference of two readings.

Prints one line per state and reading with the card's name and power limit,
and writes k_anatomy.json into chiprun_out/ beside this script's checkout.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_KERNELS = ("dyn_frames_kernel", "dyn_query_kernel", "dyn_rank_kernel", "dyn_face_kernel")
STATES = (("boxes_gs8", 9), ("boxes_gs20", 12))


def detection(torch, cs, name, step):
    """(label, fn) of one detection at the golden state, float32, by the
    checkout's own k_detect: over the collider table where its dynamic
    module builds one (made here once, as the solver makes it at
    initialize), else over the colliders one call each."""
    from admm_elastic_tpu_torch.collision import dynamic as dyn

    solver, _ = cs.boxes_scene(name, cs.torch_api())
    c = solver._contact
    x = torch.as_tensor(cs.golden(name)[f"x{step}"], device="cuda", dtype=torch.float32)
    cols = c.table if hasattr(dyn, "ColliderTable") else list(c.colliders)
    return f"{name}@{step}", (lambda: cs.k_detect(torch, cols, x, c.surf, plain=False))


def profile_split(torch, fn, reps):
    """{kernel name: (device µs a detection, launches a detection)} over
    reps detections by torch.profiler, K's kernels by name and the rest
    under their own names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in K_KERNELS if k in e.name), None) or e.name[:80]
        us, n = out.get(name, (0.0, 0))
        out[name] = (us + e.time_range.elapsed_us(), n + 1)
    return {k: (us / reps, n / reps) for k, (us, n) in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    os.environ["TEARDOWN_CUPTI"] = "0"
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("k_anatomy: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    src = open(os.path.join(root, "admm_elastic_tpu_torch", "csrc", "self_collision.cu")).read()
    unit = (("self_collision.cu", None),)
    full = _build.library()
    variants = ({f"phases 1-{n}": _build.variant(unit, (f"-DADMM_K_PHASES={n}",))
                 for n in (1, 2, 3)} if "ADMM_K_PHASES" in src else {})
    out = dict(gpu=gpu, root=root, states={})
    for name, step in STATES:
        label, fn = detection(torch, cs, name, step)
        split = profile_split(torch, fn, args.reps)
        k_us = sum(split.get(k, (0.0, 0))[0] for k in K_KERNELS)
        other = {k: v for k, v in split.items() if k not in K_KERNELS}
        calls = [("full", fn)]
        for name_v, lib in variants.items():
            def with_lib(lib=lib):
                _build._lib = lib
                try:
                    return fn()
                finally:
                    _build._lib = full
            calls.append((name_v, with_lib))
        queued = cs.queued_us(torch, calls + calls[::-1], 1)
        out["states"][label] = dict(profiler=split, k_us=k_us, queued_us=queued)
        for k in K_KERNELS:
            us, n = split.get(k, (0.0, 0))
            print(f"{label} {k}: {us:.2f} us a detection, {n:g} launches [{gpu}]", flush=True)
        print(f"{label} K's kernels: {k_us:.2f} us a detection; other kernels "
              f"{sum(v[0] for v in other.values()):.2f} us in "
              f"{sum(v[1] for v in other.values()):g} launches: "
              + "; ".join(f"{k} {v[0]:.2f} us x{v[1]:g}" for k, v in
                          sorted(other.items(), key=lambda kv: -kv[1][0])[:6])
              + f" [{gpu}]", flush=True)
        print(f"{label} queued CUDA events: "
              + "; ".join(f"{k} {v:.2f} us" for k, v in queued.items()) + f" [{gpu}]",
              flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "k_anatomy.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
