#!/usr/bin/env python3
"""Split a launch of kernel I (csrc/wind_seq.cu, the sequential wind's level
schedule) into parts, on one CUDA card, on chip_smoke.wind_lists.

    python3 tools/i_anatomy.py [--reps 5]

Run from the root of a checkout. For each list (the 40x40 and 160x160
sheets, the 160x160 sheet shuffled, a fan, repeated vertices), float32 and
float64, and each form that takes the shape (ops/cuda_wind.i_form), the
kernel is launched through the library's C entry with the wrapper's
arguments and:

- full: the launch as the wrapper makes it;
- floor: the same launch in the latency-floor build (chip_smoke.FLOOR_DEFINES:
  the levels' loads, stores and barriers with none of the force's
  arithmetic);
- phase1: the launch with no level (the staging of v, the ids and the
  geometry, and v out);
- all_walk (where fewer threads walk): every thread of the block walks the
  levels, __syncthreads between them, in place of the block's first
  cuda_wind.walkers(widest) threads and their warp or named barrier.

Every reading is device time per launch from CUDA events around each
launch, the launches queued behind a sleep kernel and taken in turns
(chip_smoke.queued_us); the outputs of full and all_walk are held bit for
bit to the wrapper's. Prints one line per list, dtype and form with the
card's name and power limit, and writes i_anatomy.json into
chip_smoke.OUT_DIR.
"""

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def launcher(torch, cuda_wind, lib, tris, sched, d, x, v, form, levels=None, walkers=None):
    """A call that launches kernel I from lib on (tris, sched, d, x, v) in
    form, as the wrapper does, with the level count or the walkers replaced
    where given; call.out is its output."""
    n, w = x.shape[0], tris.shape[0]
    out = torch.empty_like(v)
    scratch = (torch.empty((w, 4), dtype=x.dtype, device=x.device),
               torch.empty((w, 3), dtype=torch.int32, device=x.device))
    count = torch.zeros((1,), dtype=torch.int32, device=x.device)
    ptrs = (ctypes.c_uint64 * 10)(
        tris.data_ptr(), sched.order.data_ptr(), sched.offsets.data_ptr(), x.data_ptr(),
        v.data_ptr(), d.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch),
        count.data_ptr())
    ints = (ctypes.c_int * 5)(
        n, w, sched.n_levels if levels is None else levels, cuda_wind.FORMS.index(form),
        walkers or cuda_wind.walkers(sched.widest))
    fn = getattr(lib, "admm_wind_seq_" + ("f32" if x.dtype == torch.float32 else "f64"))

    def call():
        rc = fn(ptrs, ints, -1000.0, 1.0 / 24.0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel I ({form}): cudaError {rc}")

    call.out, call.keep = out, (scratch, count, ptrs, ints)
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import _build, cuda_wind

    cs.DEVICE = "cuda"
    if not torch.cuda.is_available():
        print("i_anatomy: needs a CUDA card", file=sys.stderr)
        return 1
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(_build.library), pool.submit(cs.floor_library)]
        lib, floor = (j.result() for j in jobs)
    optin = lib.admm_smem_optin()
    out = {}
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for label, tris, d, x, v in cs.wind_lists(torch, dtype):
            sched = cuda_wind.bake_schedule(tris, tris.device)
            n, w, item = x.shape[0], tris.shape[0], x.element_size()
            for form in cuda_wind.FORMS:
                try:
                    cuda_wind.i_form(n, w, item, optin, form)
                except ValueError:
                    continue
                want = cuda_wind.wind_seq(tris, d, cs.WIND_ALPHA, cs.WIND_DT, x, v, sched,
                                          form=form)
                make = lambda lib, **kw: launcher(  # noqa: E731
                    torch, cuda_wind, lib, tris, sched, d, x, v, form, **kw)
                calls = [("full", make(lib)), ("floor", make(floor)),
                         ("phase1", make(lib, levels=0))]
                if cuda_wind.walkers(sched.widest) < 512:
                    calls.append(("all_walk", make(lib, walkers=512)))
                got = cs.queued_us(torch, calls + calls[::-1], args.reps)
                for key, call in calls:
                    if key in ("full", "all_walk"):
                        call()
                        torch.cuda.synchronize()
                        cs.need(bool(torch.equal(call.out, want)),
                                f"{label} {dname} {form} {key}: not the wrapper's bits")
                out[f"{label} {dname} {form}"] = dict(
                    got, levels=sched.n_levels, widest=sched.widest,
                    walkers=cuda_wind.walkers(sched.widest))
                print(f"{label} {dname} {form}: " + ", ".join(
                    f"{k} {u:.1f}" for k, u in got.items()) + f" us a launch; "
                    f"{sched.n_levels} levels of at most {sched.widest}, "
                    f"{cuda_wind.walkers(sched.widest)} walkers [{gpu}]",
                    flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "i_anatomy.json"), "w") as f:
        json.dump(dict(gpu=gpu, readings=out), f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
