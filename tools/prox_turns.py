#!/usr/bin/env python3
"""Time kernels D and F (csrc/prox.cu) of this checkout against those of
another checkout of the repository, in turns, on one CUDA card.

    python3 tools/prox_turns.py OTHER [--reps 20] [--rounds 2]

OTHER is the root of another checkout, for example a commit unpacked with
``git archive <commit> | tar -x -C build/other``. Each library is built from
its own sources (ops/_build.build; the other checkout's in a child process
of its own) and both are loaded side by side with ctypes. Both must export
admm_prox_tet_hyper_f32 / admm_prox_tet_linear_f32 with the arguments that
ops/_build._SIGNATURES gives.

The inputs are those chip_smoke.kernel_cases hands kernels D and F: the
bench beam's D x on a perturbed pose, [T, 3, 3] float32, with each model's
material rows, at the beam's 7,680 lanes and tiled chip_smoke.TILES times
(983,040 lanes). For each model and size one torch.profiler window runs
this, other, other, this (``rounds`` times), ``reps`` launches each, and
reads the device time per launch in the order the launches ran. The two z
must be bitwise equal. Prints one line per model and size, the ptxas lines
of both builds for the prox kernels, and the card's name and power limit;
writes prox_turns.json into chip_smoke.OUT_DIR.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def other_library(root):
    """Build the kernels of the checkout at root in a child process; return
    (the loaded library, its ptxas log)."""
    code = "from admm_elastic_tpu_torch.ops import _build; print(_build.build())"
    env = dict(os.environ, PYTHONPATH=root)
    so = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, check=True,
                        capture_output=True, text=True).stdout.strip().splitlines()[-1]
    return ctypes.CDLL(so), open(so[:-len(".so")] + ".log").read()


def bind(lib):
    from admm_elastic_tpu_torch.ops import _build

    for name in ("admm_prox_tet_hyper", "admm_prox_tet_linear"):
        fn = getattr(lib, f"{name}_f32")
        fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    return lib


def prox_launcher(torch, lib, model, zi, params):
    """A call that launches lib's kernel D (or F) on zi into a buffer of its
    own and returns that buffer."""
    from admm_elastic_tpu_torch.ops.cuda_local_step import MODEL_IDS, SWEEPS

    out = torch.empty_like(zi)
    t = zi.shape[0]

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        if model == "linear":
            rc = lib.admm_prox_tet_linear_f32(zi.data_ptr(), out.data_ptr(), t, SWEEPS, stream)
        else:
            rc = lib.admm_prox_tet_hyper_f32(zi.data_ptr(), *(p.data_ptr() for p in params),
                                             out.data_ptr(), t, MODEL_IDS[model], 8, SWEEPS,
                                             stream)
        if rc != 0:
            raise RuntimeError(f"launch of {model} failed: cudaError {rc}")
        return out

    return call


def window(torch, calls, reps):
    """Device us per launch of each (label, call), the calls run in order and
    reps launches each, read in the order they ran; a window that lost
    events is taken again, three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        for _, call in calls:
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, call in calls:
                for _ in range(reps):
                    call()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        if len(ev) == len(calls) * reps:
            return [sum(e.time_range.elapsed_us() for e in ev[i * reps:(i + 1) * reps]) / reps
                    for i in range(len(calls))]
    raise RuntimeError(f"the profiler saw {len(ev)} of {len(calls) * reps} launches, three times")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prox_turns: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 2
    from admm_elastic_tpu_torch.ops import _build, cuda_stencil
    from admm_elastic_tpu_torch.ops.hyper_soa import prox_tet_hyper_tuple

    gpu = cs.environment(torch)["gpu"]
    libs = {"this": bind(_build.library())}
    lib, other_log = other_library(os.path.abspath(args.other))
    libs["other"] = bind(lib)
    logs = {"this": _build.build().with_suffix(".log").read_text(), "other": other_log}
    for who, text in logs.items():
        print(f"ptxas of {who} (the prox kernels):")
        keep = False
        for ln in text.splitlines():
            if "Compiling entry" in ln:
                keep = "tet_prox" in ln
            if keep and ("Compiling entry" in ln or "registers" in ln or "spill" in ln):
                print("  " + ln.strip())

    f32 = torch.float32
    mesh, b = cs.beam_batch(torch, f32)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(mesh.vertices + 0.05 * rng.standard_normal(mesh.vertices.shape),
                        device=cs.DEVICE, dtype=f32)
    dix = cuda_stencil.tet_Dx_rows(x, b)
    zi = dix.T.reshape(-1, 3, 3).contiguous()
    out = {}
    for model in cs.TET_MODELS:
        bm = cs.beam_batch(torch, f32, model)[1]
        params = (bm.mu, bm.lam, bm.kappa, bm.bulk)
        trips = {}
        if model != "linear":
            prox_tet_hyper_tuple(tuple(dix), model, *params, trips=trips)
        out[model] = {}
        for reps in (1, cs.TILES):
            zt, pt = cs.tiled(zi, reps), tuple(cs.tiled(p, reps) for p in params)
            lanes = zt.shape[0]
            calls = {who: prox_launcher(torch, lib, model, zt, pt) for who, lib in libs.items()}
            same = torch.equal(calls["this"]().view(torch.int32),
                               calls["other"]().view(torch.int32))
            seq = [("this", calls["this"]), ("other", calls["other"])]
            seq = (seq + seq[::-1]) * args.rounds
            us = window(torch, seq, args.reps)
            got = {who: [u for (w, _), u in zip(seq, us) if w == who] for who in calls}
            nbytes = 2 * zt.numel() * 4 + (0 if model == "linear" else sum(
                p.numel() * 4 for p in pt))
            ops = cs.tet_operations(model, lanes, False, {k: v * reps for k, v in trips.items()})
            bound_ms, bound_by = cs.bound_of(nbytes, ops)
            res = dict(lanes=lanes, bitwise_equal=same, device_us=got,
                       this_us=min(got["this"]), other_us=min(got["other"]),
                       bound_us=bound_ms * 1e3, bound_by=bound_by)
            out[model][lanes] = res
            print(f"{'F' if model == 'linear' else 'D'}[{model}] at {lanes} lanes: this "
                  + " / ".join(f"{u:.2f}" for u in got["this"]) + " us, other "
                  + " / ".join(f"{u:.2f}" for u in got["other"])
                  + f" us per launch (in turns); bound {res['bound_us']:.3f} us by {bound_by}; "
                  f"z bitwise equal: {same} [{gpu}]", flush=True)
            if not same:
                print(f"prox_turns: z of the two differ for {model} at {lanes} lanes",
                      file=sys.stderr)
                return 1
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "prox_turns.json"), "w") as f:
        json.dump(dict(gpu=gpu, other=os.path.abspath(args.other), prox=out), f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
