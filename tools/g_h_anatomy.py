#!/usr/bin/env python3
"""Split a trip of kernel G (csrc/pcg.cu) and a sweep of kernel H (csrc/gs.cu)
into parts, on one CUDA card, at the shapes of the paths that run them.

    python3 tools/g_h_anatomy.py [--reps 5] [--only barriers|h|g|forms ...]

Run from the root of a checkout. Besides the port's library it builds
variants of pcg.cu and gs.cu from the same sources under compile-time flags
(ADMM_G_ANATOMY, ADMM_H_ANATOMY; see the sources), each of which ignores the
exit test and so takes a fixed number of trips or sweeps. Every reading is
device time per launch from CUDA events around each launch, the launches
queued behind a sleep kernel and taken in turns (chip_smoke.queued_us).

- barriers: the grid barrier alone in a loop on 1-132 blocks; the cluster's
  hardware barrier alone on 1-16 blocks of 256 and 1,024 threads; how many
  clusters of 8 and 16 blocks the card holds at the block sizes and shared
  memory a CLUSTER form of G takes;
- h: H per sweep on the first solve of floor_gs5k and sphere_gs: the full
  kernel; passes with no row work (the __syncthreads chain); passes with the
  ELL row sum alone; the full passes without the residual; the residual
  alone;
- g: G per solve and per trip on the first solve of every path that
  launches it (chip_smoke.PCG_PATHS, Uzawa's inner solve and a Schur
  direction's at floor_uzawa67k, the penalty form at floor_alpcg67k): the
  full kernel and the variant whose phases do no row work (the barriers,
  block sums and totals alone) in as many trips, in the GRID form on the
  grid G takes and on 1, 2, 4 ... blocks, and in the CLUSTER form where the
  checkout has one and it takes the shape;
- forms: G per solve in its GRID and CLUSTER forms, in turns, at every
  shape the CLUSTER form takes (FORM_SCENES: torus_pcg20k, the beam at the
  CLUSTER form's largest N, crossval's small beam and torus), Jacobi and
  two-grid, float32 and float64: the readings behind cuda_pcg.g_form's rule.

Prints one line per reading with the card's name and power limit, and
writes g_h_anatomy_<parts>.json into chip_smoke.OUT_DIR.
"""

import argparse
import concurrent.futures
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

VARIANTS = {  # label -> extra -D flags
    "g_no_rows+h_no_rows": None,  # chip_smoke.FLOOR_DEFINES: the latency floor
    "h_row_sum": ("-DADMM_H_ANATOMY=2",),
    "h_no_residual": ("-DADMM_H_ANATOMY=3",),
    "h_residual": ("-DADMM_H_ANATOMY=4",),
}
GRIDS = (1, 2, 4, 8, 16, 32, 64, 132)
# The shapes the CLUSTER form of G takes (chip_smoke.PCG_SCENES, G_EDGE_SCENES)
FORM_SCENES = ("torus_pcg20k", "beam_g_edge_inside", "beam_pcg", "torus_pcg")


def g_solves(torch):
    """(label, data, b, x0, tol, max_iters, penalty) of every first solve that
    kernel G takes on the paths, and the trips each takes."""
    import chip_smoke as cs
    from admm_elastic_tpu_torch.solvers import alcg

    out = []
    for name in cs.PCG_PATHS:
        solver, _ = cs.pcg_scene(name, cs.torch_api())
        s = solver.m_settings
        b, x0 = cs.first_solve(torch, solver)
        out.append((name, solver._solve_data, b, x0, s.pcg_tol, s.pcg_max_iters, None))
    _, inner = cs.uzawa_inner_checks(torch)
    for label, t in inner.items():
        out.append((label, t["data"], t["b"], t["x0"], t["tol"], t["max_iters"], None))
    _, pen = cs.gpen_checks(torch)
    t = pen["floor_alpcg67k"]
    s = t["solver"].m_settings
    _, b_hat, pen_diag, _ = alcg._setup(t["hits"], t["ck"], t["b"], t["y"])
    pn = alcg.penalty_vectors(t["hits"], t["ck"], t["b"].shape[0])
    out.append(("floor_alpcg67k penalty", t["data"], b_hat, t["x0"], s.pcg_tol, s.pcg_max_iters,
                (pn, pen_diag)))
    return out


def g_anatomy(torch, libs, reps, gpu):
    """G per solve and per trip on every grid size of its GRID form and, where
    the checkout has one and it takes the shape, its CLUSTER form: the full
    kernel (its own exit) and the variant with no row work in as many trips."""
    import inspect

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_pcg

    has_forms = "form" in inspect.signature(cuda_pcg._launch).parameters
    res = {}
    for label, data, b, x0, tol, iters, pen in g_solves(torch):
        trips = torch.zeros((1,), dtype=torch.int32, device="cuda")
        cuda_pcg._launch(data, b, x0, tol, iters, trips, pen, None)
        k = int(trips.item())
        full_grid = cuda_pcg.grid_of(data.n, b.dtype)
        configs = [("grid", g) for g in GRIDS if g < full_grid] + [("grid", full_grid)]
        if has_forms:
            try:
                _, blocks, shift = cuda_pcg.form_of(data, b.dtype, "cluster")
                configs.append(("cluster", f"{blocks}x{1 << shift}"))
            except ValueError:
                pass
        us = {}
        for var, lib, its in (("full", libs["port"], iters),
                              ("no_rows", libs["g_no_rows+h_no_rows"], max(k, 1))):
            calls = []
            for form, g in configs:
                kw = dict(lib=lib)
                if has_forms:
                    kw["form"] = form
                if form == "grid":
                    kw["grid"] = g
                calls.append(((var, form, g), lambda kw=kw, its=its: cuda_pcg._launch(
                    data, b, x0, tol, its, None, pen, None, **kw)))
            us.update(cs.queued_us(torch, calls, reps))
        rows = {}
        for form, g in configs:
            full, bare = us[("full", form, g)], us[("no_rows", form, g)]
            rows[f"{form} {g}"] = dict(full_us=full, no_rows_us=bare,
                                       full_us_per_trip=full / max(k, 1),
                                       no_rows_us_per_trip=bare / max(k, 1))
            print(f"G {label} (n {data.n}, {k} trips), {form} form on {g} blocks: {full:.2f} us "
                  f"per solve, {full / max(k, 1):.2f} per trip; phases with no row work "
                  f"{bare / max(k, 1):.2f} per trip [{gpu}]", flush=True)
        res[label] = dict(n=data.n, trips=k, grid=full_grid, twogrid=data.agg is not None,
                          bands=len(data.band_offsets), rest=data.ell_cols.shape[1],
                          penalty=pen is not None, by_config=rows)
    return res


def barrier_anatomy(torch, lib, reps, gpu, iters=1000):
    """The grid barrier alone (iters in one launch) at each grid size, the
    cluster barrier alone at 1-16 blocks of 256 and 1,024 threads, and how
    many clusters of 8 and 16 blocks the card holds."""
    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import _build

    bar = torch.zeros((64,), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def grid_loop(g):
        _build.check(lib.admm_pcg_barrier_loop(g, iters, bar.data_ptr(), stream), "barrier")

    def cluster_loop(c, threads):
        _build.check(lib.admm_cluster_barrier_loop(c, threads, 0, iters, stream),
                     "cluster barrier")

    grid = cs.queued_us(torch, [(g, lambda g=g: grid_loop(g)) for g in GRIDS], reps)
    clusters = [(c, t) for t in (256, 1024) for c in (1, 2, 4, 8, 16)]
    cl = cs.queued_us(torch, [(c, lambda c=c: cluster_loop(*c)) for c in clusters], reps)
    out = dict(grid_barrier_us={g: grid[g] / iters for g in GRIDS},
               cluster_barrier_us={f"{c}x{t}": cl[c, t] / iters for c, t in clusters},
               capacity={})
    for g in GRIDS:
        print(f"grid barrier alone on {g} blocks: {grid[g] / iters * 1e3:.1f} ns [{gpu}]")
    for c, t in clusters:
        print(f"cluster barrier alone, {c} blocks of {t}: {cl[c, t] / iters * 1e3:.1f} ns "
              f"[{gpu}]")
    for c, threads, smem in ((8, 1024, 0), (8, 1024, 200 * 1024), (16, 1024, 0),
                             (16, 1024, 100 * 1024), (16, 1024, 200 * 1024),
                             (16, 512, 100 * 1024), (16, 256, 50 * 1024)):
        n = lib.admm_cluster_capacity(c, threads, smem)
        out["capacity"][f"{c}x{threads}@{smem}"] = n
        print(f"clusters of {c} blocks of {threads} threads with {smem} B of shared memory "
              f"the card holds at once: {n} [{gpu}]")
    return out


def h_anatomy(torch, libs, reps, gpu):
    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_gs

    _, timing = cs.h_checks(torch)
    res = {}
    for name, t in timing.items():
        solver = t["solver"]
        s, data = solver.m_settings, solver._solve_data
        k = t["sweeps"]
        obs = list(solver._contact.obstacles)
        params = solver._contact.gs_params
        colors = int(data.colors.shape[0])

        def call(lib, its):
            return lambda: cuda_gs._launch(data, t["b"], t["x0"], t["pin_mask"], t["pin_target"],
                                           obs, s.gs_omega, its, s.gs_tol,
                                           torch.zeros((1,), dtype=torch.int32, device="cuda"),
                                           params, lib=lib)

        calls = [("full", call(libs["port"], s.gs_max_iters))]
        calls += [(v, call(libs[v], k)) for v in ("g_no_rows+h_no_rows", "h_row_sum",
                                                   "h_no_residual", "h_residual")]
        us = cs.queued_us(torch, calls, reps)
        per = {v: us[v] / k for v in us}
        row = dict(n=int(data.ell_cols.shape[0]), k=int(data.ell_cols.shape[1]), colors=colors,
                   width=int(data.colors.shape[1]), sweeps=k, us_per_solve=us,
                   us_per_sweep=per,
                   us_per_pass=dict(no_rows=per["g_no_rows+h_no_rows"] / colors,
                                    row_sum=per["h_row_sum"] / colors,
                                    update=per["h_no_residual"] / colors,
                                    residual=per["h_residual"]))
        res[name] = row
        print(f"H {name} (n {row['n']}, K {row['k']}, {colors} colours of at most "
              f"{row['width']}, {k} sweeps): {per['full']:.2f} us per sweep; per pass: no row "
              f"work {row['us_per_pass']['no_rows']:.3f}, row sum alone "
              f"{row['us_per_pass']['row_sum']:.3f}, full update "
              f"{row['us_per_pass']['update']:.3f}; the residual {per['h_residual']:.3f} "
              f"[{gpu}]", flush=True)
    return res


def form_times(torch, reps, gpu):
    """G per solve in each form that takes the shape (chip_smoke.g_forms), in
    turns, on the first solve of each of FORM_SCENES, Jacobi and two-grid,
    float32 and the same inputs widened to float64; beside the form g_form
    chooses and its blocks."""
    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import cuda_pcg
    from admm_elastic_tpu_torch.solvers import pcg

    out = {}
    api = cs.torch_api()
    for name in FORM_SCENES:
        solver, _ = cs.pcg_scene(name, api, dict(cs.PCG_SCENES, **cs.G_EDGE_SCENES))
        s = solver.m_settings
        b32, x32 = cs.first_solve(torch, solver)
        for pre in ("jacobi", "twogrid"):
            for dtype in (torch.float32, torch.float64):
                data = pcg.prepare(solver.system, dtype, precond=pre)
                b, x0 = b32.to(dtype), x32.to(dtype)
                trips = torch.zeros((1,), dtype=torch.int32, device="cuda")
                cuda_pcg.pcg_solve(data, b, x0, s.pcg_tol, s.pcg_max_iters, trips)
                calls = [(f, lambda f=f: cuda_pcg.pcg_solve(data, b, x0, s.pcg_tol,
                                                             s.pcg_max_iters, None, form=f))
                         for f in cs.g_forms(data, dtype)]
                us = cs.queued_us(torch, calls + calls[::-1], reps)
                label = f"{name} {pre} {str(dtype).split('.')[-1]}"
                row = dict(n=data.n, trips=int(trips.item()), chosen=cs.g_blocks(data, dtype),
                           blocks={f: cs.g_blocks(data, dtype, f)[1:] for f in us}, us=us)
                out[label] = row
                print(f"G {label} (n {data.n}, {row['trips']} trips; g_form: "
                      f"{row['chosen'][0]}): " + ", ".join(
                          f"{f} on {row['blocks'][f][0]}x{row['blocks'][f][1]} {u:.2f} us"
                          for f, u in us.items()) + f" per solve [{gpu}]", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=("barriers", "h", "g", "forms"), action="append",
                    help="these parts only (default: all)")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from admm_elastic_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("g_h_anatomy: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gpu = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]).splitlines()[0]
    parts = args.only or ("barriers", "h", "g")
    builds = {v: (cs.FLOOR_UNITS, d or cs.FLOOR_DEFINES) for v, d in VARIANTS.items()}
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        jobs = {v: pool.submit(_build.build, *b) for v, b in builds.items()}
        jobs["port"] = pool.submit(_build.build)
        paths = {v: j.result() for v, j in jobs.items()}
    libs = {v: _build._load(p) for v, p in paths.items() if v != "port"}
    libs["port"] = _build.library()
    out = dict(gpu=gpu)
    if "barriers" in parts:
        out["barriers"] = barrier_anatomy(torch, libs["port"], args.reps, gpu)
    if "h" in parts:
        out["h"] = h_anatomy(torch, libs, args.reps, gpu)
    if "g" in parts:
        out["g"] = g_anatomy(torch, libs, args.reps, gpu)
    if "forms" in parts:
        out["forms"] = form_times(torch, args.reps, gpu)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, f"g_h_anatomy_{'_'.join(parts)}.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
