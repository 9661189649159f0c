"""The golden bounds of the PCG paths (chip_smoke.PCG_STEP_TOL) against a
planted fault, with the port's plain path on the CPU at full size:

    python tests/pcg_fault_control.py [scene ...]

For each path of chip_smoke.PCG_PATHS (all four without arguments) the port's
CPU Solver runs 8 steps three times: sound; with one band of the PCG operator
dropped (its entries set to 0: the most populated band, or where the
operator has no band, the first column of its ELL table), an A that misses
one neighbour coupling per vertex; and with that band scaled by 0.99 instead,
a coupling 1 % off. It prints the positions' errors after steps 1 and 8
relative to max |x| and the displacements' (chip_smoke.disp_err) against the
JAX package's golden, beside the bounds, and the CG trips per step beside the
golden's. The sound readings set the bounds (three to ten times the gap);
the faulted ones must exceed them (a non-finite state counts as caught). No
JAX is needed: the goldens are the reference.
"""

import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


FAULTS = (None, 0.0, 0.99)  # sound; one band dropped; one band 1 % off


def scale_band(data, factor):
    """The operator with one band (or the first ELL column) times factor."""
    if data.bands is not None and data.bands.shape[0]:
        nz = (data.bands != 0).sum(dim=1)
        d = int(torch.argmax(nz))
        bands = data.bands.clone()
        bands[d] *= factor
        return (dataclasses.replace(data, bands=bands),
                f"band offset {data.band_offsets[d]} x {factor}")
    vals = data.ell_vals.clone()
    vals[:, 0] *= factor
    return dataclasses.replace(data, ell_vals=vals), f"ELL column 0 x {factor}"


def run(name, fault):
    chip_smoke.DEVICE = "cpu"
    solver, _ = chip_smoke.pcg_scene(name, chip_smoke.torch_api("cpu"))
    what = "sound"
    if fault is not None:
        data, what = scale_band(solver._solve_data, fault)
        solver.load_arrays(solver.system, data, solver.state)
    g = chip_smoke.golden(name)
    trips, errs, disp = [], {}, {}
    for step in range(1, 9):
        solver.step()
        trips.append(solver.runtime_data().inner_iters)
        if step in (1, 8):
            x = solver.x
            errs[step] = chip_smoke.rel_err(x, g[f"x{step}"])
            disp[step] = chip_smoke.disp_err(x, g, step)[0]
    return dict(fault=what, rel_err=errs, disp_err=disp, trips=trips,
                golden_trips=g["trips"].tolist())


def main(names):
    torch.set_num_threads(4)
    for name in names or chip_smoke.PCG_PATHS:
        for fault in FAULTS:
            t0 = time.perf_counter()
            r = run(name, fault)
            r.update(bounds=chip_smoke.PCG_STEP_TOL[name],
                     disp_bound=chip_smoke.PCG_DISP_TOL.get(name, chip_smoke.DISP_TOL["float32"]),
                     seconds=round(time.perf_counter() - t0, 1))
            print(name, json.dumps(r), flush=True)
            held = (r["rel_err"][1] <= r["bounds"][0] and r["rel_err"][8] <= r["bounds"][1]
                    and max(r["disp_err"].values()) <= r["disp_bound"])
            if fault is not None and held:
                print(f"{name}: the planted fault is NOT caught by the bounds")


if __name__ == "__main__":
    main(sys.argv[1:])
