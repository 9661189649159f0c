"""The golden bounds of the contact paths (chip_smoke.CONTACT_STEP_TOL,
CONTACT_DISP_TOL) against planted faults, with the port's plain path on the
CPU at full size:

    python tests/contact_fault_control.py [scene ...]

For each path of chip_smoke.CONTACT_PATHS (all five without arguments) the
port's CPU Solver runs the golden's steps three times: sound; with the obstacle's
normal zeroed (the Floor's: what an XLA:TPU miscompile once did to the JAX package's floor
rows, bench.py:44-46: the contact rows vanish and bodies tunnel); and with
the contact's tangent-plane projection dropped from the Gauss-Seidel sweeps
(the sweeps' re-detection finds no hit, so a contact vertex keeps its
over-relaxed update); on the Uzawa and AL-PCG paths, which have no
projection, the second fault drops the constraints' right-hand side instead
(c = 0: a contact row holds its vertex to the plane through the origin).
A halved normal is no fault there: the rows C x = c scale with it. It prints x's error
at each compared step relative to max |x|, the displacement's
(chip_smoke.disp_err), the vertices in contact and the lowest y of the
compared steps, beside the
bounds and the JAX package's golden. The sound readings set the bounds (three
to ten times the gap); a faulted run must exceed one of them, or tunnel
(min y <= -1.1), or leave the state non-finite. No JAX is needed: the goldens
are the reference.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from admm_elastic_tpu_torch.collision import constraints, passive  # noqa: E402
from admm_elastic_tpu_torch.solvers import gs  # noqa: E402

FAULTS = ("sound", "normal_zeroed", "projection_dropped")
SECOND = {1: "projection_dropped", 2: "rhs_dropped", 4: "rhs_dropped"}


def _zero_normal(signed_distance):
    def zeroed(obs, x):
        d, p, n = signed_distance(obs, x)
        return d, p, torch.zeros_like(n)

    return zeroed


class planted:
    """Plant one fault for the duration of a block."""

    def __init__(self, fault, ls):
        self.fault, self.ls, self.undo = fault, ls, []

    def patch(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        if self.fault == "normal_zeroed":
            for cls in (passive.Floor, passive.Sphere):
                self.patch(cls, "signed_distance", _zero_normal(cls.signed_distance))
        elif self.fault == "projection_dropped" and self.ls == 1:
            detect = gs.detect_passive

            def unprojected(obstacles, x):  # the sweeps see no hit
                d, p, n, hit, ovf = detect(obstacles, x)
                return d, p, n, torch.zeros_like(hit), ovf

            self.patch(gs, "detect_passive", unprojected)
        elif self.fault == "projection_dropped":
            rhs = constraints.C_rhs

            def dropped(hits, ck):
                cp, cd = rhs(hits, ck)
                return torch.zeros_like(cp), cd

            self.patch(constraints, "C_rhs", dropped)
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self.undo):
            setattr(owner, name, value)


def run(name, fault):
    chip_smoke.DEVICE = "cpu"
    p = chip_smoke.CONTACT_SCENES[name]
    g = chip_smoke.golden(name)
    steps, compare = chip_smoke.contact_steps(name)
    with planted(fault, p["ls"]):
        solver = chip_smoke.contact_scene(name, chip_smoke.torch_api("cpu"))
        errs, disp, touching, inner, low = {}, {}, {}, [], np.inf
        for step in range(1, steps + 1):
            solver.step()
            inner.append(solver.runtime_data().inner_iters)
            if step in compare:  # as chip_smoke.contact_path reads them
                x = solver.x
                low = min(low, float(x[:, 1].min()) if np.isfinite(x).all() else -np.inf)
                ok = np.isfinite(x).all()
                errs[step] = chip_smoke.rel_err(x, g[f"x{step}"]) if ok else np.inf
                disp[step] = chip_smoke.disp_err(x, g, step)[0] if ok else np.inf
                touching[step] = chip_smoke.contacts(name, x)
    b1, b2 = chip_smoke.CONTACT_STEP_TOL[name]
    caught = (errs[compare[0]] >= b1 or any(errs[k] >= b2 for k in compare[1:])
              or max(disp.values()) >= chip_smoke.CONTACT_DISP_TOL[name] or low <= -1.1)
    return dict(errs=errs, disp=disp, contacts=touching, min_y=low, inner=inner, caught=caught)


def main(names):
    out = {}
    for name in names or chip_smoke.CONTACT_PATHS:
        g = chip_smoke.golden(name)
        for fault in FAULTS:
            t0 = time.perf_counter()
            r = run(name, fault)
            r["seconds"] = time.perf_counter() - t0
            label = SECOND[chip_smoke.CONTACT_SCENES[name]["ls"]] if fault == FAULTS[2] else fault
            out[f"{name} {label}"] = r
            print(f"{name} {label}: x " + ", ".join(
                f"step {k} {v:.3e}" for k, v in r["errs"].items()) + "; displacement "
                + ", ".join(f"{v:.3e}" for v in r["disp"].values())
                + f"; bounds {chip_smoke.CONTACT_STEP_TOL[name]} / "
                f"{chip_smoke.CONTACT_DISP_TOL[name]}; contacts {list(r['contacts'].values())} "
                f"(golden {g['contacts'].tolist()}); min y {r['min_y']:.4f}; "
                f"{'caught' if r['caught'] else 'within the bounds'} ({r['seconds']:.0f} s)",
                flush=True)
            if fault == "sound":
                print(f"  inner per step {r['inner']} (golden {g['inner'].tolist()})", flush=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "contact_fault_control.json"), "w") as f:
        json.dump(out, f, indent=1, default=float)


if __name__ == "__main__":
    torch.set_num_threads(int(os.environ.get("THREADS", "4")))
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    main(sys.argv[1:])
