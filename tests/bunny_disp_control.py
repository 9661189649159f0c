"""The displacement bound chip_smoke.DISP_TOL against a planted fault, on the
bunny paths of chip_smoke.GATHER_SCENES, with the port on the CPU:

    python tests/bunny_disp_control.py [scene ...]

For each scene (all four bunnies without arguments) and each eps of EPS, the
port's CPU Solver runs 8 steps with a fault planted in kernel A's rows entry:
the prox's correction z - v scaled by 1 + eps, a local step whose elastic
response is off by eps (eps = 0 is the sound run). It prints the positions'
errors after steps 1 and 8 relative to max |x| (STEP1_TOL, STEP8_TOL) and the
displacements' (chip_smoke.disp_err) beside DISP_TOL; first, each float64
bunny golden against the float32 one. No JAX is needed: the
goldens are the reference. tests/test_torch_goldens.py holds the bound
against one such fault per scene.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from admm_elastic_tpu_torch.ops import cuda_local_step  # noqa: E402

EPS = (0.0, 0.01, 0.02, 0.05, 0.1, 0.25)
BUNNIES = [n for n, p in chip_smoke.GATHER_SCENES.items() if p["mesh"] == "bunny"]


def run(name, eps):
    """8 steps of the scene with kernel A's correction scaled by 1 + eps:
    z' = v + (1 + eps)(z - v) = z - eps u', so u'' = v - z' = (1 + eps) u'.
    Returns the errors after steps 1 and 8 and the displacement bound."""
    sound = cuda_local_step.local_step_tet_hyper

    def faulty(*args, **kwargs):
        z, u = sound(*args, **kwargs)
        return z - eps * u, (1.0 + eps) * u

    cuda_local_step.local_step_tet_hyper = faulty
    try:
        solver, g, _ = chip_smoke.make_gather_solver(name, device="cpu")
        solver.step()
        x1 = solver.x
        solver.run(7)
        x8 = solver.x
    finally:
        cuda_local_step.local_step_tet_hyper = sound
    disp1, tol = chip_smoke.disp_err(x1, g, 1)
    disp8, _ = chip_smoke.disp_err(x8, g, 8)
    return dict(step1=chip_smoke.rel_err(x1, g["x1"]), step8=chip_smoke.rel_err(x8, g["x8"]),
                disp1=disp1, disp8=disp8, disp_tol=tol)


def golden_spread():
    """Each float64 bunny golden against its float32 one, step 1 / step 8:
    how far float32 rounding alone takes the reference's displacement."""
    for name in BUNNIES:
        if name.endswith("_f64"):
            g32, g64 = chip_smoke.golden(name[:-len("_f64")]), chip_smoke.golden(name)
            d = [chip_smoke.disp_err(g64[f"x{s}"], g32, s)[0] for s in (1, 8)]
            print(f"{name} golden against the float32 golden: displacement {d[0]:.3e} / "
                  f"{d[1]:.3e}", flush=True)


def main(names):
    torch.set_num_threads(1)
    golden_spread()
    for name in names or BUNNIES:
        for eps in EPS:
            r = run(name, eps)
            caught = max(r["disp1"], r["disp8"]) >= r["disp_tol"]
            print(f"{name} eps {eps}: x {r['step1']:.3e} / {r['step8']:.3e}, displacement "
                  f"{r['disp1']:.3e} / {r['disp8']:.3e} (bound {r['disp_tol']}): "
                  f"{'over the bound' if caught else 'within the bound'}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
