"""Write the golden trajectories tests/data/torch_port_golden_*.npz: JAX CPU
runs of the port's full-size scenes, against which chip_smoke.py and the
port's tests check admm_elastic_tpu_torch where no JAX is installed.

All scenes: float32 (bunny_nh_f64 and bunny_linear_f64: float64),
linsolver=0, direct_mode="inv" (beam_cho: "cho"), 10 ADMM iterations per
step, dt = 1/24; positions after steps 1 and 8 (beam_free: 1 and 2). The SVD runs the Jacobi SoA path
(set_svd_impl("jacobi")), the same body as the port's kernels.

- beam (bench.py:23-24,78-94): the 40x5x5 make_tet_blocks beam, soft rubber,
  -x face pinned, gravity -9.8; neo-Hookean in torch_port_golden_beam.npz and
  linear, stvk, spline_nh (mesh flags of binding.add_tetmesh), spline_stvk and
  spline_corot (Solver.add_tet_energies with kappa = the bulk modulus) in
  torch_port_golden_beam_<model>.npz; the neo-Hookean beam with no pins, in
  free fall for two steps, in torch_port_golden_beam_free.npz: an unpinned
  float32 system takes one iterative-refinement pass per ADMM iteration
  (Solver._refine_eff), the only place where a step applies A (D x and
  D^T W^2 on their own);
- cloth (benchmarks/matrix.py:76-119,279-281, geometry from
  chip_smoke.cloth_sheet): the 40x40 sheet, Lame.from_youngs_poisson(1e7,
  0.399), -x edge pinned; strain limits (0.95, 1.05) under gravity in
  torch_port_golden_cloth_limit40.npz, colored wind (0.05, 0.1, 0.02) without
  gravity in torch_port_golden_cloth_wind40.npz;
- the gather D / D^T and the Cholesky solve (chip_smoke.GATHER_SCENES), under
  gravity -9.8: beam_gather, the neo-Hookean bench beam with its
  lattice_dims dropped; bunny_nh and bunny_linear, the reference's
  data/bunny_1124 through load_elenode with the feet pinned
  (benchmarks/crossval.py:173-182), soft rubber, and the two again in
  float64 (bunny_nh_f64, bunny_linear_f64); cloth_gather_limit40 and
  cloth_gather_wind40, the cloth_limit40 and cloth_wind40 sheets (with their
  own gravity) renumbered by chip_smoke.renumbered_sheet; beam_cho, the
  neo-Hookean bench beam (a lattice) with direct_mode="cho";
- the PCG scenes (chip_smoke.PCG_SCENES, built by chip_smoke.pcg_scene with
  this package's API): the four full-size paths beam_pcg160k, torus_pcg20k,
  cloth_ls0_160 (linsolver=0 above direct_max_verts: two-grid PCG) and
  bunny_pcg, and crossval's small beam_pcg and torus_pcg, in float32, with
  bunny_pcg_f64, beam_pcg_f64 and torus_pcg_f64 in float64; each also holds
  the CG trips of every step 1..8 (``trips``), as runtime_data().inner_iters
  reports them;
- the contact scenes (chip_smoke.CONTACT_SCENES, built by
  chip_smoke.contact_scene with this package's API): the five full-size paths
  floor_gs5k, floor_uzawa5k, floor_uzawa67k, floor_alpcg67k (20 steps) and
  sphere_gs (40), and crossval's small contact scenes (14 steps; the sphere
  in float64, 20) in float32 and float64; each holds x at the compared steps
  (``compare``), the inner iterations of every step (``inner``: GS sweeps,
  Schur trips or CG trips), the vertices in contact at the compared steps
  (``contacts``, chip_smoke.contacts) and, for Uzawa and AL-PCG, the active
  constraint rows the state carries after them (``active_rows``), and each
  step's runtime_data().collision_overflow (``overflow``); among them the
  mesh-obstacle scenes (PassiveMeshSDF, PassiveMeshExact): the card's paths
  chip_smoke.MESH_PATHS (slab_sdf_gs5k, slab_exact_gs5k and
  slab_exact_alpcg67k, 20 steps; exactmesh_deep_gs, 8) and the CPU tests'
  chip_smoke.MESH_CPU_SCENES (crossval's five mesh scenes, two with
  near_lanes=4, a compacted AL-PCG scene, 8 steps; one in float64);
- the variants (chip_smoke.VARIANT_SCENES): beam_aa4, cloth_aa4 and
  floor_alpcg67k_aa4, the beam, cloth_limit40 and floor_alpcg67k with Anderson
  acceleration (aa_window=4), and cloth_wind40_seq, cloth_wind40 with the
  sequential wind (WindForce(sequential=True)), each stored as its base is.

Run from the repository root (all files, or only the named ones):

    JAX_PLATFORMS=cpu python tests/make_torch_golden.py [beam beam_free cloth_wind40 ...]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from admm_elastic_tpu import Lame, Settings, Solver, binding  # noqa: E402
from admm_elastic_tpu.forces import make_wind_force  # noqa: E402
from admm_elastic_tpu.geometry.factory import make_tet_blocks  # noqa: E402
from admm_elastic_tpu.geometry.io import load_elenode  # noqa: E402
from admm_elastic_tpu.ops import prox  # noqa: E402
from chip_smoke import (BEAM_FLAGS, BEAM_MODELS, BUNNY, CLOTH_SCENES,  # noqa: E402
                        CONTACT_SCENES, GATHER_SCENES, PCG_SCENES, VARIANT_SCENES, bunny_pins,
                        cloth_sheet, contact_scene, contact_steps, contacts, pcg_scene,
                        renumbered_sheet, variant_of)

DIMS = (40, 5, 5)
ADMM_ITERS = 10
DT = 1.0 / 24.0
GRAVITY = -9.8
STEPS = (1, 8)
FREE_STEPS = (1, 2)  # of beam_free
DATA = os.path.join(ROOT, "tests", "data")


def _settings(gravity, direct_mode="inv", dtype=np.float32, **change):
    return Settings(verbose=0, admm_iters=ADMM_ITERS, linsolver=0, gravity=gravity,
                    timestep_s=DT, dtype=dtype, direct_mode=direct_mode, **change)


def _rollout(solver, steps=STEPS, dtype=np.float32):
    traj = {"steps": np.asarray(steps)}
    for step in range(1, max(steps) + 1):
        solver.step()
        if step in steps:
            traj[f"x{step}"] = np.asarray(solver.x, dtype)
    return traj


def _save(name, **arrays):
    os.makedirs(DATA, exist_ok=True)
    out = os.path.join(DATA, f"torch_port_golden_{name}.npz")
    np.savez_compressed(out, admm_iters=ADMM_ITERS, dt=DT, **arrays)
    print(f"wrote {out}")


def beam(model, pinned=True, name=None):
    change = variant_of(name)[1] if name else {}
    mesh = make_tet_blocks(*DIMS)
    solver = Solver()
    lame = Lame.soft_rubber()
    if model in BEAM_FLAGS:
        mesh.flags = binding.NOSELFCOLLISION | getattr(binding, BEAM_FLAGS[model])
        binding.add_tetmesh(solver, mesh, lame, verbose=False)
    else:
        solver.add_nodes(mesh.vertices, mesh.weighted_masses(binding.RUBBER_DENSITY))
        solver.add_tet_energies(mesh.vertices, mesh.tets, lame, model=model,
                                kappa=lame.bulk_modulus(), lattice_dims=mesh.lattice_dims)
    pins = np.where(mesh.vertices[:, 0] < 1e-9)[0] if pinned else np.zeros((0,), np.int64)
    if pinned:
        solver.set_pins([int(i) for i in pins])
    assert solver.initialize(_settings(GRAVITY, **change))
    assert solver.system.tets[0].model == model
    if name:
        steps = STEPS
    elif pinned:
        name, steps = "beam" if model == "neohookean" else f"beam_{model}", STEPS
    else:
        assert model == "neohookean" and solver._refine_eff == 1
        name, steps = "beam_free", FREE_STEPS
    _save(name, dims=np.asarray(DIMS), gravity=GRAVITY, mu=lame.mu, lam=lame.lam, pins=pins,
          model=model, x0=mesh.vertices.astype(np.float32), **_rollout(solver, steps))


def cloth(name):
    base, change, sequential = variant_of(name)
    p = CLOTH_SCENES[base]
    verts, tris, masses, pins = cloth_sheet(p["nx"], p["ny"])
    solver = Solver()
    solver.add_nodes(verts, masses)
    lame = Lame.from_youngs_poisson(10000000, 0.399)
    if p["limits"] is not None:
        lame.limit_min, lame.limit_max = p["limits"]
    solver.add_tri_energies(verts, tris, lame)
    solver.set_pins([int(i) for i in pins])
    if p["wind"] is not None:
        solver.add_explicit_force(make_wind_force(tris, direction=p["wind"],
                                                  colored=not sequential, sequential=sequential))
    assert solver.initialize(_settings(p["gravity"], **change))
    assert solver.system.tris[0].stencil is not None
    _save(name, nx=p["nx"], ny=p["ny"], gravity=p["gravity"], pins=pins,
          limits=np.asarray(p["limits"] if p["limits"] is not None else (-100.0, 100.0)),
          wind=np.asarray(p["wind"] if p["wind"] is not None else (0.0, 0.0, 0.0)),
          x0=verts.astype(np.float32), **_rollout(solver))


def gather(name):
    p = GATHER_SCENES[name]
    solver = Solver()
    extra = {}
    gravity = GRAVITY
    if p["mesh"] == "sheet":
        c = CLOTH_SCENES[p["sheet"]]
        verts, tris, masses, pins, perm = renumbered_sheet(c["nx"], c["ny"])
        solver.add_nodes(verts, masses)
        lame = Lame.from_youngs_poisson(10000000, 0.399)
        if c["limits"] is not None:
            lame.limit_min, lame.limit_max = c["limits"]
        solver.add_tri_energies(verts, tris, lame)
        if c["wind"] is not None:
            solver.add_explicit_force(make_wind_force(tris, direction=c["wind"], colored=True))
        gravity = c["gravity"]
        extra = dict(nx=c["nx"], ny=c["ny"], perm=perm,
                     limits=np.asarray(c["limits"] if c["limits"] is not None else (-100.0, 100.0)),
                     wind=np.asarray(c["wind"] if c["wind"] is not None else (0.0, 0.0, 0.0)))
    else:
        if p["mesh"] == "beam":
            mesh = make_tet_blocks(*DIMS)
            if not p["lattice"]:
                mesh.lattice_dims = None
            pins = np.where(mesh.vertices[:, 0] < 1e-9)[0]
            extra = dict(dims=np.asarray(DIMS))
        else:
            mesh = load_elenode(BUNNY)
            pins = bunny_pins(mesh.vertices)
        mesh.flags = binding.NOSELFCOLLISION | getattr(binding, BEAM_FLAGS[p["model"]])
        lame = Lame.soft_rubber()
        binding.add_tetmesh(solver, mesh, lame, verbose=False)
        verts = mesh.vertices
        extra.update(model=p["model"], mu=lame.mu, lam=lame.lam)
    solver.set_pins([int(i) for i in pins])
    dtype = p.get("dtype", np.float32)
    assert solver.initialize(_settings(gravity, p["direct_mode"], dtype))
    fams = solver.system.tets + solver.system.tris
    assert len(fams) == 1 and (fams[0].stencil is not None) == (p.get("lattice") is True)
    assert solver._solve_data.mode == p["direct_mode"]
    _save(name, gravity=gravity, pins=pins, direct_mode=p["direct_mode"],
          x0=verts.astype(dtype), **extra, **_rollout(solver, dtype=dtype))


def jax_api():
    """chip_smoke.pcg_scene's and contact_scene's namespace for the JAX package."""
    import types

    import jax.numpy as jnp

    from admm_elastic_tpu import Floor, PassiveMeshExact, PassiveMeshSDF, Sphere
    from admm_elastic_tpu.geometry.factory import make_tet_torus, make_xform

    return types.SimpleNamespace(Solver=Solver, Settings=Settings, Lame=Lame, binding=binding,
                                 make_tet_blocks=make_tet_blocks, make_tet_torus=make_tet_torus,
                                 load_elenode=load_elenode, Floor=Floor, Sphere=Sphere,
                                 PassiveMeshSDF=PassiveMeshSDF, PassiveMeshExact=PassiveMeshExact,
                                 make_xform=make_xform, asarray=jnp.asarray)


def pcg(name):
    dtype = PCG_SCENES[name].get("dtype", np.float32)
    solver, pins = pcg_scene(name, jax_api())
    x0 = np.asarray(solver.x, dtype)
    traj = {"steps": np.asarray(STEPS)}
    trips = []
    for step in range(1, max(STEPS) + 1):
        solver.step()
        trips.append(solver.runtime_data().inner_iters)
        if step in STEPS:
            traj[f"x{step}"] = np.asarray(solver.x, dtype)
    s = solver.m_settings
    _save(name, gravity=GRAVITY, pins=pins, x0=x0, trips=np.asarray(trips),
          linsolver=s.linsolver, requested_linsolver=solver.requested_linsolver,
          pcg_precond=s.pcg_precond, pcg_tol=s.pcg_tol, pcg_max_iters=s.pcg_max_iters,
          **traj)


def contact(name):
    p = CONTACT_SCENES[variant_of(name)[0]]
    dtype = p.get("dtype", np.float32)
    solver = contact_scene(name, jax_api())
    steps, compare = contact_steps(name)
    x0 = np.asarray(solver.x, dtype)
    traj, inner, touching, rows, overflow = {}, [], [], [], []
    for step in range(1, steps + 1):
        solver.step()
        inner.append(solver.runtime_data().inner_iters)
        overflow.append(solver.runtime_data().collision_overflow)
        if step in compare:
            x = np.asarray(solver.x, dtype)
            traj[f"x{step}"] = x
            touching.append(contacts(name, x))
            rows.append(int(np.asarray(solver.state.prev_active).sum()))
    s = solver.m_settings
    _save(name, gravity=GRAVITY, x0=x0, steps=np.asarray(compare), n_steps=steps,
          linsolver=s.linsolver, inner=np.asarray(inner), contacts=np.asarray(touching),
          active_rows=np.asarray(rows), dims=np.asarray(p["dims"]), model=p["model"],
          uzawa_inner=type(solver._solve_data).__name__, pcg_precond=s.pcg_precond,
          overflow=np.asarray(overflow), **traj)


def main(argv):
    prox.set_svd_impl("jacobi")
    writers = {"beam": lambda: beam("neohookean"),
               "beam_free": lambda: beam("neohookean", pinned=False)}
    writers.update({f"beam_{m}": (lambda m=m: beam(m)) for m in BEAM_MODELS})
    writers.update({n: (lambda n=n: cloth(n)) for n in CLOTH_SCENES})
    writers.update({n: (lambda n=n: gather(n)) for n in GATHER_SCENES})
    writers.update({n: (lambda n=n: pcg(n)) for n in PCG_SCENES})
    writers.update({n: (lambda n=n: contact(n)) for n in CONTACT_SCENES})
    variants = {"beam": lambda n: beam("neohookean", name=n), "cloth_limit40": cloth,
                "cloth_wind40": cloth, "floor_alpcg67k": contact}
    writers.update({n: (lambda n=n, base=base: variants[base](n))
                    for n, (base, _) in VARIANT_SCENES.items()})
    names = argv or list(writers)
    for n in names:
        if n not in writers:
            raise SystemExit(f"unknown golden {n!r}; one of {sorted(writers)}")

    def f64(n):
        n = variant_of(n)[0]
        return any("dtype" in scenes.get(n, {})
                   for scenes in (GATHER_SCENES, PCG_SCENES, CONTACT_SCENES))

    # float64 scenes last: jax_enable_x64 stays on once set
    for n in sorted(names, key=f64):
        if f64(n):
            jax.config.update("jax_enable_x64", True)
        writers[n]()


if __name__ == "__main__":
    main(sys.argv[1:])
