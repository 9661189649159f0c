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
- the self-collision scenes (chip_smoke.SELFCOLL_SCENES, built by
  chip_smoke.boxes_scene with this package's API, float32 with
  jax_enable_x64 off, so that the colliders' rest vertices are float32 as the
  port's): boxes_gs8, boxes_uzawa8, boxes_alpcg8 (14 steps) and boxes_gs20
  (12), each holding x at step 1, at the first step whose state shows a
  dynamic hit and at the last (``steps``), the dynamic hits of every step's
  state (``hits``: the JAX package's _detect without the passive rows), the
  inner iterations and collision_overflow of every step, and the two boxes'
  vertex count (``n_box``); for each held step k after the first, the state
  that step starts from (``s{k}_x``, ``_v``, ``_y``, ``_prev_active``) and a
  control: the same step from that state with x one ulp up (np.nextafter),
  its gap to x{k} relative to max |x| (``ctl{k}_gap``), its dynamic hits and
  its inner iterations;
- the variants (chip_smoke.VARIANT_SCENES): beam_aa4, cloth_aa4 and
  floor_alpcg67k_aa4, the beam, cloth_limit40 and floor_alpcg67k with Anderson
  acceleration (aa_window=4), and cloth_wind40_seq, cloth_wind40 with the
  sequential wind (WindForce(sequential=True)), each stored as its base is;
- the scenario batches (chip_smoke.BATCH_SCENES, built by
  chip_smoke.batch_scene with this package's API and stepped by its
  parallel.batch.make_batched_step, mesh None): batch_beam_sweep8
  (benchmarks/scaling.py:36-47's beam sweep, 8 scenes, stiffness_scale 0.25,
  0.5, 1, 2, 4, 1, 1, 0.5 and gravity -9.8 x5, -5, -15, -15), batched_contact_alpcg
  (crossval's batched scene, benchmarks/crossval.py:183-203: 4 scenes,
  scales 0.5, 1, 2, 4, gravity -9.8, -9.8, -5, -15), in float32 and float64
  (batched_contact_alpcg_f64), batch_cloth_sweep4 (the cloth-limit-40 sheet
  under PCG, scales 0.5, 1, 2, 4) and batch_lattice_stencil (a 20x20x20
  neo-Hookean lattice, scales 0.5 and 2); each holds every scene's x after
  steps 1 and 8, the sweep (``scales``, ``gravity``) and the batch's
  overflow flags after step 8; batch_floor_uzawa5k (floor_uzawa5k's
  beam, floor and Uzawa settings) and batch_slab_exact_alpcg5k (the bench beam
  over slab_exact_gs5k's exact slab, AL-PCG), four scenes at scales 0.5, 1, 2,
  4 and gravity -9.8, -9.8, -5, -15, held at steps 1, 12 and 20, each with the
  batch before each held step after the first (``s{k}_x``, ``_v``, ``_y``,
  ``_prev_active``, ``_overflow``) and that step's one-ulp control gap
  (``ctl{k}_gap``); batched_contact_uzawa (crossval's scene under Uzawa, also
  batched_contact_uzawa_f64) and batch_exactmesh_alpcg (tests/
  test_parallel.py:224-270's scene, float64, held at 1, 8 and 30); every new
  scene with the overflow flags after each held step (``ovf{k}``); every batch
  with each scene's least y over its rollout (``min_y``);
- the demo apps (chip_smoke.APP_RUNS: app_beams, app_trianglestrain,
  app_bunnyexpand, app_bunnyexpand_rand, app_signorini, app_signorini_sdf,
  app_signorini_exact, app_torus, app_boxes): the JAX package's apps/<name>.py
  main() at its own scene and default settings with run() replaced
  (jax_app), float32, 24 steps; x after the held steps
  (chip_smoke.app_held_steps), the least y, each step's inner iterations and
  dynamic hits, bunnyexpand's last inverted tets, and for every app without a
  per-frame callback the state before each held step and its one-ulp control;
  app_bunnyexpand_f64, bunnyexpand's collapse after steps 1 and 8 and its
  scramble after one step of 1, 2 and 3 ADMM iterations, in float64
  (app_bunnyexpand_f64).

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
from chip_smoke import (APP_FRAMES, APP_RUNS, BATCH_SCENES, batch_steps,  # noqa: E402
                        BEAM_FLAGS, BEAM_MODELS, BUNNY, CLOTH_SCENES, CONTACT_SCENES, GATHER_SCENES,
                        PCG_SCENES, SELFCOLL_SCENES, VARIANT_SCENES, app_held_steps,
                        batch_scene, boxes_scene, bunny_pins, cloth_sheet, contact_scene, contact_steps,
                        contacts, pcg_scene, renumbered_sheet, variant_of)

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
    np.savez_compressed(out, **{"admm_iters": ADMM_ITERS, "dt": DT, **arrays})
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


def dynamic_hits(solver, x):
    """The dynamic hits of the JAX solver's query vertices at x (its _detect
    without the passive rows)."""
    from admm_elastic_tpu.solver import _detect

    h = _detect(tuple(solver.obstacles), tuple(solver.colliders), x, solver._surf_inds_dev, False,
                solver._dtype, solver._surf_dense)
    return int(np.asarray(h.d_mask).sum())


def selfcoll(name):
    import dataclasses

    p = SELFCOLL_SCENES[name]
    solver, n_box = boxes_scene(name, jax_api())
    x0 = np.asarray(solver.x, np.float32)
    xs, inner, overflow, hits, states = {}, [], [], [], {}
    for step in range(1, p["steps"] + 1):
        states[step] = solver.state
        solver.step()
        inner.append(solver.runtime_data().inner_iters)
        overflow.append(solver.runtime_data().collision_overflow)
        hits.append(dynamic_hits(solver, solver.state.x))
        xs[step] = np.asarray(solver.x, np.float32)
    first = next((k + 1 for k, h in enumerate(hits) if h > 0), None)
    if first is None:
        raise SystemExit(f"{name}: no dynamic hit in {p['steps']} steps")
    compare = sorted({1, first, p["steps"]})
    # each held step after the first once more from the state before it, with
    # x moved by one ulp: how far the package parts from itself in one step
    held, control = {}, {}
    for k in compare[1:]:
        st = states[k]
        held.update({f"s{k}_{f}": np.asarray(getattr(st, f)) for f in
                     ("x", "v", "y", "prev_active")})
        xu = np.asarray(st.x)
        solver.state = dataclasses.replace(st, x=jax.numpy.asarray(
            np.nextafter(xu, np.inf, dtype=xu.dtype)))
        solver.step()
        xc = np.asarray(solver.x, np.float32)
        control[f"ctl{k}_gap"] = float(np.abs(xc - xs[k]).max() / np.abs(xs[k]).max())
        control[f"ctl{k}_hits"] = dynamic_hits(solver, solver.state.x)
        control[f"ctl{k}_inner"] = solver.runtime_data().inner_iters
        print(f"{name} step {k} from the state before with x one ulp off: "
              f"{control[f'ctl{k}_gap']:.3e} of max |x|, {control[f'ctl{k}_hits']} hits "
              f"(the run's {hits[k - 1]}), {control[f'ctl{k}_inner']} inner iterations "
              f"(the run's {inner[k - 1]})")
    s = solver.m_settings
    _save(name, gravity=s.gravity, x0=x0, steps=np.asarray(compare), n_steps=p["steps"],
          linsolver=s.linsolver, inner=np.asarray(inner), overflow=np.asarray(overflow),
          hits=np.asarray(hits), n_box=n_box, uzawa_inner=type(solver._solve_data).__name__,
          **{f"x{k}": xs[k] for k in compare}, **held, **control)


def jax_app(name, drive, frames=APP_FRAMES, argv=()):
    """Run the JAX package's apps/<module>.py main() for one of APP_RUNS with
    its run() replaced by drive(solver, sim_cb, frames), whose result stands
    for the trajectory: the app's own scene, settings and callback, stepped
    as the caller likes. boxes reads its box768 from a directory with none
    in it, so that it builds the 8^3 block as the port's does. Returns what
    the app handed to run()."""
    import importlib
    import tempfile

    module, lead = APP_RUNS[name]
    apps = os.path.join(ROOT, "apps")
    if apps not in sys.path:
        sys.path.insert(0, apps)
    mod = importlib.import_module(module)
    got = {}

    def fake_run(solver, args, sim_cb=None, surfaces=None, floor_y=None):
        got.update(solver=solver, sim_cb=sim_cb, surfaces=surfaces, floor_y=floor_y)
        got["traj"] = drive(solver, sim_cb, args.frames)
        return got["traj"]

    kept = mod.run, getattr(mod, "DATA", None)
    with tempfile.TemporaryDirectory() as empty:
        mod.run = fake_run
        if kept[1] is not None:
            mod.DATA = empty
        try:
            rc = mod.main(list(lead) + ["--frames", str(frames), "-v", "0"] + list(argv))
        finally:
            mod.run = kept[0]
            if kept[1] is not None:
                mod.DATA = kept[1]
    if rc:
        raise SystemExit(f"{name}: the JAX app exited with {rc}")
    return got


def app(name):
    """One of APP_RUNS: x after each held step (app_held_steps), the least y
    of the run, the last step's inverted tets and finiteness (bunnyexpand),
    the inner iterations and the dynamic hits of every step; for an app
    without a per-frame callback (all but beams), the state before each held
    step and that step once more from it with x one ulp up (as selfcoll)."""
    import dataclasses

    rec = {"xs": [], "states": [], "hits": [], "inner": []}

    def drive(solver, sim_cb, frames):
        for f in range(frames):
            if sim_cb is not None:
                sim_cb(f)
            rec["states"].append(solver.state)
            solver.step()
            rec["xs"].append(np.asarray(solver.x, np.float32))
            rec["inner"].append(solver.runtime_data().inner_iters)
            if solver.colliders:
                rec["hits"].append(dynamic_hits(solver, solver.state.x))
        return np.stack(rec["xs"])

    got = jax_app(name, drive)
    solver, xs = got["solver"], rec["xs"]
    held = app_held_steps(name, xs, rec["hits"])
    out = {f"x{k}": xs[k - 1] for k in held}
    if got["sim_cb"] is None:  # a held step from the state before it needs no callback
        for k in held:
            st = rec["states"][k - 1]
            out.update({f"s{k}_{f}": np.asarray(getattr(st, f)) for f in
                        ("x", "v", "y", "prev_active")})
            xu = np.asarray(st.x)
            solver.state = dataclasses.replace(st, x=jax.numpy.asarray(
                np.nextafter(xu, np.inf, dtype=xu.dtype)))
            solver.step()
            xc = np.asarray(solver.x, np.float32)
            out[f"ctl{k}_gap"] = float(np.abs(xc - xs[k - 1]).max() / np.abs(xs[k - 1]).max())
            print(f"{name} step {k} from the state before with x one ulp off: "
                  f"{out[f'ctl{k}_gap']:.3e} of max |x|")
    if APP_RUNS[name][0] == "bunnyexpand":
        from admm_elastic_tpu.geometry.mesh import tet_volumes

        vols = tet_volumes(xs[-1].astype(np.float64), np.asarray(solver.system.tets[0].inds))
        out["inverted"] = int(((vols <= 0) | ~np.isfinite(vols)).sum())
    s = solver.m_settings
    _save(f"app_{name}", steps=np.asarray(held), n_steps=len(xs), admm_iters=s.admm_iters,
          dt=s.timestep_s, linsolver=s.linsolver, x0=np.asarray(rec["states"][0].x, np.float32),
          min_y=float(min(x[:, 1].min() for x in xs)), inner=np.asarray(rec["inner"]),
          hits=np.asarray(rec["hits"]), finite=bool(np.isfinite(xs[-1]).all()), **out)


def app_bunnyexpand_f64():
    """bunnyexpand in float64 (chip_smoke.APP_F64): x after steps 1 and 8 of
    the collapse (x1, x8); the scramble (x0_rand) and x after one step of it
    with 1, 2 and 3 ADMM iterations (it1-it3, the app's -it); each but x1 with
    its one-ulp control (ctl_<key>: that step once more from the state before
    it with x one ulp up; at the all-zero state before x1 one ulp up is a
    denormal, which XLA's CPU flushes to 0)."""
    import dataclasses

    def one_ulp_gap(solver, state, want):
        xu = np.asarray(state.x)
        solver.state = dataclasses.replace(state, x=jax.numpy.asarray(
            np.nextafter(xu, np.inf, dtype=xu.dtype)))
        solver.step()
        return float(np.abs(np.asarray(solver.x) - want).max() / np.abs(want).max())

    states, xs = [], []

    def collapse(solver, sim_cb, frames):
        for _ in range(frames):
            states.append(solver.state)
            solver.step()
            xs.append(np.asarray(solver.x))
        return np.stack(xs)

    solver = jax_app("bunnyexpand", collapse, frames=8)["solver"]
    out = {"x1": xs[0], "x8": xs[7], "ctl_x8": one_ulp_gap(solver, states[7], xs[7])}
    for k in (1, 2, 3):
        got = {}

        def scramble(solver, sim_cb, frames):
            got["state"] = solver.state
            solver.step()
            got["x"] = np.asarray(solver.x)
            return got["x"][None]

        solver = jax_app("bunnyexpand_rand", scramble, frames=1, argv=("-it", str(k)))["solver"]
        out["x0_rand"] = np.asarray(got["state"].x)
        out[f"it{k}"] = got["x"]
        out[f"ctl_it{k}"] = one_ulp_gap(solver, got["state"], got["x"])
    for key, v in out.items():
        if key.startswith("ctl"):
            print(f"bunnyexpand float64 {key[4:]}: the one-ulp control {v:.3e} of max |x|")
    assert all(v.dtype == np.float64 for k, v in out.items() if not k.startswith("ctl"))
    _save("app_bunnyexpand_f64", **out)


def batch(name):
    import dataclasses

    import jax.numpy as jnp

    from admm_elastic_tpu.parallel.batch import make_batched_step, make_scenario_batch

    p = BATCH_SCENES[name]
    dtype = p.get("dtype", np.float32)
    solver, scales, gravity = batch_scene(name, jax_api())
    step = make_batched_step(solver, mesh=None, donate=False)
    b = make_scenario_batch(solver, len(scales), stiffness_scale=scales, gravity=gravity)
    steps = batch_steps(name)
    traj = {"steps": np.asarray(steps)}
    states = {}
    min_y = np.full(len(scales), np.inf)
    for k in range(1, max(steps) + 1):
        if p.get("onestep"):
            states[k] = b
        b = step(b)
        min_y = np.minimum(min_y, np.asarray(b.x, np.float64)[..., 1].min(axis=1))
        if k in steps:
            traj[f"x{k}"] = np.asarray(b.x, dtype)
            traj[f"ovf{k}"] = np.asarray(b.overflow)
    # each held step after the first once more from the batch before it, with
    # x one ulp up: how far the package parts from itself in one step
    for k in (steps[1:] if p.get("onestep") else ()):
        st = states[k]
        traj.update({f"s{k}_{f}": np.asarray(getattr(st, f))
                     for f in ("x", "v", "y", "prev_active", "overflow")})
        xu = np.asarray(st.x)
        ctl = step(dataclasses.replace(st, x=jnp.asarray(np.nextafter(xu, np.inf, dtype=xu.dtype))))
        xk = traj[f"x{k}"].astype(np.float64)
        traj[f"ctl{k}_gap"] = float(np.abs(np.asarray(ctl.x, np.float64) - xk).max()
                                    / np.abs(xk).max())
        print(f"{name} step {k} from the batch before with x one ulp up: "
              f"{traj[f'ctl{k}_gap']:.3e} of max |x|")
    _save(name, scales=scales, gravity=gravity, overflow=np.asarray(b.overflow), min_y=min_y,
          **traj)


def main(argv):
    prox.set_svd_impl("jacobi")
    writers = {"beam": lambda: beam("neohookean"),
               "beam_free": lambda: beam("neohookean", pinned=False)}
    writers.update({f"beam_{m}": (lambda m=m: beam(m)) for m in BEAM_MODELS})
    writers.update({n: (lambda n=n: cloth(n)) for n in CLOTH_SCENES})
    writers.update({n: (lambda n=n: gather(n)) for n in GATHER_SCENES})
    writers.update({n: (lambda n=n: pcg(n)) for n in PCG_SCENES})
    writers.update({n: (lambda n=n: contact(n)) for n in CONTACT_SCENES})
    writers.update({n: (lambda n=n: selfcoll(n)) for n in SELFCOLL_SCENES})
    writers.update({f"app_{n}": (lambda n=n: app(n)) for n in APP_RUNS})
    writers["app_bunnyexpand_f64"] = app_bunnyexpand_f64
    writers.update({n: (lambda n=n: batch(n)) for n in BATCH_SCENES})
    variants = {"beam": lambda n: beam("neohookean", name=n), "cloth_limit40": cloth,
                "cloth_wind40": cloth, "floor_alpcg67k": contact}
    writers.update({n: (lambda n=n, base=base: variants[base](n))
                    for n, (base, _) in VARIANT_SCENES.items()})
    names = argv or list(writers)
    for n in names:
        if n not in writers:
            raise SystemExit(f"unknown golden {n!r}; one of {sorted(writers)}")

    def f64(n):
        if n == "app_bunnyexpand_f64":
            return True
        n = variant_of(n)[0]
        return any("dtype" in scenes.get(n, {})
                   for scenes in (GATHER_SCENES, PCG_SCENES, CONTACT_SCENES, BATCH_SCENES))

    # float64 scenes last: jax_enable_x64 stays on once set
    for n in sorted(names, key=f64):
        if f64(n):
            jax.config.update("jax_enable_x64", True)
        writers[n]()


if __name__ == "__main__":
    main(sys.argv[1:])
