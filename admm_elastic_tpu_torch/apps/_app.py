"""The demo apps' headless shell: a port of the JAX package's ``apps/_app.py``.

It replaces the reference's GLFW/OpenGL Application (samples/utils/
Application.hpp) with a headless loop: frame callback -> sim callback ->
step -> optional trajectory and surface export. The reference's screenshot
pipeline (Application.hpp:254-272 + make_video.sh) maps to ``--screenshots
DIR`` (rasterized %05d.png frames, ``utils/render.py``) and ``--video PATH``
(ffmpeg where installed, else an animated GIF), beside the .obj and npz dumps.

The apps run on the card: ``Solver(device="cuda")``, which raises
``RuntimeError`` where there is none. ``--cpu`` runs them on the CPU
(``Solver(device="cpu")``, the kernels' plain PyTorch versions).

Each app is a scene builder (``build``: settings and device in, a ``Scene``
out, None where ``initialize`` fails) and ``main(argv)``, which parses the
flags, builds, runs and prints the app's summary line.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np

from admm_elastic_tpu_torch.config import Settings

@dataclasses.dataclass
class Scene:
    """What an app's builder hands to run(): the initialized solver, the
    per-frame callback, the surfaces to export or render ((vertex offset,
    vertex count, faces) each), the floor's height to draw, and the app's
    own values (pins and their moves, the mesh's tets, ...)."""

    solver: object
    surfaces: list
    sim_cb: Optional[Callable[[int], None]] = None
    floor_y: Optional[float] = None
    extra: dict = dataclasses.field(default_factory=dict)


def parse_cli(settings: Settings, extra=None):
    """The reference's flags (-dt -v -it -g -ls -ck) and the apps' own."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-help", "--help", action="store_true", dest="show_help")
    ap.add_argument("-dt", type=float)
    ap.add_argument("-v", type=int)
    ap.add_argument("-it", type=int)
    ap.add_argument("-g", type=float)
    ap.add_argument("-ls", type=int)
    ap.add_argument("-ck", type=float)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", type=str, default=None, help="npz trajectory output")
    ap.add_argument("--export-objs", type=str, default=None, help="dir for per-frame .obj")
    ap.add_argument("--screenshots", type=str,
                    default=os.environ.get("ADMM_OUTPUT_DIR"),
                    help="dir for rasterized %%05d.png frames "
                         "(reference Application.hpp:254-272 equivalent)")
    ap.add_argument("--video", type=str, default=None,
                    help="assemble screenshots into a video/gif "
                         "(make_video.sh equivalent; implies --screenshots)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (Solver(device='cpu')) instead of the card")
    args = ap.parse_args(extra)
    if args.show_help:
        settings.help()
        raise SystemExit(0)
    if args.dt is not None:
        settings.timestep_s = args.dt
    if args.v is not None:
        settings.verbose = args.v
    if args.it is not None:
        settings.admm_iters = args.it
    if args.g is not None:
        settings.gravity = args.g
    if args.ls is not None:
        settings.linsolver = args.ls
    if args.ck is not None:
        settings.constraint_w = args.ck
    return args


def device_of(args) -> str:
    """The solver's device: the card, or the CPU under --cpu."""
    return "cpu" if args.cpu else "cuda"


def run(solver, args, sim_cb=None, surfaces=None, floor_y=None):
    """The game loop (Application.hpp:227-245, headless): the trajectory
    [frames, N, 3] on the host."""
    traj = []
    t0 = time.perf_counter()
    for frame in range(args.frames):
        if sim_cb is not None:
            sim_cb(frame)
        solver.step()
        traj.append(solver.x)
        if args.export_objs and surfaces:
            os.makedirs(args.export_objs, exist_ok=True)
            _export_frame(traj[-1], surfaces, args.export_objs, frame)
    wall = time.perf_counter() - t0
    n = len(traj)
    print(f"\n{n} frames in {wall:.2f}s ({n / wall:.2f} fps, "
          f"{n * solver.m_settings.admm_iters / wall:.1f} ADMM iters/s)")
    if args.out:
        np.savez(args.out, x=np.stack(traj), dt=solver.m_settings.timestep_s)
        print(f"trajectory -> {args.out}")
    shots = args.screenshots or (
        os.path.join(os.path.dirname(args.video) or ".", "frames")
        if args.video else None)
    if shots and surfaces:
        from admm_elastic_tpu_torch.utils.render import render_trajectory

        paths = render_trajectory(np.stack(traj), surfaces, shots,
                                  video=args.video, floor_y=floor_y)
        print(f"screenshots -> {shots}" +
              (f", video -> {paths[-1]}" if args.video else ""))
    return np.stack(traj)


def run_scene(scene: Optional[Scene], args):
    """run() on a built scene; None where the scene failed to initialize."""
    if scene is None:
        return None
    return run(scene.solver, args, sim_cb=scene.sim_cb, surfaces=scene.surfaces,
               floor_y=scene.floor_y)


def _export_frame(x, surfaces, outdir, frame):
    path = os.path.join(outdir, f"{frame:05d}.obj")
    with open(path, "w") as f:
        off = 0
        for (v_offset, n_verts, faces) in surfaces:
            for i in range(n_verts):
                p = x[v_offset + i]
                f.write(f"v {p[0]} {p[1]} {p[2]}\n")
            for t in faces:
                f.write(f"f {t[0]+1+off} {t[1]+1+off} {t[2]+1+off}\n")
            off += n_verts
