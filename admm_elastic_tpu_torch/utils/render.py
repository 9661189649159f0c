"""Headless screenshots and video (a copy of ``admm_elastic_tpu/utils/render.py``).

The reference Application saves GL framebuffer screenshots to
ADMMELASTIC_OUTPUT_DIR/%05d.png each frame (samples/utils/
Application.hpp:254-272) and assembles them with ffmpeg
(samples/utils/make_video.sh). This headless equivalent rasterizes the
simulation surfaces with matplotlib (painter's-algorithm Poly3DCollection
with Lambert shading, no GL context) and assembles frames into a video with
ffmpeg where it is installed, else into an animated GIF with PIL. It works on
host numpy arrays. matplotlib and PIL are imported inside the functions that
use them: a run that asks for no picture needs neither, and one that does
fails with their ImportError where they are missing.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Surface spec: (vertex_offset, n_verts, faces [F,3] local) — the same
# tuples apps pass for .obj export.
Surface = Tuple[int, int, np.ndarray]

_LIGHT = np.array([0.35, 0.65, 0.67])
_COLORS = [(0.72, 0.45, 0.20), (0.25, 0.55, 0.75), (0.45, 0.70, 0.35),
           (0.70, 0.35, 0.60)]


def render_frame(x: np.ndarray, surfaces: Sequence[Surface], path: str,
                 bounds=None, elev: float = 18.0, azim: float = -60.0,
                 floor_y: Optional[float] = None, dpi: int = 110):
    """Rasterize the scene state to one PNG screenshot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(6.4, 4.8), dpi=dpi)
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)

    # Simulation space is y-up; matplotlib 3D is z-up. Display mapping:
    # (x, y, z)_sim -> (x, z, y)_mpl.
    P = [0, 2, 1]

    if bounds is None:
        lo, hi = x.min(axis=0), x.max(axis=0)
        pad = 0.1 * max(float((hi - lo).max()), 1e-6)
        bounds = (lo - pad, hi + pad)
    lo, hi = bounds
    span = float(np.max(np.asarray(hi) - np.asarray(lo)))

    # One combined collection: matplotlib's painter sort works per
    # collection, so floor + meshes must share one for correct occlusion.
    all_tris = []
    all_cols = []
    if floor_y is not None:
        cx = 0.5 * (lo[0] + hi[0])
        cz = 0.5 * (lo[2] + hi[2])
        s = 0.75 * span
        q = np.array([[cx - s, floor_y, cz - s], [cx + s, floor_y, cz - s],
                      [cx + s, floor_y, cz + s], [cx - s, floor_y, cz + s]])
        all_tris += [q[[0, 1, 2]], q[[0, 2, 3]]]
        all_cols += [(0.82, 0.82, 0.84)] * 2

    for si, (off, n, faces) in enumerate(surfaces):
        verts = x[off:off + n]
        tris = verts[np.asarray(faces)]  # [F, 3, 3]
        nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
        lam = np.clip(nrm @ _LIGHT, 0.0, 1.0)
        base = np.asarray(_COLORS[si % len(_COLORS)])
        cols = 0.25 * base + 0.75 * base * lam[:, None]
        all_tris += list(tris)
        all_cols += [tuple(c) for c in cols]

    pc = Poly3DCollection([t[:, P] for t in all_tris], facecolors=all_cols,
                          edgecolors=(0, 0, 0, 0.08), linewidths=0.15)
    ax.add_collection3d(pc)

    ax.set_xlim(lo[0], lo[0] + span)
    ax.set_ylim(lo[2], lo[2] + span)  # sim z on the mpl depth axis
    ax.set_zlim(lo[1], lo[1] + span)  # sim y up
    ax.set_box_aspect((1, 1, 1))
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path)
    plt.close(fig)


def frames_to_video(frame_dir: str, out_path: str, fps: int = 24) -> str:
    """Assemble %05d.png frames into a video.

    ffmpeg when present (the reference's make_video.sh pipeline), else an
    animated GIF via PIL. Returns the path actually written.
    """
    pattern = os.path.join(frame_dir, "%05d.png")
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i", pattern,
             "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True, timeout=600,
        )
        return out_path
    except (FileNotFoundError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        pass
    from PIL import Image

    frames = sorted(
        f for f in os.listdir(frame_dir) if f.endswith(".png")
    )
    if not frames:
        raise FileNotFoundError(f"no .png frames in {frame_dir}")
    imgs = [Image.open(os.path.join(frame_dir, f)).convert("P")
            for f in frames]
    gif = os.path.splitext(out_path)[0] + ".gif"
    imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return gif


def render_trajectory(traj: np.ndarray, surfaces: Sequence[Surface],
                      out_dir: str, video: Optional[str] = None,
                      fps: int = 24, floor_y: Optional[float] = None,
                      stride: int = 1, follow: bool = False) -> List[str]:
    """Render every stride-th frame of a [T,N,3] trajectory to out_dir
    (%05d.png, reference naming) and optionally assemble a video.

    follow=True keeps a fixed view span (sized from the FINAL frame) but
    re-centers every frame on its own median — the right framing for
    scenes whose body translates or whose transients overshoot wildly
    (e.g. inversion-recovery scrambles); the default fixed-bounds framing
    suits drops onto a floor."""
    os.makedirs(out_dir, exist_ok=True)
    flat = traj.reshape(-1, 3)
    finite = flat[np.isfinite(flat).all(axis=1)]
    if len(finite) == 0:
        raise ValueError("render_trajectory: no finite positions")
    if follow:
        last = traj[-1]
        last = last[np.isfinite(last).all(axis=1)]
        span = 1.6 * max(float((last.max(0) - last.min(0)).max()), 1e-6)
    else:
        # Robust fixed bounds: extreme transients must not blow the frame
        # up; 1st/99th percentiles frame the bulk of all positions.
        lo = np.percentile(finite, 1.0, axis=0)
        hi = np.percentile(finite, 99.0, axis=0)
        pad = 0.05 * max(float((hi - lo).max()), 1e-6)
        bounds = (lo - pad, hi + pad)
    paths = []
    for k, x in enumerate(traj[::stride]):
        x = np.asarray(x)
        if follow:
            xf = x[np.isfinite(x).all(axis=1)]
            c = (np.median(xf, axis=0) if len(xf) else np.zeros(3))
            bounds = (c - span / 2.0, c + span / 2.0)
        p = os.path.join(out_dir, f"{k:05d}.png")
        render_frame(x, surfaces, p, bounds=bounds, floor_y=floor_y)
        paths.append(p)
    if video is not None:
        paths.append(frames_to_video(out_dir, video, fps=fps))
    return paths
