"""State checkpoint / resume.

A port of ``admm_elastic_tpu/utils/checkpoint.py``. The reference has none
(its whole state is m_x, m_v); the SimState is the entire checkpoint: x, v,
the contact multipliers y and the last active rows, written to an npz file
under the JAX package's keys, so that a file written by either package loads
in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from admm_elastic_tpu_torch.system.system import SimState


def save_state(path: str, state: SimState, **extra):
    """Write state (and any extra arrays) to the npz file path."""
    np.savez(
        path,
        x=state.x.detach().cpu().numpy(),
        v=state.v.detach().cpu().numpy(),
        y=state.y.detach().cpu().numpy(),
        prev_active=state.prev_active.detach().cpu().numpy(),
        **extra,
    )


def load_state(path: str, dtype=None, *, device) -> SimState:
    """A SimState on ``device`` from the npz file path; the floats in
    ``dtype`` (a torch dtype), or in the file's own where None."""
    def cast(a):
        t = torch.from_numpy(np.array(a))  # a copy: np.load's arrays are read-only
        return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)

    with np.load(path) as data:
        # Round-1 checkpoints stored an i32 count ("n_active_prev"); migrate to
        # the mask form conservatively: all False resets the Uzawa warm start
        # on the first solve after the load, which is always safe.
        prev = (np.asarray(data["prev_active"], dtype=bool) if "prev_active" in data
                else np.zeros(data["y"].shape, dtype=bool))
        return SimState(x=cast(data["x"]), v=cast(data["v"]), y=cast(data["y"]),
                        prev_active=torch.from_numpy(prev).to(device))
