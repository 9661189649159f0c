"""Pin prox and the tet model names (from ``admm_elastic_tpu/ops/prox.py``)."""

from __future__ import annotations

import torch

# Model ids for tet families, as in the JAX package.
TET_LINEAR = "linear"
TET_NEOHOOKEAN = "neohookean"
TET_STVK = "stvk"
TET_SPLINE_NH = "spline_nh"
TET_SPLINE_STVK = "spline_stvk"
TET_SPLINE_COROT = "spline_corot"


def check_model(model: str) -> None:
    """Raise for a tet model this package does not run yet."""
    if model == TET_NEOHOOKEAN:
        return
    if model in (TET_LINEAR, TET_STVK, TET_SPLINE_NH, TET_SPLINE_STVK, TET_SPLINE_COROT):
        raise NotImplementedError(
            f"tet model {model!r} is not ported yet; only 'neohookean' runs "
            "(ROADMAP Queue 1 item 5)")
    raise ValueError(f"unknown hyperelastic model {model!r}")


def prox_pin(zi: torch.Tensor, target: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Snap to the pin target when active, identity otherwise
    (src/SpringEnergyTerm.hpp:61)."""
    return torch.where(active[:, None], target, zi)
