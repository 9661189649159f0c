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


TET_MODELS = (TET_LINEAR, TET_NEOHOOKEAN, TET_STVK, TET_SPLINE_NH, TET_SPLINE_STVK,
              TET_SPLINE_COROT)

# Spline kinds of materials.spline_fgh (SPLINE_NEOHOOKEAN, _STVK, _COROTATED).
SPLINE_KIND = {TET_SPLINE_NH: 0, TET_SPLINE_STVK: 1, TET_SPLINE_COROT: 2}


def check_model(model: str) -> None:
    """Raise for a name that is not one of the six tet models."""
    if model not in TET_MODELS:
        raise ValueError(f"unknown hyperelastic model {model!r}")


def prox_pin(zi: torch.Tensor, target: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Snap to the pin target when active, identity otherwise
    (src/SpringEnergyTerm.hpp:61)."""
    return torch.where(active[:, None], target, zi)
