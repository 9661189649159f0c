"""Pin prox, the tet model names and the element energies (from
``admm_elastic_tpu/ops/prox.py``)."""

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


# --- element energies (admm_elastic_tpu/ops/prox.py:96-103, 250-260, 286-289) ---
# The JAX package evaluates them outside any Pallas kernel, and so do these:
# plain PyTorch on every device.

# Jacobi sweeps of the energy's signed SVD: the JAX package's _SVD_SWEEPS.
ENERGY_SVD_SWEEPS = 10


def _times_measure(measure: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """measure * value, exactly 0 where the measure is 0 (a stencil's dead
    lanes), whatever the value there (never 0 * inf = NaN)."""
    return torch.where(measure == 0.0, torch.zeros_like(value), measure * value)


def energy_tet_linear(F: torch.Tensor, k: torch.Tensor, vol: torch.Tensor) -> torch.Tensor:
    """0.5 k V ||sigma - 1||^2 of F [T, 3, 3] with the unsigned singular
    values, all nonnegative even for an inverted F (src/TetEnergyTerm.cpp:94-101)."""
    S = torch.linalg.svdvals(F)
    return _times_measure(vol, 0.5 * k * ((S - 1.0) ** 2).sum(dim=-1))


def energy_tet_hyper(F: torch.Tensor, model: str, mu, lam, kappa, k,
                     vol: torch.Tensor) -> torch.Tensor:
    """Per-element energy of F [T, 3, 3], volume-scaled, as
    HyperElasticTet::energy (src/TetEnergyTerm.cpp:139-151) with its quirk:
    the quadratic penalty is anchored at the signed stretches s0 and
    evaluated at |S2|, so an inverted element adds 4 k/2 S2^2. The signed
    SVD is the Jacobi SoA body that kernel A shares."""
    from admm_elastic_tpu_torch.ops import hyper_soa, soa

    check_model(model)
    f = tuple(F[:, i, j] for i in range(3) for j in range(3))
    _, s0, _ = soa.signed_svd3_soa(f, sweeps=ENERGY_SVD_SWEEPS)
    value, _, _ = hyper_soa._vgh_soa(model, mu, lam, kappa, k, s0)
    return _times_measure(vol, value((s0[0], s0[1], torch.abs(s0[2]))))


def energy_tri(F: torch.Tensor, k: torch.Tensor, area: torch.Tensor) -> torch.Tensor:
    """0.5 k a ||F - P||^2 of F [T, 3, 2], P its polar rotation
    (src/TriEnergyTerm.cpp:104-114)."""
    from admm_elastic_tpu_torch.ops import soa

    f = tuple(F[:, i, j] for i in range(3) for j in range(2))
    P = soa.polar_rotation_3x2_tuple(f)
    return _times_measure(area, 0.5 * k * sum((fi - pi) ** 2 for fi, pi in zip(f, P)))
