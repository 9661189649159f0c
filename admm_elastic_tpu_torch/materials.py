"""Lame constants (reference ``admm::Lame``, src/EnergyTerm.hpp:34-59).

Plain Python floats, the same values as ``admm_elastic_tpu.materials.Lame``.
The Xu-spline material curves are not part of this package yet.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Lame:
    """Lame constants with optional hard strain limits (cloth)."""

    mu: float = 0.0
    lam: float = 0.0
    limit_min: float = -100.0
    limit_max: float = 100.0

    @classmethod
    def from_youngs_poisson(cls, k: float, v: float) -> "Lame":
        mu = k / (2.0 * (1.0 + v))
        lam = k * v / ((1.0 + v) * (1.0 - 2.0 * v))
        return cls(mu=mu, lam=lam)

    # Presets (reference: src/EnergyTerm.hpp:37-39)
    @classmethod
    def rubber(cls) -> "Lame":
        return cls.from_youngs_poisson(10000000, 0.499)

    @classmethod
    def soft_rubber(cls) -> "Lame":
        return cls.from_youngs_poisson(10000000, 0.399)

    @classmethod
    def very_soft_rubber(cls) -> "Lame":
        return cls.from_youngs_poisson(1000000, 0.299)

    def bulk_modulus(self) -> float:
        return self.lam + (2.0 / 3.0) * self.mu
