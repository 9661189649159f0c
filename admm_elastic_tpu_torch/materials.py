"""Lame constants (reference ``admm::Lame``, src/EnergyTerm.hpp:34-59).

Plain Python floats, the same values as ``admm_elastic_tpu.materials.Lame``,
and the Xu-spline material curves (``spline_fgh`` and its derivatives, a
port of ``admm_elastic_tpu/materials.py:67-147``) on tensors, with the same
operations in the same order.
"""

from __future__ import annotations

import dataclasses

import torch


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


def lame(k: float, v: float) -> Lame:
    """The reference's two-argument constructor Lame(k, v)."""
    return Lame.from_youngs_poisson(k, v)


# Xu et al. 2015 spline materials: Psi(s) = sum_i f(s_i) + sum_{i<j} g(s_i s_j)
# + h(s1 s2 s3) (src/XuSpline.hpp:48-94). kind is static per element family;
# x_f, x_g, x_h, mu, lam, kappa are same-shape tensors.
SPLINE_NEOHOOKEAN = 0
SPLINE_STVK = 1
SPLINE_COROTATED = 2


def _compress_term(kappa, x):
    # Eq. 16 stabilizer (src/XuSpline.hpp:44)
    c = (1.0 - x) / 6.0
    return (kappa / 12.0) * (c * c * c)


def _d_compress_term(kappa, x):
    c = (1.0 - x) / 6.0
    return (-kappa / 24.0) * (c * c)


def _d2_compress_term(kappa, x):
    return (kappa / 72.0) * ((1.0 - x) / 6.0)


def spline_fgh(kind: int, x_f, x_g, x_h, mu, lam, kappa):
    """(f(x_f), g(x_g), h(x_h)) of the given spline kind."""
    if kind == SPLINE_NEOHOOKEAN:
        f = 0.5 * mu * (x_f * x_f - 1.0)
        g = torch.zeros_like(x_g)
        logx = torch.log(x_h)
        h = -mu * logx + 0.5 * lam * logx * logx + _compress_term(kappa, x_h)
    elif kind == SPLINE_STVK:
        x2 = x_f * x_f
        q = x2 - 1.0
        f = 0.125 * lam * (x2 * x2 - 6.0 * x2 + 5.0) + 0.25 * mu * (q * q)
        g = 0.25 * lam * (x_g * x_g - 1.0)
        h = _compress_term(kappa, x_h)
    elif kind == SPLINE_COROTATED:
        q = x_f - 1.0
        f = 0.5 * lam * (x_f * x_f - 6.0 * x_f + 5.0) + mu * (q * q)
        g = lam * (x_g - 1.0)
        h = _compress_term(kappa, x_h)
    else:
        raise ValueError(f"unknown spline kind {kind}")
    return f, g, h


def spline_dfgh(kind: int, x_f, x_g, x_h, mu, lam, kappa):
    """(df(x_f), dg(x_g), dh(x_h)) of the given spline kind."""
    if kind == SPLINE_NEOHOOKEAN:
        df = mu * x_f
        dg = torch.zeros_like(x_g)
        dh = -mu / x_h + lam * torch.log(x_h) / x_h + _d_compress_term(kappa, x_h)
    elif kind == SPLINE_STVK:
        x2 = x_f * x_f
        df = 0.125 * lam * (4.0 * x2 * x_f - 12.0 * x_f) + mu * x_f * (x2 - 1.0)
        dg = 0.5 * lam * x_g
        dh = _d_compress_term(kappa, x_h)
    elif kind == SPLINE_COROTATED:
        df = 0.5 * lam * (2.0 * x_f - 6.0) + 2.0 * mu * (x_f - 1.0)
        dg = lam + torch.zeros_like(x_g)
        dh = _d_compress_term(kappa, x_h)
    else:
        raise ValueError(f"unknown spline kind {kind}")
    return df, dg, dh


def spline_d2fgh(kind: int, x_f, x_g, x_h, mu, lam, kappa):
    """Second derivatives (d2f, d2g, d2h), for the Newton prox."""
    if kind == SPLINE_NEOHOOKEAN:
        d2f = mu * torch.ones_like(x_f)
        d2g = torch.zeros_like(x_g)
        d2h = ((mu + lam * (1.0 - torch.log(x_h))) / (x_h * x_h)
               + _d2_compress_term(kappa, x_h))
    elif kind == SPLINE_STVK:
        x2 = x_f * x_f
        d2f = 0.125 * lam * (12.0 * x2 - 12.0) + mu * (3.0 * x2 - 1.0)
        d2g = 0.5 * lam * torch.ones_like(x_g)
        d2h = _d2_compress_term(kappa, x_h)
    elif kind == SPLINE_COROTATED:
        d2f = (lam + 2.0 * mu) * torch.ones_like(x_f)
        d2g = torch.zeros_like(x_g)
        d2h = _d2_compress_term(kappa, x_h)
    else:
        raise ValueError(f"unknown spline kind {kind}")
    return d2f, d2g, d2h
