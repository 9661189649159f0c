"""Analytic passive obstacles as batched signed-distance evaluations.

A port of ``Floor``, ``Sphere`` and ``detect_passive`` of
``admm_elastic_tpu/collision/passive.py`` (:36-73, :718-750; the reference's
src/PassiveObject.hpp:32-64). ``signed_distance(x)`` takes x [..., 3] and
returns (dx [...], point [..., 3], normal [..., 3]): dx < 0 is penetration,
point the surface projection and normal the outward contact normal.

The obstacles are frozen dataclasses of tensors. A Python number or a numpy
array is held as a float64 tensor, so that the solver's ``to(device, dtype)``
at ``initialize`` rounds it once, as the JAX package's ``jnp.asarray`` does.
The mesh obstacles (``PassiveMeshSDF``, ``PassiveMeshExact``) are not ported
yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def norm3(d: torch.Tensor) -> torch.Tensor:
    """|d| over the last axis: torch.linalg.norm, whose float64 result on the
    CPU is jnp.linalg.norm's bit for bit."""
    return torch.linalg.norm(d, dim=-1)


@dataclasses.dataclass(frozen=True)
class Floor:
    """y-plane floor (src/PassiveObject.hpp:32-45)."""

    y: torch.Tensor  # scalar
    # the normal (0, 1, 0) on y's device, made once: a step captured as a CUDA
    # graph copies nothing from the host
    unit_y: torch.Tensor = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        y = _tensor(self.y)
        object.__setattr__(self, "y", y)
        object.__setattr__(self, "unit_y", torch.tensor([0.0, 1.0, 0.0], dtype=y.dtype,
                                                        device=y.device))

    def to(self, device, dtype) -> "Floor":
        return Floor(y=self.y.to(device=device, dtype=dtype))

    def signed_distance(self, x):
        dx = x[..., 1] - self.y
        point = torch.stack([x[..., 0], self.y.expand(x[..., 1].shape), x[..., 2]], dim=-1)
        # a constant broadcast, as the JAX package writes it
        normal = self.unit_y.to(x.dtype).expand(x.shape)
        return dx, point, normal


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Analytic sphere obstacle (src/PassiveObject.hpp:48-64)."""

    center: torch.Tensor  # [3]
    rad: torch.Tensor  # scalar

    def __post_init__(self):
        object.__setattr__(self, "center", _tensor(self.center))
        object.__setattr__(self, "rad", _tensor(self.rad))

    def to(self, device, dtype) -> "Sphere":
        return Sphere(center=self.center.to(device=device, dtype=dtype),
                      rad=self.rad.to(device=device, dtype=dtype))

    def signed_distance(self, x):
        dir_ = x - self.center
        dist = norm3(dir_)
        dx = dist - self.rad
        n = dir_ / torch.clamp_min(dist, 1e-30)[..., None]
        point = self.center + n * self.rad
        return dx, point, n


ANALYTIC = (Floor, Sphere)


def check_obstacle(obj) -> None:
    """Raise for an obstacle this package does not run."""
    if not isinstance(obj, ANALYTIC):
        raise NotImplementedError(
            f"{type(obj).__name__}: only the analytic Floor and Sphere are ported; mesh "
            "obstacles (PassiveMeshSDF, PassiveMeshExact) are not yet (ROADMAP Queue 1 item 9)")


def detect_passive(obstacles, xs):
    """Deepest passive hit per query point across all obstacles
    (Collider::detect's payload-min, src/Collider.hpp:178-189): the first
    obstacle of least dx wins. Returns (dx, point, normal, hit_mask,
    overflow); overflow is False (an analytic obstacle drops nothing)."""
    ovf = torch.zeros((), dtype=torch.bool, device=xs.device)
    if not obstacles:
        z3 = torch.zeros(xs.shape, dtype=xs.dtype, device=xs.device)
        big = torch.full(xs.shape[:-1], torch.finfo(xs.dtype).max, dtype=xs.dtype,
                         device=xs.device)
        return big, z3, z3, torch.zeros(xs.shape[:-1], dtype=torch.bool, device=xs.device), ovf
    if len(obstacles) == 1:  # the argmin of one picks it
        d, p, n = obstacles[0].signed_distance(xs)
        return d, p, n, d < 0.0, ovf
    found = [obs.signed_distance(xs) for obs in obstacles]
    dx = torch.stack([f[0] for f in found], dim=0)  # [O, ...]
    best = torch.argmin(dx, dim=0)  # the first least

    def pick(k):
        arr = torch.stack([f[k] for f in found], dim=0)
        return torch.take_along_dim(arr, best[None, ..., None], dim=0)[0]

    d_best = torch.take_along_dim(dx, best[None, ...], dim=0)[0]
    return d_best, pick(1), pick(2), d_best < 0.0, ovf
