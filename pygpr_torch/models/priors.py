"""Hyperparameter priors for MAP fits.

Counterpart of ``pygpr_tpu/models/priors.py``: independent priors over
the positive hyperparameters θ = [σ, ℓ…, σₙ], their summed log density,
and that density at u = log θ for a Markov chain over u
(:func:`log_prior_u`).  ``None`` entries are
improper flat, so a prior can target one hyperparameter.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor


class Prior:
    """Scalar prior over one positive hyperparameter θᵢ > 0."""

    def log_prob(self, theta: Tensor) -> Tensor:
        raise NotImplementedError


class LogNormal(Prior):
    """``log θ ~ N(mu, sigma²)``."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        self.mu = float(mu)
        self.sigma = float(sigma)

    def log_prob(self, theta):
        lt = torch.log(theta)
        z = (lt - self.mu) / self.sigma
        return -0.5 * z * z - lt - math.log(self.sigma) - 0.5 * math.log(2.0 * math.pi)


class Gamma(Prior):
    """``θ ~ Gamma(concentration a, rate b)``."""

    def __init__(self, concentration: float = 2.0, rate: float = 1.0):
        if concentration <= 0 or rate <= 0:
            raise ValueError("concentration and rate must be positive")
        self.a = float(concentration)
        self.b = float(rate)

    def log_prob(self, theta):
        return (
            self.a * math.log(self.b) - math.lgamma(self.a)
            + (self.a - 1.0) * torch.log(theta) - self.b * theta
        )


class HalfNormal(Prior):
    """``θ ~ |N(0, scale²)|``."""

    def __init__(self, scale: float = 1.0):
        if scale <= 0:
            raise ValueError("scale must be positive")
        self.scale = float(scale)

    def log_prob(self, theta):
        z = theta / self.scale
        return -0.5 * z * z + 0.5 * math.log(2.0 / math.pi) - math.log(self.scale)


class Uniform(Prior):
    """``θ ~ U(lo, hi)``: a hard box, −∞ outside it.  For a
    gradient-based MAP prefer the smooth families (the box's gradient is
    zero inside and undefined at the walls)."""

    def __init__(self, lo: float, hi: float):
        if not (0 <= lo < hi):
            raise ValueError("need 0 <= lo < hi")
        self.lo = float(lo)
        self.hi = float(hi)

    def log_prob(self, theta):
        inside = (theta >= self.lo) & (theta <= self.hi)
        return torch.where(inside, torch.full_like(theta, -math.log(self.hi - self.lo)), -math.inf)


def log_prior(priors: Sequence[Optional[Prior]], theta: Tensor) -> Tensor:
    """``Σᵢ log pᵢ(θᵢ)`` over priors aligned with ``theta``'s last axis."""
    if len(priors) != theta.shape[-1]:
        raise ValueError(f"{len(priors)} priors for {theta.shape[-1]} parameters")
    total = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
    for i, p in enumerate(priors):
        if p is not None:
            total = total + p.log_prob(theta[..., i])
    return total


def log_prior_u(priors: Sequence[Optional[Prior]], u: Tensor) -> Tensor:
    """θ-space prior at u = log θ with the change-of-variables Jacobian
    ``Σ log|dθᵢ/duᵢ| = Σ uᵢ``, what a chain over u adds so that its draws
    are samples of the θ-space posterior.  The Jacobian covers only the
    coordinates that carry a prior (a flat-in-θ coordinate stays flat)."""
    jac = torch.zeros(u.shape[:-1], dtype=u.dtype, device=u.device)
    for i, p in enumerate(priors):
        if p is not None:
            jac = jac + u[..., i]
    return log_prior(priors, torch.exp(u)) + jac
