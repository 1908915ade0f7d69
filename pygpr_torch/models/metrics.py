"""Predictive-quality metrics: RMSE, NLPD, calibration and closed-form
leave-one-out.  Counterpart of ``pygpr_tpu/models/metrics.py``."""

from __future__ import annotations

import math

import torch

from pygpr_torch.config import DEFAULT
from pygpr_torch.ops import linalg

Tensor = torch.Tensor


def rmse(y_true: Tensor, y_pred: Tensor) -> Tensor:
    """Root-mean-square error over the last axis."""
    return torch.sqrt(torch.mean(torch.square(y_pred - y_true), dim=-1))


def nlpd(y_true: Tensor, mean: Tensor, var: Tensor) -> Tensor:
    """Mean negative log predictive density under the Gaussian
    posterior: −(1/n) Σ log N(yᵢ; μᵢ, σᵢ²)."""
    var = torch.clamp_min(var, 1e-12)
    ll = -0.5 * (torch.log(2.0 * math.pi * var) + torch.square(y_true - mean) / var)
    return -torch.mean(ll, dim=-1)


def standardized_mse(y_true: Tensor, mean: Tensor, var: Tensor) -> Tensor:
    """Mean of (y − μ)²/σ²: about 1 when the variances are calibrated."""
    return torch.mean(torch.square(y_true - mean) / torch.clamp_min(var, 1e-12), dim=-1)


def loo_cv(state):
    """Closed-form leave-one-out posterior from one factorization
    (Rasmussen & Williams §5.4.2): μᵢ = yᵢ − [K⁻¹y]ᵢ/[K⁻¹]ᵢᵢ and
    σᵢ² = 1/[K⁻¹]ᵢᵢ, from an exact-GP state.  Returns ``(mean, var)``."""
    T = state.tinv if state.tinv is not None else linalg.tri_inverse_doubling(state.chol)
    var = 1.0 / torch.sum(torch.square(T), dim=-2)
    return state.y - state.weights * var, var


def loo_nlpd(kern, params, x, y, config=None) -> Tensor:
    """Negative mean LOO log predictive density (R&W eq. 5.11), a
    model-selection objective for ``fit_mle(objective=...)``."""
    from pygpr_torch.models import exact_gp

    state = exact_gp.factorize(kern, params, x, y, DEFAULT if config is None else config)
    mean, var = loo_cv(state)
    return nlpd(y, mean, var)
