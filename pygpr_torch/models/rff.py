"""Random Fourier features and pathwise posterior sampling.

Counterpart of ``pygpr_tpu/models/rff.py``.

**Random Fourier features** (Rahimi and Recht 2007): with ``m`` fixed
spectral frequencies, ``K(x, x′) ≈ φ(x)ᵀφ(x′)`` for
``φ(x) = σ·√(2/m)·cos((x⊙ℓ)·Wᵀ + b)`` under the package's inverse
lengthscales (RBF: W ~ N(0, 2I); Matérn-ν: multivariate-t rows with 2ν
degrees of freedom).  GP regression becomes Bayesian linear regression
on ``[n, m]`` features: an m×m system factored by the laddered
``safe_cholesky`` (kernel K3 at m ≤ 1024 in f32 on the card), the exact
NLML of the approximate kernel by Woodbury, no n×n matrix.

**Pathwise conditioning** (Wilson et al. 2020): a posterior function draw
``f*(·) = φ(·)θ + K(·,X)(K + σₙ²I)⁻¹(y − φ(X)θ − σₙε)`` from an exact-GP
posterior state, two tall products a draw.

All randomness is host NumPy from a seed (:func:`make_basis`,
:func:`make_path_noise`), the JAX package's own draws, so both packages
use the same basis and noise.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.exact_gp import GPState
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


class RFFBasis(NamedTuple):
    """Fixed random basis.  ``freqs`` are unit-scale spectral draws; the
    inverse lengthscales enter through ``x⊙ℓ``, so gradients in the
    hyperparameters flow with the basis fixed."""

    freqs: Tensor   #: [m, d] spectral frequencies at unit scale
    phases: Tensor  #: [m] uniform phase offsets in [0, 2π)


def make_basis(m: int, dim: int, *, profile: str = "rbf", nu: float = 1.5, seed: int = 0, dtype=np.float32,
               device=None) -> RFFBasis:
    """Draw the spectral basis on the host and put it on ``device``
    ("cuda" unless given).  ``profile="rbf"``: W ~ N(0, 2I);
    ``profile="matern"``: W ~ √(2ν/g)·N(0, I), g ~ χ²_{2ν}."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((m, dim))
    if profile == "rbf":
        w = math.sqrt(2.0) * z
    elif profile == "matern":
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError(f"nu must be 0.5, 1.5 or 2.5, got {nu}")
        g = rng.chisquare(2.0 * nu, size=(m, 1))
        w = z * np.sqrt(2.0 * nu / g)
    else:
        raise ValueError(f"unknown profile {profile!r}")
    b = rng.uniform(0.0, 2.0 * math.pi, size=m)
    return RFFBasis(freqs=as_tensor(w.astype(dtype), device), phases=as_tensor(b.astype(dtype), device))


def feature_map(basis: RFFBasis, params: Tensor, x: Tensor, *, config: Config = DEFAULT) -> Tensor:
    """φ(x) ``[n, m]`` for kernel params ``[σ, ℓ₁..ℓ_d]``."""
    sig, ls = params[0], params[1:]
    proj = (x * ls) @ basis.freqs.T
    scale = sig * math.sqrt(2.0 / basis.freqs.shape[0])
    return scale * torch.cos(proj + basis.phases)


def gram(basis: RFFBasis, params: Tensor, x: Tensor, xp: Optional[Tensor] = None, *,
         config: Config = DEFAULT) -> Tensor:
    """Approximate kernel matrix φ(x)φ(x′)ᵀ."""
    fx = feature_map(basis, params, x, config=config)
    fxp = fx if xp is None else feature_map(basis, params, xp, config=config)
    return fx @ fxp.T


class RFFState(NamedTuple):
    """Weight-space posterior: θ | y ~ N(θ̂, σₙ² A⁻¹), A = σₙ²I + ΦᵀΦ."""

    params: Tensor     #: [σ, ℓ₁..ℓ_d, σₙ]
    chol_a: Tensor     #: lower Cholesky of A [m, m]
    theta_hat: Tensor  #: posterior mean weights [m]
    jitter: Tensor
    ok: Tensor


def _system(basis, params, x, y, config):
    """``(ladder result of A = ΦᵀΦ + σₙ²I, Φᵀy)``."""
    kp, sn = params[:-1], params[-1]
    phi = feature_map(basis, kp, x, config=config)
    res = linalg.safe_cholesky(linalg.add_diag(phi.T @ phi, torch.square(sn)), config)
    return res, phi.T @ y


def factorize_rff(basis: RFFBasis, params: Tensor, x: Tensor, y: Tensor, config: Config = DEFAULT) -> RFFState:
    """Fit the feature-space Bayesian linear regression,
    ``params = [σ, ℓ₁..ℓ_d, σₙ]``: one ``[m, n]×[n, m]`` product and one
    laddered m×m Cholesky."""
    res, phi_y = _system(basis, params, x, y, config)
    return RFFState(params=params, chol_a=res.chol, theta_hat=linalg.cholesky_solve(res.chol, phi_y),
                    jitter=res.jitter, ok=res.ok)


def nlml_rff(basis: RFFBasis, params: Tensor, x: Tensor, y: Tensor, config: Config = DEFAULT) -> Tensor:
    """Exact NLML of ``y ~ N(0, ΦΦᵀ + σₙ²I)`` in Woodbury form::

        log|ΦΦᵀ + σₙ²I| = log|A| + (n − m)·log σₙ²
        yᵀ(ΦΦᵀ + σₙ²I)⁻¹y = (yᵀy − ‖L_A⁻¹Φᵀy‖²)/σₙ²

    with σₙ² carrying the ladder's jitter, as the factored A does."""
    sn = params[-1]
    n, m = y.shape[0], basis.freqs.shape[0]
    res, phi_y = _system(basis, params, x, y, config)
    c = linalg.solve_lower(res.chol, phi_y)
    sn2 = torch.square(sn) + res.jitter
    quad = (torch.dot(y, y) - torch.dot(c, c)) / sn2
    logdet = 2.0 * linalg.half_logdet_from_chol(res.chol) + (n - m) * torch.log(sn2)
    return 0.5 * (quad + logdet + n * math.log(2.0 * math.pi))


def predict_rff(basis: RFFBasis, state: RFFState, xp, var: str = "diag", config: Config = DEFAULT):
    """Latent predictive moments: mean φ*θ̂; covariance σₙ²·φ* A⁻¹ φ*ᵀ
    ("full") or its diagonal ("diag"), or ``None`` ("none")."""
    xp = torch.as_tensor(as_tensor(xp, state.params.device), dtype=state.params.dtype)
    kp, sn = state.params[:-1], state.params[-1]
    phi_s = feature_map(basis, kp, xp, config=config)
    mean = phi_s @ state.theta_hat
    if var == "none":
        return mean, None
    v = linalg.solve_lower(state.chol_a, phi_s.T)       # [m, q]
    sn2 = torch.square(sn)
    if var == "diag":
        return mean, sn2 * torch.sum(v * v, dim=0)
    return mean, sn2 * (v.T @ v)


def sample_weights(state: RFFState, z: Tensor) -> Tensor:
    """Posterior weight draws θ = θ̂ + σₙ·L_A⁻ᵀ z from standard normals
    ``z [s, m]`` → ``[s, m]``."""
    return state.theta_hat + state.params[-1] * linalg.solve_lower_t(state.chol_a, z.T).T


def fit_rff(basis: RFFBasis, x, y, params0=None, *, max_iter: int = 100, tol: float = 1e-4,
            config: Config = DEFAULT, device=None):
    """L-BFGS on the Woodbury NLML in log space (``fit_mle``'s policy),
    from ``[1…, 0.3]`` unless given.  Returns ``(state, params, nlml)``."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    if params0 is None:
        d = x.shape[-1]
        params0 = torch.cat([torch.ones(d + 1, dtype=x.dtype, device=x.device),
                             torch.full((1,), 0.3, dtype=x.dtype, device=x.device)])
    u0 = torch.log(torch.abs(torch.as_tensor(params0, dtype=x.dtype, device=x.device)))
    res = minimize_lbfgs(lambda u: nlml_rff(basis, torch.exp(u), x, y, config), u0, max_iter=max_iter, tol=tol)
    p_fit = torch.exp(res.params)
    with torch.no_grad():
        state = factorize_rff(basis, p_fit, x, y, config)
    return state, p_fit, res.value


class PathNoise(NamedTuple):
    """Host-drawn randomness of ``s`` pathwise posterior draws."""

    theta: Tensor  #: [s, m] standard-normal prior weight draws
    eps: Tensor    #: [s, n] standard-normal observation-noise draws


def make_path_noise(n_draws: int, m: int, n: int, *, seed: int = 0, dtype=np.float32, device=None) -> PathNoise:
    rng = np.random.default_rng(seed)
    return PathNoise(theta=as_tensor(rng.standard_normal((n_draws, m)).astype(dtype), device),
                     eps=as_tensor(rng.standard_normal((n_draws, n)).astype(dtype), device))


def pathwise_draws(kern: Kernel, state: GPState, basis: RFFBasis, noise: PathNoise, xq, *,
                   sigma_n: Optional[Tensor] = None, config: Config = DEFAULT) -> Tensor:
    """``s`` posterior function draws at ``xq`` → ``[s, nq]``.

    ``state`` is an exact-GP posterior whose gram includes the noise (e.g.
    ``Sum((RBF(), WhiteNoise()))``); ``kern`` and ``basis`` describe its
    stationary part; ``sigma_n`` defaults to the trailing parameter.  A
    draw is ``φ(xq)θ + K(xq, X)(K + σₙ²I)⁻¹(y − φ(X)θ − σₙε)``, the solve
    reusing ``state.chol``."""
    xq = torch.as_tensor(as_tensor(xq, state.x.device), dtype=state.x.dtype)
    kp = state.params[:-1]
    sn = state.params[-1] if sigma_n is None else sigma_n
    phi_x = feature_map(basis, kp, state.x, config=config)       # [n, m]
    phi_q = feature_map(basis, kp, xq, config=config)            # [q, m]
    prior_x = noise.theta @ phi_x.T                              # [s, n]
    prior_q = noise.theta @ phi_q.T                              # [s, q]
    resid = state.y[None, :] - prior_x - sn * noise.eps
    v = linalg.cholesky_solve(state.chol, resid.T)               # [n, s]
    return prior_q + (kern.matrix(kp, state.x, xq, config=config) @ v).T
