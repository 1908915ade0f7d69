"""Warped Gaussian processes (Snelson, Rasmussen & Ghahramani, NeurIPS 2003).

Counterpart of ``pygpr_tpu/models/warped.py``.  The GP sits on a latent
``z = g(y)`` with a learned monotone map g, and the fit minimizes the exact
marginal likelihood of the observed y, the Gaussian NLML of the warped
targets plus the change-of-variables Jacobian:

    −log p(y|X,θ,ψ) = nlml(g_ψ(y); K_θ) − Σᵢ log g′_ψ(yᵢ)

The warp's parameters reach the NLML through the targets, so the objective
is the port's ``likelihood.nlml`` under autograd, as in the JAX package
(the fast NLML carries no cotangent to y).

Warp families: :class:`TanhWarp`, ``g(y) = y + Σₐ αₐ tanh(βₐ(y + cₐ))``
with α, β ≥ 0 (softplus), strictly increasing with g′ ≥ 1;
:class:`LogWarp`, ``g(y) = log y``; :class:`IdentityWarp`.

The observation-space median is ``g⁻¹(μ)``; mean and variance come from
32-node Gauss-Hermite over the latent marginal, each node pushed through
the inverse (:meth:`TanhWarp.inverse`: 60 bisection steps and two Newton
steps, about 8 elementwise launches a step on the card, host-bound).
NLPD in y-space is closed form.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.models.likelihood import nlml as gaussian_nlml
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

#: 32-node Gauss-Hermite rule (physicists' weight e^{-x²}), the JAX
#: package's own NumPy call
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(32)


class TanhWarp:
    """``g(y) = y + Σₐ softplus(a)·tanh(softplus(b)·(y + c))`` with
    unconstrained parameters ``[a, b, c]`` per term, ``n_terms`` terms
    (flat layout ``[3·n_terms]``)."""

    def __init__(self, n_terms: int = 3):
        self.n_terms = n_terms

    @property
    def n_params(self) -> int:
        return 3 * self.n_terms

    def init_params(self, y) -> Tensor:
        """Small near-identity start, centers spread over the data range
        (host NumPy, as in the JAX package)."""
        y_t = torch.as_tensor(y)
        y_h = y_t.detach().cpu().numpy()
        c = -np.quantile(y_h, np.linspace(0.2, 0.8, self.n_terms))
        a = np.full(self.n_terms, -2.0)   # softplus ≈ 0.13: gentle
        b = np.full(self.n_terms, 0.0)    # softplus(0) ≈ 0.69
        return torch.as_tensor(np.stack([a, b, c], -1).ravel(), dtype=y_t.dtype, device=y_t.device)

    def _abc(self, wp):
        w = wp.reshape(self.n_terms, 3)
        return F.softplus(w[:, 0]), F.softplus(w[:, 1]), w[:, 2]

    def forward(self, wp, y) -> Tensor:
        a, b, c = self._abc(wp)
        return y + torch.sum(a * torch.tanh(b * (y[..., None] + c)), dim=-1)

    def deriv(self, wp, y) -> Tensor:
        """g′(y) = 1 + Σ a·b·sech²(b(y+c)) ≥ 1."""
        a, b, c = self._abc(wp)
        s = 1.0 / torch.cosh(b * (y[..., None] + c))
        return 1.0 + torch.sum(a * b * s * s, dim=-1)

    def inverse(self, wp, z, n_bisect: int = 60) -> Tensor:
        """g⁻¹ by guarded bisection and a Newton polish.

        |g(y) − y| ≤ A = Σₐ αₐ brackets y* in ``[z − A, z + A]``; ``n_bisect``
        halvings (the same midpoints as the JAX package's ``lax.scan``)
        shrink it to about machine epsilon, and two Newton steps square
        the remaining error.  Branchless."""
        a, _, _ = self._abc(wp)
        amp = torch.sum(a)
        lo, hi = z - amp, z + amp
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            too_big = self.forward(wp, mid) > z
            lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
        y = 0.5 * (lo + hi)
        for _ in range(2):
            y = y - (self.forward(wp, y) - z) / self.deriv(wp, y)
        return y


class LogWarp:
    """Fixed ``g(y) = log y`` (log-normal observations, y > 0)."""

    n_params = 0

    def init_params(self, y) -> Tensor:
        y = torch.as_tensor(y)
        return torch.zeros((0,), dtype=y.dtype, device=y.device)

    def forward(self, wp, y) -> Tensor:
        return torch.log(y)

    def deriv(self, wp, y) -> Tensor:
        return 1.0 / y

    def inverse(self, wp, z, n_newton: int = 0) -> Tensor:
        return torch.exp(z)


class IdentityWarp:
    """``g(y) = y``: the warped GP reduces to the plain exact GP."""

    n_params = 0

    def init_params(self, y) -> Tensor:
        y = torch.as_tensor(y)
        return torch.zeros((0,), dtype=y.dtype, device=y.device)

    def forward(self, wp, y) -> Tensor:
        return y

    def deriv(self, wp, y) -> Tensor:
        return torch.ones_like(y)

    def inverse(self, wp, z, n_newton: int = 0) -> Tensor:
        return z


def nlml_warped(kern: Kernel, params, warp, wp, x, y, config: Config = DEFAULT) -> Tensor:
    """Exact warped-GP negative log marginal likelihood."""
    z = warp.forward(wp, y)
    jac = torch.sum(torch.log(warp.deriv(wp, y)))
    return gaussian_nlml(kern, params, x, z, config) - jac


def factorize_warped(kern: Kernel, params, warp, wp, x, y, config: Config = DEFAULT) -> exact_gp.GPState:
    """Exact-GP state on the warped targets z = g(y)."""
    with torch.no_grad():
        return exact_gp.factorize(kern, params, x, warp.forward(wp, y), config)


def predict_warped(kern: Kernel, state: exact_gp.GPState, warp, wp, xp,
                   config: Config = DEFAULT) -> Tuple[Tensor, Tensor, Tensor]:
    """Observation-space prediction ``(mean, var, median)``: the median maps
    the latent mean through g⁻¹, mean and variance by Gauss-Hermite over
    the latent Gaussian."""
    with torch.no_grad():
        mu, var = exact_gp.predict(kern, state, xp, "diag", config)
        median = warp.inverse(wp, mu)
        xg = torch.as_tensor(_GH_X, dtype=mu.dtype, device=mu.device)
        wg = torch.as_tensor(_GH_W / math.sqrt(math.pi), dtype=mu.dtype, device=mu.device)
        zs = mu[..., None] + torch.sqrt(2.0 * var)[..., None] * xg   # [q, H]
        ys = warp.inverse(wp, zs)
        mean = torch.sum(wg * ys, dim=-1)
        e2 = torch.sum(wg * ys * ys, dim=-1)
        return mean, torch.clamp_min(e2 - mean**2, 0.0), median


def nlpd_warped(kern: Kernel, state: exact_gp.GPState, warp, wp, xp, yp, config: Config = DEFAULT) -> Tensor:
    """Mean observation-space negative log predictive density, exact by
    the change of variables."""
    with torch.no_grad():
        mu, var = exact_gp.predict(kern, state, xp, "diag", config)
        yp = torch.as_tensor(as_tensor(yp, mu.device), dtype=mu.dtype)
        z = warp.forward(wp, yp)
        lp = -0.5 * torch.log(2.0 * math.pi * var) - (z - mu) ** 2 / (2.0 * var) + torch.log(warp.deriv(wp, yp))
        return -torch.mean(lp)


class FitWarpedResult(NamedTuple):
    state: exact_gp.GPState
    params: Tensor        #: fitted kernel hyperparameters
    warp_params: Tensor   #: fitted warp parameters
    nlml: Tensor
    converged: Tensor


def fit_warped(kern: Kernel, warp, x, y, params0=None, wp0=None, *, max_iter: int = 150, tol: float = 1e-4,
               config: Config = DEFAULT, device=None) -> FitWarpedResult:
    """Joint L-BFGS over log kernel parameters and raw warp parameters.
    NumPy inputs go to ``device`` ("cuda" unless given)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    params0 = (kern.init_params(x, config) if params0 is None
               else torch.as_tensor(params0, dtype=x.dtype, device=x.device))
    wp0 = warp.init_params(y) if wp0 is None else torch.as_tensor(wp0, dtype=x.dtype, device=x.device)
    nk = params0.shape[0]
    u0 = torch.cat([torch.log(torch.abs(params0)), wp0])

    def objective(u):
        return nlml_warped(kern, torch.exp(u[:nk]), warp, u[nk:], x, y, config)

    res = minimize_lbfgs(objective, u0, max_iter=max_iter, tol=tol)
    p_fit = torch.exp(res.params[:nk])
    wp_fit = res.params[nk:]
    state = factorize_warped(kern, p_fit, warp, wp_fit, x, y, config)
    return FitWarpedResult(state=state, params=p_fit, warp_params=wp_fit, nlml=res.value, converged=res.converged)


class WarpedGP:
    """Stateful wrapper in the house style.

    >>> gp = WarpedGP(x, y, Sum((RBF(), WhiteNoise())), TanhWarp(3))
    >>> gp.train()
    >>> mean, var, median = gp.predict(xs)
    """

    def __init__(self, x, y, cov: Kernel, warp=None, config: Config = DEFAULT, device=None):
        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.cov = cov
        self.warp = TanhWarp(3) if warp is None else warp
        self.config = config
        self.params = cov.init_params(self.x, config)
        self.warp_params = self.warp.init_params(self.y)
        self._state: Optional[exact_gp.GPState] = None

    def train(self, max_iter: int = 150, **kwargs) -> FitWarpedResult:
        res = fit_warped(self.cov, self.warp, self.x, self.y, self.params, self.warp_params, max_iter=max_iter,
                         config=self.config, **kwargs)
        self.params, self.warp_params = res.params, res.warp_params
        self._state = res.state
        return res

    def update(self) -> exact_gp.GPState:
        if self._state is None:
            self._state = factorize_warped(self.cov, self.params, self.warp, self.warp_params, self.x, self.y,
                                           self.config)
        return self._state

    def predict(self, xp):
        return predict_warped(self.cov, self.update(), self.warp, self.warp_params, xp, self.config)
