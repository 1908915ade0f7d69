"""Student-t process regression (Shah, Wilson & Ghahramani, AISTATS 2014).

Counterpart of ``pygpr_tpu/models/tprocess.py``.  A TP keeps the exact
GP's one Cholesky of the kernel gram and its predictive mean, and replaces
the Gaussian marginal with a multivariate Student-t (dof ν > 2, K the
covariance):

    −log p(y) = −log Γ((ν+n)/2) + log Γ(ν/2) + (n/2)·log((ν−2)π)
                + Σᵢ log Lᵢᵢ + ((ν+n)/2)·log(1 + β/(ν−2)),
    β = yᵀK⁻¹y

The predictive covariance is the GP's scaled by (ν + β − 2)/(ν + n − 2).
ν is fit jointly with the kernel hyperparameters as ν = 2 + softplus(u).
Noise is carried in the kernel (``Sum((…, WhiteNoise()))``).  The gram is
``train_gram``'s, so the canonical kernel in f32 on the card is one K1
launch; the ladder's Cholesky takes K3 where the JAX package takes its
Pallas Cholesky.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel, train_gram

Tensor = torch.Tensor


def nlml_tp(kern: Kernel, params, nu, x, y, config: Config = DEFAULT) -> Tensor:
    """Negative log marginal likelihood of the TP (Shah et al. eq. 6,
    covariance parameterization): one gram and one laddered Cholesky."""
    n = y.shape[-1]
    res = linalg.safe_cholesky(train_gram(kern, params, x, config), config)
    z = linalg.solve_lower(res.chol, y)
    beta = torch.dot(z, z)
    half_logdet = linalg.half_logdet_from_chol(res.chol)
    nuf = torch.as_tensor(nu, dtype=y.dtype, device=y.device)
    return (
        -torch.special.gammaln(0.5 * (nuf + n))
        + torch.special.gammaln(0.5 * nuf)
        + 0.5 * n * torch.log((nuf - 2.0) * math.pi)
        + half_logdet
        + 0.5 * (nuf + n) * torch.log1p(beta / (nuf - 2.0))
    )


def predict_tp(kern: Kernel, state: exact_gp.GPState, nu, xp, var: str = "diag", config: Config = DEFAULT):
    """TP posterior predictive (Shah et al. lemma 3): ``(mean, cov, dof)``
    with the GP's mean, dof ν + n and the GP's covariance scaled by
    (ν + β − 2)/(ν + n − 2).  ``state`` is an ``exact_gp.factorize`` result
    on the same kernel."""
    mean, cov = exact_gp.predict(kern, state, xp, var, config)
    n = state.y.shape[-1]
    z = linalg.solve_lower(state.chol, state.y)
    beta = torch.dot(z, z)
    nuf = torch.as_tensor(nu, dtype=mean.dtype, device=mean.device)
    scale = (nuf + beta - 2.0) / (nuf + n - 2.0)
    if cov is None:
        return mean, None, nuf + n
    return mean, scale * cov, nuf + n


def nlpd_tp(mean, cov_diag, dof, yt) -> Tensor:
    """Mean negative log predictive density under the Student-t marginals
    (covariance parameterization: scale² = cov·(dof−2)/dof)."""
    scale2 = cov_diag * (dof - 2.0) / dof
    zq = torch.square(yt - mean) / scale2
    lp = (
        torch.special.gammaln(0.5 * (dof + 1.0))
        - torch.special.gammaln(0.5 * dof)
        - 0.5 * torch.log(dof * math.pi * scale2)
        - 0.5 * (dof + 1.0) * torch.log1p(zq / dof)
    )
    return -torch.mean(lp)


class FitTPResult(NamedTuple):
    state: exact_gp.GPState
    params: Tensor
    nu: Tensor
    nlml: Tensor
    converged: Tensor


def fit_tp(kern: Kernel, x, y, params0=None, nu0: float = 5.0, *, max_iter: int = 150, tol: float = 1e-4,
           config: Config = DEFAULT, device=None) -> FitTPResult:
    """Joint L-BFGS over log kernel parameters and the dof, ν = 2 +
    softplus(u_ν).  NumPy inputs go to ``device`` ("cuda" unless given)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    params0 = (kern.init_params(x, config) if params0 is None
               else torch.as_tensor(params0, dtype=x.dtype, device=x.device))
    nk = params0.shape[0]
    # softplus⁻¹(ν₀ − 2)
    u_nu0 = torch.log(torch.expm1(torch.as_tensor(nu0 - 2.0, dtype=y.dtype, device=y.device)))
    u0 = torch.cat([torch.log(torch.abs(params0)), u_nu0[None]])

    def objective(u):
        return nlml_tp(kern, torch.exp(u[:nk]), 2.0 + F.softplus(u[nk]), x, y, config)

    res = minimize_lbfgs(objective, u0, max_iter=max_iter, tol=tol)
    p_fit = torch.exp(res.params[:nk])
    nu_fit = 2.0 + F.softplus(res.params[nk])
    with torch.no_grad():
        state = exact_gp.factorize(kern, p_fit, x, y, config)
    return FitTPResult(state=state, params=p_fit, nu=nu_fit, nlml=res.value, converged=res.converged)


class TProcess:
    """Stateful wrapper in the house style.

    >>> tp = TProcess(x, y, Sum((RBF(), WhiteNoise())))
    >>> tp.train()
    >>> mean, cov, dof = tp.predict(xs)
    """

    def __init__(self, x, y, cov: Kernel, nu: float = 5.0, params=None, config: Config = DEFAULT, device=None):
        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.cov = cov
        self.nu = nu
        self.config = config
        self.params = (cov.init_params(self.x, config) if params is None
                       else torch.as_tensor(params, dtype=self.x.dtype, device=self.x.device))
        self._state: Optional[exact_gp.GPState] = None

    def train(self, max_iter: int = 150, **kwargs) -> FitTPResult:
        res = fit_tp(self.cov, self.x, self.y, self.params, self.nu, max_iter=max_iter, config=self.config, **kwargs)
        self.params, self.nu = res.params, float(res.nu)
        self._state = res.state
        return res

    def update(self) -> exact_gp.GPState:
        if self._state is None:
            with torch.no_grad():
                self._state = exact_gp.factorize(self.cov, self.params, self.x, self.y, self.config)
        return self._state

    def predict(self, xp, var: str = "diag"):
        with torch.no_grad():
            return predict_tp(self.cov, self.update(), self.nu, xp, var, self.config)
