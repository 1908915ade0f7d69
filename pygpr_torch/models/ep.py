"""Expectation Propagation for non-Gaussian GP inference (R&W §3.6).

Counterpart of ``pygpr_tpu/models/ep.py``: damped **parallel** EP, every
site updated at once from the current global posterior marginals (one
Cholesky of ``B = I + S̃^{1/2} K S̃^{1/2}``, two triangular solves and
vectorized tilted moments per sweep).  The sweeps are unrolled in the
autograd graph, so the evidence's hyperparameter gradient is reverse-mode
autograd through the iteration, as the JAX package differentiates its
scan.  Tilted moments are the likelihood's closed form where it has one
(``tilted_moments``) and 32-node Gauss-Hermite in the log domain
otherwise.  With ``GaussianLik`` EP ends at the exact posterior and the
exact Gaussian evidence.

B's eigenvalues are ≥ 1, so B is factored by ``torch.linalg.cholesky_ex``
with no jitter ladder, NaN where it fails, as in ``models.laplace``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.laplace import LaplaceGP, _fit_joint
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

#: site-precision floor: keeps 1/τ̃ and ν̃/√τ̃ defined for sites that
#: carry (numerically) no information
TAU_FLOOR = 1e-10
#: cavity-precision floor: a non-positive cavity precision is clamped and
#: damping repairs it (the standard parallel-EP guard)
CAV_FLOOR = 1e-8

_GH_X, _GH_W = np.polynomial.hermite.hermgauss(32)


class EPState(NamedTuple):
    """Converged EP posterior."""

    x: Tensor           #: training inputs [n, d]
    y: Tensor           #: observations [n]
    params: Tensor      #: kernel hyperparameters [nhp]
    lik_params: Tensor  #: likelihood parameters [nlp] (possibly empty)
    tau: Tensor         #: site precisions τ̃ [n]
    nu: Tensor          #: site precision-means ν̃ = τ̃μ̃ [n]
    mu: Tensor          #: posterior marginal means [n]
    sigma2: Tensor      #: posterior marginal variances [n]
    w_pred: Tensor      #: (K + S̃⁻¹)⁻¹ μ̃, the predictive mean's weights [n]
    w_sqrt: Tensor      #: S̃^{1/2} [n]
    chol_b: Tensor      #: lower Cholesky of B = I + S̃^{1/2} K S̃^{1/2}
    nlml: Tensor        #: −log Z_EP (R&W eq. 3.65), scalar
    delta: Tensor       #: largest site change of the last sweep
    ok: Tensor          #: finiteness flag


def _tilted_moments(lik, lp, y, mu_cav, var_cav):
    """``(log Ẑ, μ̂, σ̂²)`` of ``∝ N(f; μ₋, σ²₋) p(y|f)``: the likelihood's
    closed form if it has one, else log-domain Gauss-Hermite."""
    if hasattr(lik, "tilted_moments"):
        return lik.tilted_moments(lp, y, mu_cav, var_cav)
    xg = torch.as_tensor(_GH_X, dtype=mu_cav.dtype, device=mu_cav.device)
    logw = torch.as_tensor(np.log(_GH_W) - 0.5 * math.log(math.pi), dtype=mu_cav.dtype, device=mu_cav.device)
    f = mu_cav[..., None] + torch.sqrt(2.0 * var_cav)[..., None] * xg
    ll = lik.log_lik(lp, y[..., None], f)                    # [n, H]
    lse = torch.logsumexp(logw + ll, dim=-1)
    q = torch.exp(logw + ll - lse[..., None])
    mu_hat = torch.sum(q * f, dim=-1)
    e2 = torch.sum(q * f * f, dim=-1)
    return lse, mu_hat, e2 - mu_hat**2


def _posterior_from_sites(K, tau, nu):
    """Global marginals from the sites: Σ = K − K S̃^{1/2} B⁻¹ S̃^{1/2} K.
    Returns ``(mu, sigma2, chol_b, ws, V = L⁻¹ S̃^{1/2} K)``."""
    n = K.shape[-1]
    ws = torch.sqrt(torch.clamp_min(tau, TAU_FLOOR))
    B = torch.eye(n, dtype=K.dtype, device=K.device) + ws[:, None] * K * ws[None, :]
    L, info = torch.linalg.cholesky_ex(B)
    L = torch.where(info == 0, L, torch.nan)
    V = linalg.solve_lower(L, ws[:, None] * K)               # [n, n]
    sigma2 = torch.diagonal(K) - torch.sum(V * V, dim=0)
    mu = K @ nu - V.T @ (V @ nu)
    return mu, sigma2, L, ws, V


def _cavity(K, tau, nu):
    mu, sigma2, L, ws, _ = _posterior_from_sites(K, tau, nu)
    sigma2 = torch.clamp_min(sigma2, TAU_FLOOR)
    tau_cav = torch.clamp_min(1.0 / sigma2 - tau, CAV_FLOOR)
    nu_cav = mu / sigma2 - nu
    var_cav = 1.0 / tau_cav
    return mu, L, ws, tau_cav, nu_cav, var_cav, nu_cav * var_cav


def _sweep(K, y, lik, lp, tau, nu, damping):
    """One damped parallel-EP sweep over all sites."""
    _, _, _, tau_cav, nu_cav, var_cav, mu_cav = _cavity(K, tau, nu)
    _, mu_hat, var_hat = _tilted_moments(lik, lp, y, mu_cav, var_cav)
    var_hat = torch.clamp_min(var_hat, TAU_FLOOR)
    tau_new = torch.clamp_min(1.0 / var_hat - tau_cav, 0.0)
    nu_new = mu_hat / var_hat - nu_cav
    d = torch.maximum(torch.max(torch.abs(tau_new - tau)), torch.max(torch.abs(nu_new - nu)))
    return (1.0 - damping) * tau + damping * tau_new, (1.0 - damping) * nu + damping * nu_new, d


def _log_z_ep(K, y, lik, lp, tau, nu):
    """The EP evidence log Z_EP (R&W eq. 3.65) in B-stable form: every
    unbounded σ̃² = 1/τ̃ factor cancels against |K + S̃⁻¹| = |B|/|S̃|,
    leaving log(1 + τ̃σ²₋) and the L_B solve of ν̃/√τ̃."""
    _, L, ws, _, _, var_cav, mu_cav = _cavity(K, tau, nu)
    lz_hat, _, _ = _tilted_moments(lik, lp, y, mu_cav, var_cav)
    live = tau > 1e-8
    t_logdet_sites = 0.5 * torch.sum(torch.log1p(tau * var_cav))
    quad_sites = torch.where(live, (mu_cav * tau - nu) ** 2
                             / (2.0 * torch.clamp_min(tau, TAU_FLOOR) * (1.0 + tau * var_cav)), 0.0)
    a = torch.where(live, nu / ws, 0.0)
    c = linalg.solve_lower(L, a)
    return (torch.sum(lz_hat) + t_logdet_sites + torch.sum(quad_sites)
            - torch.sum(torch.log(torch.diagonal(L))) - 0.5 * torch.dot(c, c))


def posterior_ep(kern: Kernel, params: Tensor, lik, lik_params: Tensor, x: Tensor, y: Tensor, *,
                 n_sweeps: int = 30, damping: float = 0.7, config: Config = DEFAULT) -> EPState:
    """``n_sweeps`` damped parallel-EP sweeps from zero sites, then the
    posterior and the evidence; ``delta`` is the last sweep's largest site
    move."""
    K = kern.matrix(params, x, config=config)
    tau = torch.zeros_like(y)
    nu = torch.zeros_like(y)
    d = torch.zeros((), dtype=y.dtype, device=y.device)
    for _ in range(n_sweeps):
        tau, nu, d = _sweep(K, y, lik, lik_params, tau, nu, damping)
    mu, sigma2, L, ws, _ = _posterior_from_sites(K, tau, nu)
    log_z = _log_z_ep(K, y, lik, lik_params, tau, nu)
    # predictive weights (K + S̃⁻¹)⁻¹μ̃ = S̃^{1/2} B⁻¹ (ν̃/√τ̃)
    a = torch.where(tau > 1e-8, nu / ws, 0.0)
    w_pred = ws * linalg.solve_lower_t(L, linalg.solve_lower(L, a))
    return EPState(x=x, y=y, params=params, lik_params=lik_params, tau=tau, nu=nu, mu=mu, sigma2=sigma2,
                   w_pred=w_pred, w_sqrt=ws, chol_b=L, nlml=-log_z, delta=d,
                   ok=torch.isfinite(log_z) & torch.isfinite(L).all())


def nlml(kern: Kernel, params: Tensor, lik, lik_params: Tensor, x: Tensor, y: Tensor, *, n_sweeps: int = 30,
         damping: float = 0.7, config: Config = DEFAULT) -> Tensor:
    """Negative EP evidence −log Z_EP, the fit criterion."""
    return posterior_ep(kern, params, lik, lik_params, x, y, n_sweeps=n_sweeps, damping=damping,
                        config=config).nlml


def predict(kern: Kernel, state: EPState, xp, lik=None, *, space: str = "observation",
            config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Predictive moments at ``xp`` (R&W eqs. 3.60-3.61): latent mean
    ``K*ᵀ w_pred`` and variance ``k** − ‖L_B⁻¹ S̃^{1/2} K*‖²`` columnwise,
    pushed through the likelihood for ``space="observation"``."""
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    krns = kern.matrix(state.params, state.x, xp, config=config)
    mean = krns @ state.w_pred
    v = linalg.solve_lower(state.chol_b, state.w_sqrt[:, None] * krns.T)
    var = torch.clamp_min(kern.diag(state.params, xp, config=config) - torch.sum(v * v, dim=0), config.jitter)
    if space == "latent":
        return mean, var
    if lik is None:
        raise ValueError('space="observation" needs the likelihood')
    return lik.predict(state.lik_params, mean, var)


class FitEPResult(NamedTuple):
    state: EPState
    params: Tensor
    lik_params: Tensor
    nlml: Tensor
    converged: Tensor


def fit(kern: Kernel, lik, x, y, params0=None, lik_params0=None, *, n_sweeps: int = 30, damping: float = 0.7,
        max_iter: int = 100, tol: float = 1e-4, config: Config = DEFAULT, device=None) -> FitEPResult:
    """Hyperparameter fit by minimizing −log Z_EP: kernel parameters in
    log space, likelihood parameters raw, gradients by autograd through
    the sweeps (``models.laplace.fit``'s policy)."""
    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)

    def evidence(p, lp):
        return nlml(kern, p, lik, lp, x, y, n_sweeps=n_sweeps, damping=damping, config=config)

    def state_fn(p, lp):
        return posterior_ep(kern, p, lik, lp, x, y, n_sweeps=n_sweeps, damping=damping, config=config)

    state, p_fit, lp_fit, conv = _fit_joint(evidence, state_fn, kern, lik, x, y, params0, lik_params0, max_iter,
                                            tol, config)
    return FitEPResult(state=state, params=p_fit, lik_params=lp_fit, nlml=state.nlml, converged=conv)


class EPGP(LaplaceGP):
    """Stateful wrapper in the style of :class:`~pygpr_torch.models.laplace.LaplaceGP`.

    >>> gp = EPGP(x, y, RBF(), BernoulliProbit())
    >>> gp.train()
    >>> p, pvar = gp.predict(xs)              # class probabilities
    """

    _fit, _state, _predict = staticmethod(fit), staticmethod(posterior_ep), staticmethod(predict)
