"""Laplace-approximation GP for non-Gaussian likelihoods (R&W ch. 3).

Counterpart of ``pygpr_tpu/models/laplace.py``:

  * :func:`posterior_mode`: a fixed number of damped Newton steps toward
    the latent mode f̂ (R&W Algorithm 3.1) on the well-conditioned
    ``B = I + W^{1/2} K W^{1/2}``, unrolled in the autograd graph, so the
    evidence's hyperparameter gradient is plain reverse-mode autograd
    through the iteration (as the JAX package differentiates its scan);
  * :func:`nlml`: the negative Laplace evidence
    ``½ aᵀf̂ − Σᵢ log p(yᵢ|f̂ᵢ) + Σᵢ log Lᵢᵢ(B)`` (R&W eq. 3.32);
  * :func:`predict`: latent moments (R&W Algorithm 3.2), pushed through
    the likelihood's ``predict``;
  * :func:`fit`: L-BFGS over log kernel parameters and raw likelihood
    parameters.

The likelihood's f-derivatives (∇log p and W = −∇²log p) are autograd of
the pointwise ``log_lik``, taken twice with ``create_graph=True`` so that
the outer gradient runs through them (the JAX package's grad of grad).
W is floored at ``W_FLOOR``.

B's eigenvalues are ≥ 1, so B is factored by ``torch.linalg.cholesky_ex``
with no jitter ladder (a jitter would bias the mode), NaN where it fails,
as XLA's Cholesky gives: not by ``safe_cholesky``, whose ladder would add
jitter and whose K3 would change which kernel runs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

#: floor of the clamped curvature W: keeps W^{1/2} defined where the
#: likelihood is locally flat (logit tails) or convex (Student-t outliers)
W_FLOOR = 1e-10

#: Newton step sizes tried each iteration, largest first
_STEPS = (1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125)


class LaplaceState(NamedTuple):
    """Posterior state at the Laplace mode."""

    x: Tensor           #: training inputs [n, d]
    y: Tensor           #: observations [n]
    params: Tensor      #: kernel hyperparameters [nhp]
    lik_params: Tensor  #: likelihood parameters [nlp] (possibly empty)
    f_hat: Tensor       #: latent posterior mode [n]
    a: Tensor           #: K⁻¹ f̂ [n]
    grad_ll: Tensor     #: ∇ log p(y|f̂) [n], the predictive mean's weights
    w_sqrt: Tensor      #: W^{1/2} at the mode [n]
    chol_b: Tensor      #: lower Cholesky of B = I + W^{1/2} K W^{1/2}
    nlml: Tensor        #: −log q(y|X,θ) (R&W eq. 3.32), scalar
    ok: Tensor          #: whether the factor is finite


def _ll_terms(lik, lp: Tensor, y: Tensor, f: Tensor):
    """Pointwise ``(log p, d/df, W = max(−d²/df², W_FLOOR))``, each ``[n]``,
    by autograd: the densities are elementwise, so the gradient of the sum
    is the per-point derivative and the gradient of its sum is the
    Hessian's diagonal.  Differentiable in f, lp and y."""
    fv = f if f.requires_grad else f.detach().requires_grad_(True)
    with torch.enable_grad():
        ll = lik.log_lik(lp, y, fv)
        (d1,) = torch.autograd.grad(ll.sum(), fv, create_graph=True)
        (d2,) = torch.autograd.grad(d1.sum(), fv, create_graph=True, allow_unused=True)
    if d2 is None:
        d2 = torch.zeros_like(f)
    w = torch.clamp_min(-d2, W_FLOOR)
    if not torch.is_grad_enabled():
        ll, d1, w = ll.detach(), d1.detach(), w.detach()
    return ll, d1, w


def _b_cholesky(K: Tensor, w_sqrt: Tensor) -> Tensor:
    """chol(B), B = I + W^{1/2} K W^{1/2}, with no ladder and no jitter;
    all NaN where the factorization fails."""
    n = K.shape[-1]
    B = torch.eye(n, dtype=K.dtype, device=K.device) + w_sqrt[:, None] * K * w_sqrt[None, :]
    L, info = torch.linalg.cholesky_ex(B)
    return torch.where(info == 0, L, torch.nan)


def _newton_step(K: Tensor, y: Tensor, lik, lp: Tensor, f: Tensor, a: Tensor) -> Tuple[Tensor, Tensor]:
    """One damped Newton update of (f, a = K⁻¹f).  The full-step target
    ``a⁺ = b − W^{1/2} B⁻ᵀ B⁻¹ W^{1/2} K b`` (R&W Alg. 3.1, lines 4-7); the
    carried pair gives each fractional step's objective
    ψ = ½ aₛᵀ fₛ − Σ log p(y|fₛ) with one product, and the smallest finite
    ψ of ``_STEPS`` is taken (an argmin's one-hot, no branch)."""
    _, d1, w = _ll_terms(lik, lp, y, f)
    ws = torch.sqrt(w)
    chol_b = _b_cholesky(K, ws)
    b = w * f + d1
    kb = K @ b
    c = linalg.solve_lower(chol_b, ws * kb)
    a_full = b - ws * linalg.solve_lower_t(chol_b, c)

    s = torch.tensor(_STEPS, dtype=f.dtype, device=f.device)
    a_s = a[None, :] + s[:, None] * (a_full - a)[None, :]      # [S, n]
    f_s = a_s @ K                                              # [S, n] (K symmetric)
    psi = 0.5 * torch.sum(a_s * f_s, dim=-1) - torch.sum(lik.log_lik(lp, y[None, :], f_s), dim=-1)
    psi = torch.where(torch.isfinite(psi), psi, torch.inf)
    # the argmin's one-hot without F.one_hot, whose range check reads the
    # device
    pick = (torch.arange(len(_STEPS), device=f.device) == torch.argmin(psi)).to(f.dtype)
    return pick @ f_s, pick @ a_s


def posterior_mode(kern: Kernel, params: Tensor, lik, lik_params: Tensor, x: Tensor, y: Tensor, *,
                   n_newton: int = 20, config: Config = DEFAULT) -> LaplaceState:
    """The latent posterior mode and the Laplace evidence, after
    ``n_newton`` Newton steps from f = 0."""
    K = kern.matrix(params, x, config=config)
    f = a = torch.zeros_like(y)
    for _ in range(n_newton):
        f, a = _newton_step(K, y, lik, lik_params, f, a)
    ll, d1, w = _ll_terms(lik, lik_params, y, f)
    ws = torch.sqrt(w)
    chol_b = _b_cholesky(K, ws)
    nlml_val = 0.5 * torch.dot(a, f) - torch.sum(ll) + linalg.half_logdet_from_chol(chol_b)
    return LaplaceState(x=x, y=y, params=params, lik_params=lik_params, f_hat=f, a=a, grad_ll=d1, w_sqrt=ws,
                        chol_b=chol_b, nlml=nlml_val, ok=torch.isfinite(chol_b).all())


def nlml(kern: Kernel, params: Tensor, lik, lik_params: Tensor, x: Tensor, y: Tensor, *, n_newton: int = 20,
         config: Config = DEFAULT) -> Tensor:
    """Negative Laplace evidence (R&W eq. 3.32), the fit criterion."""
    return posterior_mode(kern, params, lik, lik_params, x, y, n_newton=n_newton, config=config).nlml


def predict(kern: Kernel, state: LaplaceState, xp, lik=None, *, space: str = "observation",
            config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Predictive moments at ``xp`` (R&W Algorithm 3.2): latent mean
    ``K*ᵀ ∇log p(y|f̂)`` and variance ``k** − ‖L_B⁻¹ W^{1/2} K*‖²``
    columnwise; ``space="observation"`` (needs ``lik``) pushes them through
    the likelihood's ``predict``."""
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    krns = kern.matrix(state.params, state.x, xp, config=config)          # [m, n]
    mean = krns @ state.grad_ll
    v = linalg.solve_lower(state.chol_b, state.w_sqrt[:, None] * krns.T)  # [n, m]
    var = kern.diag(state.params, xp, config=config) - torch.sum(v * v, dim=0)
    var = torch.clamp_min(var, config.jitter)
    if space == "latent":
        return mean, var
    if lik is None:
        raise ValueError('space="observation" needs the likelihood')
    return lik.predict(state.lik_params, mean, var)


class FitLaplaceResult(NamedTuple):
    state: LaplaceState   #: posterior at the optimum
    params: Tensor        #: fitted kernel hyperparameters
    lik_params: Tensor    #: fitted likelihood parameters
    nlml: Tensor          #: final negative evidence
    converged: Tensor


def _fit_joint(evidence, state_fn, kern: Kernel, lik, x: Tensor, y: Tensor, params0, lik_params0, max_iter: int,
               tol: float, config: Config):
    """L-BFGS on ``evidence(θ, lik_params)`` over ``[log θ, lik_params]``;
    returns ``(state at the optimum, θ, lik_params, converged)``."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    params0 = kern.init_params(x, config) if params0 is None else torch.as_tensor(params0, dtype=x.dtype,
                                                                                    device=x.device)
    lik_params0 = (lik.init_params(y.dtype, y.device) if lik_params0 is None
                   else torch.as_tensor(lik_params0, dtype=y.dtype, device=y.device))
    nk = params0.shape[0]
    u0 = torch.cat([torch.log(torch.abs(params0)), lik_params0])
    res = minimize_lbfgs(lambda u: evidence(torch.exp(u[:nk]), u[nk:]), u0, max_iter=max_iter, tol=tol)
    p_fit, lp_fit = torch.exp(res.params[:nk]), res.params[nk:]
    with torch.no_grad():
        state = state_fn(p_fit, lp_fit)
    return state, p_fit, lp_fit, res.converged


def fit(kern: Kernel, lik, x, y, params0=None, lik_params0=None, *, n_newton: int = 20, max_iter: int = 100,
        tol: float = 1e-4, config: Config = DEFAULT, device=None) -> FitLaplaceResult:
    """Joint hyperparameter fit by minimizing the Laplace evidence:
    kernel parameters in log space (``fit_mle``'s policy), likelihood
    parameters raw."""
    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)

    def evidence(p, lp):
        return nlml(kern, p, lik, lp, x, y, n_newton=n_newton, config=config)

    def state_fn(p, lp):
        return posterior_mode(kern, p, lik, lp, x, y, n_newton=n_newton, config=config)

    state, p_fit, lp_fit, conv = _fit_joint(evidence, state_fn, kern, lik, x, y, params0, lik_params0, max_iter,
                                            tol, config)
    return FitLaplaceResult(state=state, params=p_fit, lik_params=lp_fit, nlml=state.nlml, converged=conv)


class LaplaceGP:
    """Stateful wrapper in the style of :class:`~pygpr_torch.models.exact_gp.ExactGP`.

    >>> gp = LaplaceGP(x, y, RBF(), BernoulliLogit())
    >>> gp.train()
    >>> p, pvar = gp.predict(xs)              # class probabilities
    >>> mu, var = gp.predict(xs, space="latent")
    """

    _fit, _state, _predict = staticmethod(fit), staticmethod(posterior_mode), staticmethod(predict)

    def __init__(self, x, y, cov: Kernel, lik, params=None, lik_params=None, config: Config = DEFAULT,
                 device=None):
        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.cov, self.lik, self.config = cov, lik, config
        self.params = (cov.init_params(self.x, config) if params is None
                       else torch.as_tensor(params, dtype=self.x.dtype, device=self.x.device))
        self.lik_params = (lik.init_params(self.y.dtype, self.y.device) if lik_params is None
                           else torch.as_tensor(lik_params, dtype=self.y.dtype, device=self.y.device))
        self._posterior = None

    def train(self, max_iter: int = 100, **kwargs):
        res = self._fit(self.cov, self.lik, self.x, self.y, self.params, self.lik_params, max_iter=max_iter,
                        config=self.config, **kwargs)
        self.params, self.lik_params = res.params, res.lik_params
        self._posterior = res.state
        return res

    def update(self):
        if self._posterior is None:
            with torch.no_grad():
                self._posterior = self._state(self.cov, self.params, self.lik, self.lik_params, self.x, self.y,
                                              config=self.config)
        return self._posterior

    def predict(self, xp, space: str = "observation"):
        state = self.update()
        with torch.no_grad():
            return self._predict(self.cov, state, xp, self.lik, space=space, config=self.config)
