"""Gradient-enhanced GP: regression with derivative observations (R&W
§9.4; "gradient-enhanced kriging").

Counterpart of ``pygpr_tpu/models/derivative.py``.  ``(f, ∇f)`` is jointly
Gaussian with

    cov(f(x),    f(x'))     = k(x, x')
    cov(∂ₖf(x),  f(x'))     = ∂k/∂xₖ (x, x')
    cov(∂ₖf(x),  ∂ₗf(x'))   = ∂²k/∂xₖ∂x'ₗ (x, x'),

and conditioning on observed gradients is exact GP regression on the
stacked system.  The derivative blocks are autodiff of the kernel itself,
as in the JAX package: ``torch.func.grad`` of a scalar kernel for the
value–gradient block and ``torch.func.jacfwd`` over it (forward over
reverse) for the mixed Hessian, under two nested ``torch.func.vmap`` over
point pairs.  Any kernel smooth in the squared distance works (RBF,
RationalQuadratic, Linear, Periodic and Sum/Product/ActiveDims trees of
them); RBF's squared distance keeps its straight-through clamp, so the
second derivatives at coincident points are the exact polynomial's.  The
Matérn family is excluded, as in the JAX package.  The joint gram feeds the
laddered Cholesky (K3 in f32 on the card up to [1024, 1024]).

Observation noise is per channel (σ_f on values, σ_g on gradients): pass a
noise-free base kernel.  Layout: ``[f(x₁..x_n), ∂₁f(xg₁), …, ∂_df(xg₁),
∂₁f(xg₂), …]`` (gradient entries grouped per point, C order of
``g.ravel()``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.func import grad, jacfwd, vmap

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import RBF, Kernel, WhiteNoise

Tensor = torch.Tensor


def _check_noise_free(kern: Kernel):
    """Reject WhiteNoise anywhere in the kernel tree: at any depth it
    would land on the value–value block only, a model that is neither the
    noise-free kernel nor the per-channel noise model."""
    if isinstance(kern, WhiteNoise):
        raise ValueError(
            "derivative GP takes a noise-free base kernel; noise is "
            "per-channel (sigma_f, sigma_g) — remove WhiteNoise "
            "(found embedded in the kernel tree)"
        )
    for child in getattr(kern, "kernels", ()) or ():  # Sum / Product
        _check_noise_free(child)
    for attr in ("base", "k1", "k2"):  # ActiveDims / ChangePoint
        child = getattr(kern, attr, None)
        if isinstance(child, Kernel):
            _check_noise_free(child)


def _scalar_k(kern: Kernel, params, config):
    """k(a, b) as a scalar function of two points (for autodiff)."""

    def k(a, b):
        return kern.matrix(params, a[None, :], b[None, :], config=config)[0, 0]

    return k


def _pairs(fn, a, b) -> Tensor:
    """``fn`` over every pair of rows of ``a`` and ``b``: ``[len(a), len(b), …]``."""
    return vmap(lambda u: vmap(lambda v: fn(u, v))(b))(a)


def joint_gram(kern: Kernel, params, x, xg, *, config: Config = DEFAULT) -> Tensor:
    """Joint covariance of ``[f(x); ∇f(xg).ravel()]``,
    ``[(n + ng·d), (n + ng·d)]``: the plain gram, ∂k/∂b and the mixed
    Hessian ∂²k/∂a∂b (forward over reverse)."""
    n, d = x.shape
    ng = xg.shape[0]
    k = _scalar_k(kern, params, config)
    kff = kern.matrix(params, x, config=config)               # [n, n]
    dk_b = grad(k, argnums=1)                                 # [d]
    kfg = _pairs(dk_b, x, xg)                                 # [n, ng, d]
    kgg = _pairs(jacfwd(dk_b, argnums=0), xg, xg)             # [ng, ng, d, d]
    kfg2 = kfg.reshape(n, ng * d)
    # kgg[i, j, m, l] = ∂²k/∂a_l ∂b_m (a = xg_i, b = xg_j); the joint row
    # is (point i, ∂_l), the column (point j, ∂_m) → [i, l, j, m]
    kgg2 = kgg.permute(0, 3, 1, 2).reshape(ng * d, ng * d)
    return torch.cat([torch.cat([kff, kfg2], dim=1), torch.cat([kfg2.T, kgg2], dim=1)], dim=0)


def _joint_cross(kern, params, xq, x, xg, config) -> Tensor:
    """cov(f(xq), [f(x); ∇f(xg)]), ``[nq, n + ng·d]``."""
    nq = xq.shape[0]
    ng, d = xg.shape
    kqf = kern.matrix(params, x, xq, config=config)           # [nq, n]
    kqg = _pairs(grad(_scalar_k(kern, params, config), argnums=1), xq, xg).reshape(nq, ng * d)
    return torch.cat([kqf, kqg], dim=1)


class DerivGPState(NamedTuple):
    chol: Tensor      #: Cholesky factor of the joint gram + noise
    weights: Tensor   #: K⁻¹ [y; g]
    jitter: Tensor    #: ladder rung used
    ok: Tensor        #: factorization health


def joint_targets(y, g) -> Tensor:
    """Stack values and per-point gradient rows into the joint vector."""
    return torch.cat([y, g.reshape(-1)])


def _noise_diag(n, ng, d, sigma_f, sigma_g, dtype, device=None) -> Tensor:
    sf2 = torch.square(torch.as_tensor(sigma_f, dtype=dtype, device=device))
    sg2 = torch.square(torch.as_tensor(sigma_g, dtype=dtype, device=device))
    return torch.cat([sf2.expand(n), sg2.expand(ng * d)])


def _noisy_joint(kern, params, x, xg, sigma_f, sigma_g, config) -> Tensor:
    n, d = x.shape
    K = joint_gram(kern, params, x, xg, config=config)
    return K + torch.diag(_noise_diag(n, xg.shape[0], d, sigma_f, sigma_g, K.dtype, K.device))


def _inputs(x, y, xg, g, device):
    x = as_tensor(x, device)
    return (x, *(torch.as_tensor(as_tensor(a, x.device), dtype=x.dtype) for a in (y, xg, g)))


def factorize(kern: Kernel, params, x, y, xg, g, *, sigma_f: float = 1e-2, sigma_g: float = 1e-2,
              config: Config = DEFAULT, device=None) -> DerivGPState:
    """Factorize the joint (value + gradient) system."""
    _check_noise_free(kern)
    x, y, xg, g = _inputs(x, y, xg, g, device)
    params = torch.as_tensor(params, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        res = linalg.safe_cholesky(_noisy_joint(kern, params, x, xg, sigma_f, sigma_g, config), config)
        w = linalg.cholesky_solve(res.chol, joint_targets(y, g))
    return DerivGPState(chol=res.chol, weights=w, jitter=res.jitter, ok=res.ok)


def nlml(kern: Kernel, params, x, y, xg, g, *, sigma_f: float = 1e-2, sigma_g: float = 1e-2,
         config: Config = DEFAULT) -> Tensor:
    """Negative log marginal likelihood of the joint system."""
    res = linalg.safe_cholesky(_noisy_joint(kern, params, x, xg, sigma_f, sigma_g, config), config)
    t = joint_targets(y, g)
    a = linalg.solve_lower(res.chol, t)
    return 0.5 * torch.dot(a, a) + torch.sum(torch.log(torch.diagonal(res.chol))) + 0.5 * t.shape[0] * math.log(
        2.0 * math.pi)


def predict(kern: Kernel, params, state: DerivGPState, x, xg, xq, *, grad_out: bool = False,
            config: Config = DEFAULT) -> Union[Tuple[Tensor, Tensor], Tuple[Tensor, Tensor, Tensor]]:
    """Posterior mean and diagonal variance of f at xq; with
    ``grad_out=True`` also the posterior mean of ∇f at xq:
    ``(mean, var, grad_mean)``."""
    ref = state.chol
    xq = torch.as_tensor(as_tensor(xq, ref.device), dtype=ref.dtype)
    with torch.no_grad():
        kq = _joint_cross(kern, params, xq, x, xg, config)        # [nq, M]
        mean = kq @ state.weights
        v = linalg.solve_lower(state.chol, kq.T)                  # [M, nq]
        var = torch.clamp_min(kern.diag(params, xq, config=config) - torch.sum(v * v, 0), config.jitter)
        if not grad_out:
            return mean, var
        # the posterior mean's gradient: differentiate the cross covariances
        k = _scalar_k(kern, params, config)
        gf = _pairs(grad(k, argnums=0), xq, x)                    # [nq, n, d]
        dk_ab = jacfwd(grad(k, argnums=1), argnums=0)             # ∂a∂b
        gg = _pairs(lambda a, b: dk_ab(a, b).T, xq, xg)           # [nq, ng, d(q), d(g)]
        nq = xq.shape[0]
        ng, d = xg.shape
        kq_grad = torch.cat([gf.permute(0, 2, 1), gg.permute(0, 2, 1, 3).reshape(nq, d, ng * d)], dim=2)
        grad_mean = torch.einsum("qdm,m->qd", kq_grad, state.weights)
    return mean, var, grad_mean


def fit(kern: Kernel, params0, x, y, xg, g, *, fit_noise: bool = True, sigma_f: float = 1e-2,
        sigma_g: float = 1e-2, max_iter: int = 150, config: Config = DEFAULT, device=None):
    """Joint MLE of the kernel hyperparameters (and, by default, the two
    noise scales) by L-BFGS in log space.  Returns ``(FitResult, σ_f, σ_g)``."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    _check_noise_free(kern)
    x, y, xg, g = _inputs(x, y, xg, g, device)
    params0 = torch.as_tensor(params0, dtype=x.dtype, device=x.device)
    nhp = params0.shape[0]
    if fit_noise:
        u0 = torch.log(torch.abs(torch.cat([params0, torch.tensor([sigma_f, sigma_g], dtype=x.dtype,
                                                                  device=x.device)])))

        def obj(u):
            p = torch.exp(u)
            return nlml(kern, p[:nhp], x, y, xg, g, sigma_f=p[nhp], sigma_g=p[nhp + 1], config=config)

        res = minimize_lbfgs(obj, u0, max_iter=max_iter)
        p = torch.exp(res.params)
        return res._replace(params=p[:nhp]), float(p[nhp]), float(p[nhp + 1])

    res = minimize_lbfgs(lambda u: nlml(kern, torch.exp(u), x, y, xg, g, sigma_f=sigma_f, sigma_g=sigma_g,
                                        config=config), torch.log(torch.abs(params0)), max_iter=max_iter)
    return res._replace(params=torch.exp(res.params)), sigma_f, sigma_g


class DerivativeGP:
    """Stateful wrapper: condition on values (x, y) and gradients (xg, g).

    ``DerivativeGP(x, y, xg, g).train().predict(xq)``; the noise scales are
    fitted jointly by default.
    """

    def __init__(self, x, y, xg, g, kern: Optional[Kernel] = None, config: Config = DEFAULT, device=None):
        self.kern = kern if kern is not None else RBF()
        _check_noise_free(self.kern)
        self.x, self.y, self.xg, self.g = _inputs(x, y, xg, g, device)
        self.config = config
        self.params = self.kern.init_params(self.x, config)
        self.sigma_f = 1e-2
        self.sigma_g = 1e-2
        self._state = None

    def train(self, **kw) -> "DerivativeGP":
        res, sf, sg = fit(self.kern, self.params, self.x, self.y, self.xg, self.g, config=self.config, **kw)
        self.params, self.sigma_f, self.sigma_g = res.params, sf, sg
        self._state = None
        return self

    def _ensure_state(self):
        if self._state is None:
            self._state = factorize(self.kern, self.params, self.x, self.y, self.xg, self.g, sigma_f=self.sigma_f,
                                    sigma_g=self.sigma_g, config=self.config)
        return self._state

    def predict(self, xq, grad_out: bool = False):
        return predict(self.kern, self.params, self._ensure_state(), self.x, self.xg, xq, grad_out=grad_out,
                       config=self.config)
