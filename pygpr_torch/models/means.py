"""Explicit prior mean functions for exact GP regression.

Counterpart of ``pygpr_tpu/models/means.py``.  The reference is zero-mean
everywhere; an explicit parametric mean m(x) (R&W §2.7) gives

    f ~ GP(m(x), k),   nlml(θ) = ½ rᵀK⁻¹r + Σ log diag L + ½n log 2π,
    r = y − m(x);      posterior mean at x* = m(x*) + K* K⁻¹ r.

A :class:`Mean` is a stateless parametric function, and the GP with a
mean is "subtract m(x), run the zero-mean engine on the residuals, add
m(x*) back".  The joint parameter vector is ``θ = [θ_kernel, θ_mean]``;
:func:`fit_gp_mean` searches the kernel's part in log space (scales) and
the mean's raw (signed coefficients).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.models.exact_gp import GPState
from pygpr_torch.models.likelihood import nlml, nlml_fast
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


class Mean:
    """Stateless parametric prior mean."""

    def n_params(self, dim: int) -> int:
        raise NotImplementedError

    def init_params(self, x: Tensor, y: Optional[Tensor] = None, config: Config = DEFAULT) -> Tensor:
        """Data-informed initial parameters, ``[n_params]``."""
        raise NotImplementedError

    def __call__(self, params: Tensor, x: Tensor, *, config: Config = DEFAULT) -> Tensor:
        """m(x): ``[n, d] -> [n]``."""
        raise NotImplementedError


class ZeroMean(Mean):
    """m(x) = 0, the reference's implicit mean."""

    def n_params(self, dim: int) -> int:
        return 0

    def init_params(self, x, y=None, config: Config = DEFAULT):
        return x.new_zeros((0,))

    def __call__(self, params, x, *, config: Config = DEFAULT):
        return x.new_zeros(x.shape[:-1])


class ConstantMean(Mean):
    """m(x) = c.  One signed parameter; init mean(y) when given."""

    def n_params(self, dim: int) -> int:
        return 1

    def init_params(self, x, y=None, config: Config = DEFAULT):
        if y is None:
            return x.new_zeros((1,))
        return torch.mean(y, dim=-1, keepdim=True).to(x.dtype)

    def __call__(self, params, x, *, config: Config = DEFAULT):
        return params[0].expand(x.shape[:-1])


class LinearMean(Mean):
    """m(x) = b + x·w, an affine trend.  Params ``[b, w₁..w_d]``; init the
    least-squares fit of y on [1, x]."""

    def n_params(self, dim: int) -> int:
        return dim + 1

    def init_params(self, x, y=None, config: Config = DEFAULT):
        if y is None:
            return x.new_zeros((x.shape[-1] + 1,))
        a = torch.cat([x.new_ones(x.shape[:-1] + (1,)), x], dim=-1)
        return torch.linalg.lstsq(a, y[..., None]).solution[..., 0].to(x.dtype)

    def __call__(self, params, x, *, config: Config = DEFAULT):
        return params[0] + torch.einsum("...d,d->...", x, params[1:])


def n_params_joint(kern: Kernel, mean: Mean, dim: int) -> int:
    return kern.n_params(dim) + mean.n_params(dim)


def init_params_joint(kern: Kernel, mean: Mean, x, y, config: Config = DEFAULT) -> Tensor:
    return torch.cat([kern.init_params(x, config), mean.init_params(x, y, config)])


def split_params(kern: Kernel, mean: Mean, theta, dim: int) -> Tuple[Tensor, Tensor]:
    nk = kern.n_params(dim)
    return theta[..., :nk], theta[..., nk:]


def nlml_mean(kern: Kernel, mean: Mean, theta, x, y, config: Config = DEFAULT) -> Tensor:
    """NLML of the GP with prior mean: the zero-mean NLML of the residuals
    r = y − m(x) (``likelihood.nlml`` under :class:`ZeroMean`)."""
    pk, pm = split_params(kern, mean, theta, x.shape[-1])
    return nlml(kern, pk, x, y - mean(pm, x, config=config), config)


def factorize_mean(kern: Kernel, mean: Mean, theta, x, y, config: Config = DEFAULT, device=None) -> GPState:
    """Posterior state on the residuals r = y − m(x): the state's ``y``
    holds them; pass the same ``theta`` to :func:`predict_mean`."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    theta = torch.as_tensor(theta, dtype=x.dtype, device=x.device)
    pk, pm = split_params(kern, mean, theta, x.shape[-1])
    return exact_gp.factorize(kern, pk, x, y - mean(pm, x, config=config), config)


def predict_mean(kern: Kernel, mean: Mean, theta, state: GPState, xp, var: str = "full",
                 config: Config = DEFAULT):
    """Posterior mean and uncertainty with the prior mean added back,
    μ(x*) = m(x*) + K* K⁻¹ (y − m(x)); the covariance is the zero-mean
    GP's."""
    theta = torch.as_tensor(theta, dtype=state.x.dtype, device=state.x.device)
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    _, pm = split_params(kern, mean, theta, state.x.shape[-1])
    mu, cov = exact_gp.predict(kern, state, xp, var, config)
    return mu + mean(pm, xp, config=config), cov


def fit_gp_mean(kern: Kernel, mean: Mean, x, y, theta0=None, *, config: Config = DEFAULT, max_iter: int = 200,
                tol: float = 1e-4, memory_size: int = 15, device=None):
    """Joint maximum-likelihood fit of kernel and mean parameters with
    L-BFGS: kernel parameters in log space, mean parameters raw.  The
    NLML's gradient is the fast closed form (``nlml_fast``, its y-part
    carrying the mean's) under ``config.grad_mode == "fast"``, else
    autograd through the Cholesky.  Returns a ``FitResult`` whose
    ``params`` is the joint ``[θ_kernel, θ_mean]``.  NumPy ``x``/``y`` go
    to ``device`` ("cuda" unless given)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    nk = kern.n_params(x.shape[-1])
    if theta0 is None:
        theta0 = init_params_joint(kern, mean, x, y, config)
    theta0 = torch.as_tensor(theta0, dtype=x.dtype, device=x.device)
    objective = nlml_fast if config.grad_mode == "fast" else nlml

    def unpack(u):
        return torch.cat([torch.exp(u[..., :nk]), u[..., nk:]])

    def loss(u):
        pk, pm = split_params(kern, mean, unpack(u), x.shape[-1])
        return objective(kern, pk, x, y - mean(pm, x, config=config), config)

    u0 = torch.cat([torch.log(theta0[..., :nk]), theta0[..., nk:]])
    res = minimize_lbfgs(loss, u0, max_iter=max_iter, tol=tol, memory_size=memory_size)
    return res._replace(params=unpack(res.params))
