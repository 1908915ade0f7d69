"""GPLVM: the Gaussian process latent variable model (Lawrence, JMLR 2005),
unsupervised nonlinear dimensionality reduction.

Counterpart of ``pygpr_tpu/models/gplvm.py``.  Observed Y [n, p] is
modeled as p independent GPs over a shared latent X [n, q],

    p(Y | X, θ) = Π_j N(y_j ; 0, K(X) + σₙ²I),

and (X, θ) are fitted jointly by MAP (a standard-normal prior on the
latents) with L-BFGS over ``[X.ravel(), log θ]``.  All p outputs share
one Cholesky of the [n, n] latent gram (K3 in f32 on the card for
n ≤ 1024, as the JAX package's Pallas Cholesky) and one [n, p] solve.
The latent gradient runs through ``kern.matrix``, where RBF's squared
distance has the JAX package's straight-through clamp.  PCA init is host
NumPy SVD, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import RBF, Kernel, Sum, WhiteNoise

Tensor = torch.Tensor


def nlml_multi(kern: Kernel, params, x, y2d, *, config: Config = DEFAULT) -> Tensor:
    """Joint NLML of p independent GPs sharing one gram: ``Y [n, p]``, one
    Cholesky, one [n, p] solve."""
    n, p = y2d.shape
    res = linalg.safe_cholesky(kern.matrix(params, x, config=config), config)
    a = linalg.solve_lower(res.chol, y2d)                     # [n, p]
    return (0.5 * torch.sum(torch.square(a)) + p * torch.sum(torch.log(torch.diagonal(res.chol)))
            + 0.5 * n * p * math.log(2.0 * math.pi))


class GPLVMResult(NamedTuple):
    latents: Tensor    #: MAP latent positions [n, q]
    params: Tensor     #: kernel hyperparameters [nhp]
    value: Tensor      #: final MAP objective
    grad_norm: Tensor
    iters: Tensor


def pca_init(y2d, q: int) -> np.ndarray:
    """Host PCA scores scaled to unit variance, the latent init (Lawrence
    §4); the JAX package's NumPy SVD, sign convention included."""
    y2d = y2d.detach().cpu().numpy() if isinstance(y2d, torch.Tensor) else np.asarray(y2d)
    yc = y2d - y2d.mean(0)
    u, s, _ = np.linalg.svd(yc, full_matrices=False)
    x0 = u[:, :q] * s[:q]
    return x0 / (x0.std(0) + 1e-12)


def fit(kern: Kernel, y2d, q: int = 2, *, x0=None, params0=None, prior_weight: float = 1.0, max_iter: int = 300,
        config: Config = DEFAULT, device=None) -> GPLVMResult:
    """Joint MAP fit of latents and hyperparameters by L-BFGS.

    Objective: ``nlml_multi + prior_weight·½‖X‖²``.  ``params0`` defaults
    to all ones (the reference's 1e-4 noise init traps the joint fit in a
    worse embedding than its PCA start).  NumPy ``y2d`` goes to ``device``
    ("cuda" unless given)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    y2d = as_tensor(y2d, device)
    n, p = y2d.shape
    if x0 is None:
        x0 = pca_init(y2d, q)
    x0 = torch.as_tensor(x0, dtype=y2d.dtype, device=y2d.device)
    params0 = (torch.ones(kern.n_params(q), dtype=y2d.dtype, device=y2d.device) if params0 is None
               else torch.as_tensor(params0, dtype=y2d.dtype, device=y2d.device))

    def unpack(u):
        return u[: n * q].reshape(n, q), torch.exp(u[n * q:])

    def objective(u):
        x, theta = unpack(u)
        return nlml_multi(kern, theta, x, y2d, config=config) + 0.5 * prior_weight * torch.sum(torch.square(x))

    u0 = torch.cat([x0.reshape(-1), torch.log(torch.abs(params0))])
    res = minimize_lbfgs(objective, u0, max_iter=max_iter)
    x, theta = unpack(res.params)
    return GPLVMResult(latents=x, params=theta, value=res.value, grad_norm=res.grad_norm, iters=res.iters)


def reconstruct(kern: Kernel, params, x, y2d, xq=None, *, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Posterior mean and variance of Y at latent positions ``xq`` (default
    the training latents: the model's reconstruction of Y).  One
    factorization serves all p outputs."""
    y2d = torch.as_tensor(as_tensor(y2d, x.device), dtype=x.dtype)
    with torch.no_grad():
        res = linalg.safe_cholesky(linalg.add_diag(kern.matrix(params, x, config=config), config.jitter), config)
        w = linalg.cholesky_solve(res.chol, y2d)                  # [n, p]
        xq = x if xq is None else torch.as_tensor(as_tensor(xq, x.device), dtype=x.dtype)
        ks = kern.matrix(params, x, xq, config=config)            # [m, n]
        mean = ks @ w                                             # [m, p]
        v = linalg.solve_lower(res.chol, ks.T)                    # [n, m]
        var = torch.clamp_min(kern.diag(params, xq, config=config) - torch.sum(v * v, 0), config.jitter)
    return mean, var


class GPLVM:
    """Stateful wrapper: ``GPLVM(Y, q=2).train()``; latents in ``.latents``,
    the reconstruction by ``.reconstruct()``.  The kernel defaults to
    RBF + WhiteNoise over the latent space."""

    def __init__(self, y2d, q: int = 2, kern: Optional[Kernel] = None, config: Config = DEFAULT, device=None):
        self.y2d = as_tensor(y2d, device)
        self.q = q
        self.kern = kern if kern is not None else Sum((RBF(), WhiteNoise()))
        self.config = config
        self.latents: Optional[Tensor] = None
        self.params: Optional[Tensor] = None

    def train(self, **kw) -> "GPLVM":
        res = fit(self.kern, self.y2d, self.q, config=self.config, **kw)
        self.latents, self.params = res.latents, res.params
        self.value = res.value
        return self

    def reconstruct(self, xq=None):
        if self.latents is None:
            raise RuntimeError("call train() first")
        return reconstruct(self.kern, self.params, self.latents, self.y2d, xq, config=self.config)
