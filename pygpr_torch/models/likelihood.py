"""Negative log marginal likelihood (NLML) and its hyperparameter gradient.

Counterpart of ``pygpr_tpu/models/likelihood.py``.  The value is the
reference's minimization target::

    nlml(θ) = ½ yᵀK⁻¹y + Σ log diag L + ½ n log 2π,   K = k_θ(x, x) + λI

Gradient strategies (``config.grad_mode``):

  * ``"fast"`` — :func:`_nlml_vg_fast_one`: no triangular solves.
    ``(L, T = L⁻¹)`` in one sweep, ``K⁻¹ = TᵀT``, and the gradient as the
    kernel's analytic contraction ⟨½(K⁻¹ − wwᵀ), ∂K/∂θ⟩.
  * ``"ad"`` — autograd through the laddered Cholesky.

A leading committee axis ``[nc, n, d]`` is a loop over experts (fast
mode) or one stack of grams and one batched factorization (value and
``"ad"`` mode).  A leading axis of the parameters alone, ``params [C,
nhp]`` with one shared ``x [n, d]`` (the chains of ``sample.mcmc``), is
the same: the ``[C, n, n]`` stack built in one call with x shared, never
copied.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel, train_gram

Tensor = torch.Tensor


def _const(n: int) -> float:
    return 0.5 * n * math.log(2.0 * math.pi)


def _nlml_one(kern: Kernel, params, x, y, config: Config) -> Tensor:
    L = linalg.safe_cholesky(train_gram(kern, params, x, config), config).chol
    # yᵀK⁻¹y = ‖L⁻¹y‖²: one triangular solve
    z = linalg.solve_lower(L, y)
    return 0.5 * torch.dot(z, z) + linalg.half_logdet_from_chol(L) + _const(y.shape[-1])


def _nlml_batched_vals(kern, params, x, y, config: Config) -> Tensor:
    """NLML ``[nb]`` of a stack: the grams as one stack (``train_gram``:
    one K1 launch for the canonical kernel in f32 on the card), one
    laddered Cholesky over ``[nb, n, n]`` (each matrix on its own rung).
    ``x [nb, n, d]`` with ``params [nb, nhp]`` or ``[nhp]`` (a committee),
    or one shared ``x [n, d]`` with ``params [nb, nhp]`` (chains)."""
    L = linalg.safe_cholesky(train_gram(kern, params, x, config), config).chol
    z = linalg.solve_lower(L, y)
    return 0.5 * torch.sum(z * z, dim=-1) + linalg.half_logdet_from_chol(L) + _const(y.shape[-1])


def nlml(kern: Kernel, params, x, y, config: Config = DEFAULT) -> Tensor:
    """NLML; ``[nc]`` over a leading committee axis of ``x``, ``[C]`` over
    a leading axis of ``params`` alone (one data set, C parameter vectors)."""
    if x.ndim == 3:
        return _nlml_batched_vals(kern, params, x, y, config)
    if params.ndim == 2:
        return _nlml_batched_vals(kern, params, x, y.expand(params.shape[0], -1), config)
    return _nlml_one(kern, params, x, y, config)


def _nlml_vg_fast_one(kern, params, x, y, config) -> Tuple[Tensor, Tensor, Tensor]:
    """Closed-form value and gradient with no triangular solves, and
    ``w = K⁻¹y`` (the NLML's gradient with respect to y).

    The NLML's adjoint with respect to the gram is ``½(K⁻¹ − wwᵀ)``,
    so the gradient is one contraction against ∂K/∂θ:

        z = T y,  w = Tᵀ z,  K⁻¹ = TᵀT

    The kernel's ``gram_adjoint`` gives it in closed form; a kernel
    without one falls back to autograd through the gram build.
    """
    params = params.detach()
    with torch.no_grad():
        krn = train_gram(kern, params, x, config)
        L, T = linalg.chol_and_tri_inverse(krn, config)
        del krn
        z = T @ y
        w = T.T @ z
        val = 0.5 * torch.dot(z, z) + linalg.half_logdet_from_chol(L) + _const(y.shape[-1])
        del L
        Abar = linalg.syrk_from_tril(T)
        del T
        Abar.sub_(torch.outer(w, w)).mul_(0.5)
        grad = kern.gram_adjoint(params, x, Abar, config=config)
    if grad is None:
        p = params.clone().requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(train_gram(kern, p, x, config), p, Abar)
    return val, grad, w


def nlml_value_and_grad(kern: Kernel, params, x, y, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """``(nlml, ∂nlml/∂θ)`` by ``config.grad_mode``; over a committee
    axis ``[nc]`` values and ``[nc, nhp]`` gradients."""
    if config.grad_mode == "fast":
        if x.ndim == 3:
            nc = x.shape[0]
            outs = [
                _nlml_vg_fast_one(kern, params[i] if params.ndim == 2 else params, x[i], y[i], config)
                for i in range(nc)
            ]
            return torch.stack([v for v, _, _ in outs]), torch.stack([g for _, g, _ in outs])
        return _nlml_vg_fast_one(kern, params, x, y, config)[:2]
    if x.ndim == 3:
        # experts are independent: per-expert gradients are the gradient
        # of the sum over the batch-visible stack
        nc = x.shape[0]
        p = (params if params.ndim == 2 else params.expand(nc, -1)).detach().clone().requires_grad_(True)
        with torch.enable_grad():
            vals = _nlml_batched_vals(kern, p, x, y, config)
            (g,) = torch.autograd.grad(vals.sum(), p)
        return vals.detach(), g
    p = params.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        val = _nlml_one(kern, p, x, y, config)
        (g,) = torch.autograd.grad(val, p)
    return val.detach(), g


class _NlmlFast(torch.autograd.Function):
    """NLML whose backward is the fast closed-form gradient (and ``K⁻¹y``
    for a target that needs one, such as a mean's residual)."""

    @staticmethod
    def forward(ctx, params, x, y, kern, config):
        val, grad, w = _nlml_vg_fast_one(kern, params, x, y.detach(), config)
        ctx.save_for_backward(grad, w)
        return val

    @staticmethod
    def backward(ctx, ct):
        grad, w = ctx.saved_tensors
        return ct * grad, None, ct * w if ctx.needs_input_grad[2] else None, None, None


def nlml_fast(kern: Kernel, params, x, y, config: Config = DEFAULT) -> Tensor:
    """NLML whose derivative is the solve-free closed form
    (:func:`_nlml_vg_fast_one`) instead of autograd through the Cholesky:
    the objective of the L-BFGS fit.  Its derivative in ``y`` is
    ``K⁻¹y``.  Without a gradient to track it is the plain value
    (:func:`nlml`)."""
    if not (torch.is_grad_enabled() and (params.requires_grad or y.requires_grad)):
        return nlml(kern, params, x, y, config)
    if x.ndim == 3:
        return torch.stack([
            _NlmlFast.apply(params[i] if params.ndim == 2 else params, x[i], y[i], kern, config)
            for i in range(x.shape[0])
        ])
    return _NlmlFast.apply(params, x, y, kern, config)


def _analytic_one(kern, params, x, y, config):
    krn, dkrn = kern.matrix_and_grad(params, x, config=config)
    L = linalg.safe_cholesky(krn, config).chol
    w = linalg.cholesky_solve(L, y)
    val = 0.5 * torch.dot(w, y) + linalg.half_logdet_from_chol(L) + _const(y.shape[-1])
    tr1 = torch.einsum("i,kij,j->k", w, dkrn, w)        # wᵀ ∂K/∂θₖ w
    kk = linalg.cholesky_solve(L, dkrn)                  # K⁻¹ ∂K/∂θₖ
    tr2 = torch.diagonal(kk, dim1=-2, dim2=-1).sum(-1)
    return val, -0.5 * (tr1 - tr2)


def nlml_and_grad_analytic(kern: Kernel, params, x, y, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """The reference's closed-form value and gradient (O(nhp·n³))."""
    if x.ndim == 3:
        outs = [
            _analytic_one(kern, params[i] if params.ndim == 2 else params, x[i], y[i], config)
            for i in range(x.shape[0])
        ]
        return torch.stack([v for v, _ in outs]), torch.stack([g for _, g in outs])
    return _analytic_one(kern, params, x, y, config)


class Loss:
    """Abstract loss interface (the reference's ``Loss``)."""

    def __init__(self, model):
        self.model = model
        self.loss_value = None
        self.grad_value = None

    def loss(self, params):
        raise NotImplementedError

    def grad(self, params):
        raise NotImplementedError

    def loss_and_grad(self, params):
        raise NotImplementedError


class MLE(Loss):
    """NumPy-in, NumPy-out loss wrapper with the reference ``MLE`` API,
    for SciPy-driven fits.  Caches ``loss_value`` and ``grad_value``."""

    def __init__(self, model, config: Config = DEFAULT, analytic: bool = False):
        super().__init__(model)
        self.config = config
        self._vg = nlml_and_grad_analytic if analytic else nlml_value_and_grad

    def _asdev(self, params) -> Tensor:
        return torch.as_tensor(np.asarray(params), dtype=self.model.x.dtype, device=self.model.x.device)

    def loss(self, params) -> float:
        m = self.model
        with torch.no_grad():
            val = nlml(m.cov, self._asdev(params), m.x, m.y, self.config)
        self.loss_value = val.cpu().numpy()
        return float(val)

    def grad(self, params) -> np.ndarray:
        return self.loss_and_grad(params)[1]

    def loss_and_grad(self, params):
        m = self.model
        v, g = self._vg(m.cov, self._asdev(params), m.x, m.y, self.config)
        self.loss_value = v.detach().cpu().numpy()
        self.grad_value = g.detach().cpu().numpy()
        return float(v), self.grad_value


def log_likelihood_batched(kern, params, x, y, config: Config = DEFAULT) -> Tensor:
    """The reference's batched free function, with its dangling log-det
    and constant terms restored: the full batched NLML."""
    return nlml(kern, params, x, y, config)
