"""Exact GP on Cartesian-product grids via Kronecker algebra
(Saatçi 2011, "Scalable inference for structured GP models", ch. 5).

Counterpart of ``pygpr_tpu/models/kronecker.py``.  When the training
inputs form a grid ``X = x⁽¹⁾ × … × x⁽ᴰ⁾`` and the kernel is a tensor
product over dimensions (``ops/kernels.Separable``:
``K = σ²·Π_d φ(ℓ_d|Δx_d|)``), the N×N gram is ``σ²·K₁ ⊗ … ⊗ K_D`` and

    K + σₙ²I = (⊗_d Q_d)(σ²·⊗_d Λ_d + σₙ²I)(⊗_d Q_d)ᵀ

from one small symmetric eigendecomposition per axis
(``torch.linalg.eigh``: cuSOLVER on the card), so exact inference costs
O(Σ_d G_d³ + N·Σ_d G_d) instead of O(N³).  The N-sized work is mode-d
products (``tensordot`` over the matricized tensor, IEEE f32 on the card:
TF32 stays off, ``pygpr_torch/config.py``).

Eigenvector signs and the order within clusters of eigenvalues are
cuSOLVER's or LAPACK's, not the JAX package's: the NLML, its gradient,
α and the predictions are invariant to them, ``eigvecs`` and the rotated
targets are not.  Hyperparameter gradients flow by autograd through
``eigh`` (distinct grid points give simple eigenvalues in exact
arithmetic).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops.kernels import Separable, _abs

Tensor = torch.Tensor


def _axis_gram(profile_fn, ls_d: Tensor, ax: Tensor) -> Tensor:
    """1-D correlation matrix φ(ℓ|xᵢ − xⱼ|) for one grid axis [G, G]."""
    r = _abs(ax[:, None] - ax[None, :]) * _abs(ls_d)
    return profile_fn(r)


def _cross_axis(profile_fn, ls_d: Tensor, xq_d: Tensor, ax: Tensor) -> Tensor:
    """1-D cross-correlation φ(ℓ|x*_d − axis|) → [nq, G]."""
    r = _abs(xq_d[:, None] - ax[None, :]) * _abs(ls_d)
    return profile_fn(r)


def _tucker_apply(mats: Sequence[Tensor], t: Tensor) -> Tensor:
    """(⊗_d M_d)·vec(t) as mode-d products: t ← M_d ×_d t for all d.

    ``mats[d]`` is [G_d', G_d]; ``t`` is [G_1..G_D]."""
    for d, m in enumerate(mats):
        t = torch.movedim(torch.tensordot(m, t, dims=([1], [d])), 0, d)
    return t


def _contract_queries(vecs: Sequence[Tensor], t: Tensor) -> Tensor:
    """Σ_grid t[g₁..g_D]·Π_d vecs[d][q, g_d] → [nq] (per-query full
    contraction; the Kronecker cross-kernel row never materializes)."""
    out = torch.tensordot(vecs[0], t, dims=([1], [0]))
    for v in vecs[1:]:
        out = torch.einsum("qg,qg...->q...", v, out)
    return out


class KronState(NamedTuple):
    """Factorized grid posterior."""

    axes: Tuple[Tensor, ...]     #: per-dim grid coordinates [G_d]
    params: Tensor               #: [σ, ℓ₁..ℓ_D, σₙ]
    eigvecs: Tuple[Tensor, ...]  #: per-dim Q_d [G_d, G_d]
    denom: Tensor                #: σ²·⊗λ + σₙ² as a [G₁..G_D] tensor
    alpha: Tensor                #: (K + σₙ²I)⁻¹y as a [G₁..G_D] tensor
    nlml: Tensor                 #: exact negative log marginal likelihood
    ok: Tensor


def _decompose(kern: Separable, params: Tensor, axes, y_t: Tensor, config: Config):
    """Shared eigen-machinery: returns (Qs, denom, y_rot, nlml)."""
    sig, sn = params[0], params[-1]
    ls = params[1:-1]
    qs, lams = [], []
    for d, ax in enumerate(axes):
        lam_d, q_d = torch.linalg.eigh(_axis_gram(kern.profile_fn, ls[d], ax))
        qs.append(q_d)
        # PSD up to round-off; torch.maximum halves the gradient at a tie,
        # as jnp.maximum does (clamp_min would pass it whole)
        lams.append(torch.maximum(lam_d, torch.zeros_like(lam_d)))

    # σ²·⊗λ + σₙ² as a dense [G1..GD] tensor (size N — same as y)
    lam = lams[0]
    for l_d in lams[1:]:
        lam = lam[..., None] * l_d
    denom = torch.square(sig) * lam + torch.square(sn)

    y_rot = _tucker_apply([q.T for q in qs], y_t)
    n = y_t.numel()
    nlml = 0.5 * (torch.sum(torch.square(y_rot) / denom) + torch.sum(torch.log(denom))
                  + n * math.log(2.0 * math.pi))
    return qs, denom, y_rot, nlml


def _shape(axes) -> Tuple[int, ...]:
    return tuple(int(a.shape[0]) for a in axes)


def nlml_kron(kern: Separable, params: Tensor, axes: Sequence[Tensor], y: Tensor,
              config: Config = DEFAULT) -> Tensor:
    """Exact NLML of the grid GP: the dense ``likelihood.nlml`` of
    ``Sum((Separable, WhiteNoise))`` on the meshgrid, at O(ΣG³).

    ``params = [σ, ℓ₁..ℓ_D, σₙ]``; ``y`` is the [G₁..G_D] grid tensor (or
    flat [N] in C order of ``meshgrid(indexing="ij")``)."""
    _, _, _, val = _decompose(kern, params, axes, y.reshape(_shape(axes)), config)
    return val


def factorize_kron(kern: Separable, params: Tensor, axes: Sequence[Tensor], y: Tensor,
                   config: Config = DEFAULT) -> KronState:
    """Build the posterior state: α = (⊗Q)(ỹ/denom) in tensor form."""
    y_t = y.reshape(_shape(axes))
    qs, denom, y_rot, val = _decompose(kern, params, axes, y_t, config)
    alpha = _tucker_apply(qs, y_rot / denom)
    return KronState(axes=tuple(axes), params=params, eigvecs=tuple(qs), denom=denom, alpha=alpha, nlml=val,
                     ok=torch.isfinite(val))


def predict_kron(kern: Separable, state: KronState, xq: Tensor, var: str = "diag", config: Config = DEFAULT):
    """Exact posterior moments at arbitrary (off-grid) queries.

    The cross row k(x*, grid) = σ²·⊗_d φ_d(x*_d) factorizes, so the mean
    is a per-dim contraction of α and the variance a contraction of
    1/denom with the squared rotated factors — never an [nq, N] matrix.
    """
    sig = state.params[0]
    ls = state.params[1:-1]
    cross = [_cross_axis(kern.profile_fn, ls[d], xq[:, d], ax) for d, ax in enumerate(state.axes)]
    sig2 = torch.square(sig)
    mean = sig2 * _contract_queries(cross, state.alpha)
    if var == "none":
        return mean, None
    # u = (⊗Qᵀ)k* = σ²·⊗(Q_dᵀφ_d*);  var = k** − Σ u²/denom
    w2 = [torch.square(c @ q) for c, q in zip(cross, state.eigvecs)]
    quad = _contract_queries(w2, 1.0 / state.denom)
    v = sig2 - torch.square(sig2) * quad
    return mean, torch.maximum(v, torch.as_tensor(config.jitter, dtype=v.dtype, device=v.device))


class FitKronResult(NamedTuple):
    state: KronState
    params: Tensor
    nlml: Tensor
    converged: Tensor


def _default_params(d: int, like: Tensor) -> Tensor:
    return torch.cat([torch.ones(d + 1, dtype=like.dtype, device=like.device),
                      torch.full((1,), 0.3, dtype=like.dtype, device=like.device)])


def fit_kron(kern: Separable, axes: Sequence[Tensor], y: Tensor, params0: Optional[Tensor] = None, *,
             max_iter: int = 150, tol: float = 1e-4, config: Config = DEFAULT) -> FitKronResult:
    """L-BFGS on the exact grid NLML, log-space (``fit_mle`` policy)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    if params0 is None:
        params0 = _default_params(len(axes), y)
    u0 = torch.log(torch.abs(params0))
    res = minimize_lbfgs(lambda u: nlml_kron(kern, torch.exp(u), axes, y, config), u0, max_iter=max_iter,
                         tol=tol)
    p_fit = torch.exp(res.params)
    with torch.no_grad():
        state = factorize_kron(kern, p_fit, axes, y, config)
    return FitKronResult(state=state, params=p_fit, nlml=state.nlml, converged=res.converged)


class KroneckerGP:
    """OO wrapper for grid data.  NumPy inputs go to ``device``
    (``"cuda"`` unless given, see ``config.as_tensor``).

    >>> gp = KroneckerGP([ax1, ax2], y_grid, profile="rbf")
    >>> gp.train()
    >>> mean, var = gp.predict(xq)
    """

    def __init__(self, axes, y, profile: str = "rbf", params=None, config: Config = DEFAULT, device=None):
        self.axes = [as_tensor(a, device) for a in axes]
        dev = self.axes[0].device
        self.y = as_tensor(y, dev)
        self.cov = Separable(profile)
        self.config = config
        self.params = _default_params(len(self.axes), self.y) if params is None else as_tensor(params, dev)
        self._state: Optional[KronState] = None

    def train(self, max_iter: int = 150, **kwargs) -> FitKronResult:
        res = fit_kron(self.cov, self.axes, self.y, self.params, max_iter=max_iter, config=self.config, **kwargs)
        self.params = res.params
        self._state = res.state
        return res

    def update(self) -> KronState:
        if self._state is None:
            with torch.no_grad():
                self._state = factorize_kron(self.cov, self.params, self.axes, self.y, self.config)
        return self._state

    def predict(self, xq, var: str = "diag"):
        with torch.no_grad():
            return predict_kron(self.cov, self.update(), as_tensor(xq, self.y.device), var, self.config)
