"""SVGP: the stochastic (uncollapsed) variational GP, trained on minibatches.

Counterpart of ``pygpr_tpu/models/svgp.py`` (Hensman et al. 2013, 2015)::

    q(u) = N(m_u, S) over f at m inducing points z,
    ELBO = Σᵢ E_{q(fᵢ)}[log p(yᵢ | fᵢ)] − KL(q(u) ‖ p(u)),

the data term estimated on minibatches (scaled n/|B|, unbiased), for any
likelihood of ``models.obs``.  The parameterization is whitened,
``u = L v``, ``q(v) = N(m_w, S_w)`` with L = chol K_uu, so the KL is
against N(0, I) and S_w = I is the prior.  K_uu goes through the
laddered ``safe_cholesky`` (kernel K3 at m ≤ 1024 in f32 on the card)
and ``tri_inverse_doubling``; the rest is tall products.

The minibatch schedule is drawn on the host with NumPy from a seed
(:func:`make_batches`, the JAX package's own draw), and the fit is
optax's Adam (``optimize.adam``).  With ``GaussianLik``,
:func:`optimal_q_gaussian` gives the closed-form optimum, at which the
bound equals the collapsed SGPR bound of ``models.sgpr``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.sgpr import _check_noise_free, init_inducing
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel
from pygpr_torch.optimize.adam import Adam

Tensor = torch.Tensor


class SVGPParams(NamedTuple):
    """Trainable state.  ``ls_raw`` gives the whitened covariance factor
    ``L_s = strict_tril(ls_raw) + diag(exp(diag(ls_raw)))``; zeros give
    ``S_w = I``."""

    log_theta: Tensor  #: kernel hyperparameters, log-space [nhp]
    lik: Tensor        #: likelihood parameters (unconstrained) [nl]
    z: Tensor          #: inducing locations [m, d]
    m_w: Tensor        #: whitened variational mean [m]
    ls_raw: Tensor     #: raw whitened factor [m, m]


def _ls(ls_raw: Tensor) -> Tensor:
    """``strict_tril(ls_raw) + diag(exp(diag(ls_raw)))``, over any leading axes."""
    return torch.tril(ls_raw, -1) + torch.diag_embed(torch.exp(torch.diagonal(ls_raw, dim1=-2, dim2=-1)))


def init_variational(kern: Kernel, lik, x: Tensor, z, config: Config = DEFAULT) -> SVGPParams:
    """All-ones kernel init, q(v) = the prior N(0, I)."""
    theta = kern.init_params(x, config)
    z = torch.as_tensor(as_tensor(z, x.device), dtype=x.dtype)
    m = z.shape[0]
    return SVGPParams(log_theta=torch.log(torch.abs(theta)), lik=lik.init_params(x.dtype, x.device), z=z,
                      m_w=torch.zeros(m, dtype=x.dtype, device=x.device),
                      ls_raw=torch.zeros((m, m), dtype=x.dtype, device=x.device))


def _whitened_a(kern, theta, z, xb, config):
    """``(A = L⁻¹ K_uf [m, nb], ok)``, L = chol K_uu by the ladder."""
    res = linalg.safe_cholesky(kern.matrix(theta, z, config=config), config)
    return linalg.tri_inverse_doubling(res.chol) @ kern.matrix(theta, xb, z, config=config), res.ok


def _latent_marginals(kern, theta, vp: SVGPParams, xb, config):
    """q(f) marginals at xb: μ = Aᵀm_w, σ² = k − ΣA² + Σ(L_sᵀA)²."""
    A, ok = _whitened_a(kern, theta, vp.z, xb, config)
    mu = A.T @ vp.m_w
    SA = _ls(vp.ls_raw).T @ A
    var = kern.diag(theta, xb, config=config) - torch.sum(A * A, 0) + torch.sum(SA * SA, 0)
    return mu, torch.clamp_min(var, config.jitter), ok


def kl_whitened(vp: SVGPParams) -> Tensor:
    """KL(N(m_w, L_sL_sᵀ) ‖ N(0, I)) in closed form."""
    Ls = _ls(vp.ls_raw)
    m = vp.m_w.shape[0]
    return 0.5 * (torch.dot(vp.m_w, vp.m_w) + torch.sum(Ls * Ls) - m) - torch.sum(torch.diagonal(vp.ls_raw))


def neg_elbo(kern: Kernel, lik, vp: SVGPParams, xb: Tensor, yb: Tensor, *, scale: float = 1.0,
             config: Config = DEFAULT) -> Tensor:
    """Minibatch negative ELBO ``KL − scale · Σ_batch E[log p(y|f)]``;
    ``scale = n_total / batch`` makes it unbiased in the batch."""
    theta = torch.exp(vp.log_theta)
    mu, var, _ = _latent_marginals(kern, theta, vp, xb, config)
    return kl_whitened(vp) - scale * torch.sum(lik.expected_log_lik(vp.lik, yb, mu, var))


def predict(kern: Kernel, lik, vp: SVGPParams, xp, space: str = "y", config: Config = DEFAULT
            ) -> Tuple[Tensor, Tensor]:
    """Posterior predictive at xp: the latent marginals (μ, σ²) for
    ``space="f"``, mapped through the likelihood for ``space="y"``."""
    xp = torch.as_tensor(as_tensor(xp, vp.z.device), dtype=vp.z.dtype)
    mu, var, _ = _latent_marginals(kern, torch.exp(vp.log_theta), vp, xp, config)
    if space == "f":
        return mu, var
    return lik.predict(vp.lik, mu, var)


def optimal_q_gaussian(kern: Kernel, vp: SVGPParams, x: Tensor, y: Tensor, config: Config = DEFAULT) -> SVGPParams:
    """Closed-form optimal (m_w, S_w) for the Gaussian likelihood:
    ``S_w = (I + AAᵀ/σₙ²)⁻¹``, ``m_w = S_w A y / σₙ²``, ``A = L⁻¹K_uf``.
    Substituted back, the ELBO is Titsias' collapsed SGPR bound."""
    theta = torch.exp(vp.log_theta)
    sn2 = torch.exp(2.0 * vp.lik[0])
    A, _ = _whitened_a(kern, theta, vp.z, x, config)
    P = linalg.add_diag(A @ A.T / sn2, 1.0)
    S = linalg.inv_from_chol(linalg.safe_cholesky(P, config).chol)
    m_w = S @ (A @ y) / sn2
    Ls = linalg.safe_cholesky(S, config).chol
    return vp._replace(m_w=m_w, ls_raw=torch.tril(Ls, -1) + torch.diag(torch.log(torch.diagonal(Ls))))


class SVGPFit(NamedTuple):
    params: SVGPParams  #: final variational and hyper parameters
    losses: Tensor      #: per-step minibatch −ELBO [n_steps]


def make_batches(n: int, batch: int, n_steps: int, seed: int = 0) -> np.ndarray:
    """Host-side minibatch index schedule ``[n_steps, batch]``: reshuffled
    epoch permutations, wrapped cyclically (the JAX package's NumPy draw,
    so the same batches)."""
    rng = np.random.default_rng(seed)
    per_epoch = max(n // batch, 1)
    idx = []
    while len(idx) < n_steps:
        perm = rng.permutation(n)
        for b in range(per_epoch):
            idx.append(perm[b * batch: (b + 1) * batch])
            if len(idx) == n_steps:
                break
    return np.stack(idx).astype(np.int32)


def _adam_step(loss_fn, vp: SVGPParams, opt: Adam, opt_z: bool):
    """One Adam step on ``loss_fn(vp)``; returns ``(vp, loss)``."""
    frozen = () if opt_z else (SVGPParams._fields.index("z"),)
    leaves, val = opt.value_and_step(lambda t: loss_fn(SVGPParams(*t)), list(vp), frozen)
    return SVGPParams(*leaves), val


def fit(kern: Kernel, lik, x, y, z0, *, vp0: Optional[SVGPParams] = None, batch_size: Optional[int] = None,
        n_steps: int = 500, learning_rate: float = 0.05, opt_z: bool = True, seed: int = 0,
        config: Config = DEFAULT, batch_sharding=None, segment_steps: Optional[int] = None,
        device=None) -> SVGPFit:
    """Adam on the minibatch negative ELBO over the host-drawn schedule;
    ``opt_z=False`` freezes the inducing locations.  ``segment_steps``
    rounds ``n_steps`` up to whole segments, as the JAX package does (its
    segments bound the length of one device call; here every step is its
    own).  ``batch_sharding`` (the data-parallel path) must be None."""
    if batch_sharding is not None:
        raise NotImplementedError("batch_sharding: the data-parallel SVGP fit is not ported; pass None")
    _check_noise_free(kern)
    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    n = x.shape[0]
    nb = batch_size or min(n, 512)
    if vp0 is None:
        vp0 = init_variational(kern, lik, x, z0, config)
    if segment_steps is not None:
        n_steps = -(-n_steps // segment_steps) * segment_steps
    sched = torch.as_tensor(make_batches(n, nb, n_steps, seed), dtype=torch.int64, device=x.device)
    scale = n / nb
    opt = Adam(list(vp0), learning_rate)
    vp, losses = vp0, []
    for idx in sched:
        xb, yb = x[idx], y[idx]
        vp, val = _adam_step(lambda v: neg_elbo(kern, lik, v, xb, yb, scale=scale, config=config), vp, opt, opt_z)
        losses.append(val)
    return SVGPFit(vp, torch.stack(losses))


def fit_streamed(kern: Kernel, lik, dataset, z0, *, vp0: Optional[SVGPParams] = None, batch_size: int = 1024,
                 epochs: int = 1, learning_rate: float = 0.05, opt_z: bool = True, seed: int = 0,
                 sync_every: int = 50, config: Config = DEFAULT, device=None) -> SVGPFit:
    """Minibatch Adam over an out-of-core dataset: anything with ``.n``,
    ``.x`` (indexable on the host) and ``minibatches(batch_size, seed=,
    epochs=)`` yielding NumPy ``(xb, yb)`` of full batches.  Each batch
    goes to ``device`` ("cuda" unless given) as it comes; ``sync_every``
    steps the host reads a loss, bounding the queued work."""
    _check_noise_free(kern)
    n = dataset.n
    if vp0 is None:
        head = as_tensor(np.array(dataset.x[: max(4 * batch_size, 1024)]), device)
        vp0 = init_variational(kern, lik, head, z0, config)
    dev, dtype = vp0.z.device, vp0.z.dtype
    scale = n / batch_size
    opt = Adam(list(vp0), learning_rate)
    vp, losses = vp0, []
    for xb, yb in dataset.minibatches(batch_size, seed=seed, epochs=epochs):
        xb = torch.as_tensor(np.asarray(xb), dtype=dtype, device=dev)
        yb = torch.as_tensor(np.asarray(yb), dtype=dtype, device=dev)
        vp, val = _adam_step(lambda v: neg_elbo(kern, lik, v, xb, yb, scale=scale, config=config), vp, opt, opt_z)
        losses.append(val)
        if len(losses) % sync_every == 0:
            float(val)  # bound in-flight device work
    if not losses:
        raise ValueError("dataset yielded no full batches")
    return SVGPFit(vp, torch.stack(losses))


class SVGP:
    """Stateful wrapper in the style of :class:`~pygpr_torch.models.sgpr.SGPR`.

    >>> model = SVGP(x, y, RBF(), BernoulliLogit(), m=128)
    >>> model.train(n_steps=1000)
    >>> p, _ = model.predict(xs)              # class-1 probability
    """

    def __init__(self, x, y, cov: Kernel, lik, m: int = 128, z=None, seed: int = 0, config: Config = DEFAULT,
                 device=None):
        _check_noise_free(cov)
        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.cov, self.lik, self.config = cov, lik, config
        z = z if z is not None else init_inducing(self.x, m, seed)
        self.vp = init_variational(cov, lik, self.x, z, config)

    def train(self, **kw) -> SVGPFit:
        res = fit(self.cov, self.lik, self.x, self.y, self.vp.z, vp0=self.vp, config=self.config, **kw)
        self.vp = res.params
        return res

    def predict(self, xp, space: str = "y"):
        with torch.no_grad():
            return predict(self.cov, self.lik, self.vp, xp, space, self.config)

    def neg_elbo(self) -> Tensor:
        with torch.no_grad():
            return neg_elbo(self.cov, self.lik, self.vp, self.x, self.y, config=self.config)
