"""Deep GP by doubly stochastic variational inference (Salimbeni and
Deisenroth 2017).

Counterpart of ``pygpr_tpu/models/deepgp.py``: GP layers
``f = f_L ∘ … ∘ f_1``, each a whitened sparse variational GP (the
machinery of ``models.svgp``), the bound sampled through the hidden
layers and the last layer's expectation taken analytically::

    ELBO = E_{q(f_1..L)}[ Σᵢ E[log p(yᵢ | f_L,i)] ] − Σ_l KL_l.

Hidden layers carry a fixed identity/linear skip mean, so the network
starts near the identity.  Every K_uu goes through the laddered
``safe_cholesky`` (kernel K3 at m ≤ 1024 in f32 on the card).  All
randomness (the minibatch schedule and the reparameterization noise) is
host NumPy from a seed, the JAX package's own draws.  A depth-1 deep GP
has no sampled layer: its bound is SVGP's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.svgp import _ls, _whitened_a, make_batches
from pygpr_torch.ops.kernels import RBF, Kernel
from pygpr_torch.optimize.adam import Adam

Tensor = torch.Tensor


class LayerParams(NamedTuple):
    """Trainable state of one whitened SVGP layer of width ``w``."""

    log_theta: Tensor  #: kernel hyperparameters, log-space [nhp]
    z: Tensor          #: inducing locations [m, d_in]
    m_w: Tensor        #: whitened variational means [w, m]
    ls_raw: Tensor     #: raw whitened factors [w, m, m]


class DGPParams(NamedTuple):
    layers: Tuple[LayerParams, ...]
    lik: Tensor  #: likelihood parameters (unconstrained)


def _skip_weight(d_in: int, w: int, dtype) -> np.ndarray:
    """Fixed linear mean W [d_in, w]: the identity, padded or truncated."""
    W = np.zeros((d_in, w), dtype=np.dtype(dtype).name)
    for j in range(w):
        W[j % d_in, j] = 1.0
    return W


def skip_means(widths: Sequence[int], d_in: int, dtype=np.float32) -> Tuple[np.ndarray, ...]:
    """Per-hidden-layer fixed skip means for a width schedule."""
    means = []
    d = d_in
    for w in widths:
        means.append(_skip_weight(d, w, dtype))
        d = w
    return tuple(means)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def init_deep(kerns: Sequence[Kernel], lik, x: Tensor, widths: Sequence[int], m: int = 32, *, seed: int = 0,
              config: Config = DEFAULT) -> DGPParams:
    """An L-layer deep GP (L = len(kerns); the last layer has width 1,
    ``widths`` are the L − 1 hidden widths).  Inducing inputs: an m-point
    host subset of x for layer 1, pushed through the skip means for the
    deeper ones.  Hidden layers start near-deterministic (S_w = 1e-4·I),
    the last at the prior (S_w = I)."""
    if len(widths) != len(kerns) - 1:
        raise ValueError(f"{len(kerns)} kernels need {len(kerns) - 1} hidden widths, got {len(widths)}")
    rng = np.random.default_rng(seed)
    xn = _np(x)
    n, d = xn.shape
    z = xn[rng.choice(n, size=min(m, n), replace=False)]
    means = skip_means(widths, d, xn.dtype)
    layers = []
    for li, (kern, w) in enumerate(zip(kerns, list(widths) + [1])):
        zj = torch.as_tensor(z, device=x.device)
        theta = kern.init_params(zj, config)
        mm = z.shape[0]
        hidden = li < len(kerns) - 1
        ls0 = float(np.log(1e-2 if hidden else 1.0))
        layers.append(LayerParams(
            log_theta=torch.log(torch.abs(theta)), z=zj,
            m_w=torch.zeros((w, mm), dtype=zj.dtype, device=x.device),
            ls_raw=(ls0 * torch.eye(mm, dtype=zj.dtype, device=x.device)).expand(w, mm, mm).clone()))
        if hidden:
            z = z @ means[li]
    return DGPParams(layers=tuple(layers), lik=lik.init_params(x.dtype, x.device))


def _layer_marginals(kern, lp: LayerParams, xb, config):
    """q(f) marginals of one layer at xb: μ ``[w, nb]``, σ² ``[w, nb]``."""
    theta = torch.exp(lp.log_theta)
    A, _ = _whitened_a(kern, theta, lp.z, xb, config)        # [m, nb]
    mu = lp.m_w @ A                                           # [w, nb]
    SA = _ls(lp.ls_raw).mT @ A                                # [w, m, nb]
    var = kern.diag(theta, xb, config=config)[None] - torch.sum(A * A, 0)[None] + torch.sum(SA * SA, dim=1)
    return mu, torch.clamp_min(var, config.jitter)


def _kl_layer(lp: LayerParams) -> Tensor:
    """Σ over the layer's units of KL(N(m_w, L_sL_sᵀ) ‖ N(0, I))."""
    Ls = _ls(lp.ls_raw)
    mm = lp.m_w.shape[-1]
    per_unit = (0.5 * (torch.sum(lp.m_w * lp.m_w, dim=-1) + torch.sum(Ls * Ls, dim=(-2, -1)) - mm)
                - torch.sum(torch.diagonal(lp.ls_raw, dim1=-2, dim2=-1), dim=-1))
    return torch.sum(per_unit)


def propagate(kerns, params: DGPParams, means, xb: Tensor, eps: Tensor, config: Config = DEFAULT):
    """One sampled pass through the hidden layers; the last layer's
    analytic marginals ``(μ [nb], σ² [nb])``.  ``eps [Σw_hidden, nb]`` is
    this sample's reparameterization noise, split per hidden layer."""
    h = xb
    off = 0
    for li, kern in enumerate(kerns[:-1]):
        mu, var = _layer_marginals(kern, params.layers[li], h, config)
        w = mu.shape[0]
        f = mu + torch.sqrt(var) * eps[off: off + w]
        off += w
        h = f.T + h @ torch.as_tensor(means[li], dtype=h.dtype, device=h.device)
    mu, var = _layer_marginals(kerns[-1], params.layers[-1], h, config)
    return mu[0], var[0]


def neg_elbo(kerns, lik, params: DGPParams, means, xb: Tensor, yb: Tensor, eps: Tensor, *, scale: float = 1.0,
             config: Config = DEFAULT) -> Tensor:
    """Doubly stochastic minibatch −ELBO; ``eps [S, Σw_hidden, nb]``
    carries S samples through the network (one suffices, and is used,
    with no hidden layer: the bound is then exact)."""
    def one(e):
        mu, var = propagate(kerns, params, means, xb, e, config)
        return torch.sum(lik.expected_log_lik(params.lik, yb, mu, var))

    ell = one(eps[0]) if len(kerns) == 1 else torch.mean(torch.stack([one(e) for e in eps]))
    return sum(_kl_layer(lp) for lp in params.layers) - scale * ell


class DGPFit(NamedTuple):
    params: DGPParams
    losses: Tensor


def _flatten(p: DGPParams):
    return [t for lp in p.layers for t in lp] + [p.lik]


def _unflatten(leaves, n_layers: int) -> DGPParams:
    k = len(LayerParams._fields)
    return DGPParams(layers=tuple(LayerParams(*leaves[i * k:(i + 1) * k]) for i in range(n_layers)),
                     lik=leaves[n_layers * k])


def fit(kerns, lik, x, y, *, widths: Sequence[int] = (1,), m: int = 32, params0: Optional[DGPParams] = None,
        n_samples: int = 3, batch_size: Optional[int] = None, n_steps: int = 400, learning_rate: float = 0.02,
        seed: int = 0, config: Config = DEFAULT, device=None) -> DGPFit:
    """Adam on the doubly stochastic bound over a host-drawn minibatch
    schedule and host-drawn reparameterization noise."""
    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    n = x.shape[0]
    nb = batch_size or min(n, 256)
    if params0 is None:
        params0 = init_deep(kerns, lik, x, widths, m, seed=seed, config=config)
    else:
        got = tuple(lp.m_w.shape[0] for lp in params0.layers[:-1])
        if len(params0.layers) > 1 and got != tuple(widths):
            raise ValueError(f"params0 hidden-layer widths {got} do not match widths={tuple(widths)}; pass the "
                             "widths the params were initialized with")
    means = skip_means(widths, x.shape[-1], _np(x[:1]).dtype)
    sched = torch.as_tensor(make_batches(n, nb, n_steps, seed), dtype=torch.int64, device=x.device)
    w_hid = int(sum(widths)) if len(kerns) > 1 else 1
    rng = np.random.default_rng(seed + 1)
    noise = torch.as_tensor(rng.standard_normal((n_steps, n_samples, w_hid, nb)), dtype=x.dtype, device=x.device)
    scale = n / nb
    n_layers = len(params0.layers)
    leaves = _flatten(params0)
    opt = Adam(leaves, learning_rate)
    losses = []
    for idx, eps in zip(sched, noise):
        xb, yb = x[idx], y[idx]
        leaves, val = opt.value_and_step(
            lambda t: neg_elbo(kerns, lik, _unflatten(t, n_layers), means, xb, yb, eps, scale=scale, config=config),
            leaves)
        losses.append(val)
    return DGPFit(_unflatten(leaves, n_layers), torch.stack(losses))


def predict(kerns, lik, params: DGPParams, means, xp, *, n_samples: int = 20, seed: int = 0, space: str = "y",
            config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Posterior predictive: S host-noise samples propagated, mixed by the
    law of total variance; ``space="f"`` the latent mixture, ``space="y"``
    each sample mapped through the likelihood first."""
    z0 = params.layers[0].z
    xp = torch.as_tensor(as_tensor(xp, z0.device), dtype=z0.dtype)
    L = len(kerns)
    w_hid = int(sum(lp.m_w.shape[0] for lp in params.layers[:-1])) if L > 1 else 1
    rng = np.random.default_rng(seed)
    S = n_samples if L > 1 else 1
    eps = torch.as_tensor(rng.standard_normal((S, w_hid, xp.shape[0])), dtype=xp.dtype, device=xp.device)
    mus, vars_ = [], []
    for e in eps:
        mu, var = propagate(kerns, params, means, xp, e, config)
        if space != "f":
            mu, var = lik.predict(params.lik, mu, var)
        mus.append(mu)
        vars_.append(var)
    mus, vars_ = torch.stack(mus), torch.stack(vars_)
    mean = torch.mean(mus, 0)
    var = torch.mean(vars_ + torch.square(mus), 0) - torch.square(mean)
    return mean, torch.clamp_min(var, 0.0)


class DeepGP:
    """Stateful wrapper: ``DeepGP(x, y, widths=(1,)).train().predict(xq)``.
    ``len(widths) + 1`` GP layers, RBF kernels unless given, any
    ``models.obs`` likelihood (``GaussianLik`` unless given)."""

    def __init__(self, x, y, widths: Sequence[int] = (1,), kerns: Optional[Sequence[Kernel]] = None, lik=None,
                 m: int = 32, config: Config = DEFAULT, device=None):
        from pygpr_torch.models.obs import GaussianLik

        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.widths = tuple(widths)
        self.kerns = tuple(kerns) if kerns is not None else tuple(RBF() for _ in range(len(self.widths) + 1))
        if len(self.kerns) != len(self.widths) + 1:
            raise ValueError(f"{len(self.widths)} hidden widths need {len(self.widths) + 1} kernels")
        self.lik = lik if lik is not None else GaussianLik()
        self.m = m
        self.config = config
        self.means = skip_means(self.widths, self.x.shape[-1], _np(self.x[:1]).dtype)
        self.params: Optional[DGPParams] = None
        self.losses: Optional[Tensor] = None

    def train(self, **kw) -> "DeepGP":
        res = fit(self.kerns, self.lik, self.x, self.y, widths=self.widths, m=self.m, config=self.config, **kw)
        self.params, self.losses = res.params, res.losses
        return self

    def predict(self, xp, **kw):
        if self.params is None:
            raise RuntimeError("call train() first")
        with torch.no_grad():
            return predict(self.kerns, self.lik, self.params, self.means, xp, config=self.config, **kw)
