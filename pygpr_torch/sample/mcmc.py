"""MCMC over GP hyperparameters: adaptive random-walk Metropolis and HMC.

Counterpart of ``pygpr_tpu/sample/mcmc.py``.  The target is the
hyperparameter posterior over u = log θ::

    log p(u | x, y) ∝ −nlml(exp u) + log N(u; 0, prior_std²)

(or explicit θ-space priors with the change-of-variables Jacobian).

The JAX package ``vmap``s one ``lax.scan`` chain per chain.  Here the
chains lie on a leading axis: u is ``[C, nhp]``, the ``[C, n, n]`` stack
of grams is built by one ``train_gram`` call (one launch of the fused gram
kernel K1 for ``Sum(RBF, WhiteNoise)`` in f32 on the card, x shared), and one laddered
``safe_cholesky`` factors the stack, each matrix on its own rung (kernel
K3 at n ≤ 1024 in f32).  Accept and reject stay on the device
(``torch.where``): a step reads nothing on the host beyond the ladder's
one sync per rung.  HMC takes the gradient by autograd through ``nlml``,
as the JAX package takes ``jax.grad`` of it.

The randomness of RWM and HMC has a fixed count, so it is drawn up front
from a ``torch.Generator`` (in place of the JAX ``key``), and the chain
functions :func:`_rwm_chain` and :func:`_hmc_chain` are pure in those
draws.  The step size adapts in warmup by Robbins-Monro toward a target
acceptance; the statistic passes through ``sync_fn`` (identity by
default; the distributed layer averages it across chains or hosts).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.likelihood import nlml
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


class MCMCResult(NamedTuple):
    samples: Tensor      #: [C, n_samples, nhp] hyperparameter draws (θ, not log θ)
    log_prob: Tensor     #: [C, n_samples] unnormalized log-posterior
    accept_rate: Tensor  #: [C] post-warmup acceptance fraction
    step_size: Tensor    #: [C] adapted step size


def log_posterior_fn(kern: Kernel, x: Tensor, y: Tensor, prior_std: float = 3.0, config: Config = DEFAULT,
                     priors=None) -> Callable[[Tensor], Tensor]:
    """Log-posterior over u = log θ, for u ``[nhp]`` (a scalar) or
    ``[C, nhp]`` (``[C]``, one factorization of the ``[C, n, n]`` stack).

    Default prior: a broad Gaussian on u (scale ``prior_std``).  With
    ``priors`` (a per-parameter sequence of :mod:`pygpr_torch.models.priors`)
    the θ-space priors enter with their Jacobian
    (:func:`~pygpr_torch.models.priors.log_prior_u`); ``None`` coordinates
    keep the Gaussian on u (a flat one would make the u-marginal improper).
    """
    if priors is not None:
        from pygpr_torch.models.priors import log_prior_u

        soft = [i for i, p in enumerate(priors) if p is None]

        def lp(u: Tensor) -> Tensor:
            val = -nlml(kern, torch.exp(u), x, y, config)
            reg = -0.5 * torch.sum(torch.square(u[..., soft] / prior_std), dim=-1) if soft else 0.0
            return val + log_prior_u(priors, u) + reg

        return lp

    def lp(u: Tensor) -> Tensor:
        val = -nlml(kern, torch.exp(u), x, y, config)
        return val - 0.5 * torch.sum(torch.square(u / prior_std), dim=-1)

    return lp


def _value_and_grad(lp: Callable[[Tensor], Tensor], u: Tensor) -> Tuple[Tensor, Tensor]:
    """``(lp(u), ∇lp(u))`` per chain: the chains are independent, so the
    gradient of the sum is each chain's gradient."""
    u = u.detach().requires_grad_(True)
    with torch.enable_grad():
        v = lp(u)
        (g,) = torch.autograd.grad(v.sum(), u)
    return v.detach(), g


def _adapt(log_step: Tensor, a_prob: Tensor, target_accept: float, it: int, sync_fn) -> Tensor:
    """Robbins-Monro step toward the target acceptance at warmup step ``it``."""
    return log_step + sync_fn(a_prob - target_accept) / math.sqrt(1.0 + it)


def _run_chain(step, u0: Tensor, lp_u: Tensor, n_samples: int, n_warmup: int, target_accept: float,
               init_step: float, sync_fn):
    """Warmup (adapting) then sampling, ``step(t, u, lp_u, log_step)`` →
    ``(u, lp_u, accept, a_prob)`` being one Metropolis step at draw ``t``."""
    u = u0
    log_step = torch.full(u0.shape[:-1], math.log(init_step), dtype=u0.dtype, device=u0.device)
    for it in range(n_warmup):
        u, lp_u, _, a_prob = step(it, u, lp_u, log_step)
        log_step = _adapt(log_step, a_prob, target_accept, it, sync_fn)
    us, lps, accepts = [], [], []
    for t in range(n_warmup, n_warmup + n_samples):
        u, lp_u, accept, _ = step(t, u, lp_u, log_step)
        us.append(u)
        lps.append(lp_u)
        accepts.append(accept)
    us, lps = torch.stack(us, dim=-2), torch.stack(lps, dim=-1)
    acc = torch.stack(accepts, dim=-1).to(u0.dtype).mean(dim=-1)
    return torch.exp(us), lps, acc, torch.exp(log_step)


def _rwm_chain(lp: Callable[[Tensor], Tensor], u0: Tensor, normals: Tensor, uniforms: Tensor, n_samples: int,
               n_warmup: int, target_accept: float, init_step: float, sync_fn: Callable[[Tensor], Tensor]):
    """Adaptive random-walk Metropolis of the chains ``u0 [C, nhp]``.

    ``normals [n_warmup + n_samples, C, nhp]`` are the proposals' standard
    normals and ``uniforms [n_warmup + n_samples, C]`` the acceptance
    tests' uniforms, one of each a step.  A non-finite log posterior is
    rejected with acceptance 0.  Returns ``(θ draws [C, S, nhp], log
    posteriors [C, S], acceptance [C], adapted step [C])``."""

    def step(t, u, lp_u, log_step):
        prop = u + torch.exp(log_step)[..., None] * normals[t]
        lp_p = lp(prop)
        # a non-finite log posterior (a factorization that failed every
        # rung of the ladder) is a rejection with acceptance 0, as in HMC;
        # the JAX package's RWM lets its NaN into the adapted step instead
        # (ROADMAP §C, C3)
        log_a = lp_p - lp_u
        log_a = torch.where(torch.isfinite(log_a), log_a, -math.inf)
        accept = torch.log(uniforms[t]) < log_a
        u = torch.where(accept[..., None], prop, u)
        lp_u = torch.where(accept, lp_p, lp_u)
        return u, lp_u, accept, torch.clamp_max(torch.exp(log_a), 1.0)

    with torch.no_grad():
        return _run_chain(step, u0, lp(u0), n_samples, n_warmup, target_accept, init_step, sync_fn)


def _hmc_chain(lp: Callable[[Tensor], Tensor], u0: Tensor, momenta: Tensor, uniforms: Tensor, n_samples: int,
               n_warmup: int, target_accept: float, init_step: float, n_leapfrog: int,
               sync_fn: Callable[[Tensor], Tensor]):
    """Adaptive Hamiltonian Monte Carlo of the chains ``u0 [C, nhp]``:
    ``n_leapfrog`` leapfrog steps with autograd gradients, one NLML
    gradient each (plus one at the start), from ``momenta
    [n_warmup + n_samples, C, nhp]`` and ``uniforms [n_warmup + n_samples,
    C]``.  A non-finite trajectory is rejected outright.  Returns as
    :func:`_rwm_chain`."""

    def grad_lp(u):
        return _value_and_grad(lp, u)[1]

    def leapfrog(u, p, eps):
        """The trajectory's end ``(u, p)`` and ``lp(u)`` there (the value
        of the last gradient's evaluation)."""
        p = p + 0.5 * eps * grad_lp(u)
        for _ in range(n_leapfrog - 1):
            u = u + eps * p
            p = p + eps * grad_lp(u)
        u = u + eps * p
        lp_u, g = _value_and_grad(lp, u)
        return u, p + 0.5 * eps * g, lp_u

    def step(t, u, lp_u, log_step):
        eps = torch.exp(log_step)[..., None]
        p0 = momenta[t]
        u_new, p_new, lp_new = leapfrog(u, p0, eps)
        h0 = lp_u - 0.5 * torch.sum(p0 * p0, dim=-1)
        h1 = lp_new - 0.5 * torch.sum(p_new * p_new, dim=-1)
        log_a = h1 - h0
        log_a = torch.where(torch.isfinite(log_a), log_a, -math.inf)
        accept = torch.log(uniforms[t]) < log_a
        u = torch.where(accept[..., None], u_new, u)
        lp_u = torch.where(accept, lp_new, lp_u)
        return u, lp_u, accept, torch.clamp_max(torch.exp(log_a), 1.0)

    with torch.no_grad():
        lp0 = lp(u0)
    return _run_chain(step, u0, lp0, n_samples, n_warmup, target_accept, init_step, sync_fn)


def _draw(generator: torch.Generator, shape, like: Tensor, kind: str = "normal") -> Tensor:
    """Draws of ``shape`` from ``generator``, on its device, then moved to
    ``like``'s device and dtype."""
    fn = torch.randn if kind == "normal" else torch.rand
    return fn(shape, generator=generator, dtype=like.dtype, device=generator.device).to(like.device)


def _data(x, y, device):
    """NumPy ``x, y`` on ``device`` ("cuda" unless given); tensors stay."""
    x = as_tensor(x, device)
    return x, torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)


def _start(kern: Kernel, x: Tensor, params0, n_chains: int, jitter_init: float, generator) -> Tensor:
    """Chains' start ``[C, nhp]``: jittered ``log params0`` (θ = 1 unless
    given: the kernel-layer init, noise 1e-4, sits deep in the
    interpolation mode and can trap whole chains there)."""
    if params0 is None:
        params0 = torch.ones(kern.n_params(x.shape[-1]), dtype=x.dtype, device=x.device)
    u0 = torch.log(torch.abs(torch.as_tensor(params0, dtype=x.dtype, device=x.device)))
    return u0[None] + jitter_init * _draw(generator, (n_chains, u0.shape[-1]), x)


def sample_posterior(kern: Kernel, x: Tensor, y: Tensor, generator: torch.Generator, params0=None, *,
                     n_samples: int = 1000, n_warmup: int = 500, n_chains: int = 4, target_accept: float = 0.3,
                     init_step: float = 0.1, prior_std: float = 3.0, jitter_init: float = 0.5,
                     config: Config = DEFAULT, sync_fn: Callable[[Tensor], Tensor] = lambda s: s,
                     priors=None, device=None) -> MCMCResult:
    """Sample the hyperparameter posterior with ``n_chains`` adaptive-RWM
    chains on a leading axis, started from jittered ``log params0``.
    Returns θ-space draws ``[n_chains, n_samples, nhp]``.  The draws come
    from ``generator`` (not the JAX key's numbers).  NumPy ``x, y`` go to
    ``device`` ("cuda" unless given)."""
    x, y = _data(x, y, device)
    u0s = _start(kern, x, params0, n_chains, jitter_init, generator)
    total = n_warmup + n_samples
    normals = _draw(generator, (total,) + tuple(u0s.shape), x)
    uniforms = _draw(generator, (total, n_chains), x, "uniform")
    lp = log_posterior_fn(kern, x, y, prior_std, config, priors)
    return MCMCResult(*_rwm_chain(lp, u0s, normals, uniforms, n_samples, n_warmup, target_accept, init_step,
                                  sync_fn))


def sample_posterior_hmc(kern: Kernel, x: Tensor, y: Tensor, generator: torch.Generator, params0=None, *,
                         n_samples: int = 500, n_warmup: int = 300, n_chains: int = 4, target_accept: float = 0.75,
                         init_step: float = 0.05, n_leapfrog: int = 8, prior_std: float = 3.0,
                         jitter_init: float = 0.5, config: Config = DEFAULT,
                         sync_fn: Callable[[Tensor], Tensor] = lambda s: s, priors=None,
                         device=None) -> MCMCResult:
    """HMC over log-hyperparameters (each leapfrog step costs one NLML
    gradient of every chain); chains, jitter, priors, ``sync_fn`` and
    ``device`` as :func:`sample_posterior`."""
    x, y = _data(x, y, device)
    u0s = _start(kern, x, params0, n_chains, jitter_init, generator)
    total = n_warmup + n_samples
    momenta = _draw(generator, (total,) + tuple(u0s.shape), x)
    uniforms = _draw(generator, (total, n_chains), x, "uniform")
    lp = log_posterior_fn(kern, x, y, prior_std, config, priors)
    return MCMCResult(*_hmc_chain(lp, u0s, momenta, uniforms, n_samples, n_warmup, target_accept, init_step,
                                  n_leapfrog, sync_fn))


def posterior_moments(samples: Tensor) -> Tuple[Tensor, Tensor]:
    """Pooled posterior mean and std over chains × draws → ``[nhp]`` each."""
    flat = samples.reshape(-1, samples.shape[-1])
    return torch.mean(flat, dim=0), torch.std(flat, dim=0, correction=0)


def effective_sample_size(samples) -> np.ndarray:
    """ESS per hyperparameter (Stan's rank-free estimator: multi-chain
    autocorrelations by FFT, Geyer's initial-positive-pair truncation), on
    the host in NumPy like the JAX package's.

    ``samples: [n_chains, n_samples, nhp]`` → ``[nhp]``.
    """
    s = samples.detach().cpu().numpy() if isinstance(samples, Tensor) else np.asarray(samples)
    nc, ns, nhp = s.shape
    out = np.empty(nhp)
    for j in range(nhp):
        ch = s[:, :, j]
        centered = ch - ch.mean(axis=1, keepdims=True)
        nfft = 1 << (2 * ns - 1).bit_length()
        f = np.fft.rfft(centered, nfft, axis=1)
        acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :ns].real
        acov /= ns
        W = ch.var(axis=1, ddof=1).mean()
        B = ns * ch.mean(axis=1).var(ddof=1) if nc > 1 else 0.0
        var_plus = W * (ns - 1) / ns + B / ns
        if var_plus <= 0:
            out[j] = float(nc * ns)
            continue
        rho = 1.0 - (W - acov.mean(axis=0)) / var_plus
        tau = 0.0
        t = 1
        while t + 1 < ns:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            tau += pair
            t += 2
        out[j] = nc * ns / (1.0 + 2.0 * tau)
    return out


def predictive_mixture(kern: Kernel, x: Tensor, y: Tensor, samples: Tensor, xs: Tensor, *, n_use: int = 64,
                       config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Posterior predictive with the hyperparameters marginalized over the
    MCMC draws, moment-matched to one Gaussian a query: ``mean = E_s[μ_s]``,
    ``var = E_s[σ_s²] + Var_s[μ_s]``.  The draws (any leading chain axes)
    are thinned to ≤ ``n_use`` by a fixed stride and run one factorize and
    predict at a time (peak memory one n×n gram).  ``(mean [nq], var [nq])``."""
    from pygpr_torch.models import exact_gp

    flat = samples.reshape(-1, samples.shape[-1])
    stride = max(flat.shape[0] // n_use, 1)
    use = flat[::stride][:n_use]
    mus, vars_ = [], []
    with torch.no_grad():
        for p in use:
            state = exact_gp.factorize(kern, p, x, y, config)
            mu, var = exact_gp.predict(kern, state, xs, "diag", config)
            mus.append(mu)
            vars_.append(var)
    mus, vars_ = torch.stack(mus), torch.stack(vars_)
    return torch.mean(mus, dim=0), torch.mean(vars_, dim=0) + torch.var(mus, dim=0, correction=0)


def split_rhat(samples: Tensor) -> Tensor:
    """Split-R̂ per hyperparameter → ``[nhp]`` (Gelman-Rubin on
    2×n_chains half-chains; ≲ 1.01 indicates mixing)."""
    nc, ns, nhp = samples.shape
    half = ns // 2
    chains = torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)
    mean_c = torch.mean(chains, dim=1)
    var_c = torch.var(chains, dim=1, correction=1)
    W = torch.mean(var_c, dim=0)
    B = half * torch.var(mean_c, dim=0, correction=1)
    var_post = (half - 1) / half * W + B / half
    return torch.sqrt(var_post / W)
