"""Elliptical slice sampling of latent GP posteriors (Murray, Adams and
MacKay, AISTATS 2010).

Counterpart of ``pygpr_tpu/sample/ess.py``.  Draws from
``p(f | y, X, θ) ∝ N(f; 0, K) · Πᵢ p(yᵢ|fᵢ)`` with no tuning parameter:
the proposal ellipse ``f' = f cos ϑ + ν sin ϑ`` through the state and a
prior draw ``ν = L z`` stays on the prior's equi-density shells, so only
the likelihood enters the slice test.

K is factored once, by the laddered ``safe_cholesky`` (kernel K3 at
n ≤ 1024 in f32 on the card); a prior draw is then one GEMV.  The JAX
package's angle-shrinking ``lax.while_loop`` is a host loop here, one
read of the slice test a shrink (it ends: the bracket shrinks toward
ϑ = 0, where f' = f).  The draws come from a ``torch.Generator``;
:func:`_ess_step` takes them as arguments, so it is pure in them.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


class ESSResult(NamedTuple):
    samples: Tensor  #: [n_samples, n] latent draws f ~ p(f | y, X, θ)
    log_lik: Tensor  #: [n_samples] Σᵢ log p(yᵢ|fᵢ) along the chain


def _ess_step(log_l: Callable[[Tensor], Tensor], chol_k: Tensor, f: Tensor, ll: Tensor, z: Tensor, u: Tensor,
              theta: Tensor, shrink: Callable[[], Tensor]) -> Tuple[Tensor, Tensor]:
    """One elliptical slice transition (Murray et al., Fig. 2) from the
    draws: ``z [n]`` standard normal (ν = L z), ``u`` and ``theta/2π``
    uniform, and ``shrink()`` the next uniform of the shrinking loop."""
    nu = chol_k @ z
    log_u = ll + torch.log(u)
    lo, hi = theta - 2.0 * math.pi, theta
    th = theta
    fp = f * torch.cos(th) + nu * torch.sin(th)
    llp = log_l(fp)
    while bool(llp <= log_u):
        lo = torch.where(th < 0.0, th, lo)
        hi = torch.where(th < 0.0, hi, th)
        th = lo + (hi - lo) * shrink()
        fp = f * torch.cos(th) + nu * torch.sin(th)
        llp = log_l(fp)
    return fp, llp


def sample_latent(kern: Kernel, params: Tensor, lik, lik_params: Tensor, x: Tensor, y: Tensor,
                  generator: torch.Generator, *, n_samples: int = 200, n_warmup: int = 100, thin: int = 1,
                  f0: Optional[Tensor] = None, config: Config = DEFAULT, device=None) -> ESSResult:
    """Sample the latent posterior ``p(f | y, X, θ)`` by ESS, one chain.

    ``thin`` keeps every ``thin``-th post-warmup state; ``f0`` defaults
    to the zero function (the prior mean).  The draws come from
    ``generator`` (not the JAX key's numbers).  NumPy inputs go to
    ``device`` ("cuda" unless given).
    """
    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    params, lik_params = (torch.as_tensor(as_tensor(a, x.device), dtype=x.dtype) for a in (params, lik_params))
    with torch.no_grad():
        K = kern.matrix(params, x, config=config)
        chol_k = linalg.safe_cholesky(K, config).chol

        def log_l(f):
            return torch.sum(lik.log_lik(lik_params, y, f))

        def uniform():
            return torch.rand((), generator=generator, dtype=y.dtype, device=generator.device).to(y.device)

        f = torch.zeros_like(y) if f0 is None else f0
        ll = log_l(f)
        samples, lls = [], []
        for t in range(n_warmup + n_samples * thin):
            z = torch.randn(y.shape, generator=generator, dtype=y.dtype, device=generator.device).to(y.device)
            u, theta = uniform(), 2.0 * math.pi * uniform()
            f, ll = _ess_step(log_l, chol_k, f, ll, z, u, theta, uniform)
            if t >= n_warmup and (t - n_warmup + 1) % thin == 0:
                samples.append(f)
                lls.append(ll)
    return ESSResult(samples=torch.stack(samples), log_lik=torch.stack(lls))


def predictive_latent_mixture(kern: Kernel, params: Tensor, x: Tensor, result: ESSResult, xp: Tensor,
                              config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Latent predictive moments at ``xp`` mixed over the ESS draws (law
    of total variance).  Each draw's conditional is
    ``N(K*ᵀK⁻¹f, K** − K*ᵀK⁻¹K*)``; the covariance does not depend on f,
    so it is computed once and only the means mix."""
    with torch.no_grad():
        K = kern.matrix(params, x, config=config)
        res = linalg.safe_cholesky(K, config)
        krns = kern.matrix(params, x, xp, config=config)        # [m, n]
        lks = linalg.cholesky_solve(res.chol, krns.T)            # [n, m]
        base_var = torch.clamp_min(kern.diag(params, xp, config=config) - torch.sum(krns * lks.T, dim=-1), 0.0)
        means = result.samples @ lks                             # [S, m]
    return torch.mean(means, dim=0), base_var + torch.var(means, dim=0, correction=0)
