"""Observation likelihoods of the non-Gaussian and variational models.

Counterpart of ``pygpr_tpu/models/obs.py``.  Each likelihood supplies,
elementwise over ``[nb]`` tensors:

  * ``expected_log_lik(lp, y, mu, var)``: ``E_{f ~ N(mu, var)}[log p(y | f)]``
    (closed form where one exists, else 32-node Gauss-Hermite), the data
    term of SVGP and the deep GP;
  * ``predict(lp, mu, var)``: moments of the observation's predictive
    given the latent marginal N(mu, var);
  * ``log_lik(lp, y, f)``: ``log p(y | f)`` at a latent value, whose
    derivatives in f the Laplace approximation takes by autograd;
  * ``tilted_moments`` where the tilted integrals are exact (Gaussian,
    probit), for EP.

``lp`` is the likelihood's own unconstrained parameter vector (the
Gaussian's log σₙ; empty for Bernoulli and Poisson).  The Gauss-Hermite
nodes are NumPy's, computed on the host once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

# 32-node Gauss-Hermite rule (physicists' convention):
# ∫N(f; μ, σ²) g(f) df = π^{-1/2} Σᵢ wᵢ g(μ + √2 σ xᵢ)
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(32)


def gauss_hermite(g, mu: Tensor, var: Tensor) -> Tensor:
    """``E_{f ~ N(mu, var)}[g(f)]`` elementwise over ``mu, var [nb]``."""
    x = torch.as_tensor(_GH_X, dtype=mu.dtype, device=mu.device)
    w = torch.as_tensor(_GH_W / math.sqrt(math.pi), dtype=mu.dtype, device=mu.device)
    f = mu[..., None] + torch.sqrt(2.0 * var)[..., None] * x
    return torch.sum(g(f) * w, dim=-1)


def softplus(t: Tensor) -> Tensor:
    """``log(1 + eᵗ)`` as ``jax.nn.softplus`` computes it (``logaddexp(t, 0)``;
    ``torch.nn.functional.softplus`` returns t itself above 20)."""
    return torch.logaddexp(t, torch.zeros((), dtype=t.dtype, device=t.device))


def norm_logcdf(t: Tensor) -> Tensor:
    return torch.special.log_ndtr(t)


def norm_logpdf(t: Tensor) -> Tensor:
    return -0.5 * t * t - 0.5 * math.log(2.0 * math.pi)


def _empty(dtype, device) -> Tensor:
    return torch.zeros((0,), dtype=dtype, device=device)


class GaussianLik:
    """y = f + ε, ε ~ N(0, σₙ²); one parameter, log σₙ.  Closed-form
    expectation ``−½log 2πσₙ² − ((y−μ)² + σ²)/(2σₙ²)``."""

    n_params = 1

    def init_params(self, dtype=torch.float32, device=None) -> Tensor:
        return torch.zeros((1,), dtype=dtype, device=device)  # log σₙ = 0

    def expected_log_lik(self, lp, y, mu, var):
        sn2 = torch.exp(2.0 * lp[0])
        return -0.5 * (math.log(2.0 * math.pi) + 2.0 * lp[0] + ((y - mu) ** 2 + var) / sn2)

    def log_lik(self, lp, y, f):
        sn2 = torch.exp(2.0 * lp[0])
        return -0.5 * (math.log(2.0 * math.pi) + 2.0 * lp[0] + (y - f) ** 2 / sn2)

    def predict(self, lp, mu, var):
        return mu, var + torch.exp(2.0 * lp[0])

    def tilted_moments(self, lp, y, mu, var):
        """Exact moments of ``N(f; mu, var)·N(y; f, σₙ²)``: EP with this
        likelihood ends at the exact posterior and evidence."""
        sn2 = torch.exp(2.0 * lp[0])
        tot = var + sn2
        log_z_hat = -0.5 * (math.log(2.0 * math.pi) + torch.log(tot) + (y - mu) ** 2 / tot)
        var_hat = var * sn2 / tot
        mu_hat = var_hat * (mu / var + y / sn2)
        return log_z_hat, mu_hat, var_hat


class BernoulliLogit:
    """y ∈ {0, 1}, p(y=1|f) = σ(f).  Gauss-Hermite expectation and
    predictive mean ``E[σ(f)]``."""

    n_params = 0

    def init_params(self, dtype=torch.float32, device=None) -> Tensor:
        return _empty(dtype, device)

    def expected_log_lik(self, lp, y, mu, var):
        s = 2.0 * y - 1.0
        # log σ(s f) = −softplus(−s f)
        return gauss_hermite(lambda f: -softplus(-s[..., None] * f), mu, var)

    def log_lik(self, lp, y, f):
        return -softplus(-(2.0 * y - 1.0) * f)

    def predict(self, lp, mu, var):
        p = gauss_hermite(torch.sigmoid, mu, var)
        return p, p * (1.0 - p)


class BernoulliProbit:
    """y ∈ {0, 1}, p(y=1|f) = Φ(f).  Gauss-Hermite expectation; the
    predictive mean is ``Φ(μ/√(1+σ²))``."""

    n_params = 0

    def init_params(self, dtype=torch.float32, device=None) -> Tensor:
        return _empty(dtype, device)

    def expected_log_lik(self, lp, y, mu, var):
        s = 2.0 * y - 1.0
        return gauss_hermite(lambda f: norm_logcdf(s[..., None] * f), mu, var)

    def log_lik(self, lp, y, f):
        return norm_logcdf((2.0 * y - 1.0) * f)

    def predict(self, lp, mu, var):
        p = torch.special.ndtr(mu / torch.sqrt(1.0 + var))
        return p, p * (1.0 - p)

    def tilted_moments(self, lp, y, mu, var):
        """Closed-form ``(log Ẑ, μ̂, σ̂²)`` of ``N(f; mu, var)·Φ(s f)``
        (R&W §3.9, eqs. 3.80-3.83), the EP site update."""
        s = 2.0 * y - 1.0
        denom = torch.sqrt(1.0 + var)
        z = s * mu / denom
        log_z_hat = norm_logcdf(z)
        ratio = torch.exp(norm_logpdf(z) - log_z_hat)  # N(z)/Φ(z) in log space
        mu_hat = mu + s * var * ratio / denom
        var_hat = var - var**2 * ratio * (z + ratio) / (1.0 + var)
        return log_z_hat, mu_hat, var_hat


class StudentTLik:
    """y = f + ε, ε ~ Student-t(ν, scale σ): robust regression.  ν > 2 is
    fixed; log σ is the parameter.  Gauss-Hermite expectation; predictive
    mean μ and variance σ_f² + νσ²/(ν − 2)."""

    n_params = 1

    def __init__(self, nu: float = 4.0):
        if nu <= 2.0:
            raise ValueError("StudentTLik needs nu > 2 (finite variance)")
        self.nu = float(nu)

    def init_params(self, dtype=torch.float32, device=None) -> Tensor:
        return torch.zeros((1,), dtype=dtype, device=device)  # log σ = 0

    def _lognorm(self, log_s):
        nu = self.nu
        return math.lgamma((nu + 1.0) / 2.0) - math.lgamma(nu / 2.0) - 0.5 * math.log(nu * math.pi) - log_s

    def expected_log_lik(self, lp, y, mu, var):
        nu, log_s = self.nu, lp[0]
        lognorm = self._lognorm(log_s)

        def logpdf(f):
            r2 = ((y[..., None] - f) / torch.exp(log_s)) ** 2
            return lognorm - 0.5 * (nu + 1.0) * torch.log1p(r2 / nu)

        return gauss_hermite(logpdf, mu, var)

    def log_lik(self, lp, y, f):
        r2 = ((y - f) / torch.exp(lp[0])) ** 2
        return self._lognorm(lp[0]) - 0.5 * (self.nu + 1.0) * torch.log1p(r2 / self.nu)

    def predict(self, lp, mu, var):
        return mu, var + self.nu * torch.exp(2.0 * lp[0]) / (self.nu - 2.0)


class PoissonLik:
    """y ∈ ℕ, rate exp(f).  Closed-form expectation
    ``y μ − e^{μ+σ²/2} − lgamma(y+1)``."""

    n_params = 0

    def init_params(self, dtype=torch.float32, device=None) -> Tensor:
        return _empty(dtype, device)

    def expected_log_lik(self, lp, y, mu, var):
        return y * mu - torch.exp(mu + 0.5 * var) - torch.lgamma(y + 1.0)

    def log_lik(self, lp, y, f):
        return y * f - torch.exp(f) - torch.lgamma(y + 1.0)

    def predict(self, lp, mu, var):
        # moments of a log-Gaussian-rate Poisson mixture
        m = torch.exp(mu + 0.5 * var)
        return m, m + (torch.exp(var) - 1.0) * m * m


#: the likelihood classes by name, for ``convert.likelihood_from_name``
LIKELIHOODS = {cls.__name__: cls for cls in (GaussianLik, BernoulliLogit, BernoulliProbit, StudentTLik, PoissonLik)}
