"""Sparse variational GP regression (SGPR): Titsias' collapsed bound.

Counterpart of ``pygpr_tpu/models/sgpr.py``.  ``m`` inducing points
summarize all ``n`` observations in one model:

    ELBO = log N(y | 0, Q_ff + σₙ²I) − tr(K_ff − Q_ff) / (2σₙ²),
    Q_ff = K_fu K_uu⁻¹ K_uf                  (Titsias 2009, collapsed bound)

The fit is O(n·m²) of tall ``[m, n]`` products and a predict is O(m²) a
query with no n-sized state.

Conventions, shared with the iterative GP (``models/iterative.py``):

  * ``kern`` is the **noise-free signal kernel** (e.g. ``RBF()``).  The
    Gaussian observation noise σₙ is the LAST entry of the packed
    ``params = [θ_kernel…, σₙ]``; it enters the bound as the likelihood
    variance, so :class:`~pygpr_torch.ops.kernels.WhiteNoise` must not be
    a summand of ``kern``.
  * The predictive variance includes σₙ², as the exact GP's does.
  * Inducing locations are picked on the host (:func:`init_inducing`) or
    by the pivoted Cholesky (:func:`init_inducing_pivoted`).

In f32 on the card the two m×m factorizations go through the jitter
ladder, which sends ``[m, m]`` with m ≤ 1024 to kernel K3; the rest is
torch ops over cuBLAS.  NumPy inputs go to ``device`` ("cuda" unless
given; no GPU raises); tensors stay where they are.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel, Sum, WhiteNoise

Tensor = torch.Tensor


def _check_noise_free(kern: Kernel) -> None:
    parts = kern.kernels if isinstance(kern, Sum) else (kern,)
    if any(isinstance(k, WhiteNoise) for k in parts):
        raise ValueError(
            "SGPR takes a noise-free signal kernel; the observation "
            "noise is the last packed parameter (params = [θ_kernel…, "
            "σₙ]).  Drop WhiteNoise from the kernel."
        )


def init_params(kern: Kernel, x, config: Config = DEFAULT) -> Tensor:
    """``[θ_kernel… (all ones), σₙ=1]``.

    σₙ starts at 1, not at the reference's 1e-4 noise init: the fits of
    these models run in log space, where 1 is a well-scaled start.
    """
    p = kern.init_params(x, config)
    return torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)], dim=-1)


def init_inducing(x, m: int, seed: int = 0) -> np.ndarray:
    """``m`` inducing locations on the host: a seeded permutation subset
    of the training inputs (the same NumPy draw as the JAX package's, so
    the same points)."""
    x = x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)
    n = x.shape[0]
    if m > n:
        raise ValueError(f"m={m} inducing points > n={n} data points")
    idx = np.random.default_rng(seed).permutation(n)[:m]
    return np.ascontiguousarray(x[idx])


def init_inducing_pivoted(kern: Kernel, x, m: int, *, theta=None, config: Config = DEFAULT,
                          device=None) -> np.ndarray:
    """``m`` inducing locations by greedy pivoted-Cholesky selection: each
    pivot maximizes the residual prior variance under ``kern``/``theta``
    (default ``kern.init_params``).  O(m·n·d), no n×n matrix; returns the
    chosen rows of ``x`` as NumPy."""
    from pygpr_torch.models.iterative import pivoted_cholesky

    xt = as_tensor(x, device)
    if m > xt.shape[0]:
        raise ValueError(f"m={m} inducing points > n={xt.shape[0]}")
    th = kern.init_params(xt, config) if theta is None else torch.as_tensor(theta, dtype=xt.dtype, device=xt.device)
    with torch.no_grad():
        _, pivs = pivoted_cholesky(kern, th, xt, m, config=config, return_pivots=True)
    return np.ascontiguousarray(xt.detach().cpu().numpy()[pivs.cpu().numpy()])


def _common(kern, params, x, y, z, config):
    """Shared factorization of the collapsed bound.

    Returns (T=L⁻¹, TB=LB⁻¹, LB, c, A, σₙ², ok) with L = chol K_uu,
    A = T·K_uf/σₙ [m, n], B = I + AAᵀ [m, m], c = TB·Ay/σₙ [m].  The
    n-sized products are products with the inverses, not triangular solves
    (as in the JAX package): GEMMs where a solve with n right-hand sides
    would crawl.
    """
    theta, sn = params[..., :-1], params[..., -1]
    sn2 = sn * sn + config.jitter
    kuu = kern.matrix(theta, z, config=config)                  # [m, m]
    res_uu = linalg.safe_cholesky(kuu, config)
    T = linalg.tri_inverse_doubling(res_uu.chol)
    kuf = kern.matrix(theta, x, z, config=config)               # [m, n]
    A = (T @ kuf) / torch.sqrt(sn2)
    res_b = linalg.safe_cholesky(linalg.add_diag(A @ A.T, 1.0), config)
    LB = res_b.chol
    TB = linalg.tri_inverse_doubling(LB)
    c = (TB @ (A @ y)) / torch.sqrt(sn2)
    return T, TB, LB, c, A, sn2, res_uu.ok * res_b.ok


def neg_elbo(kern: Kernel, params: Tensor, x: Tensor, y: Tensor, z: Tensor, config: Config = DEFAULT) -> Tensor:
    """Negative collapsed ELBO (a minimization target, like ``nlml``):

        −ELBO = ½n log 2πσₙ² + Σ log diag LB + ½(yᵀy/σₙ² − cᵀc)
                + Σ k_ff,ii/(2σₙ²) − ½ Σ A²

    An upper bound of the exact NLML of the GP with kernel k + σₙ²I, equal
    when z = x.  Differentiable by autograd in ``params`` and ``z``
    (through the ladder's Cholesky and the inverses' adjoints)."""
    theta = params[..., :-1]
    _, _, LB, c, A, sn2, _ = _common(kern, params, x, y, z, config)
    n = y.shape[-1]
    kdiag = kern.diag(theta, x, config=config)
    return (
        0.5 * n * (math.log(2.0 * math.pi) + torch.log(sn2))
        + linalg.half_logdet_from_chol(LB)
        + 0.5 * (torch.dot(y, y) / sn2 - torch.dot(c, c))
        + 0.5 * torch.sum(kdiag) / sn2
        - 0.5 * torch.sum(torch.square(A))
    )


class SGPRState(NamedTuple):
    """Posterior state of a fitted SGPR model; everything is m-sized."""

    z: Tensor         #: inducing locations [m, d]
    params: Tensor    #: packed hyperparameters [nhp_kernel + 1]
    tinv_kuu: Tensor  #: T = L⁻¹, L = chol(K_uu + jitter·I)    [m, m]
    tinv_b: Tensor    #: TB = LB⁻¹, LB = chol(I + AAᵀ)         [m, m]
    c: Tensor         #: TB A y / σₙ                            [m]
    ok: Tensor        #: both factorizations finite


def factorize(kern: Kernel, params, x, y, z, config: Config = DEFAULT, device=None) -> SGPRState:
    """One-time O(n·m²) summary of (x, y) into m-sized state."""
    x = as_tensor(x, device)
    y, z = (torch.as_tensor(as_tensor(a, x.device), dtype=x.dtype) for a in (y, z))
    params = torch.as_tensor(params, dtype=x.dtype, device=x.device)
    with torch.no_grad():
        T, TB, _, c, _, _, ok = _common(kern, params, x, y, z, config)
    return SGPRState(z, params, T, TB, c, ok)


def predict(kern: Kernel, state: SGPRState, xp, var: str = "diag",
            config: Config = DEFAULT) -> Tuple[Tensor, Optional[Tensor]]:
    """Posterior mean and ("full" | "diag" | "none") uncertainty at xp:
    μ* = tmpᵀc, Σ* = K** − wᵀw + tmpᵀtmp + σₙ²I with w = T·K_us and
    tmp = TB·w, products only (O(m²) a query).  The variance includes σₙ²."""
    if var not in ("full", "diag", "none"):
        raise ValueError(f"var must be 'full', 'diag' or 'none', got {var!r}")
    xp = torch.as_tensor(as_tensor(xp, state.z.device), dtype=state.z.dtype)
    theta, sn = state.params[..., :-1], state.params[..., -1]
    sn2 = sn * sn + config.jitter
    kus = kern.matrix(theta, xp, state.z, config=config)        # [m, nq]
    w = state.tinv_kuu @ kus
    tmp = state.tinv_b @ w
    mean = tmp.T @ state.c
    if var == "full":
        cov = kern.matrix(theta, xp, config=config) - w.T @ w + tmp.T @ tmp
        return mean, linalg.add_diag(cov, sn2)
    if var == "diag":
        v = kern.diag(theta, xp, config=config) - torch.sum(torch.square(w), dim=0) + torch.sum(torch.square(tmp), dim=0) + sn2
        return mean, torch.clamp_min(v, config.jitter)
    return mean, None


def sample_predictive(kern: Kernel, state: SGPRState, xp, generator: Optional[torch.Generator] = None,
                      n_samples: int = 1, config: Config = DEFAULT) -> Tensor:
    """Joint draws ``[n_samples, nq]`` from the SGPR posterior at ``xp``:
    ``f = μ + L_Σ z`` through the jitter ladder.  ``generator`` takes the
    place of the JAX key (the two give different numbers)."""
    mean, cov = predict(kern, state, xp, var="full", config=config)
    chol = linalg.safe_cholesky(cov, config).chol
    z = torch.randn((n_samples, mean.shape[0]), generator=generator, dtype=mean.dtype, device=mean.device)
    return mean[None] + z @ chol.T


def fit(kern: Kernel, params0, x, y, z0, *, opt_inducing: bool = False, config: Config = DEFAULT,
        max_iter: int = 200, tol: float = 1e-4, memory_size: int = 15, device=None):
    """Maximize the collapsed ELBO by L-BFGS (``optimize/lbfgs.py``).

    Hyperparameters are searched in log space; with ``opt_inducing=True``
    the inducing locations z join the search vector unconstrained (more or
    better z only tighten the bound).  Returns ``(FitResult, z_opt)`` with
    ``FitResult.params`` the packed ``[θ…, σₙ]``."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    _check_noise_free(kern)
    x = as_tensor(x, device)
    y, z0 = (torch.as_tensor(as_tensor(a, x.device), dtype=x.dtype) for a in (y, z0))
    params0 = torch.as_tensor(params0, dtype=x.dtype, device=x.device)
    nhp = params0.shape[-1]
    u0 = torch.log(torch.abs(params0))
    if opt_inducing:
        u0 = torch.cat([u0, z0.reshape(-1)])

        def obj(u):
            return neg_elbo(kern, torch.exp(u[:nhp]), x, y, u[nhp:].reshape(z0.shape), config)
    else:
        def obj(u):
            return neg_elbo(kern, torch.exp(u), x, y, z0, config)

    res = minimize_lbfgs(obj, u0, max_iter=max_iter, tol=tol, memory_size=memory_size)
    if opt_inducing:
        return res._replace(params=torch.exp(res.params[:nhp])), res.params[nhp:].reshape(z0.shape)
    return res._replace(params=torch.exp(res.params)), z0


class SGPR:
    """Stateful wrapper in the house style (cf. :class:`ExactGP`).

    >>> model = SGPR(x, y, RBF(), m=256)
    >>> model.train()                        # ELBO L-BFGS, z learned too
    >>> mean, var = model.predict(xs, var="diag")
    """

    def __init__(self, x, y, cov: Kernel, m: int = 128, z=None, seed: int = 0, config: Config = DEFAULT,
                 device=None):
        _check_noise_free(cov)
        self.x = as_tensor(x, device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.cov = cov
        self.config = config
        z = init_inducing(self.x, m, seed) if z is None else z
        self.z = torch.as_tensor(as_tensor(z, self.x.device), dtype=self.x.dtype)
        self.params = init_params(cov, self.x, config)
        self.state: Optional[SGPRState] = None
        self.need_upd = True

    def set_params(self, params) -> None:
        self.params = torch.as_tensor(params, dtype=self.x.dtype, device=self.x.device)
        self.need_upd = True

    def set_data(self, x, y) -> None:
        """Rebind the training data and mark dirty (the inducing locations
        are kept)."""
        self.x = as_tensor(x, self.x.device)
        self.y = torch.as_tensor(as_tensor(y, self.x.device), dtype=self.x.dtype)
        self.need_upd = True

    def train(self, opt_inducing: bool = True, max_iter: int = 200, **kw):
        res, z = fit(self.cov, self.params, self.x, self.y, self.z, opt_inducing=opt_inducing,
                     config=self.config, max_iter=max_iter, **kw)
        self.params, self.z = res.params, z
        self.need_upd = True
        return res

    def update(self) -> None:
        if self.need_upd:
            self.state = factorize(self.cov, self.params, self.x, self.y, self.z, self.config)
            self.need_upd = False

    def predict(self, xp, var: str = "diag"):
        self.update()
        mean, cov = predict(self.cov, self.state, xp, var, self.config)
        return [mean, cov]

    def neg_elbo(self) -> Tensor:
        with torch.no_grad():
            return neg_elbo(self.cov, self.params, self.x, self.y, self.z, self.config)
