"""Generalized robust Bayesian Committee Machine (grBCM).

Counterpart of ``pygpr_tpu/models/grbcm.py`` (the reference's
``gr_bcm.py``, arXiv:1806.00720):

  * **Augmentation**: each of the nc local experts trains on the global
    (communication) set ``(xg, yg)`` in front of its local shard.
  * **Training** (:func:`fit`): a global-expert fit plus either one
    shared hyperparameter vector on the summed expert NLML (the paper's
    joint training) or independent per-expert fits.
  * **Aggregation**: ``prec₀ = 1/var_g``, ``precᵢ = 1/var_lᵢ``,
    ``βᵢ = ½(log precᵢ − log prec₀)`` per query, the communication
    expert pinned to ``β₁ = 1``, the global expert ``β₀ = 1 − Σᵢ≥₁ βᵢ``;
    ``covar = (Σ βᵢ precᵢ)⁻¹`` and ``mean = covar Σ βᵢ precᵢ μᵢ``.
  * **Failure masking**: a per-expert mask zeroes failed experts out of
    the β sums.

On the card the committee is batch-visible: the fit's objective factors
the ``[nc, n_aug, n_aug]`` stack of grams in one laddered Cholesky
(kernel K3), as does ``factorize``; ``fit(stream=True)`` sums the
experts' NLMLs one at a time instead.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


def augment(xl: Tensor, yl: Tensor, xg: Tensor, yg: Tensor) -> Tuple[Tensor, Tensor]:
    """Augmented expert datasets: ``xl [nc, nls, d]``, ``xg [ng, d]`` →
    ``x_aug [nc, ng + nls, d]``, the global set in front of every shard."""
    nc = xl.shape[0]
    return (
        torch.cat([xg.expand((nc,) + xg.shape), xl], dim=1),
        torch.cat([yg.expand((nc,) + yg.shape), yl], dim=1),
    )


class AggregateResult(NamedTuple):
    mean: Tensor   #: aggregated posterior mean [np]
    covar: Tensor  #: aggregated variance [np] (diag) or covariance [np, np]
    beta: Tensor   #: β weights [nc + 1, np]
    prec: Tensor   #: expert precisions [nc + 1, np]


def aggregate(ys_g, var_g, ys_l, var_l, *, mask: Optional[Tensor] = None, config: Config = DEFAULT) -> AggregateResult:
    """Diagonal-variance grBCM aggregation.  ``ys_g``/``var_g`` ``[np]``
    from the global expert, ``ys_l``/``var_l`` ``[nc, np]`` from the
    local experts, optional ``mask`` ``[nc]`` bool (True keeps an expert)."""
    prec_g = 1.0 / var_g
    prec_l = 1.0 / var_l
    prec = torch.cat([prec_g[None], prec_l], dim=0)
    beta_l = 0.5 * (torch.log(prec_l) - torch.log(prec_g)[None])
    beta_l = torch.cat([torch.ones_like(beta_l[:1]), beta_l[1:]], dim=0)  # communication expert
    if mask is not None:
        beta_l = torch.where(mask[:, None], beta_l, 0.0)
    beta = torch.cat([(1.0 - beta_l.sum(dim=0))[None], beta_l], dim=0)
    precs = prec * beta
    if mask is not None:
        keep = torch.cat([torch.ones_like(mask[:1]), mask], dim=0)
        precs = torch.where(keep[:, None], precs, 0.0)
    covar = 1.0 / precs.sum(dim=0)
    mean = covar * torch.sum(torch.cat([ys_g[None], ys_l], dim=0) * precs, dim=0)
    return AggregateResult(mean, covar, beta, prec)


def aggregate_full_covar(beta, covars_g, covars_l, *, config: Config = DEFAULT) -> Tensor:
    """Full-covariance aggregation: invert each expert's posterior
    covariance (one laddered Cholesky of the ``[nc + 1, np, np]`` stack),
    weight the precisions by ``½(βᵢ + βⱼ)``, sum, invert back."""
    covar_gl = torch.cat([covars_g[None], covars_l], dim=0)
    prec_gl = linalg.inv_from_chol(linalg.safe_cholesky(covar_gl, config).chol)
    beta_sym = 0.5 * (beta[:, :, None] + beta[:, None, :])
    prec = torch.sum(prec_gl * beta_sym, dim=0)
    return linalg.inv_from_chol(linalg.safe_cholesky(prec, config).chol)


def predict(
    kern: Kernel,
    params_g,
    params_l,
    state_g: exact_gp.GPState,
    state_l: exact_gp.GPState,
    xs,
    var: str = "diag",
    *,
    mask: Optional[Tensor] = None,
    config: Config = DEFAULT,
) -> AggregateResult:
    """Committee prediction: the global and the local experts' predicts,
    then the aggregation."""
    ys_g, cov_g = exact_gp.predict(kern, state_g, xs, var, config)
    ys_l, cov_l = exact_gp.predict(kern, state_l, xs, var, config)
    if var == "diag":
        var_g, var_l = cov_g, cov_l
    else:
        # the diag path's jitter floor, so that β agrees between modes
        var_g = torch.clamp_min(torch.diagonal(cov_g, dim1=-2, dim2=-1), config.jitter)
        var_l = torch.clamp_min(torch.diagonal(cov_l, dim1=-2, dim2=-1), config.jitter)
    res = aggregate(ys_g, var_g, ys_l, var_l, mask=mask, config=config)
    if var == "diag":
        return res
    # the mean keeps the diagonal β-precisions in full mode, as the reference's
    return res._replace(covar=aggregate_full_covar(res.beta, cov_g, cov_l, config=config))


def sample_predictive(
    kern: Kernel,
    params_g,
    params_l,
    state_g: exact_gp.GPState,
    state_l: exact_gp.GPState,
    xs,
    generator: Optional[torch.Generator] = None,
    n_samples: int = 1,
    *,
    mask: Optional[Tensor] = None,
    config: Config = DEFAULT,
) -> Tensor:
    """Joint draws ``[n_samples, np]`` from the aggregated committee
    posterior: the full-covariance predict, then ``f = μ + Lₚ z`` through
    the jitter ladder.  ``generator`` takes the place of the key."""
    res = predict(kern, params_g, params_l, state_g, state_l, xs, "full", mask=mask, config=config)
    lp = linalg.safe_cholesky(res.covar, config).chol
    z = torch.randn((lp.shape[-1], n_samples), generator=generator, dtype=lp.dtype, device=lp.device)
    return res.mean[None, :] + (lp @ z).T


class FitInfo(NamedTuple):
    params_g: Tensor  #: fitted global-expert hyperparameters [nhp]
    params_l: Tensor  #: fitted per-expert hyperparameters [nc, nhp]
    nlml_g: Tensor    #: global-expert NLML at the optimum
    nlml_l: Tensor    #: per-expert NLML [nc]
    ok_l: Tensor      #: per-expert success mask [nc] (finite optimum)


def fit(
    kern: Kernel,
    xl,
    yl,
    xg,
    yg,
    *,
    params0=None,
    config: Config = DEFAULT,
    max_iter: int = 200,
    tol: float = 1e-4,
    log_space: bool = True,
    shared: bool = False,
    stream: bool = False,
    segment_iters: Optional[int] = None,
    device=None,
) -> Tuple[FitInfo, Tensor, Tensor]:
    """Hyperparameter fits on the augmented datasets plus a global-expert
    fit (what the reference's broken ``GRBCM.train`` meant).

    ``shared=True`` optimizes one hyperparameter vector on the summed
    expert NLML, the calibrated choice for the β aggregation.  Its
    objective is the batch-visible committee NLML, autograd through one
    laddered Cholesky of the stack; ``stream=True`` sums the experts'
    ``nlml_fast`` one at a time instead, so peak memory is one expert's.
    ``segment_iters`` breaks the shared L-BFGS into segments of that many
    iterations, each restarting the curvature memory, until convergence,
    a segment that makes no iteration, or ``max_iter``.
    ``shared=False`` fits each expert on its own.

    NumPy inputs go to ``device`` ("cuda" unless given; no GPU raises).
    Returns ``(FitInfo, x_aug, y_aug)``.
    """
    from pygpr_torch.models.likelihood import nlml, nlml_fast
    from pygpr_torch.optimize.lbfgs import fit_mle, minimize_lbfgs

    xg = as_tensor(xg, device)
    yg, xl, yl = (as_tensor(a, xg.device) for a in (yg, xl, yl))
    x_aug, y_aug = augment(xl, yl, xg, yg)
    if params0 is None:
        # all ones (θ = 1, noise 1): shrinking the noise from the data scale
        # is well conditioned, where the parity init (noise 1e-4) starts
        # near interpolation and traps f32 fits
        params0 = torch.ones(kern.n_params(xg.shape[-1]), dtype=xg.dtype, device=xg.device)
    params0 = torch.as_tensor(params0, dtype=xg.dtype, device=xg.device)

    res_g = fit_mle(kern, params0, xg, yg, config=config, max_iter=max_iter, tol=tol, log_space=log_space)
    nc = xl.shape[0]
    if shared:
        def committee_vals(q):
            if stream:
                return nlml_fast(kern, q, x_aug, y_aug, config)
            return nlml(kern, q, x_aug, y_aug, config)

        def total(u):
            return torch.sum(committee_vals(torch.exp(u) if log_space else u))

        u = torch.log(torch.abs(params0)) if log_space else params0
        if segment_iters is None:
            res_s = minimize_lbfgs(total, u, max_iter=max_iter, tol=tol)
        else:
            done = 0
            while True:
                res_s = minimize_lbfgs(total, u, max_iter=segment_iters, tol=tol)
                u = res_s.params
                it = int(res_s.iters)
                done += it
                if bool(res_s.converged) or it == 0 or done >= max_iter:
                    break
            res_s = res_s._replace(iters=torch.tensor(done))
        p_shared = torch.exp(res_s.params) if log_space else res_s.params
        with torch.no_grad():
            vals = committee_vals(p_shared)
        res_l = res_s._replace(params=p_shared.expand(nc, -1).clone(), value=vals)
    else:
        res_l = fit_mle(
            kern, params0.expand(nc, -1), x_aug, y_aug, config=config, max_iter=max_iter, tol=tol, log_space=log_space
        )
    ok_l = torch.isfinite(res_l.params).all(dim=-1) & torch.isfinite(res_l.value)
    info = FitInfo(res_g.params, res_l.params, res_g.value, res_l.value, ok_l)
    return info, x_aug, y_aug


class GRBCM:
    """Stateful wrapper with the reference ``GRBCM`` API: construct from
    local shards and the global set, ``train()``, ``predict(xs, var)``;
    keeps ``beta`` and ``prec`` of the last aggregation.  NumPy data goes
    to ``device`` ("cuda" unless given; no GPU raises)."""

    def __init__(self, xl, yl, xg, yg, cov: Kernel, config: Config = DEFAULT, device=None):
        xg = as_tensor(xg, device)
        yg, xl, yl = (as_tensor(a, xg.device) for a in (yg, xl, yl))
        self.nc, self.nsc = xl.shape[0], xl.shape[1]
        self.ng, self.dim = xg.shape
        self.cov = cov
        self.config = config
        self.xl, self.yl, self.xg, self.yg = xl, yl, xg, yg
        x, y = augment(xl, yl, xg, yg)
        self.gpg = exact_gp.ExactGP(xg, yg, cov, config)
        self.gpl = exact_gp.ExactGP(x, y, cov, config)
        self.mask = torch.ones(self.nc, dtype=torch.bool, device=xg.device)
        self.beta = None
        self.prec = None

    def train(self, max_iter: int = 200, tol: float = 1e-4, shared: bool = True) -> FitInfo:
        """Hyperparameter fits: one shared vector on the summed expert
        NLML (default) or independent per-expert fits."""
        info, _, _ = fit(
            self.cov, self.xl, self.yl, self.xg, self.yg,
            config=self.config, max_iter=max_iter, tol=tol, shared=shared,
        )
        self.gpg.set_params(info.params_g)
        self.gpl.set_params(info.params_l)
        self.mask = info.ok_l
        return info

    def prepare_serving(self) -> None:
        """Factorize both states and attach ``T = L⁻¹`` to each
        (:func:`exact_gp.precompute_tinv`): later predicts are GEMMs only."""
        self.gpg.prepare_serving()
        self.gpl.prepare_serving()

    def predict(self, xs, var: str = "diag"):
        self.gpg.update()
        self.gpl.update()
        res = predict(
            self.cov, self.gpg.params, self.gpl.params, self.gpg.state, self.gpl.state, xs, var,
            mask=self.mask, config=self.config,
        )
        self.beta, self.prec = res.beta, res.prec
        return res.mean, res.covar

    def aggregate(self, ys_g, covars_g, ys_l, covars_l, var: str = "diag"):
        """The reference's aggregation entry, on given expert predictions."""
        if var == "diag":
            var_g, var_l = covars_g, covars_l
        else:
            var_g = torch.diagonal(covars_g, dim1=-2, dim2=-1)
            var_l = torch.diagonal(covars_l, dim1=-2, dim2=-1)
        res = aggregate(ys_g, var_g, ys_l, var_l, mask=self.mask, config=self.config)
        self.beta, self.prec = res.beta, res.prec
        if var == "diag":
            return res.mean, res.covar
        return res.mean, aggregate_full_covar(res.beta, covars_g, covars_l, config=self.config)
