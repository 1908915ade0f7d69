"""Product-of-experts committees: PoE, gPoE, BCM and rBCM.

Counterpart of ``pygpr_tpu/models/committee.py``: the distributed-GP
family of Deisenroth & Ng (ICML 2015) that grBCM is defined against.  All
four combine the experts' precisions,

    prec(x*) = Σᵢ βᵢ(x*)·precᵢ(x*)  [+ prior correction]
    mean(x*) = covar(x*) · Σᵢ βᵢ(x*)·precᵢ(x*)·μᵢ(x*)

and differ in the weights and the correction:

  ============  ==========================  =============================
  method        βᵢ                          prior correction
  ============  ==========================  =============================
  ``"poe"``     1                           none
  ``"gpoe"``    1/nc (sums to 1)            none
  ``"bcm"``     1                           + (1 − nc)·prec_prior
  ``"rbcm"``    ½(log σ²_prior − log σ²ᵢ)   + (1 − Σᵢβᵢ)·prec_prior
  ============  ==========================  =============================

Experts are plain data shards (no global expert, no augmentation); their
predicts are the batched ``exact_gp.predict``.
"""

from __future__ import annotations

from typing import Optional

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.models.grbcm import AggregateResult
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

METHODS = ("poe", "gpoe", "bcm", "rbcm")


def committee_beta(method: str, var_l: Tensor, prior_var: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Per-expert, per-query weights βᵢ(x*) ``[nc, np]`` from the expert
    variances ``var_l [nc, np]`` and the prior variance ``[np]`` or
    ``[nc, np]``; ``mask [nc]`` bool keeps an expert where True."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if method in ("poe", "bcm"):
        beta = torch.ones_like(var_l)
    elif method == "gpoe":
        n_act = var_l.shape[0] if mask is None else torch.clamp_min(mask.to(var_l.dtype).sum(), 1.0)
        beta = torch.ones_like(var_l) / n_act
    else:
        # differential-entropy weights, clamped at 0: an f32 posterior
        # variance can round above the prior's
        beta = torch.clamp_min(0.5 * (torch.log(prior_var.expand_as(var_l)) - torch.log(var_l)), 0.0)
    if mask is not None:
        beta = torch.where(mask[:, None], beta, 0.0)
    return beta


def aggregate_committee(
    method: str, ys_l: Tensor, var_l: Tensor, prior_var: Tensor, *, mask: Optional[Tensor] = None,
    config: Config = DEFAULT,
) -> AggregateResult:
    """Combine the expert posteriors ``(ys_l, var_l) [nc, np]`` into one
    Gaussian per query (diagonal path).  With per-expert prior variances
    ``[nc, np]`` the BCM correction uses the committee-mean prior
    precision."""
    beta = committee_beta(method, var_l, prior_var, mask)
    prec_l = 1.0 / var_l
    inv_pv = 1.0 / prior_var.expand_as(var_l)
    if mask is not None:
        prec_prior = torch.where(mask[:, None], inv_pv, 0.0).sum(dim=0) / torch.clamp_min(
            mask.to(inv_pv.dtype).sum(), 1.0
        )
    else:
        prec_prior = inv_pv.mean(dim=0)
    wprec = beta * prec_l
    prec = wprec.sum(dim=0)
    if method in ("bcm", "rbcm"):
        prec = prec + (1.0 - beta.sum(dim=0)) * prec_prior
    # Deisenroth & Ng guarantee prec ≥ prec_prior for valid posteriors;
    # the floor only guards f32 rounding at the boundary
    prec = torch.maximum(prec, config.jitter * prec_prior)
    covar = 1.0 / prec
    return AggregateResult(covar * torch.sum(wprec * ys_l, dim=0), covar, beta, prec_l)


def prior_variance(kern: Kernel, params: Tensor, xs: Tensor, config: Config = DEFAULT) -> Tensor:
    """Prior variance k(x*, x*) at the queries, ``[np]`` or, for
    per-expert parameters ``[nc, nhp]``, ``[nc, np]``."""
    if params.ndim == 2:
        return torch.stack([kern.diag(p, xs, config=config) for p in params])
    return kern.diag(params, xs, config=config)


def predict_committee(
    kern: Kernel, state_l: exact_gp.GPState, xs, method: str = "rbcm", *, mask: Optional[Tensor] = None,
    config: Config = DEFAULT,
) -> AggregateResult:
    """Per-expert diagonal predicts over a committee state ``[nc, ...]``
    and the chosen aggregation."""
    xs = torch.as_tensor(as_tensor(xs, state_l.x.device), dtype=state_l.x.dtype)
    ys_l, var_l = exact_gp.predict(kern, state_l, xs, "diag", config)
    pv = prior_variance(kern, state_l.params, xs, config)
    return aggregate_committee(method, ys_l, var_l, pv, mask=mask, config=config)


def fit_committee(
    kern: Kernel, xl, yl, *, params0=None, config: Config = DEFAULT, max_iter: int = 200, tol: float = 1e-4,
    log_space: bool = True, shared: bool = True, device=None,
):
    """Hyperparameter fit of a plain committee: one vector on the summed
    expert NLML (``shared``, the default) or independent per-expert fits.
    Returns the ``optimize.lbfgs`` result, ``params`` ``[nhp]`` or
    ``[nc, nhp]``."""
    from pygpr_torch.models.likelihood import nlml
    from pygpr_torch.optimize.lbfgs import fit_mle, minimize_lbfgs

    xl = as_tensor(xl, device)
    yl = as_tensor(yl, xl.device)
    if params0 is None:
        params0 = torch.ones(kern.n_params(xl.shape[-1]), dtype=xl.dtype, device=xl.device)
    params0 = torch.as_tensor(params0, dtype=xl.dtype, device=xl.device)
    if not shared:
        return fit_mle(
            kern, params0.expand(xl.shape[0], -1), xl, yl,
            config=config, max_iter=max_iter, tol=tol, log_space=log_space,
        )

    def total(u):
        return torch.sum(nlml(kern, torch.exp(u) if log_space else u, xl, yl, config))

    res = minimize_lbfgs(total, torch.log(torch.abs(params0)) if log_space else params0, max_iter=max_iter, tol=tol)
    return res._replace(params=torch.exp(res.params)) if log_space else res
