"""Bayesian optimization on exact-GP posteriors.

Counterpart of ``pygpr_tpu/optimize/bayesopt.py``, for minimization:

  * acquisition functions over the posterior ``(μ, σ²)``: expected
    improvement (EI) and its stable log form (Ament et al. 2023, LogEI),
    the lower confidence bound (LCB) and the probability of improvement;
  * :func:`propose`: a raw random sweep, then multi-start Adam ascent in a
    sigmoid reparameterization that keeps every iterate inside the box;
    :func:`propose_from_raw` is its deterministic part, from the raw
    candidates to the returned point;
  * :func:`thompson_sample`: the minimizer of one posterior draw over a
    random candidate set;
  * :func:`propose_batch`: q-point batches (kriging believer on
    ``exact_gp.extend_state``, or q joint Thompson draws);
  * :class:`BayesOpt`: the ask/tell loop; ``tell`` extends the factorized
    state incrementally and refits every ``refit_every`` observations.

Randomness comes from a ``torch.Generator`` (on the state's device) in
place of the JAX package's key; ``None`` uses torch's default generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.models.exact_gp import GPState
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

_SQRT2PI = math.sqrt(2.0 * math.pi)


def _phi(z):
    return torch.exp(-0.5 * z * z) / _SQRT2PI


def _Phi(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


def expected_improvement(mean, var, best) -> Tensor:
    """EI for minimization: E[max(0, best − f)] = σ(zΦ(z) + φ(z)),
    z = (best − μ)/σ."""
    sigma = torch.sqrt(var)
    z = (best - mean) / sigma
    return sigma * (z * _Phi(z) + _phi(z))


def log_expected_improvement(mean, var, best) -> Tensor:
    """log EI, stable for z ≪ 0 where EI underflows (the asymptotic branch
    uses h(z) → φ(z)/z² as z → −∞)."""
    sigma = torch.sqrt(var)
    z = (best - mean) / sigma
    exact_side = z > -6.0
    zs = torch.where(exact_side, z, torch.zeros_like(z))  # keep the exact branch finite
    h = zs * _Phi(zs) + _phi(zs)
    exact = torch.log(torch.clamp_min(h, torch.finfo(h.dtype).tiny))
    asym = -0.5 * z * z - math.log(_SQRT2PI) - 2.0 * torch.log(torch.clamp_min(-z, 1e-12))
    return torch.log(sigma) + torch.where(exact_side, exact, asym)


def lower_confidence_bound(mean, var, beta: float = 2.0) -> Tensor:
    """Negated LCB (maximizing it minimizes f): −(μ − β·σ)."""
    return -(mean - beta * torch.sqrt(var))


def probability_of_improvement(mean, var, best) -> Tensor:
    """PI for minimization: Φ((best − μ)/σ)."""
    return _Phi((best - mean) / torch.sqrt(var))


def _acq_values(kern, state, x, acq, best, beta, config) -> Tensor:
    mean, var = exact_gp.predict(kern, state, x, "diag", config)
    if acq == "log_ei":
        return log_expected_improvement(mean, var, best)
    if acq == "ei":
        return expected_improvement(mean, var, best)
    if acq == "lcb":
        return lower_confidence_bound(mean, var, beta)
    if acq == "pi":
        return probability_of_improvement(mean, var, best)
    raise ValueError(f"unknown acquisition {acq!r}")


def _box(bounds, state: GPState) -> Tuple[Tensor, Tensor]:
    return tuple(torch.as_tensor(as_tensor(b, state.x.device), dtype=state.x.dtype) for b in bounds)


def _uniform(lo, hi, m: int, generator) -> Tensor:
    return lo + (hi - lo) * torch.rand((m, lo.shape[-1]), generator=generator, dtype=lo.dtype, device=lo.device)


def propose_from_raw(kern: Kernel, state: GPState, bounds, raw, *, acq: str = "log_ei", best=None,
                     beta: float = 2.0, n_starts: int = 8, n_steps: int = 80, learning_rate: float = 0.1,
                     config: Config = DEFAULT) -> Tensor:
    """The deterministic part of :func:`propose`: the ``n_starts`` best of
    the raw candidates ``[n_raw, d]`` seed Adam ascents in
    ``x = lo + (hi−lo)·σ(u)``; the best end point ``[d]``."""
    from pygpr_torch.optimize.adam import Adam

    lo, hi = _box(bounds, state)
    raw = torch.as_tensor(as_tensor(raw, state.x.device), dtype=state.x.dtype)
    if best is None:
        best = torch.min(state.y)
    with torch.no_grad():
        vals = _acq_values(kern, state, raw, acq, best, beta, config)
        x0 = raw[torch.topk(vals, n_starts).indices]
        # sigmoid reparameterization, clipped strictly inside for the logit
        frac = torch.clamp((x0 - lo) / (hi - lo), 1e-4, 1.0 - 1e-4)
        u = torch.log(frac) - torch.log1p(-frac)

    def to_x(v):
        return lo + (hi - lo) * torch.sigmoid(v)

    opt = Adam([u], learning_rate)
    for _ in range(n_steps):
        (u,), _ = opt.value_and_step(lambda p: -torch.sum(_acq_values(kern, state, to_x(p[0]), acq, best, beta,
                                                                      config)), [u])
    with torch.no_grad():
        x = to_x(u)
        return x[torch.argmax(_acq_values(kern, state, x, acq, best, beta, config))]


def propose(kern: Kernel, state: GPState, bounds, generator: Optional[torch.Generator] = None, *,
            acq: str = "log_ei", best=None, beta: float = 2.0, n_raw: int = 512, n_starts: int = 8,
            n_steps: int = 80, learning_rate: float = 0.1, config: Config = DEFAULT) -> Tensor:
    """Next evaluation point ``[d]``: the argmax of the acquisition over the
    box.  ``n_raw`` uniform candidates drawn from ``generator``, then
    :func:`propose_from_raw`."""
    lo, hi = _box(bounds, state)
    raw = _uniform(lo, hi, n_raw, generator)
    return propose_from_raw(kern, state, (lo, hi), raw, acq=acq, best=best, beta=beta, n_starts=n_starts,
                            n_steps=n_steps, learning_rate=learning_rate, config=config)


def thompson_sample(kern: Kernel, state: GPState, bounds, generator: Optional[torch.Generator] = None, *,
                    n_candidates: int = 512, config: Config = DEFAULT) -> Tensor:
    """Thompson sampling: one posterior draw on a random candidate set and
    its minimizer."""
    lo, hi = _box(bounds, state)
    with torch.no_grad():
        cand = _uniform(lo, hi, n_candidates, generator)
        f = exact_gp.sample_predictive(kern, state, cand, generator, 1, config)[0]
    return cand[torch.argmin(f)]


def propose_batch(kern: Kernel, state: GPState, bounds, generator: Optional[torch.Generator], q: int, *,
                  acq: str = "log_ei", beta: float = 2.0, config: Config = DEFAULT, **propose_kwargs) -> Tensor:
    """``q``-point batch ``[q, d]`` for parallel evaluation.

    Kriging believer (Ginsbourger et al. 2010): propose greedily, take the
    posterior mean as the fantasized outcome, append it by
    ``exact_gp.extend_state`` (O(n²) a fantasy, no refactorization), and
    repeat with the updated incumbent.  ``acq="thompson"`` draws ``q``
    joint posterior functions on one candidate set and returns each one's
    minimizer.
    """
    if acq == "thompson":
        lo, hi = _box(bounds, state)
        with torch.no_grad():
            cand = _uniform(lo, hi, propose_kwargs.get("n_raw", 512), generator)
            f = exact_gp.sample_predictive(kern, state, cand, generator, q, config)
        return cand[torch.argmin(f, dim=-1)]

    st = state
    best = torch.min(state.y)
    pts = []
    for _ in range(q):
        xq = propose(kern, st, bounds, generator, acq=acq, best=best, beta=beta, config=config, **propose_kwargs)
        pts.append(xq)
        with torch.no_grad():
            fantasy, _ = exact_gp.predict(kern, st, xq[None], "none", config)
            st = exact_gp.extend_state(kern, st, xq[None], fantasy, config)
        best = torch.minimum(best, fantasy[0])
    return torch.stack(pts)


class BayesOpt:
    """Ask/tell Bayesian-optimization loop over an exact GP.

    ``ask()`` proposes the next point; ``tell(x, y)`` appends the
    observation by incremental block-Cholesky extension (O(n²) a point)
    and refits the hyperparameters (L-BFGS) every ``refit_every``
    observations.  NumPy inputs go to ``device`` ("cuda" unless given); the
    generator is seeded with ``seed`` on that device.
    """

    def __init__(self, kern: Kernel, x0, y0, bounds, *, acq: str = "log_ei", beta: float = 2.0,
                 refit_every: int = 5, seed: int = 0, config: Config = DEFAULT,
                 propose_kwargs: Optional[dict] = None, device=None):
        self.kern = kern
        self.x = torch.atleast_2d(as_tensor(x0, device))
        self.y = torch.as_tensor(as_tensor(y0, self.x.device), dtype=self.x.dtype)
        self.bounds = tuple(torch.as_tensor(as_tensor(b, self.x.device), dtype=self.x.dtype) for b in bounds)
        self.acq = acq
        self.beta = beta
        self.refit_every = refit_every
        self.propose_kwargs = dict(propose_kwargs or {})
        self.config = config
        self.generator = torch.Generator(device=self.x.device)
        self.generator.manual_seed(seed)
        self.params = kern.init_params(self.x, config)
        self._since_fit = 0
        self._refit()

    def _refit(self):
        from pygpr_torch.optimize.lbfgs import fit_mle

        self.params = fit_mle(self.kern, self.params, self.x, self.y, config=self.config, max_iter=100).params
        with torch.no_grad():
            self.state = exact_gp.factorize(self.kern, self.params, self.x, self.y, self.config)
        self._since_fit = 0

    @property
    def best(self):
        """(x_best, y_best) of the observations so far."""
        i = int(torch.argmin(self.y))
        return self.x[i], self.y[i]

    def ask(self, q: int = 1) -> Tensor:
        """Next point ``[d]`` (default), or a ``[q, d]`` batch for parallel
        evaluation (:func:`propose_batch`)."""
        if q > 1:
            return propose_batch(self.kern, self.state, self.bounds, self.generator, q, acq=self.acq,
                                 beta=self.beta, config=self.config, **self.propose_kwargs)
        if self.acq == "thompson":
            return thompson_sample(self.kern, self.state, self.bounds, self.generator, config=self.config)
        return propose(self.kern, self.state, self.bounds, self.generator, acq=self.acq, beta=self.beta,
                       config=self.config, **self.propose_kwargs)

    def tell(self, x, y) -> None:
        x = torch.atleast_2d(torch.as_tensor(as_tensor(x, self.x.device), dtype=self.x.dtype))
        y = torch.atleast_1d(torch.as_tensor(as_tensor(y, self.x.device), dtype=self.y.dtype))
        self.x = torch.cat([self.x, x], dim=0)
        self.y = torch.cat([self.y, y], dim=0)
        self._since_fit += x.shape[0]
        if self._since_fit >= self.refit_every:
            self._refit()
        else:
            with torch.no_grad():
                self.state = exact_gp.extend_state(self.kern, self.state, x, y, self.config)
