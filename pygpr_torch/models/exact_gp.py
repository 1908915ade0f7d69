"""Exact Gaussian-process regression: functional core and a thin wrapper.

Counterpart of ``pygpr_tpu/models/exact_gp.py`` (the reference's
``gpr.py``).  :func:`factorize` builds an explicit posterior state
(:class:`GPState`): K → L → w = K⁻¹y.  :func:`predict` gives the mean
K*·w and the diagonal variance or full covariance K** − K*K⁻¹K*ᵀ.

A leading committee axis ``[nc, n, d]`` is batch-visible: the grams are
built as one stack (``train_gram``: one K1 launch on the card) and one
laddered Cholesky factors the ``[nc, n, n]`` stack, so f32 on the card
goes through kernel K3 with every expert's pivot chain advancing
together, and the solves and products are batched.  A stack
larger than :data:`BATCHED_STACK_BYTES` is factored and solved one
expert at a time instead (the JAX package's ``lax.map``).

NumPy inputs go to ``device`` ("cuda" unless given; no GPU raises);
tensors stay where they are.  ``predict`` puts NumPy queries where the
state lives.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel, train_gram

Tensor = torch.Tensor

#: largest ``[nc, n, n]`` stack (bytes) that is factored and solved in
#: one batched call: cuSOLVER's batched solve refused a 5.2 GB f64 stack
#: ([16, 6400, 6400]) with "invalid argument" on an H100, where the
#: 2.6 GB f32 stack of the same shape runs
BATCHED_STACK_BYTES = 2**32


def _per_expert(t: Tensor) -> bool:
    """Whether a committee ``[nc, n, ·]`` is too large for the batched
    factorization and solves: its ``[nc, n, n]`` stack in ``t``'s type."""
    return t.ndim == 3 and t.shape[0] * t.shape[1] ** 2 * t.element_size() > BATCHED_STACK_BYTES


class GPState(NamedTuple):
    """Posterior state of an exact GP."""

    x: Tensor        #: training inputs [n, d] (or [nc, n, d])
    y: Tensor        #: training targets [n] (or [nc, n])
    params: Tensor   #: kernel hyperparameters [nhp] (or [nc, nhp])
    chol: Tensor     #: lower Cholesky factor of K + jitter·I
    weights: Tensor  #: w = K⁻¹ y
    jitter: Tensor   #: jitter the ladder used, per matrix
    ok: Tensor       #: factorization success flag, per matrix
    #: optional T = L⁻¹ (:func:`precompute_tinv`): every predict-time
    #: triangular solve becomes one GEMM
    tinv: Optional[Tensor] = None


def _stack_states(states) -> GPState:
    fields = list(zip(*states))
    tinv = fields.pop()
    stacked = [torch.stack(f) for f in fields]
    return GPState(*stacked, tinv=None if tinv[0] is None else torch.stack(tinv))


def _expert(state: GPState, i: int) -> GPState:
    return GPState(*(None if f is None else f[i] for f in state))


def _factorize_one(kern: Kernel, params, x, y, config: Config) -> GPState:
    res = linalg.safe_cholesky(train_gram(kern, params, x, config), config)
    w = linalg.cholesky_solve(res.chol, y)
    return GPState(x, y, params, res.chol, w, res.jitter, res.ok)


def factorize(kern: Kernel, params, x, y, config: Config = DEFAULT, device=None) -> GPState:
    """Posterior state K → L → w (the reference's ``update()``).

    Over a committee axis: one laddered Cholesky of the stacked grams
    (each expert on its own rung) and one batched solve, or one expert at
    a time for a stack above :data:`BATCHED_STACK_BYTES`."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    params = torch.as_tensor(params, dtype=x.dtype, device=x.device)
    if x.ndim != 3:
        return _factorize_one(kern, params, x, y, config)
    nc = x.shape[0]
    p_all = params if params.ndim == 2 else params.expand(nc, -1)
    if _per_expert(x):
        return _stack_states(_factorize_one(kern, p_all[i], x[i], y[i], config) for i in range(nc))
    grams = train_gram(kern, params, x, config)
    res = linalg.safe_cholesky(grams, config)
    del grams
    w = linalg.cholesky_solve(res.chol, y)
    return GPState(x, y, p_all, res.chol, w, res.jitter, res.ok)


def precompute_tinv(state: GPState, config: Config = DEFAULT) -> GPState:
    """Serving state: attach ``T = L⁻¹`` (one ⅓n³ block-doubling
    inverse, batched over a committee); afterwards each predict is GEMMs
    only."""
    with torch.no_grad():
        tinv = linalg.tri_inverse_doubling(state.chol)
    return state._replace(tinv=tinv)


def _cross(kern, params, x, xp, config) -> Tensor:
    """K(xp, x) ``[m, n]``, or ``[nc, m, n]`` per expert (xp shared
    ``[m, d]`` or per expert ``[nc, m, d]``)."""
    if x.ndim == 2:
        return kern.matrix(params, x, xp, config=config)
    return torch.stack([
        kern.matrix(params[i], x[i], xp[i] if xp.ndim == 3 else xp, config=config) for i in range(x.shape[0])
    ])


def _query_kernel(kern, params, xp, full: bool, config) -> Tensor:
    """K(xp, xp) (``full``) or its diagonal, per expert for ``[nc, nhp]``
    parameters."""
    if params.ndim == 1:
        return kern.matrix(params, xp, config=config) if full else kern.diag(params, xp, config=config)
    return torch.stack([
        _query_kernel(kern, params[i], xp[i] if xp.ndim == 3 else xp, full, config)
        for i in range(params.shape[0])
    ])


def _predict_mean(kern, state, xp, config) -> Tuple[Tensor, Tensor]:
    """(mean [..., m], cross kernel K* [..., m, n])."""
    krns = _cross(kern, state.params, state.x, xp, config)
    return (krns @ state.weights[..., None])[..., 0], krns


def _predict_var(kern, state, xp, krns, config) -> Tensor:
    """diag(K**) − Σⱼ K*ᵢⱼ (K⁻¹K*ᵀ)ⱼᵢ, clamped at the jitter floor (f32
    round-off can leave a small negative at well-observed points)."""
    kss_diag = _query_kernel(kern, state.params, xp, False, config)
    if state.tinv is not None:
        v = state.tinv @ krns.mT
        quad = torch.sum(v * v, dim=-2)
    else:
        lks = linalg.cholesky_solve(state.chol, krns.mT)
        quad = torch.sum(krns * lks.mT, dim=-1)
    return torch.clamp_min(kss_diag - quad, config.jitter)


def _predict_covar(kern, state, xp, krns, config) -> Tensor:
    """K** − K* K⁻¹ K*ᵀ."""
    kss = _query_kernel(kern, state.params, xp, True, config)
    if state.tinv is not None:
        v = state.tinv @ krns.mT
        return kss - v.mT @ v
    return kss - krns @ linalg.cholesky_solve(state.chol, krns.mT)


def _predict_all(kern, state, xp, var, config):
    mean, krns = _predict_mean(kern, state, xp, config)
    if var == "full":
        return mean, _predict_covar(kern, state, xp, krns, config)
    if var == "diag":
        return mean, _predict_var(kern, state, xp, krns, config)
    return mean, None


def predict(kern: Kernel, state: GPState, xp, var: str = "full", config: Config = DEFAULT):
    """Posterior mean and ("full" | "diag" | "none") uncertainty at xp.

    A committee state with one ``[m, d]`` xp predicts it for every
    expert; ``[nc, m, d]`` gives each expert its own queries.  Batched
    over the committee, except for the solves of a state without ``T``
    whose stack is above :data:`BATCHED_STACK_BYTES`.
    """
    if var not in ("full", "diag", "none"):
        raise ValueError(f"var must be 'full', 'diag' or 'none', got {var!r}")
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    if var != "none" and state.tinv is None and _per_expert(state.chol):
        outs = [
            _predict_all(kern, _expert(state, i), xp[i] if xp.ndim == 3 else xp, var, config)
            for i in range(state.x.shape[0])
        ]
        means = torch.stack([m for m, _ in outs])
        return means, None if var == "none" else torch.stack([c for _, c in outs])
    return _predict_all(kern, state, xp, var, config)


def fit_predict(kern: Kernel, params, x, y, xp, var: str = "diag", config: Config = DEFAULT, device=None):
    """factorize + predict in one call."""
    state = factorize(kern, params, x, y, config, device=device)
    return predict(kern, state, xp, var, config)


def predictive_factor(kern: Kernel, state: GPState, xp, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """``(μ, Lₚ)``: the posterior mean at ``xp`` and the laddered lower
    factor of the predictive covariance Σ = K** − K*K⁻¹K*ᵀ (exactly
    singular at noiseless training inputs, hence the ladder).  Per expert
    over a committee axis."""
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    mean, covar = _predict_all(kern, state, xp, "full", config)
    return mean, linalg.safe_cholesky(covar, config).chol


def sample_predictive(
    kern: Kernel,
    state: GPState,
    xp,
    generator: Optional[torch.Generator] = None,
    n_samples: int = 1,
    config: Config = DEFAULT,
) -> Tensor:
    """Joint draws from the GP posterior at ``xp``: ``f = μ + Lₚ z``.

    ``generator`` (on the state's device) takes the place of the JAX
    package's key; ``None`` uses torch's default generator.  Returns
    ``[n_samples, m]`` (or ``[nc, n_samples, m]`` for a committee state,
    one draw of ``z`` per expert in order).
    """
    mean, lp = predictive_factor(kern, state, xp, config)
    z = torch.randn(lp.shape[:-1] + (n_samples,), generator=generator, dtype=lp.dtype, device=lp.device)
    return mean[..., None, :] + (lp @ z).mT


def _extend_one(kern: Kernel, state: GPState, x2, y2, config: Config) -> GPState:
    k21 = kern.matrix(state.params, state.x, x2, config=config)  # [k, n]
    k22 = kern.matrix(state.params, x2, config=config)           # [k, k]
    s = linalg.solve_lower(state.chol, k21.T)                    # [n, k]
    # the Schur factorization's ladder re-adds config.jitter on rung 0:
    # subtract it, so the extended factor equals a refactorization
    carry = state.jitter - config.jitter
    res = linalg.safe_cholesky(linalg.add_diag(k22 - s.T @ s, carry), config)
    l22 = res.chol                                               # [k, k]

    n, k = state.x.shape[-2], x2.shape[-2]
    chol = torch.zeros((n + k, n + k), dtype=state.chol.dtype, device=state.chol.device)
    chol[:n, :n] = state.chol
    chol[n:, :n] = s.T
    chol[n:, n:] = l22

    # incremental solve of K_new w_new = [y; y2]: the old forward pass is
    # Lᵀw = L⁻¹y, so no re-solve with n right-hand sides
    z1 = state.chol.T @ state.weights
    z2 = linalg.solve_lower(l22, y2 - s.T @ z1)
    w2 = linalg.solve_lower_t(l22, z2)
    w1 = state.weights - linalg.solve_lower_t(state.chol, s @ w2)

    tinv = None
    if state.tinv is not None:
        # T_new = [[T, 0], [−L22⁻¹ Sᵀ T, L22⁻¹]] keeps serving GEMM-only
        t22 = linalg.tri_inverse_doubling(l22)
        tinv = torch.zeros_like(chol)
        tinv[:n, :n] = state.tinv
        tinv[n:, :n] = -(t22 @ (s.T @ state.tinv))
        tinv[n:, n:] = t22

    return GPState(
        x=torch.cat([state.x, x2], dim=-2),
        y=torch.cat([state.y, y2], dim=-1),
        params=state.params,
        chol=chol,
        weights=torch.cat([w1, w2], dim=-1),
        jitter=torch.maximum(state.jitter, res.jitter),
        ok=state.ok * res.ok,
        tinv=tinv,
    )


def extend_state(kern: Kernel, state: GPState, x2, y2, config: Config = DEFAULT) -> GPState:
    """Online update: append ``k`` observations to a factorized state in
    O(n²k) instead of the O((n+k)³) refactorization.

    With ``K_new = [[K, K₁₂], [K₂₁, K₂₂]]`` and ``K = LLᵀ``::

        S = L⁻¹K₁₂,   L_new = [[L, 0], [Sᵀ, chol(K₂₂ − SᵀS)]]

    The Schur block goes through the jitter ladder (kernel K3 for f32
    k ≤ 1024 on the card), so a near-duplicate new point is rescued, not
    NaN.  Weights are updated incrementally and a serving state keeps its
    ``T``.  Over a committee axis (``x2`` shared ``[k, d]`` or per expert
    ``[nc, k, d]``) one expert at a time.
    """
    x2 = torch.as_tensor(as_tensor(x2, state.x.device), dtype=state.x.dtype)
    y2 = torch.as_tensor(as_tensor(y2, state.x.device), dtype=state.x.dtype)
    if state.x.ndim == 3:
        per = x2.ndim == 3
        return _stack_states(
            _extend_one(kern, _expert(state, i), x2[i] if per else x2, y2[i] if per else y2, config)
            for i in range(state.x.shape[0])
        )
    return _extend_one(kern, state, x2, y2, config)


class GPR:
    """Abstract GP-regression base (the reference's ``GPR``): holds
    ``x``/``y``/``cov``/``params`` and the ``need_upd`` dirty flag."""

    def __init__(self, x, y, cov: Kernel, device=None):
        self.x = as_tensor(x, device)
        self.y = as_tensor(y, self.x.device)
        self.cov = cov
        self.params = NotImplemented
        self.need_upd: bool = True

    def set_params(self, params) -> None:
        """Replace the parameters and mark the model dirty."""
        self.params = torch.as_tensor(params, dtype=self.x.dtype, device=self.x.device).clone()
        self.need_upd = True

    def update(self) -> None:
        raise NotImplementedError

    def predict(self, xp, var: str = "full"):
        raise NotImplementedError

    def predict_var(self, xp, **kwargs):
        raise NotImplementedError

    def predict_covar(self, xp, **kwargs):
        raise NotImplementedError


class ExactGP(GPR):
    """Stateful wrapper with the reference ``Exact_GP`` API: lazy
    ``update`` behind the dirty flag, ``predict(xp, var=...)`` returning
    ``[mean, covariance]``.  NumPy data goes to ``device`` ("cuda"
    unless given; no GPU raises)."""

    def __init__(self, x, y, cov: Kernel, config: Config = DEFAULT, device=None):
        super().__init__(x, y, cov, device)
        self.config = config
        self.params = cov.init_params(self.x, config)
        self.state: Optional[GPState] = None

    def set_data(self, x, y) -> None:
        self.x = as_tensor(x, self.x.device)
        self.y = as_tensor(y, self.x.device)
        self.need_upd = True

    def add_data(self, x2, y2) -> None:
        """Append observations: extend a live factorized state
        (:func:`extend_state`), else grow the data for the next update."""
        x2 = as_tensor(x2, self.x.device)
        y2 = as_tensor(y2, self.x.device)
        if self.state is not None and not self.need_upd:
            self.state = extend_state(self.cov, self.state, x2, y2, self.config)
            self.x, self.y = self.state.x, self.state.y
        else:
            self.x = torch.cat([self.x, x2], dim=-2)
            self.y = torch.cat([self.y, y2], dim=-1)
            self.need_upd = True

    def update(self) -> None:
        if self.need_upd:
            self.state = factorize(self.cov, self.params, self.x, self.y, self.config)
            self.need_upd = False

    def prepare_serving(self) -> None:
        """Attach ``T = L⁻¹`` to the cached state (:func:`precompute_tinv`)."""
        self.update()
        if self.state.tinv is None:
            self.state = precompute_tinv(self.state, self.config)

    def predict(self, xp, var: str = "full"):
        self.update()
        return list(predict(self.cov, self.state, xp, var, self.config))

    def predict_var(self, xp, **kwargs):
        """Diagonal predictive variance."""
        return self.predict(xp, "diag")[1]

    def predict_covar(self, xp, **kwargs):
        """Full predictive covariance."""
        return self.predict(xp, "full")[1]
