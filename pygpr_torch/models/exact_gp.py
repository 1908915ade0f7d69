"""Exact Gaussian-process regression: functional core and a thin wrapper.

Counterpart of ``pygpr_tpu/models/exact_gp.py`` (the reference's
``gpr.py``).  :func:`factorize` builds an explicit posterior state
(:class:`GPState`): K → L → w = K⁻¹y.  :func:`predict` gives the mean
K*·w and the diagonal variance or full covariance K** − K*K⁻¹K*ᵀ.  A
leading committee axis ``[nc, n, d]`` is a loop over experts, stacked.

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


def _factorize_one(kern: Kernel, params, x, y, config: Config) -> GPState:
    res = linalg.safe_cholesky(train_gram(kern, params, x, config), config)
    w = linalg.cholesky_solve(res.chol, y)
    return GPState(x, y, params, res.chol, w, res.jitter, res.ok)


def factorize(kern: Kernel, params, x, y, config: Config = DEFAULT, device=None) -> GPState:
    """Posterior state K → L → w (the reference's ``update()``)."""
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    params = torch.as_tensor(params, dtype=x.dtype, device=x.device)
    if x.ndim == 3:
        return _stack_states(
            _factorize_one(kern, params[i] if params.ndim == 2 else params, x[i], y[i], config)
            for i in range(x.shape[0])
        )
    return _factorize_one(kern, params, x, y, config)


def precompute_tinv(state: GPState, config: Config = DEFAULT) -> GPState:
    """Serving state: attach ``T = L⁻¹`` (one ⅓n³ block-doubling
    inverse); afterwards each predict is GEMMs only."""
    with torch.no_grad():
        if state.chol.ndim == 3:
            tinv = torch.stack([linalg.tri_inverse_doubling(c) for c in state.chol])
        else:
            tinv = linalg.tri_inverse_doubling(state.chol)
    return state._replace(tinv=tinv)


def _predict_mean_one(kern, state, xp, config) -> Tuple[Tensor, Tensor]:
    """(mean [m], cross kernel K* [m, n])."""
    krns = kern.matrix(state.params, state.x, xp, config=config)
    return krns @ state.weights, krns


def _predict_var_one(kern, state, xp, krns, config) -> Tensor:
    """diag(K**) − Σⱼ K*ᵢⱼ (K⁻¹K*ᵀ)ⱼᵢ, clamped at the jitter floor (f32
    round-off can leave a small negative at well-observed points)."""
    kss_diag = kern.diag(state.params, xp, config=config)
    if state.tinv is not None:
        v = state.tinv @ krns.T
        quad = torch.sum(v * v, dim=0)
    else:
        lks = linalg.cholesky_solve(state.chol, krns.T)
        quad = torch.sum(krns * lks.T, dim=-1)
    return torch.clamp_min(kss_diag - quad, config.jitter)


def _predict_covar_one(kern, state, xp, krns, config) -> Tensor:
    """K** − K* K⁻¹ K*ᵀ."""
    kss = kern.matrix(state.params, xp, config=config)
    if state.tinv is not None:
        v = state.tinv @ krns.T
        return kss - v.T @ v
    return kss - krns @ linalg.cholesky_solve(state.chol, krns.T)


def _predict_one(kern, state, xp, var, config):
    mean, krns = _predict_mean_one(kern, state, xp, config)
    if var == "full":
        return mean, _predict_covar_one(kern, state, xp, krns, config)
    if var == "diag":
        return mean, _predict_var_one(kern, state, xp, krns, config)
    return mean, None


def predict(kern: Kernel, state: GPState, xp, var: str = "full", config: Config = DEFAULT):
    """Posterior mean and ("full" | "diag" | "none") uncertainty at xp.

    A committee state with one ``[m, d]`` xp predicts it for every
    expert; ``[nc, m, d]`` gives each expert its own queries.
    """
    if var not in ("full", "diag", "none"):
        raise ValueError(f"var must be 'full', 'diag' or 'none', got {var!r}")
    xp = torch.as_tensor(as_tensor(xp, state.x.device), dtype=state.x.dtype)
    if state.x.ndim == 3:
        outs = [
            _predict_one(kern, GPState(*(None if f is None else f[i] for f in state)),
                         xp[i] if xp.ndim == 3 else xp, var, config)
            for i in range(state.x.shape[0])
        ]
        means = torch.stack([m for m, _ in outs])
        return means, None if var == "none" else torch.stack([c for _, c in outs])
    return _predict_one(kern, state, xp, var, config)


def fit_predict(kern: Kernel, params, x, y, xp, var: str = "diag", config: Config = DEFAULT, device=None):
    """factorize + predict in one call."""
    state = factorize(kern, params, x, y, config, device=device)
    return predict(kern, state, xp, var, config)


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
