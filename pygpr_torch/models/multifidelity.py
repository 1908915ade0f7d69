"""Multi-fidelity GP regression: AR(1) co-kriging (Kennedy & O'Hagan,
Biometrika 2000) in Le Gratiet's recursive form (Le Gratiet & Garnier,
IJUQ 2014).

Counterpart of ``pygpr_tpu/models/multifidelity.py``.  Many cheap
low-fidelity observations and a few expensive high-fidelity ones under

    f_hi(x) = ρ · f_lo(x) + δ(x),     δ ⊥ f_lo,  δ ~ GP(0, k_δ)

Two stages, each a standard exact GP: (1) fit GP_lo on (X_lo, y_lo) by
the log-space L-BFGS MLE; (2) fit (ρ, θ_δ) on the residuals
``y_hi − ρ·μ_lo(X_hi)`` under k_δ.  Prediction composes the levels:
μ_hi = ρ·μ_lo + μ_δ, σ²_hi = ρ²·σ²_lo + σ²_δ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.models.likelihood import nlml as gaussian_nlml
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


class MFState(NamedTuple):
    """Fitted two-level posterior."""

    state_lo: exact_gp.GPState   #: exact-GP state of the low level
    state_d: exact_gp.GPState    #: exact-GP state of the discrepancy
    rho: Tensor                  #: fitted autoregressive scale
    params_lo: Tensor
    params_d: Tensor
    nlml_lo: Tensor
    nlml_d: Tensor


def nlml_stage2(kern_d: Kernel, params_d, rho, kern_lo: Kernel, state_lo: exact_gp.GPState, x_hi, y_hi,
                config: Config = DEFAULT) -> Tensor:
    """Exact NLML of the high-fidelity residuals ``y_hi − ρ·μ_lo(x_hi)``
    under the discrepancy kernel, differentiable in (ρ, θ_δ)."""
    mu_lo, _ = exact_gp.predict(kern_lo, state_lo, x_hi, "none", config)
    return gaussian_nlml(kern_d, params_d, x_hi, y_hi - rho * mu_lo, config)


def fit_mf(kern_lo: Kernel, kern_d: Kernel, x_lo, y_lo, x_hi, y_hi, *, params_lo0=None, params_d0=None,
           rho0: float = 1.0, max_iter: int = 150, tol: float = 1e-4, config: Config = DEFAULT,
           device=None) -> MFState:
    """Two-stage recursive co-kriging fit (L-BFGS both; stage 2 jointly
    over raw ρ and log θ_δ).  NumPy inputs go to ``device``."""
    from pygpr_torch.optimize.lbfgs import fit_mle, minimize_lbfgs

    x_lo = as_tensor(x_lo, device)
    y_lo, x_hi, y_hi = (torch.as_tensor(as_tensor(a, x_lo.device), dtype=x_lo.dtype) for a in (y_lo, x_hi, y_hi))
    if params_lo0 is None:
        params_lo0 = kern_lo.init_params(x_lo, config)
    res_lo = fit_mle(kern_lo, params_lo0, x_lo, y_lo, max_iter=max_iter, tol=tol, config=config)
    with torch.no_grad():
        state_lo = exact_gp.factorize(kern_lo, res_lo.params, x_lo, y_lo, config)

    params_d0 = (kern_d.init_params(x_hi, config) if params_d0 is None
                 else torch.as_tensor(params_d0, dtype=x_hi.dtype, device=x_hi.device))
    nk = params_d0.shape[0]
    u0 = torch.cat([torch.log(torch.abs(params_d0)),
                    torch.tensor([rho0], dtype=y_hi.dtype, device=y_hi.device)])

    def objective(u):
        return nlml_stage2(kern_d, torch.exp(u[:nk]), u[nk], kern_lo, state_lo, x_hi, y_hi, config)

    res_d = minimize_lbfgs(objective, u0, max_iter=max_iter, tol=tol)
    params_d = torch.exp(res_d.params[:nk])
    rho = res_d.params[nk]
    with torch.no_grad():
        mu_lo_hi, _ = exact_gp.predict(kern_lo, state_lo, x_hi, "none", config)
        state_d = exact_gp.factorize(kern_d, params_d, x_hi, y_hi - rho * mu_lo_hi, config)
    return MFState(state_lo=state_lo, state_d=state_d, rho=rho, params_lo=res_lo.params, params_d=params_d,
                   nlml_lo=res_lo.value, nlml_d=res_d.value)


def predict_mf(kern_lo: Kernel, kern_d: Kernel, state: MFState, xq,
               config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """High-fidelity posterior: mean = ρ·μ_lo + μ_δ, var = ρ²·σ²_lo + σ²_δ."""
    with torch.no_grad():
        m_lo, v_lo = exact_gp.predict(kern_lo, state.state_lo, xq, "diag", config)
        m_d, v_d = exact_gp.predict(kern_d, state.state_d, xq, "diag", config)
        return state.rho * m_lo + m_d, torch.square(state.rho) * v_lo + v_d


class MultiFidelityGP:
    """Stateful wrapper.

    >>> mf = MultiFidelityGP(x_lo, y_lo, x_hi, y_hi, Sum((RBF(), WhiteNoise())))
    >>> mf.train()
    >>> mean, var = mf.predict(xq)
    """

    def __init__(self, x_lo, y_lo, x_hi, y_hi, cov_lo: Kernel, cov_d: Optional[Kernel] = None,
                 config: Config = DEFAULT, device=None):
        self.x_lo = as_tensor(x_lo, device)
        self.y_lo, self.x_hi, self.y_hi = (torch.as_tensor(as_tensor(a, self.x_lo.device), dtype=self.x_lo.dtype)
                                           for a in (y_lo, x_hi, y_hi))
        self.cov_lo = cov_lo
        self.cov_d = cov_lo if cov_d is None else cov_d
        self.config = config
        self._state: Optional[MFState] = None

    def train(self, max_iter: int = 150, **kwargs) -> MFState:
        self._state = fit_mf(self.cov_lo, self.cov_d, self.x_lo, self.y_lo, self.x_hi, self.y_hi,
                             max_iter=max_iter, config=self.config, **kwargs)
        return self._state

    def predict(self, xq):
        if self._state is None:
            raise RuntimeError("call train() first")
        return predict_mf(self.cov_lo, self.cov_d, self._state, xq, self.config)
