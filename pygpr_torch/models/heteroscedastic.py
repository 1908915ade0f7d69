"""Most-likely heteroscedastic GP (Kersting, Plagemann, Pfaff & Burgard,
ICML 2007): input-dependent observation noise, learned.

Counterpart of ``pygpr_tpu/models/heteroscedastic.py``.  A damped fixed
point of exact-GP fits:

  1. fit a homoscedastic exact GP to (X, y);
  2. the most-likely empirical log noise zᵢ = log((yᵢ − μᵢ)² + σᵢ²),
     bias-corrected for E[log χ²₁];
  3. fit a noise GP to the centered z;
  4. refit the mean GP with the predicted per-point noise variance
     exp(ẑ(X)) through :class:`~pygpr_torch.ops.fixed_noise.FixedNoise`;
  5. repeat 2–4.

The loop and the noise column stay on the host in NumPy, as in the JAX
package; each fit is one ``fit_mle``.  Prediction composes the latent
moments of the FixedNoise mean GP with the log-normal mean of the noise
GP, ``exp(μ_z + σ_z²/2)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models import exact_gp
from pygpr_torch.ops.fixed_noise import FixedNoise, with_noise
from pygpr_torch.ops.kernels import RBF, Kernel, Sum, WhiteNoise

Tensor = torch.Tensor


class HGPState(NamedTuple):
    """Fitted heteroscedastic posterior."""

    state_mean: exact_gp.GPState   #: FixedNoise mean GP (x cols + s²)
    state_noise: exact_gp.GPState  #: noise GP on z = log noise var
    params_mean: Tensor
    params_noise: Tensor
    noise_train: Tensor            #: fitted per-point noise variance [n]
    z_mean: float                  #: centering offset of the noise GP


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def fit_hgp(x, y, cov_mean: Optional[Kernel] = None, cov_noise: Optional[Kernel] = None, *, n_rounds: int = 3,
            damping: float = 1.0, max_iter: int = 100, config: Config = DEFAULT, device=None) -> HGPState:
    """Run the MLHGP fixed point.

    ``cov_mean`` is the latent kernel (no noise term: noise enters through
    FixedNoise); ``cov_noise`` models z = log σ²(x) with its own
    WhiteNoise.  Each fit starts at its kernel's ``init_params(x)``, as in
    the JAX package.  The device is ``y``'s for a tensor, else
    ``device`` ("cuda" unless given)."""
    from pygpr_torch.optimize.lbfgs import fit_mle

    if cov_mean is None:
        cov_mean = RBF()
    if cov_noise is None:
        cov_noise = Sum((RBF(), WhiteNoise()))

    y_j = as_tensor(y, x.device if isinstance(x, torch.Tensor) else device)
    x_h = _host(x)
    dev, dtype = y_j.device, y_j.dtype
    x_j = torch.as_tensor(x_h, dtype=dtype, device=dev)
    y_h = _host(y_j)
    n = x_h.shape[0]

    def on_dev(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # round 0: homoscedastic warm start
    cov0 = Sum((cov_mean, WhiteNoise()))
    res0 = fit_mle(cov0, cov0.init_params(x_j), x_j, y_j, max_iter=max_iter, config=config)
    with torch.no_grad():
        st0 = exact_gp.factorize(cov0, res0.params, x_j, y_j, config)
        mu, var = exact_gp.predict(cov0, st0, x_j, "diag", config)
    noise_var = np.full(n, float(res0.params[-1]) ** 2)

    kern_fix = FixedNoise(cov_mean)
    params_m = params_z = None
    st_m, st_z = st0, None
    z_prev = np.log(np.maximum(noise_var, 1e-12))
    z_mean = float(np.mean(z_prev))
    first_round = True

    for _ in range(n_rounds):
        # 2. most-likely empirical log noise; (y−μ)² ~ σ²·χ²₁ and
        # E[log χ²₁] = ψ(½) + log 2 ≈ −1.2704 is the bias correction
        resid2 = np.square(_host(mu) - y_h) + _host(var)
        z_emp = np.log(np.maximum(resid2, 1e-12)) + 1.2704
        # round 0 is never damped: the warm start's σₙ can collapse to the
        # interpolation mode in f32
        z_cur = z_emp if first_round else (1.0 - damping) * z_prev + damping * z_emp
        first_round = False

        # 3. noise GP on the centered z
        z_mean = float(np.mean(z_cur))
        z_j = on_dev(z_cur - z_mean)
        res_z = fit_mle(cov_noise, cov_noise.init_params(x_j), x_j, z_j, max_iter=max_iter, config=config)
        with torch.no_grad():
            st_z = exact_gp.factorize(cov_noise, res_z.params, x_j, z_j, config)
            z_hat, _ = exact_gp.predict(cov_noise, st_z, x_j, "none", config)
        z_hat = _host(z_hat) + z_mean
        noise_var = np.exp(z_hat)
        z_prev = z_hat

        # 4. mean GP with the predicted noise through FixedNoise
        x_aug = on_dev(with_noise(x_h, noise_var))
        res_m = fit_mle(kern_fix, kern_fix.init_params(x_aug), x_aug, y_j, max_iter=max_iter, config=config)
        with torch.no_grad():
            st_m = exact_gp.factorize(kern_fix, res_m.params, x_aug, y_j, config)
            # latent moments at the train points: query noise column 0
            mu, var = exact_gp.predict(kern_fix, st_m, on_dev(with_noise(x_h, 0.0)), "diag", config)
        params_m, params_z = res_m.params, res_z.params

    return HGPState(state_mean=st_m, state_noise=st_z, params_mean=params_m, params_noise=params_z,
                    noise_train=on_dev(noise_var), z_mean=z_mean)


def predict_hgp(state: HGPState, cov_mean: Kernel, cov_noise: Kernel, xq, *, observation: bool = True,
                config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Latent moments from the FixedNoise mean GP (query noise column 0),
    plus, for ``observation``, the noise GP's log-normal mean."""
    ref = state.state_mean.y
    xq_h = _host(xq)
    xq_aug = torch.as_tensor(with_noise(xq_h, 0.0), dtype=ref.dtype, device=ref.device)
    kern_fix = cov_mean if isinstance(cov_mean, FixedNoise) else FixedNoise(cov_mean)
    with torch.no_grad():
        mu, var = exact_gp.predict(kern_fix, state.state_mean, xq_aug, "diag", config)
        if not observation:
            return mu, var
        z_mu, z_var = exact_gp.predict(cov_noise, state.state_noise, torch.as_tensor(xq_h, dtype=ref.dtype,
                                                                                    device=ref.device), "diag", config)
        # log-normal mean, with the centering offset restored
        return mu, var + torch.exp(z_mu + state.z_mean + 0.5 * z_var)


class HeteroscedasticGP:
    """Stateful wrapper.

    >>> gp = HeteroscedasticGP(x, y)
    >>> gp.train()
    >>> mean, var = gp.predict(xq)            # observation variance
    >>> noise = gp.noise_at(xq)               # learned σ²(x)
    """

    def __init__(self, x, y, cov_mean: Optional[Kernel] = None, cov_noise: Optional[Kernel] = None,
                 config: Config = DEFAULT, device=None):
        self.x = _host(x)
        self.y = as_tensor(y, y.device if isinstance(y, torch.Tensor) else device)
        self.cov_mean = RBF() if cov_mean is None else cov_mean
        self.cov_noise = Sum((RBF(), WhiteNoise())) if cov_noise is None else cov_noise
        self.config = config
        self._state: Optional[HGPState] = None

    def train(self, n_rounds: int = 3, **kwargs) -> HGPState:
        self._state = fit_hgp(self.x, self.y, self.cov_mean, self.cov_noise, n_rounds=n_rounds,
                              config=self.config, **kwargs)
        return self._state

    def predict(self, xq, observation: bool = True):
        if self._state is None:
            raise RuntimeError("call train() first")
        return predict_hgp(self._state, self.cov_mean, self.cov_noise, xq, observation=observation,
                           config=self.config)

    def noise_at(self, xq):
        if self._state is None:
            raise RuntimeError("call train() first")
        ref = self._state.state_noise.y
        with torch.no_grad():
            z_mu, z_var = exact_gp.predict(self.cov_noise, self._state.state_noise,
                                           torch.as_tensor(_host(xq), dtype=ref.dtype, device=ref.device), "diag",
                                           self.config)
        return torch.exp(z_mu + self._state.z_mean + 0.5 * z_var)
