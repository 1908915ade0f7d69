"""scikit-learn interop (the reference's ``scikit_model.py``).

Counterpart of ``pygpr_tpu/interop/sklearn.py``: ``SKWrap`` mirrors the
reference ``SK_WRAP`` with its two latent bugs fixed, as the JAX
package's does:

  * ``fit`` rebinds the training data **and marks the model dirty** (the
    reference marks the wrapper, leaving a stale Cholesky after a refit);
  * ``fit(..., optimize=True)`` runs the model's ``train``, or the L-BFGS
    fit ``fit_mle`` for a model without one (the reference's ``fit``
    optimizes nothing);
  * ``predict`` returns the posterior mean, and with ``return_std=True``
    also the predictive standard deviation.

Data cross the host boundary here: NumPy in, the model's dtype on the
model's device, NumPy out.

Without scikit-learn installed, ``SKWrap`` keeps the parts of the
estimator protocol it uses (``get_params``, ``set_params`` and ``score``,
the R² of its predictions), so the wrapper also runs where only PyTorch,
NumPy and SciPy are.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

try:
    from sklearn.base import BaseEstimator, RegressorMixin
except ImportError:
    class BaseEstimator:
        """``get_params``/``set_params`` over the constructor's arguments,
        as scikit-learn's ``BaseEstimator`` gives them."""

        def get_params(self, deep: bool = True) -> dict:
            names = [p for p in inspect.signature(type(self).__init__).parameters if p != "self"]
            return {name: getattr(self, name) for name in names}

        def set_params(self, **params):
            for name, value in params.items():
                setattr(self, name, value)
            return self

    class RegressorMixin:
        """``score``: the coefficient of determination R² of ``predict``."""

        def score(self, X, y, sample_weight=None) -> float:
            y = np.asarray(y, dtype=np.float64)
            w = np.ones_like(y) if sample_weight is None else np.asarray(sample_weight, dtype=np.float64)
            resid = np.sum(w * (y - np.asarray(self.predict(X), dtype=np.float64)) ** 2)
            total = np.sum(w * (y - np.average(y, weights=w)) ** 2)
            return float(1.0 - resid / total)


class SKWrap(RegressorMixin, BaseEstimator):
    """scikit-learn regressor over a GP model of the port: ``ExactGP``
    (the reference's), or any model with the ``set_data``/``train``/
    ``predict`` contract (``SGPR``, ``IterativeGP``)."""

    def __init__(self, model, optimize: bool = False, max_iter: int = 200):
        self.model = model
        self.optimize = optimize
        self.max_iter = max_iter

    def _tensor(self, a) -> torch.Tensor:
        x = self.model.x
        return torch.as_tensor(np.asarray(a), dtype=x.dtype, device=x.device)

    def fit(self, x, y):
        self.model.set_data(self._tensor(x), self._tensor(y))
        if self.optimize:
            if hasattr(self.model, "train"):
                self.model.train(max_iter=self.max_iter)
            else:
                from pygpr_torch.optimize.lbfgs import fit_mle

                res = fit_mle(self.model.cov, self.model.params, self.model.x, self.model.y,
                              config=self.model.config, max_iter=self.max_iter)
                self.model.set_params(res.params)
        return self

    def predict(self, xp, return_std: bool = False):
        if return_std:
            mean, var = self.model.predict(self._tensor(xp), var="diag")
            return mean.detach().cpu().numpy(), np.sqrt(var.detach().cpu().numpy())
        mean, _ = self.model.predict(self._tensor(xp), var="none")
        return mean.detach().cpu().numpy()


#: the reference's spelling
SK_WRAP = SKWrap
