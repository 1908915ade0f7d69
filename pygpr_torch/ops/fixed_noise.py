"""Regression with known per-point observation noise.

Counterpart of ``pygpr_tpu/ops/fixed_noise.py``.  :class:`FixedNoise`
wraps a base kernel and adds a known noise variance per training point:

    K = k_base(x, x') + diag(s²)        (train block)
    K = k_base(x, x')                   (cross blocks)

The variances ride in the LAST input column (:func:`with_noise` builds
the augmented design), so the noise is data, not a hyperparameter: the
parameter vector and its gradient are the base kernel's alone, and every
fit, predict and committee path takes the kernel unchanged.  ``diag`` at
query points adds the query rows' own column (the observation's
variance); a zero column predicts the latent f.
"""

from __future__ import annotations

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor


def with_noise(x, noise_var) -> np.ndarray:
    """Append the per-point noise-VARIANCE column to a NumPy design
    matrix; ``noise_var`` a scalar or ``[n]``."""
    x = np.asarray(x)
    col = np.broadcast_to(np.asarray(noise_var, x.dtype).reshape(-1), (x.shape[0],))
    return np.concatenate([x, col[:, None].astype(x.dtype)], axis=1)


class FixedNoise(Kernel):
    """Known per-point observation noise over ``base``, on inputs
    ``[x…, s²]``: ``n_params(dim) = base.n_params(dim − 1)``."""

    def __init__(self, base: Kernel):
        if isinstance(base, FixedNoise):
            raise ValueError("nested FixedNoise is not supported")
        self.base = base

    def __hash__(self):
        return hash((type(self), self.base))

    def __eq__(self, other):
        return type(other) is FixedNoise and other.base == self.base

    def n_params(self, dim: int) -> int:
        return self.base.n_params(dim - 1)

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        return self.base.init_params(torch.as_tensor(x)[..., :-1], config)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        if xp is None:
            return self.base.matrix(params, x[..., :-1], config=config) + torch.diag(x[..., -1])
        return self.base.matrix(params, x[..., :-1], xp[..., :-1], config=config)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return self.base.diag(params, x[..., :-1], config=config) + x[..., -1]

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        k, dk = self.base.matrix_and_grad(params, x[..., :-1], config=config)
        return k + torch.diag(x[..., -1]), dk
