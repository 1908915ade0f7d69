"""Multi-output GPs by the intrinsic coregionalization model (ICM).

Counterpart of ``pygpr_tpu/ops/coregion.py``.  t correlated outputs share
one latent structure,

    K((x, i), (x', j)) = B[i, j] · k_base(x, x'),   B = W Wᵀ + diag(κ²)

with the task indices ``i, j`` in the LAST input column (cast to int).
It is just a kernel over the augmented input ``[x…, task]``, so every
exact-GP path takes it unchanged.  ``B[task_i, task_j]`` is expanded as
``E_q B E_xᵀ`` with the one-hot task matrices E, whose products are exact
(one nonzero term a sum): the same values as the JAX package's gather,
and a backward of two small GEMMs, not a scatter-add of n² terms into
t² places.

Parameter packing: ``params = [θ_base…, W.ravel() (t·r), κ (t)]``; κ
enters squared, W is unconstrained.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops.kernels import Kernel, _jac

Tensor = torch.Tensor


def with_task(x, task: int):
    """Append a constant task-index column: a tensor for a tensor (on its
    device), a NumPy array otherwise."""
    if isinstance(x, Tensor):
        return torch.cat([x, torch.full((x.shape[0], 1), float(task), dtype=x.dtype, device=x.device)], dim=1)
    x = np.asarray(x)
    return np.concatenate([x, np.full((x.shape[0], 1), float(task), x.dtype)], axis=1)


def stack_outputs(xs: Sequence, ys: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Per-task NumPy inputs and targets → one augmented ``[Σn, d+1]``
    design (task index last) and the stacked targets."""
    xa, ya = [], []
    for t, (x, y) in enumerate(zip(xs, ys)):
        x = np.asarray(x)
        xa.append(np.concatenate([x, np.full((x.shape[0], 1), float(t), x.dtype)], axis=1))
        ya.append(np.asarray(y))
    return np.concatenate(xa, 0), np.concatenate(ya, 0)


def _tasks(x: Tensor) -> Tensor:
    return x[:, -1].long()


def _onehot(x: Tensor, t: int) -> Tensor:
    """``[n, t]`` indicator of each row's task, in x's dtype."""
    return torch.nn.functional.one_hot(_tasks(x), t).to(x.dtype)


class ICM(Kernel):
    """Intrinsic coregionalization over ``base`` on inputs ``[x…, task]``:
    ``n_params(dim) = base.n_params(dim−1) + t·r + t``."""

    def __init__(self, base: Kernel, n_outputs: int, rank: int = 1):
        if isinstance(base, ICM):
            raise ValueError("nested ICM is not supported")
        self.base = base
        self.n_outputs = int(n_outputs)
        self.rank = int(rank)

    def __hash__(self):
        return hash((type(self), self.base, self.n_outputs, self.rank))

    def __eq__(self, other):
        return (type(other) is ICM and other.base == self.base and other.n_outputs == self.n_outputs
                and other.rank == self.rank)

    def _split(self, params, dim: int):
        nb = self.base.n_params(dim - 1)
        t, r = self.n_outputs, self.rank
        W = params[..., nb:nb + t * r].reshape(params.shape[:-1] + (t, r))
        return params[..., :nb], W, params[..., nb + t * r:]

    def coregion_matrix(self, params, dim: int) -> Tensor:
        """B = W Wᵀ + diag(κ²), ``[t, t]``."""
        _, W, kappa = self._split(params, dim)
        return W @ W.mT + torch.diag(torch.square(kappa))

    def n_params(self, dim: int) -> int:
        return self.base.n_params(dim - 1) + self.n_outputs * self.rank + self.n_outputs

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        dim = x.shape[-1]
        theta_b, _, _ = self._split(params, dim)
        B = self.coregion_matrix(params, dim)
        ex = _onehot(x, self.n_outputs)
        if xp is None:
            return (ex @ B @ ex.T) * self.base.matrix(theta_b, x[:, :-1], config=config)
        kb = self.base.matrix(theta_b, x[:, :-1], xp[:, :-1], config=config)   # [m, n], rows xp
        return (_onehot(xp, self.n_outputs) @ B @ ex.T) * kb

    def diag(self, params, x, *, config: Config = DEFAULT):
        dim = x.shape[-1]
        theta_b, _, _ = self._split(params, dim)
        B = self.coregion_matrix(params, dim)
        return torch.diagonal(B)[_tasks(x)] * self.base.diag(theta_b, x[:, :-1], config=config)

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class TaskNoise(Kernel):
    """Per-task observation noise: ``K = diag(σ_{task(i)}²)`` on the train
    block, zero on cross blocks.  Params ``[σ₁..σ_t]``, init 1e-4 each."""

    def __init__(self, n_outputs: int):
        self.n_outputs = int(n_outputs)

    def __hash__(self):
        return hash((type(self), self.n_outputs))

    def __eq__(self, other):
        return type(other) is TaskNoise and other.n_outputs == self.n_outputs

    def n_params(self, dim: int) -> int:
        return self.n_outputs

    def _init_flat(self, nhp, dtype, device, config: Config):
        return torch.full((nhp,), 1e-4, dtype=dtype, device=device)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        if xp is not None:
            return torch.zeros((xp.shape[-2], x.shape[-2]), dtype=x.dtype, device=x.device)
        return torch.diag(torch.square(params)[_tasks(x)])

    def diag(self, params, x, *, config: Config = DEFAULT):
        return torch.square(params)[_tasks(x)]

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        krn = self.matrix(params, x, config=config)
        eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
        onehot = _onehot(x, self.n_outputs).T                      # [t, n]
        return krn, 2.0 * params[:, None, None] * onehot[:, :, None] * eye
