"""Parabolic step-size estimation (the reference's ``hp_update.py``).

Counterpart of ``pygpr_tpu/optimize/step_size.py``.  A parabola along the
gradient direction through three loss values f(θ−εJ), f(θ), f(θ+εJ)
gives the step γ = −½·C₁/C₂ of its minimum, for cheap re-tuning of
hyperparameters when the data change a little.  :func:`learn_rate` works
on tensors; :func:`get_learn_rate` is the reference's host API over a
NumPy-facing loss object.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def learn_rate(fun: Callable[[Tensor], Tensor], grad_fun: Callable[[Tensor], Tensor], params: Tensor,
               eps: float) -> Tuple[Tensor, Tensor]:
    """Parabolic step size ``(γ, J)`` for the update θ⁺ = θ − γ·J, which
    is left to the caller (as in the reference)."""
    f0 = fun(params)
    J = grad_fun(params)
    fp = fun(params - eps * J)
    fm = fun(params + eps * J)
    C1 = (fp - fm) / (2.0 * eps)
    C2 = (fp + fm - 2.0 * f0) / (2.0 * eps**2)
    return -0.5 * (C1 / C2), J


def get_learn_rate(current_param, loss_new, eps: float) -> float:
    """The reference's host API: three evaluations through a NumPy-facing
    loss object (``MLE``)."""
    old_params = np.asarray(current_param)
    f0, J = loss_new.loss_and_grad(old_params)
    fp = loss_new.loss(old_params - eps * J)
    fm = loss_new.loss(old_params + eps * J)
    C1 = (fp - fm) / (2.0 * eps)
    C2 = (fp + fm - 2.0 * f0) / (2.0 * eps**2)
    return float(-0.5 * (C1 / C2))
