"""Adam, as optax's ``adam(learning_rate)`` computes it.

The iterative GP's fit, SVGP's and the deep GP's take Adam steps on a
list of tensors.  This is optax's ``scale_by_adam`` (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0) followed by ``scale(-learning_rate)``, written out
so that the iterates are the JAX package's to round-off
(``torch.optim.Adam`` would also do, but its first step imports torch's
compiler stack, seconds per process).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

Tensor = torch.Tensor


class Adam:
    """Adam state over a fixed list of tensors; :meth:`step` returns the
    updated tensors (the inputs are not written)."""

    def __init__(self, params: Sequence[Tensor], learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def step(self, params: Sequence[Tensor], grads: Sequence[Tensor]) -> List[Tensor]:
        b1, b2 = self.b1, self.b2
        self.count += 1
        t = self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * g**2 + b2 * self.nu[i]
            mu_hat = self.mu[i] / (1 - b1**t)
            nu_hat = self.nu[i] / (1 - b2**t)
            out.append(p + (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * -self.lr)
        return out

    def value_and_step(self, loss_fn: Callable[[List[Tensor]], Tensor], params: Sequence[Tensor],
                       frozen: Sequence[int] = ()) -> Tuple[List[Tensor], Tensor]:
        """``loss_fn(params)`` and one step on its autograd gradient; the
        tensors at the indices ``frozen`` get a zero gradient (a parameter
        left out of the fit, as the JAX package zeroes its gradient)."""
        leaves = [t.detach().requires_grad_(True) for t in params]
        with torch.enable_grad():
            val = loss_fn(leaves)
            grads = torch.autograd.grad(val, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None or i in frozen else g for i, (p, g) in enumerate(zip(leaves, grads))]
        return self.step([t.detach() for t in leaves], grads), val.detach()
