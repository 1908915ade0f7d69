"""Deep kernel learning: a neural feature map under any base kernel
(Wilson et al., AISTATS 2016).

Counterpart of ``pygpr_tpu/models/dkl.py``.  ``K(x, x') = k_base(φ_W(x),
φ_W(x'))`` with a small MLP ``φ_W`` (tanh hidden layers, linear last
layer), learned jointly with the base kernel's hyperparameters by
maximizing the marginal likelihood.  :class:`DeepKernel` is a kernel whose
flat parameter vector packs ``[W₁,b₁,…,W_L,b_L, θ_base]``, so the exact-GP
stack takes it unchanged.  It has no closed-form gram adjoint: the fast
NLML's gradient is one autograd VJP through :meth:`DeepKernel.matrix`, the
MLP's backward riding inside it.  A deep kernel is never the canonical
RBF + white noise, so its gram is built by ``matrix`` (no K1); its fast
NLML factors with K2 where n takes it.

:func:`fit_dkl` runs Adam (optax's, ``optimize/adam.py``) under a mixed
transform: log space for the base kernel's positive scales, raw space for
the signed network weights.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops.kernels import Kernel, _jac

Tensor = torch.Tensor


class DeepKernel(Kernel):
    """MLP feature extractor under ``base``.

    ``DeepKernel(RBF(), widths=(16, 2))`` maps ``[n, d] → tanh GEMM →
    [n, 16] → linear GEMM → [n, 2]`` and evaluates the base kernel in the
    2-D feature space.  ``n_params(dim)`` = MLP weights and biases +
    ``base.n_params(widths[-1])``.
    """

    def __init__(self, base: Kernel, widths: Sequence[int], seed: int = 0):
        if isinstance(base, DeepKernel):
            raise ValueError("nested DeepKernel is not supported")
        if len(widths) < 1:
            raise ValueError("widths must name at least the output size")
        self.base = base
        self.widths = tuple(int(w) for w in widths)
        self.seed = int(seed)

    def __hash__(self):
        return hash((type(self), self.base, self.widths, self.seed))

    def __eq__(self, other):
        return (type(other) is DeepKernel and other.base == self.base and other.widths == self.widths
                and other.seed == self.seed)

    # -- parameter packing -------------------------------------------------
    def _layer_dims(self, dim: int) -> Tuple[Tuple[int, int], ...]:
        sizes = (dim,) + self.widths
        return tuple(zip(sizes[:-1], sizes[1:]))

    def n_mlp_params(self, dim: int) -> int:
        return sum((i + 1) * o for i, o in self._layer_dims(dim))

    def n_params(self, dim: int) -> int:
        return self.n_mlp_params(dim) + self.base.n_params(self.widths[-1])

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        """Glorot-uniform MLP weights from ``np.random.default_rng(seed)``
        (the JAX package's draw, bit for bit), zero biases, then the base
        kernel's init; ``[nc, nhp]`` for ``[nc, n, d]`` inputs."""
        x = torch.as_tensor(x)
        dim = x.shape[-1]
        rng = np.random.default_rng(self.seed)
        parts = []
        for i, o in self._layer_dims(dim):
            lim = math.sqrt(6.0 / (i + o))
            parts.append(rng.uniform(-lim, lim, size=i * o))
            parts.append(np.zeros(o))
        w = torch.as_tensor(np.concatenate(parts), dtype=x.dtype, device=x.device)
        zf = torch.zeros((1, self.widths[-1]), dtype=x.dtype, device=x.device)
        flat = torch.cat([w, self.base.init_params(zf, config)])
        return flat.expand(*x.shape[:-2], flat.shape[0]).clone()

    def split(self, params, dim: int) -> Tuple[Tensor, Tensor]:
        nm = self.n_mlp_params(dim)
        return params[..., :nm], params[..., nm:]

    # -- forward -----------------------------------------------------------
    def features(self, params, x, *, config: Config = DEFAULT) -> Tensor:
        """``φ_W(x)``: tanh hidden layers, linear final layer."""
        w, _ = self.split(params, x.shape[-1])
        dims = self._layer_dims(x.shape[-1])
        z = x
        off = 0
        for li, (i, o) in enumerate(dims):
            W = w[off: off + i * o].reshape(i, o)
            off += i * o
            b = w[off: off + o]
            off += o
            z = z @ W + b
            if li < len(dims) - 1:
                z = torch.tanh(z)
        return z

    # -- Kernel API ----------------------------------------------------------
    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT) -> Tensor:
        _, pb = self.split(params, x.shape[-1])
        fx = self.features(params, x, config=config)
        fxp = None if xp is None else self.features(params, xp, config=config)
        return self.base.matrix(pb, fx, fxp, config=config)

    def diag(self, params, x, *, config: Config = DEFAULT) -> Tensor:
        _, pb = self.split(params, x.shape[-1])
        return self.base.diag(pb, self.features(params, x, config=config), config=config)

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
        """``(K, ∂K/∂θ [nhp, n, n])`` by ``torch.func.jacfwd``: nhp
        matrices, for small n only (the fit never calls it)."""
        return _jac(self, params, x, config)


class DKLFit(NamedTuple):
    params: Tensor      #: joint [W…, θ_base] at the last step
    nlml: Tensor        #: objective trace [n_steps]
    converged: Tensor   #: ‖grad‖∞ < tol at the last step


def fit_dkl(kern: DeepKernel, x, y, params0=None, *, config: Config = DEFAULT, n_steps: int = 300,
            learning_rate: float = 3e-2, tol: float = 1e-4, device=None) -> DKLFit:
    """Joint Adam MLE of the MLP weights and the base hyperparameters.

    Full-batch NLML through the fast gradient (``likelihood.nlml_fast``:
    one Cholesky and one gram-build VJP a step).  Mixed transform: base
    scales in log space, weights raw.  As in the JAX package, start a
    ``WhiteNoise`` term near 0.1, not at the reference's 1e-4:
    ``p0 = kern.init_params(x); p0[-1] = 0.1``.  NumPy inputs go to
    ``device`` ("cuda" unless given).
    """
    from pygpr_torch.models.likelihood import nlml_fast
    from pygpr_torch.optimize.adam import Adam

    x = as_tensor(x, device)
    y = torch.as_tensor(as_tensor(y, x.device), dtype=x.dtype)
    nm = kern.n_mlp_params(x.shape[-1])
    params0 = (kern.init_params(x, config) if params0 is None
               else torch.as_tensor(params0, dtype=x.dtype, device=x.device))

    def unpack(u):
        return torch.cat([u[:nm], torch.exp(u[nm:])])

    u = torch.cat([params0[:nm], torch.log(params0[nm:])])
    opt = Adam([u], learning_rate)
    vals, gmax = [], None
    for _ in range(n_steps):
        leaf = u.detach().requires_grad_(True)
        with torch.enable_grad():
            val = nlml_fast(kern, unpack(leaf), x, y, config)
            (g,) = torch.autograd.grad(val, leaf)
        (u,) = opt.step([leaf.detach()], [g])
        vals.append(val.detach())
        gmax = torch.max(torch.abs(g))
    return DKLFit(unpack(u), torch.stack(vals), gmax < tol)
