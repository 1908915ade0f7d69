"""Covariance kernels as stateless objects over packed parameter vectors.

Counterpart of the main-path subset of ``pygpr_tpu/ops/kernels.py``:
:class:`RBF`, :class:`WhiteNoise` and :class:`Sum`, with the same
parameterization and packed order (the reference's ``covar.py``):

  * :class:`RBF` (ARD squared exponential):
    ``K(x, x') = σ² · exp(−‖(x − x') ⊙ ℓ‖²)`` with inverse lengthscales
    ℓ and no ½ in the exponent.  Params ``[σ, ℓ₁..ℓ_d]``, init all ones.
  * :class:`WhiteNoise`: ``σₙ² I`` on the train block, zero on cross
    blocks.  One param, init ``config.noise_init``.
  * :class:`Sum`: concatenated parameter vectors, split per child.

Methods take one unbatched ``[n, d]`` input; :func:`kernel_matrix`,
:func:`kernel_diag` and :func:`kernel_and_grad` loop over a leading
committee axis.  :func:`train_gram` is the train-gram entry of the NLML
and dispatches to the fused gram kernel (``ops.gram``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops import gram

Tensor = torch.Tensor


def sq_distance(x: Tensor, xp: Optional[Tensor] = None) -> Tensor:
    """Pairwise squared distance by the matmul trick.

    ``x: [n, d]``, ``xp: [m, d]`` → ``[m, n]`` (rows index xp).  With
    ``xp=None`` the symmetric ``[n, n]`` matrix.  The clamp at zero is
    straight-through: its gradient is the exact polynomial's, since the
    true distance is never negative.
    """
    x2 = torch.sum(torch.square(x), dim=-1)
    if xp is None:
        sqd = x2[:, None] + x2[None, :] - 2.0 * (x @ x.T)
    else:
        xp2 = torch.sum(torch.square(xp), dim=-1)
        sqd = xp2[:, None] + x2[None, :] - 2.0 * (xp @ x.T)
    return sqd + (sqd.clamp_min(0.0) - sqd).detach()


class Kernel:
    """Stateless covariance kernel."""

    def n_params(self, dim: int) -> int:
        raise NotImplementedError

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        """Reference-parity initial parameters: ``[nhp]`` for ``[n, d]``
        inputs, ``[nc, nhp]`` for ``[nc, n, d]``."""
        x = torch.as_tensor(x)
        nhp = self.n_params(x.shape[-1])
        flat = self._init_flat(nhp, x.dtype, x.device, config)
        return flat.expand(*x.shape[:-2], nhp).clone()

    def _init_flat(self, nhp: int, dtype, device, config: Config) -> Tensor:
        return torch.ones(nhp, dtype=dtype, device=device)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT) -> Tensor:
        """Unbatched kernel matrix, ``[n, n]`` or cross ``[m, n]``."""
        raise NotImplementedError

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
        """Unbatched ``(K [n, n], dK [nhp, n, n])``."""
        raise NotImplementedError

    def diag(self, params, x, *, config: Config = DEFAULT) -> Tensor:
        """Diagonal of the train-block kernel, ``[n]``."""
        return torch.diagonal(self.matrix(params, x, config=config))

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT) -> Optional[Tensor]:
        """``⟨Abar, ∂K/∂θ⟩`` for the train gram in matvec-shaped
        contractions, or ``None`` where no closed form exists (the
        caller then differentiates the gram build)."""
        return None

    def get_params_shape(self, x):
        """``[*batch, nhp]`` for a sample input."""
        return list(x.shape[:-2]) + [self.n_params(x.shape[-1])]

    def kernel(self, params, x, xp=None):
        return kernel_matrix(self, params, x, xp)

    def kernel_and_grad(self, params, x):
        krn, dkrn = kernel_and_grad(self, params, x)
        return [krn, dkrn]

    def __add__(self, other: "Kernel") -> "Sum":
        a = self.kernels if isinstance(self, Sum) else (self,)
        b = other.kernels if isinstance(other, Sum) else (other,)
        return Sum(a + b)

    def __hash__(self):
        return hash((type(self),))

    def __eq__(self, other):
        return type(self) is type(other)


def _ard_sqd_adjoint(abar, x, ls, w):
    """Lengthscale part of :meth:`Kernel.gram_adjoint` for a radial
    kernel ``K = f(sqd)``, ``sqd = Σⱼ ℓⱼ²(xᵢⱼ − xᵢ'ⱼ)²``:

      ⟨Abar, ∂K/∂ℓⱼ⟩ = 2ℓⱼ Σᵢᵢ' mᵢᵢ' (xᵢⱼ − xᵢ'ⱼ)²,  m = Abar ∘ ∂K/∂sqd

    expanded as (r₁ + r₂)ᵀqⱼ − 2 xⱼᵀ(m xⱼ) with q = x²: one elementwise
    pass and one [n, n]×[n, d] GEMM for all d.  m's diagonal is zeroed
    first: its exact contribution is 0 (diff² = 0), but the partial sums
    would carry it separately."""
    m = abar * w
    m.diagonal(dim1=-2, dim2=-1).zero_()
    r12 = m.sum(dim=-1) + m.sum(dim=-2)
    u = m @ x
    s = r12 @ torch.square(x) - 2.0 * torch.sum(x * u, dim=-2)
    return 2.0 * ls * s


class RBF(Kernel):
    """ARD squared exponential, ``K = σ² exp(−‖(x−x')⊙ℓ‖²)``; params
    ``[σ, ℓ₁..ℓ_d]``."""

    def n_params(self, dim: int) -> int:
        return dim + 1

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        xpl = None if xp is None else xp * ls
        return torch.square(sig) * torch.exp(-sq_distance(x * ls, xpl))

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        e = torch.exp(-sq_distance(x * ls))
        dsig = 2.0 * sig * torch.sum(abar * e)
        dls = _ard_sqd_adjoint(abar, x, ls, -torch.square(sig) * e)
        return torch.cat([dsig[None], dls])

    def diag(self, params, x, *, config: Config = DEFAULT):
        return torch.square(params[0]).expand(x.shape[-2]).clone()

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        krn = self.matrix(params, x, config=config)
        dsig = krn * (2.0 / sig)                                # ∂K/∂σ = 2K/σ
        diff = x.T[:, :, None] - x.T[:, None, :]                # [d, n, n]
        dls = (-2.0 * ls[:, None, None]) * torch.square(diff) * krn[None]
        return krn, torch.cat([dsig[None], dls], dim=0)


class WhiteNoise(Kernel):
    """Observation noise: ``σₙ² I`` on the train block, zero on cross
    blocks; init ``config.noise_init``."""

    def n_params(self, dim: int) -> int:
        return 1

    def _init_flat(self, nhp, dtype, device, config: Config):
        return torch.full((nhp,), config.noise_init, dtype=dtype, device=device)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        n = x.shape[-2]
        if xp is None:
            return torch.square(params[0]) * torch.eye(n, dtype=x.dtype, device=x.device)
        return torch.zeros((xp.shape[-2], n), dtype=x.dtype, device=x.device)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return torch.square(params[0]).expand(x.shape[-2]).clone()

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        # ∂K/∂σₙ = 2σₙ I  ⇒  ⟨Abar, ·⟩ = 2σₙ tr(Abar)
        return (2.0 * params[0] * torch.trace(abar))[None]

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        eye = torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
        return torch.square(params[0]) * eye, (2.0 * params[0] * eye)[None]


class _Compose(Kernel):
    """Combinator over concatenated parameter vectors split per child."""

    def __init__(self, kernels: Sequence[Kernel]):
        self.kernels: Tuple[Kernel, ...] = tuple(kernels)

    def __hash__(self):
        return hash((type(self), self.kernels))

    def __eq__(self, other):
        return type(other) is type(self) and self.kernels == other.kernels

    def n_params(self, dim: int) -> int:
        return sum(k.n_params(dim) for k in self.kernels)

    def _parts(self, params, dim):
        lo = 0
        for k in self.kernels:
            hi = lo + k.n_params(dim)
            yield k, params[lo:hi]
            lo = hi

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        return torch.cat([k.init_params(x, config) for k in self.kernels], dim=-1)


class Sum(_Compose):
    """Sum of kernels; gradients concatenate along the parameter axis."""

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        terms = [k.matrix(p, x, xp, config=config) for k, p in self._parts(params, x.shape[-1])]
        return sum(terms[1:], terms[0])

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        # specialized only when every child is
        parts = []
        for k, p in self._parts(params, x.shape[-1]):
            ga = k.gram_adjoint(p, x, abar, config=config)
            if ga is None:
                return None
            parts.append(ga)
        return torch.cat(parts, dim=-1)

    def diag(self, params, x, *, config: Config = DEFAULT):
        terms = [k.diag(p, x, config=config) for k, p in self._parts(params, x.shape[-1])]
        return sum(terms[1:], terms[0])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        pairs = [k.matrix_and_grad(p, x, config=config) for k, p in self._parts(params, x.shape[-1])]
        krn = sum((km for km, _ in pairs[1:]), pairs[0][0])
        return krn, torch.cat([dk for _, dk in pairs], dim=0)


def _batched(core, params, x, *rest):
    """Apply ``core`` per element of a leading batch axis of x and/or
    params (a loop, stacked), or once when neither is batched."""
    x_b, p_b = x.ndim == 3, params.ndim == 2
    if not (x_b or p_b):
        return core(params, x, *rest)
    nc = x.shape[0] if x_b else params.shape[0]
    outs = [core(params[i] if p_b else params, x[i] if x_b else x, *rest) for i in range(nc)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def kernel_matrix(kern: Kernel, params, x, xp=None, *, config: Config = DEFAULT) -> Tensor:
    """Kernel matrix, ``x: [n, d]`` or ``[nc, n, d]``, ``params: [nhp]``
    or ``[nc, nhp]``, ``xp: [m, d]`` (never batched)."""
    if xp is None:
        return _batched(lambda p, xx: kern.matrix(p, xx, config=config), params, x)
    return _batched(lambda p, xx: kern.matrix(p, xx, xp, config=config), params, x)


def kernel_diag(kern: Kernel, params, x, *, config: Config = DEFAULT) -> Tensor:
    return _batched(lambda p, xx: kern.diag(p, xx, config=config), params, x)


def kernel_and_grad(kern: Kernel, params, x, *, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Batched ``(K, dK)`` with dK laid out ``[..., nhp, n, n]``."""
    return _batched(lambda p, xx: kern.matrix_and_grad(p, xx, config=config), params, x)


def train_gram(kern: Kernel, params, x, config: Config = DEFAULT) -> Tensor:
    """Unbatched train gram K(x, x).  The canonical RBF+WhiteNoise on an
    f32 input of a width the fused kernel takes goes through
    :func:`pygpr_torch.ops.gram.rbf_noise_gram` (the CUDA kernel on the
    card, its plain version on the CPU); anything else through
    ``kern.matrix``.  Differentiable on both paths."""
    if gram.takes(x) and gram.matches_rbf_noise(kern):
        return gram.rbf_noise_gram(params, x)
    return kern.matrix(params, x, config=config)
