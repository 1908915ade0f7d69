"""Covariance kernels as stateless objects over packed parameter vectors.

Counterpart of ``pygpr_tpu/ops/kernels.py``, every class with the same
parameterization and packed order:

  * :class:`RBF` (ARD squared exponential, the reference's ``covar.py``):
    ``K(x, x') = σ² · exp(−‖(x − x') ⊙ ℓ‖²)`` with inverse lengthscales
    ℓ and no ½ in the exponent.  Params ``[σ, ℓ₁..ℓ_d]``, init all ones.
  * :class:`WhiteNoise`: ``σₙ² I`` on the train block, zero on cross
    blocks.  One param, init ``config.noise_init``.
  * :class:`Sum` and :class:`Product`: concatenated parameter vectors,
    split per child.
  * :class:`Matern` (ν ∈ {½, 3/2, 5/2}), :class:`RationalQuadratic`,
    :class:`Periodic`, :class:`Constant`, :class:`SpectralMixture`,
    :class:`Linear`, :class:`ArcCosine`, :class:`Separable`,
    :class:`ActiveDims` and :class:`ChangePoint`.

Methods take one unbatched ``[n, d]`` input; :func:`kernel_matrix`,
:func:`kernel_diag` and :func:`kernel_and_grad` loop over a leading
committee axis.  :func:`train_gram` is the train-gram entry of the NLML,
of one gram or a stack (``jax.vmap`` of it in the JAX package), and
dispatches to the fused gram kernel (``ops.gram``, one launch a stack)
for the canonical RBF + white noise alone.
``matrix_and_grad`` is analytic where the JAX class writes it out and
``torch.func.jacfwd`` of ``matrix`` where the JAX class takes
``jax.jacfwd``, laid out ``[nhp, n, n]``.

Kinks follow the JAX package's gradient rules: a max, min or clip splits
the gradient in half at a tie, as ``lax.max`` does (``torch.maximum`` and
``torch.minimum`` do the same; ``torch.clamp`` would pass it whole), and
``|t|`` has derivative 1 at t = 0, as ``jnp.abs`` has under ``jax.grad``
(``torch.abs`` gives 0) — :func:`_abs`.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
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


def _per_row(v: Tensor, x: Tensor) -> Tensor:
    """The scalar ``v`` at each of x's ``n`` rows, ``[n]``."""
    return v.expand(x.shape[-2]).clone()


def _const(t: Tensor, c) -> Tensor:
    return torch.as_tensor(c, dtype=t.dtype, device=t.device)


def _maximum(t: Tensor, c) -> Tensor:
    """``max(t, c)``, the gradient halved at a tie (``jnp.maximum``)."""
    return torch.maximum(t, _const(t, c))


def _minimum(t: Tensor, c) -> Tensor:
    """``min(t, c)``, the gradient halved at a tie (``jnp.minimum``)."""
    return torch.minimum(t, _const(t, c))


def _clip(t: Tensor, lo, hi) -> Tensor:
    """``jnp.clip``: ``min(max(t, lo), hi)``, ties as above."""
    return _minimum(_maximum(t, lo), hi)


def _abs(t: Tensor) -> Tensor:
    """``|t|`` with derivative 1 at t = 0, as ``jnp.abs`` under
    ``jax.grad`` (``torch.abs`` gives 0 there)."""
    return torch.where(t >= 0, t, -t)


def _jac(kern: "Kernel", params, x, config) -> Tuple[Tensor, Tensor]:
    """``(K, ∂K/∂θ [nhp, n, n])`` by forward-mode autodiff of
    ``kern.matrix`` (the JAX package's ``jax.jacfwd``)."""
    from torch.func import jacfwd

    krn = kern.matrix(params, x, config=config)
    jac = jacfwd(lambda p: kern.matrix(p, x, config=config))(params)
    return krn, torch.movedim(jac, -1, 0)


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

    def __mul__(self, other: "Kernel") -> "Product":
        a = self.kernels if isinstance(self, Product) else (self,)
        b = other.kernels if isinstance(other, Product) else (other,)
        return Product(a + b)

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
        return _per_row(torch.square(params[0]), x)

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
        return _per_row(torch.square(params[0]), x)

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


class Product(_Compose):
    """Elementwise product of kernels, same packing as :class:`Sum`;
    gradients by the product rule, ``∂(∏Kⱼ)/∂θᵢ = (∂Kᵢ/∂θᵢ) ⊙ ∏_{j≠i} Kⱼ``."""

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        terms = [k.matrix(p, x, xp, config=config) for k, p in self._parts(params, x.shape[-1])]
        out = terms[0]
        for t in terms[1:]:
            out = out * t
        return out

    def diag(self, params, x, *, config: Config = DEFAULT):
        terms = [k.diag(p, x, config=config) for k, p in self._parts(params, x.shape[-1])]
        out = terms[0]
        for t in terms[1:]:
            out = out * t
        return out

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        # ⟨Abar, ∂(∏K)/∂θᵢ⟩ = ⟨Abar ∘ ∏_{j≠i} Kⱼ, ∂Kᵢ/∂θᵢ⟩: each child's own
        # contraction on the other factors' weighted adjoint
        spans = list(self._parts(params, x.shape[-1]))
        mats = [k.matrix(p, x, config=config) for k, p in spans]
        parts = []
        for i, (k, p) in enumerate(spans):
            others = None
            for j, m in enumerate(mats):
                if j != i:
                    others = m if others is None else others * m
            ga = k.gram_adjoint(p, x, abar if others is None else abar * others, config=config)
            if ga is None:
                return None
            parts.append(ga)
        return torch.cat(parts, dim=-1)

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        pairs = [k.matrix_and_grad(p, x, config=config) for k, p in self._parts(params, x.shape[-1])]
        ks = [km for km, _ in pairs]
        m = len(ks)
        # prefix[i] = K₀⊙…⊙Kᵢ₋₁, suffix[i] = Kᵢ₊₁⊙…⊙K_{m−1}
        prefix, suffix = [None] * m, [None] * m
        acc = None
        for i in range(m):
            prefix[i] = acc
            acc = ks[i] if acc is None else acc * ks[i]
        krn = acc
        acc = None
        for i in reversed(range(m)):
            suffix[i] = acc
            acc = ks[i] if acc is None else ks[i] * acc
        dkrns = []
        for i, (_, dk) in enumerate(pairs):
            rest = prefix[i]
            if suffix[i] is not None:
                rest = suffix[i] if rest is None else rest * suffix[i]
            dkrns.append(dk if rest is None else dk * rest[None])
        return krn, torch.cat(dkrns, dim=0)


class Matern(Kernel):
    """ARD Matérn, ν ∈ {½, 3/2, 5/2}, ``r = ‖(x − x')⊙ℓ‖``:

      ν=½:   K = σ² exp(−r)
      ν=3/2: K = σ² (1 + √3 r) exp(−√3 r)
      ν=5/2: K = σ² (1 + √5 r + 5r²/3) exp(−√5 r)

    ``r = sqrt(max(sqd, 1e-30))`` keeps the gradient finite at r = 0."""

    def __init__(self, nu: float = 1.5):
        assert nu in (0.5, 1.5, 2.5), "Matern supports nu in {0.5,1.5,2.5}"
        self.nu = nu

    def __hash__(self):
        return hash((type(self), self.nu))

    def __eq__(self, other):
        return type(other) is Matern and other.nu == self.nu

    def n_params(self, dim: int) -> int:
        return dim + 1

    def diag(self, params, x, *, config: Config = DEFAULT):
        return _per_row(torch.square(params[0]), x)

    def _sqd(self, params, x, xp=None):
        ls = params[1:]
        if xp is not None:
            return sq_distance(x * ls, xp * ls)
        # exactly 0 on the diagonal, as XLA's fused product leaves it: the
        # residue of a cuBLAS or MKL product (up to ~2e-6 in f32 here) comes
        # out of Matérn-½'s √ as ~1e-3 in K
        eye = torch.eye(x.shape[-2], dtype=torch.bool, device=x.device)
        return sq_distance(x * ls).masked_fill(eye, 0.0)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        sqd = self._sqd(params, x, xp)
        r = torch.sqrt(_maximum(sqd, 1e-30))
        if self.nu == 0.5:
            return torch.square(params[0]) * torch.exp(-r)
        c = math.sqrt(3.0) if self.nu == 1.5 else math.sqrt(5.0)
        shape = 1.0 + c * r if self.nu == 1.5 else 1.0 + c * r + (5.0 / 3.0) * sqd
        return torch.square(params[0]) * shape * torch.exp(-c * r)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        sqd = self._sqd(params, x)
        r = torch.sqrt(_maximum(sqd, 1e-30))
        s2 = torch.square(sig)
        if self.nu == 0.5:
            k_own = s2 * torch.exp(-r)
            w = -k_own / (2.0 * r)
        elif self.nu == 1.5:
            c = math.sqrt(3.0)
            e = torch.exp(-c * r)
            k_own = s2 * (1.0 + c * r) * e
            # dK/dr = −σ²c²r·e  ⇒  ∂K/∂sqd = −σ²c²e/2 (regular)
            w = -1.5 * s2 * e
        else:
            c = math.sqrt(5.0)
            e = torch.exp(-c * r)
            k_own = s2 * (1.0 + c * r + (5.0 / 3.0) * sqd) * e
            # dK/dr = −(5/3)σ²r(1+√5r)e ⇒ ∂K/∂sqd = −(5/6)σ²(1+√5r)e
            w = -(5.0 / 6.0) * s2 * (1.0 + c * r) * e
        # zero inside the clamp, as autodiff through it gives (diff² = 0
        # there, so its exact contribution is 0)
        w = torch.where(sqd > 1e-30, w, torch.zeros_like(w))
        dsig = (2.0 / sig) * torch.sum(abar * k_own)
        dls = _ard_sqd_adjoint(abar, x, ls, w)
        return torch.cat([dsig[None], dls])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class ArcCosine(Kernel):
    """Arc-cosine kernel of order n ∈ {0, 1, 2} (Cho & Saul 2009), the
    kernel of an infinite ReLUⁿ layer on x̃ = x⊙ℓ:

        K = σ²/π · ‖x̃‖ⁿ‖x̃′‖ⁿ · J_n(θ),  θ = ∠(x̃, x̃′)

    Params ``[σ, ℓ₁..ℓ_d]``, init all ones.  cos θ is clipped inside
    (−1, 1) by 30 ulps so the arccos stays differentiable at θ = 0; no
    gram adjoint (the fast gradient takes autograd through the gram)."""

    def __init__(self, order: int = 1):
        assert order in (0, 1, 2), "ArcCosine supports order 0, 1, 2"
        self.order = order

    def __hash__(self):
        return hash((type(self), self.order))

    def __eq__(self, other):
        return type(other) is ArcCosine and other.order == self.order

    def n_params(self, dim: int) -> int:
        return dim + 1

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        xl = x * ls
        xpl = xl if xp is None else xp * ls
        ip = xpl @ xl.T                                                  # [m, n]
        nx = torch.sqrt(_maximum(torch.sum(torch.square(xl), -1), 1e-36))     # [n]
        nxp = torch.sqrt(_maximum(torch.sum(torch.square(xpl), -1), 1e-36))  # [m]
        ceps = 30.0 * torch.finfo(x.dtype).eps
        cos = _clip(ip / (nxp[:, None] * nx[None, :]), -1.0 + ceps, 1.0 - ceps)
        theta = torch.arccos(cos)
        sin = torch.sqrt(_maximum(1.0 - torch.square(cos), 0.0))
        if self.order == 0:
            j = math.pi - theta
            amp = 1.0
        elif self.order == 1:
            j = sin + (math.pi - theta) * cos
            amp = nxp[:, None] * nx[None, :]
        else:
            j = 3.0 * sin * cos + (math.pi - theta) * (1.0 + 2.0 * torch.square(cos))
            amp = torch.square(nxp)[:, None] * torch.square(nx)[None, :]
        return torch.square(sig) / math.pi * amp * j

    def diag(self, params, x, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        n2 = _maximum(torch.sum(torch.square(x * ls), -1), 1e-36)
        if self.order == 0:
            amp, j0 = torch.ones_like(n2), math.pi
        elif self.order == 1:
            amp, j0 = n2, math.pi
        else:
            amp, j0 = torch.square(n2), 3.0 * math.pi
        return torch.square(sig) / math.pi * amp * j0

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class RationalQuadratic(Kernel):
    """ARD rational quadratic, ``K = σ² (1 + r²/α²)^(−α²)``, a scale
    mixture of :class:`RBF` (no ½ in the exponent).  Params
    ``[σ, α, ℓ₁..ℓ_d]``, init all ones.  α² is clipped to [1e-12, 1e12]:
    at either end the kernel saturates to its limit instead of a NaN."""

    def n_params(self, dim: int) -> int:
        return dim + 2

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        sig, alpha, ls = params[0], params[1], params[2:]
        sqd = sq_distance(x * ls, None if xp is None else xp * ls)
        a2 = _clip(torch.square(alpha), 1e-12, 1e12)
        return torch.square(sig) * torch.exp(-a2 * torch.log1p(sqd / a2))

    def diag(self, params, x, *, config: Config = DEFAULT):
        return _per_row(torch.square(params[0]), x)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        sig, alpha, ls = params[0], params[1], params[2:]
        sqd = sq_distance(x * ls)
        a2 = _clip(torch.square(alpha), 1e-12, 1e12)
        s = sqd / a2
        k_own = torch.square(sig) * torch.exp(-a2 * torch.log1p(s))
        dsig = (2.0 / sig) * torch.sum(abar * k_own)
        # dK/da2 = K·(s/(1+s) − log1p(s)); the clip passes gradient only
        # strictly inside its bounds
        inside = ((torch.square(alpha) > 1e-12) & (torch.square(alpha) < 1e12)).to(sqd.dtype)
        dalpha = 2.0 * alpha * inside * torch.sum(abar * k_own * (s / (1.0 + s) - torch.log1p(s)))
        dls = _ard_sqd_adjoint(abar, x, ls, -k_own / (1.0 + s))
        return torch.cat([dsig[None], dalpha[None], dls])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class Periodic(Kernel):
    """ARD exp-sine-squared, ``K = σ² exp(−2 Σⱼ ℓⱼ² sin²(π ωⱼ (xⱼ−x'ⱼ)))``
    with inverse periods ω.  Params ``[σ, ℓ₁..ℓ_d, ω₁..ω_d]``, init all
    ones.  Computed through the feature map
    ``φ(x) = [ℓ⊙cos(2πω⊙x), ℓ⊙sin(2πω⊙x)]`` as
    ``K = σ² exp(min(φ(x')φ(x)ᵀ − ‖ℓ‖², 0))``: one GEMM, no
    ``[d, m, n]`` difference tensor."""

    def n_params(self, dim: int) -> int:
        return 2 * dim + 1

    def _features(self, params, x):
        dim = x.shape[-1]
        ls, om = params[1:1 + dim], params[1 + dim:]
        u = (2.0 * math.pi) * (x * om)
        return torch.cat([ls * torch.cos(u), ls * torch.sin(u)], dim=-1)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        ls = params[1:1 + x.shape[-1]]
        fx = self._features(params, x)
        fxp = fx if xp is None else self._features(params, xp)
        expo = _minimum(fxp @ fx.T - torch.sum(torch.square(ls)), 0.0)
        return torch.square(params[0]) * torch.exp(expo)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return _per_row(torch.square(params[0]), x)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        dim = x.shape[-1]
        sig, ls, om = params[0], params[1:1 + dim], params[1 + dim:]
        u = (2.0 * math.pi) * (x * om)
        c, s = torch.cos(u), torch.sin(u)                       # [n, d]
        fx = torch.cat([ls * c, ls * s], dim=-1)
        expo_raw = fx @ fx.T - torch.sum(torch.square(ls))
        k_own = torch.square(sig) * torch.exp(_minimum(expo_raw, 0.0))
        dsig = (2.0 / sig) * torch.sum(abar * k_own)
        # the min passes gradient only where the exponent is strictly
        # negative (off the diagonal, whose exact contribution is 0)
        m = torch.where(expo_raw < 0.0, abar * k_own, torch.zeros_like(k_own))
        # one [n, n]·[n, 4d] GEMM feeds every ℓ and ω component
        pm = m @ torch.cat([c, s, x * c, x * s], dim=-1)
        pc, ps, pxc, pxs = pm[:, :dim], pm[:, dim:2 * dim], pm[:, 2 * dim:3 * dim], pm[:, 3 * dim:]
        # ∂E/∂ℓⱼ = 2ℓⱼ(cos(uₐⱼ−u_bⱼ) − 1)
        dls = 2.0 * ls * (torch.sum(c * pc + s * ps, dim=-2) - torch.sum(m))
        # ∂E/∂ωⱼ = −2πℓⱼ²·sin(uₐⱼ−u_bⱼ)(xₐⱼ−x_bⱼ)
        t_sum = (torch.sum((x * s) * pc, dim=-2) - torch.sum((x * c) * ps, dim=-2)
                 - torch.sum(s * pxc, dim=-2) + torch.sum(c * pxs, dim=-2))
        dom = -(2.0 * math.pi) * torch.square(ls) * t_sum
        return torch.cat([dsig[None], dls, dom])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class Constant(Kernel):
    """Constant (bias) kernel ``K = σ²·𝟙𝟙ᵀ``: a learned offset under
    :class:`Sum`, a bias factor in :class:`Product`.  One param, init 1."""

    def n_params(self, dim: int) -> int:
        return 1

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        m = x.shape[-2] if xp is None else xp.shape[-2]
        return torch.square(params[0]) * torch.ones((m, x.shape[-2]), dtype=x.dtype, device=x.device)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return _per_row(torch.square(params[0]), x)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        # ∂K/∂σ = 2σ·𝟙𝟙ᵀ ⇒ ⟨Abar, ·⟩ = 2σ·ΣAbar
        return (2.0 * params[0] * torch.sum(abar))[None]

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        n = x.shape[-2]
        krn = self.matrix(params, x, config=config)
        return krn, (2.0 * params[0]) * torch.ones((1, n, n), dtype=x.dtype, device=x.device)


class SpectralMixture(Kernel):
    """Spectral mixture (Wilson & Adams 2013), Q Gaussian components of
    the spectral density:

        K(τ) = Σ_q w_q² · exp(−‖τ ⊙ s_q‖²) · cos(2π μ_qᵀ τ),  τ = x − x'

    Params ``[w (Q), μ (Q·d), s (Q·d)]``, init all ones, or
    :meth:`init_from_data`.  Per component one squared distance and the
    cosine of a phase difference as a rank-2 outer product."""

    def __init__(self, q: int = 2):
        if q < 1:
            raise ValueError("SpectralMixture needs q >= 1")
        self.q = int(q)

    def __hash__(self):
        return hash((type(self), self.q))

    def __eq__(self, other):
        return type(other) is SpectralMixture and other.q == self.q

    def n_params(self, dim: int) -> int:
        return self.q * (1 + 2 * dim)

    def _split(self, params, dim):
        q = self.q
        w = params[..., :q]
        mu = params[..., q:q + q * dim].reshape(params.shape[:-1] + (q, dim))
        s = params[..., q + q * dim:].reshape(params.shape[:-1] + (q, dim))
        return w, mu, s

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        w, mu, s = self._split(params, x.shape[-1])
        xq = x if xp is None else xp
        out = 0.0
        for k in range(self.q):
            sqd = sq_distance(x * s[k], None if xp is None else xp * s[k])
            a = (2.0 * math.pi) * (x @ mu[k])                             # [n]
            b = a if xp is None else (2.0 * math.pi) * (xq @ mu[k])       # [m]
            cosd = torch.cos(b)[:, None] * torch.cos(a)[None, :] + torch.sin(b)[:, None] * torch.sin(a)[None, :]
            out = out + torch.square(w[k]) * torch.exp(-sqd) * cosd
        return out

    def diag(self, params, x, *, config: Config = DEFAULT):
        w, _, _ = self._split(params, x.shape[-1])
        return _per_row(torch.sum(torch.square(w)), x)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        w, mu, s = self._split(params, x.shape[-1])
        dws, dmus, dss = [], [], []
        for k in range(self.q):
            e = torch.exp(-sq_distance(x * s[k]))
            a = (2.0 * math.pi) * (x @ mu[k])
            ca, sa = torch.cos(a), torch.sin(a)
            cosd = ca[:, None] * ca[None, :] + sa[:, None] * sa[None, :]
            sind = sa[:, None] * ca[None, :] - ca[:, None] * sa[None, :]
            w2 = torch.square(w[k])
            dws.append(2.0 * w[k] * torch.sum(abar * e * cosd))
            # ∂C/∂μ_kj = −w²E sin(φ)·2π(xₐ−x_b)ⱼ: row and column sums
            mt = abar * (w2 * e * sind) * (2.0 * math.pi)
            dmus.append(-((mt.sum(dim=-1) - mt.sum(dim=-2)) @ x))
            # ∂C/∂sqd = −w²E cos φ: the shared ARD contraction
            dss.append(_ard_sqd_adjoint(abar, x, s[k], -w2 * e * cosd))
        return torch.cat([torch.stack(dws), torch.cat(dmus), torch.cat(dss)])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)

    def init_from_data(self, x, seed: int = 0, n_restarts: int = 1):
        """Spectral init on the host (NumPy, the JAX package's to the bit):
        w = 1/√Q, frequencies μ_q log-uniform between the data-range scale
        1/L and the Nyquist frequency of the median sample spacing,
        bandwidths s_q = 1/L.  ``n_restarts > 1`` gives ``[R, nhp]``."""
        x = np.asarray(x)
        n, dim = x.shape
        rng = np.random.default_rng(seed)
        L = x.max(0) - x.min(0) + 1e-12
        f_lo = 1.0 / L
        nyq = np.empty(dim)
        for j in range(dim):
            dx = np.diff(np.sort(x[:, j]))
            dx = dx[dx > 0]
            nyq[j] = 0.5 / (np.median(dx) if dx.size else 1.0)
        nyq = np.maximum(nyq, 2.0 * f_lo)
        outs = []
        for _ in range(max(n_restarts, 1)):
            w = np.full(self.q, 1.0 / np.sqrt(self.q))
            u = rng.uniform(size=(self.q, dim))
            mu = f_lo * (nyq / f_lo) ** u            # log-uniform
            s = np.broadcast_to(1.0 / L, (self.q, dim)).copy()
            outs.append(np.concatenate([w, mu.ravel(), s.ravel()]).astype(x.dtype))
        return outs[0] if n_restarts == 1 else np.stack(outs)


class Linear(Kernel):
    """ARD linear (dot-product) kernel, ``K = σ² (x⊙ℓ)(x'⊙ℓ)ᵀ``: Bayesian
    linear regression as a GP.  Params ``[σ, ℓ₁..ℓ_d]``, init all ones;
    ``∂K/∂σ = 2K/σ``, ``∂K/∂ℓⱼ = 2ℓⱼ σ² xⱼx'ⱼᵀ``."""

    def n_params(self, dim: int) -> int:
        return dim + 1

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        ls = params[1:]
        xl = x * ls
        xpl = xl if xp is None else xp * ls
        return torch.square(params[0]) * (xpl @ xl.T)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return torch.square(params[0]) * torch.sum(torch.square(x * params[1:]), dim=-1)

    def gram_adjoint(self, params, x, abar, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        xl = x * ls
        dsig = 2.0 * sig * torch.sum(abar * (xl @ xl.T))
        # ⟨Abar, ∂K/∂ℓⱼ⟩ = 2ℓⱼσ²·xⱼᵀ Abar xⱼ
        dls = 2.0 * ls * torch.square(sig) * torch.sum(x * (abar @ x), dim=-2)
        return torch.cat([dsig[None], dls])

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        krn = self.matrix(params, x, config=config)
        outer = x.T[:, :, None] * x.T[:, None, :]                 # [d, n, n]
        dls = (2.0 * torch.square(sig) * ls[:, None, None]) * outer
        return krn, torch.cat([(krn * (2.0 / sig))[None], dls], dim=0)


_SEPARABLE_PROFILES = {
    # r ≥ 0 ↦ correlation, each a 1-D stationary kernel, so their tensor
    # product over dimensions is PSD (Schur product theorem)
    "rbf": lambda r: torch.exp(-torch.square(r)),
    "exp": lambda r: torch.exp(-r),                               # Matérn ν=½
    "matern32": lambda r: (1.0 + math.sqrt(3.0) * r) * torch.exp(-math.sqrt(3.0) * r),
    "matern52": lambda r: (1.0 + math.sqrt(5.0) * r + (5.0 / 3.0) * torch.square(r)) * torch.exp(-math.sqrt(5.0) * r),
}


class Separable(Kernel):
    """Tensor product of 1-D stationary profiles,
    ``K = σ² · Π_j φ(|ℓ_j|·|x_j − x'_j|)``, φ ∈ {rbf, exp, matern32,
    matern52}: the Matérn profiles along each axis, factorizing over a
    Cartesian grid.  Params ``[σ, ℓ₁..ℓ_d]``."""

    def __init__(self, profile: str = "matern52"):
        if profile not in _SEPARABLE_PROFILES:
            raise ValueError(f"profile {profile!r} not in {sorted(_SEPARABLE_PROFILES)}")
        self.profile = profile

    def __hash__(self):
        return hash((type(self), self.profile))

    def __eq__(self, other):
        return type(other) is Separable and other.profile == self.profile

    def n_params(self, dim: int) -> int:
        return dim + 1

    def profile_fn(self, r: Tensor) -> Tensor:
        return _SEPARABLE_PROFILES[self.profile](r)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        sig, ls = params[0], params[1:]
        xp_ = x if xp is None else xp
        out = torch.square(sig) * torch.ones((xp_.shape[-2], x.shape[-2]), dtype=x.dtype, device=x.device)
        phi = _SEPARABLE_PROFILES[self.profile]
        for j in range(x.shape[-1]):
            out = out * phi(_abs(xp_[:, j][:, None] - x[:, j][None, :]) * _abs(ls[j]))
        return out

    def diag(self, params, x, *, config: Config = DEFAULT):
        return _per_row(torch.square(params[0]), x)

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


class ActiveDims(Kernel):
    """``base`` on the input columns ``dims`` alone; its parameters are the
    base kernel's for ``len(dims)`` inputs.  The building block of
    additive structure, e.g. ``ActiveDims(RBF(), (0,)) +
    ActiveDims(Matern(2.5), (1, 2))``."""

    def __init__(self, base: Kernel, dims: Sequence[int]):
        self.base = base
        self.dims = tuple(int(d) for d in dims)
        if len(set(self.dims)) != len(self.dims):
            raise ValueError("ActiveDims dims must be unique")

    def __hash__(self):
        return hash((type(self), self.base, self.dims))

    def __eq__(self, other):
        return type(other) is ActiveDims and other.base == self.base and other.dims == self.dims

    def _slice(self, x):
        return None if x is None else x[..., list(self.dims)]

    def n_params(self, dim: int) -> int:
        return self.base.n_params(len(self.dims))

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        return self.base.init_params(self._slice(torch.as_tensor(x)), config)

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        return self.base.matrix(params, self._slice(x), self._slice(xp), config=config)

    def diag(self, params, x, *, config: Config = DEFAULT):
        return self.base.diag(params, self._slice(x), config=config)

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return self.base.matrix_and_grad(params, self._slice(x), config=config)


class ChangePoint(Kernel):
    """Sigmoid changepoint between two kernels along one input axis
    (Lloyd et al. 2014):

        K(x, x') = s(x)s(x')K₁(x, x') + (1 − s(x))(1 − s(x'))K₂(x, x'),
        s(x) = sigmoid(a²·(x_axis − c))

    Params ``[c, a, θ₁…, θ₂…]``, init ``c = a = 1`` and the sub-kernels'
    own; both sub-kernels see every input column."""

    def __init__(self, k1: Kernel, k2: Kernel, axis: int = 0):
        self.k1 = k1
        self.k2 = k2
        self.axis = int(axis)

    def __hash__(self):
        return hash((type(self), self.k1, self.k2, self.axis))

    def __eq__(self, other):
        return (type(other) is ChangePoint and other.k1 == self.k1 and other.k2 == self.k2
                and other.axis == self.axis)

    def n_params(self, dim: int) -> int:
        return 2 + self.k1.n_params(dim) + self.k2.n_params(dim)

    def init_params(self, x, config: Config = DEFAULT) -> Tensor:
        x = torch.as_tensor(x)
        gate = torch.ones(x.shape[:-2] + (2,), dtype=x.dtype, device=x.device)
        return torch.cat([gate, self.k1.init_params(x, config), self.k2.init_params(x, config)], dim=-1)

    def init_from_data(self, x, n_restarts: int = 1, config: Config = DEFAULT):
        """Host-side init, the JAX package's: the gate at the median of the
        gate axis (``n_restarts > 1``: evenly spaced quantiles, stacked
        ``[R, nhp]``), sharpness ``a² = 4/range``, the sub-kernels at their
        own inits.  A gate location ≤ 0 is clamped to 1e-3 of the range,
        with a warning, so the default log-space fit stays finite.  A
        NumPy array for a NumPy ``x``, else a tensor on ``x``'s device."""
        xt = torch.as_tensor(x)
        col = xt.detach().cpu().numpy()[..., self.axis].ravel()
        rng_ = max(float(col.max() - col.min()), 1e-6)
        a = float(np.sqrt(4.0 / rng_))
        sub = torch.cat([self.k1.init_params(xt, config), self.k2.init_params(xt, config)], dim=-1)
        qs = [0.5] if n_restarts == 1 else np.linspace(0.15, 0.85, n_restarts)
        rows, bad_c = [], []
        c_floor = 1e-3 * rng_
        for q in qs:
            c = float(np.quantile(col, q))
            if c <= 0.0:
                bad_c.append(c)
                c = c_floor
            gate = torch.tensor([c, a], dtype=sub.dtype, device=sub.device)
            rows.append(torch.cat([gate, sub], dim=-1))
        if bad_c:
            warnings.warn(
                "ChangePoint.init_from_data: gate location(s) "
                f"{bad_c} were <= 0 because the gate-axis data spans "
                "non-positive values; clamped to "
                f"{c_floor:.3g} so the default log-space fit_mle "
                "stays finite.  For a genuinely non-positive change "
                "point, shift the inputs or fit with "
                "log_space=False.",
                stacklevel=2,
            )
        out = rows[0] if n_restarts == 1 else torch.stack(rows)
        return out if isinstance(x, Tensor) else out.numpy()

    def _gate(self, params, x):
        return torch.sigmoid(torch.square(params[1]) * (x[..., self.axis] - params[0]))

    def _split(self, params, dim):
        n1 = self.k1.n_params(dim)
        return params[2:2 + n1], params[2 + n1:]

    def matrix(self, params, x, xp=None, *, config: Config = DEFAULT):
        p1, p2 = self._split(params, x.shape[-1])
        s_x = self._gate(params, x)                              # [n]
        s_q = s_x if xp is None else self._gate(params, xp)      # [m]
        k1 = self.k1.matrix(p1, x, xp, config=config)
        k2 = self.k2.matrix(p2, x, xp, config=config)
        return s_q[:, None] * s_x[None, :] * k1 + (1.0 - s_q)[:, None] * (1.0 - s_x)[None, :] * k2

    def diag(self, params, x, *, config: Config = DEFAULT):
        p1, p2 = self._split(params, x.shape[-1])
        s = self._gate(params, x)
        return (torch.square(s) * self.k1.diag(p1, x, config=config)
                + torch.square(1.0 - s) * self.k2.diag(p2, x, config=config))

    def matrix_and_grad(self, params, x, *, config: Config = DEFAULT):
        return _jac(self, params, x, config)


def _batched(core, params, x, *rest):
    """Apply ``core`` per element of a leading batch axis of x and/or
    params (a loop, stacked), or once when neither is batched.  ``rest``
    (a cross block's ``xp``) is never batched: every element gets it
    whole, as the JAX package's ``n_array_rest`` arrays."""
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
    return _batched(lambda p, xx, xpp: kern.matrix(p, xx, xpp, config=config), params, x, xp)


def kernel_diag(kern: Kernel, params, x, *, config: Config = DEFAULT) -> Tensor:
    return _batched(lambda p, xx: kern.diag(p, xx, config=config), params, x)


def kernel_and_grad(kern: Kernel, params, x, *, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Batched ``(K, dK)`` with dK laid out ``[..., nhp, n, n]``."""
    return _batched(lambda p, xx: kern.matrix_and_grad(p, xx, config=config), params, x)


def train_gram(kern: Kernel, params, x, config: Config = DEFAULT) -> Tensor:
    """Train gram K(x, x) ``[n, n]``, or a stack ``[nb, n, n]``, the
    counterpart of the JAX package's ``train_gram`` and of ``jax.vmap`` of
    it: ``x [n, d]`` or ``[nb, n, d]`` with ``params [nhp]`` or
    ``[nb, nhp]`` (a shared input is one tensor for the whole stack).  The
    canonical RBF+WhiteNoise on an f32 input of a width the fused kernel
    takes is one call of :func:`pygpr_torch.ops.gram.rbf_noise_gram` (one
    K1 launch on the card, however deep the stack, a shared input never
    copied; its plain version on the CPU); anything else ``kern.matrix``,
    a matrix at a time.  Differentiable on both paths."""
    if gram.takes(x) and gram.matches_rbf_noise(kern):
        if params.ndim == 2 and params.stride(0) != 0:
            params = params.contiguous()  # a column slice of a stack of θ; a few hundred bytes
        return gram.rbf_noise_gram(params, x)
    if x.ndim == 2 and params.ndim == 1:
        return kern.matrix(params, x, config=config)
    nb = x.shape[0] if x.ndim == 3 else params.shape[0]
    return torch.stack([
        kern.matrix(params[i] if params.ndim == 2 else params, x[i] if x.ndim == 3 else x, config=config)
        for i in range(nb)
    ])
