"""Dense linear algebra for GP inference: laddered Cholesky and solves.

Counterpart of ``pygpr_tpu/ops/linalg.py``.  Near-singular kernel
matrices are the common failure in f32, so every factorization runs
under an escalating jitter ladder: retry with jitter·10^k until the
factor is finite, per matrix.  A matrix that fails every rung gets an
all-NaN factor, as XLA's Cholesky gives.

Each rung factors f32 input of the shapes the JAX package sends to its
Pallas Cholesky kernels with kernel K3 (``ops.chol_batched``; its plain
version on the CPU), a single f32 ``[n, n]`` above 1024 of K2's shapes
with K2 (``ops.chol_inverse``, keeping L), and everything else with
``torch.linalg.cholesky_ex``, which reports a failure in ``info`` where
``torch.linalg.cholesky`` would raise.

The K2 route departs from the JAX package, which sends a single f32 gram
above 1024 to XLA's Cholesky.  On the card that call is cuSOLVER's, whose
f32 factor of a 4096 gram leaves a backward error ‖LLᵀ − K‖/‖K‖ about 14×
K2's, and fails every rung of some near-singular grams that K2 factors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops import chol_batched, chol_inverse

Tensor = torch.Tensor


class CholResult(NamedTuple):
    """Result of a jitter-laddered Cholesky factorization."""

    chol: Tensor    #: lower factor L, K + jitter·I = L Lᵀ
    jitter: Tensor  #: jitter used, per matrix (batch-shaped)
    ok: Tensor      #: 1.0/0.0 per matrix: whether any rung succeeded


def add_diag(K: Tensor, eps) -> Tensor:
    """K + eps·I (eps a number or a batch-shaped tensor), out of place."""
    out = K.clone()
    if isinstance(eps, Tensor) and eps.ndim:
        eps = eps[..., None]
    out.diagonal(dim1=-2, dim2=-1).add_(eps)
    return out


def batched_kernel_takes(K: Tensor) -> bool:
    """Routing rule of the ladder, the JAX package's (``safe_cholesky``
    under ``use_pallas``): f32 ``[n, n]`` with n ≤ 1024 (as
    ``cholesky_pallas``); ``[nb, n, n]`` with nb ≥ 2, n % 128 == 0 and
    n ≥ 256 (as ``cholesky_pallas_batched``); any other stack with
    n ≤ 1024 (``cholesky_pallas`` under ``vmap``).  Leading batch axes
    count as one."""
    if K.dtype != torch.float32 or K.ndim < 2:
        return False
    n = K.shape[-1]
    if n <= 1024:
        return True
    nb = math.prod(K.shape[:-2])
    return K.ndim > 2 and nb >= 2 and n % 128 == 0


def fused_kernel_takes(K: Tensor) -> bool:
    """Second routing rule of the ladder, the port's own: a single f32
    ``[n, n]`` with n > 1024, n % 128 == 0 goes to K2, which the first rule
    leaves to the library."""
    return K.dtype == torch.float32 and K.shape[-1] > 1024 and chol_inverse.takes(K)


def _ladder(K: Tensor, config: Config):
    rungs = config.jitter_rungs
    kernel = batched_kernel_takes(K)
    fused = fused_kernel_takes(K)

    def attempt(k):
        jit = config.jitter * torch.pow(10.0, k)
        A = add_diag(K, jit)
        if kernel:
            n = K.shape[-1]
            A = A if A.ndim <= 3 else A.reshape((-1, n, n))
            L = chol_batched.cholesky_batched(A.contiguous()).reshape(K.shape)
            ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
        elif fused:
            L = chol_inverse.cholesky_inverse(A.contiguous())[0]
            ok = torch.isfinite(L).all()
        else:
            L, info = torch.linalg.cholesky_ex(A)
            ok = (info == 0) & torch.isfinite(L).all(dim=-1).all(dim=-1)
        return L, jit, ok

    k = torch.zeros(K.shape[:-2], dtype=K.dtype, device=K.device)
    L, j, ok = attempt(k)
    # converged matrices keep their rung and factor; the rest escalate
    while bool(torch.any(~ok & (k < rungs - 1))):
        k = torch.where(ok, k, k + 1.0)
        L2, j2, ok2 = attempt(k)
        L = torch.where(ok[..., None, None], L, L2)
        j = torch.where(ok, j, j2)
        ok = ok | ok2
    L = torch.where(ok[..., None, None], L, torch.nan)
    return L, j, ok.to(K.dtype)


class _SafeCholesky(torch.autograd.Function):
    """Laddered Cholesky whose backward reuses the factor: the adjoint of
    dL = L Φ(L⁻¹ dK L⁻ᵀ) (Murray 2016), K̄ = L⁻ᵀ Φ(LᵀL̄) L⁻¹ with Φ the
    lower triangle with halved diagonal.  The chosen rung is treated as
    locally constant."""

    @staticmethod
    def forward(ctx, K, config):
        L, j, ok = _ladder(K, config)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(j, ok)
        return L, j, ok

    @staticmethod
    def backward(ctx, Lbar, _jbar, _okbar):
        (L,) = ctx.saved_tensors
        P = L.mT @ Lbar
        P = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
        S = torch.linalg.solve_triangular(L.mT, P, upper=True)
        return torch.linalg.solve_triangular(L, S, upper=False, left=False), None


def safe_cholesky(K: Tensor, config: Config = DEFAULT) -> CholResult:
    """Cholesky of ``K + jitter·I`` under the escalating ladder, per
    matrix of a ``[..., n, n]`` batch.  One factorization and one host
    sync in the common case; differentiable through the factor."""
    return CholResult(*_SafeCholesky.apply(K, config))


def _as_matrix(L: Tensor, b: Tensor):
    vec = b.ndim == L.ndim - 1
    return (b[..., None] if vec else b), vec


def cholesky_solve(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``K x = b`` given ``K = L Lᵀ``; ``b`` is ``[n]`` or ``[n, m]``."""
    B, vec = _as_matrix(L, b)
    x = torch.cholesky_solve(B, L, upper=False)
    return x[..., 0] if vec else x


def solve_lower(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``L z = b`` (forward substitution)."""
    B, vec = _as_matrix(L, b)
    z = torch.linalg.solve_triangular(L, B, upper=False)
    return z[..., 0] if vec else z


def solve_lower_t(L: Tensor, b: Tensor) -> Tensor:
    """Solve ``Lᵀ x = b`` (backward substitution on the lower factor)."""
    B, vec = _as_matrix(L, b)
    z = torch.linalg.solve_triangular(L.mT, B, upper=True)
    return z[..., 0] if vec else z


def logdet_from_chol(L: Tensor) -> Tensor:
    """log|K| = 2 Σ log diag(L)."""
    return 2.0 * half_logdet_from_chol(L)


def half_logdet_from_chol(L: Tensor) -> Tensor:
    """Σ log diag(L)."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


class _TriInverse(torch.autograd.Function):
    """T = L⁻¹ whose backward is the inverse's adjoint, L̄ = −tril(Tᵀ T̄ Tᵀ)
    (dT = −T dL T, restricted to L's lower triangle)."""

    @staticmethod
    def forward(ctx, L, base):
        T = _tri_inverse_doubling(L, base)
        ctx.save_for_backward(T)
        return T

    @staticmethod
    def backward(ctx, Tbar):
        (T,) = ctx.saved_tensors
        return -torch.tril(T.mT @ Tbar @ T.mT), None


def tri_inverse_doubling(L: Tensor, base: int = 128) -> Tensor:
    """Lower-triangular inverse ``T = L⁻¹`` by block doubling: invert the
    n/base diagonal blocks at once, then log₂(n/base) levels stitch pairs
    by ``T₂₁ = −T₂₂ L₂₁ T₁₁`` in two batched GEMMs each (≈ ⅓n³ flops).
    n is padded to base·2ᵏ with an identity tail.  Leading batch axes are
    inverted together.  Differentiable in ``L`` (SGPR's bound)."""
    return _TriInverse.apply(L, base)


def _tri_inverse_doubling(L: Tensor, base: int) -> Tensor:
    batch, n0 = L.shape[:-2], L.shape[-1]
    P = 1
    while P * base < n0:
        P *= 2
    n = P * base
    L = L.reshape((-1, n0, n0))
    B = L.shape[0]
    if n != n0:
        L = F.pad(L, (0, n - n0, 0, n - n0))
        tail = torch.arange(n0, n, device=L.device)
        L[:, tail, tail] = 1.0
    idx = torch.arange(P, device=L.device)
    eye = torch.eye(base, dtype=L.dtype, device=L.device).expand(P, B, base, base)
    # advanced indices split by a slice go first: blocks are [P, B, base, base]
    Tdiag = torch.linalg.solve_triangular(L.reshape(B, P, base, P, base)[:, idx, :, idx, :], eye, upper=False)
    T = torch.zeros((B, P, base, P, base), dtype=L.dtype, device=L.device)
    T[:, idx, :, idx, :] = Tdiag
    T = T.reshape(B, n, n)
    s = base
    while s < n:
        even = torch.arange(n // (2 * s), device=L.device) * 2
        odd = even + 1
        Ls = L.reshape(B, n // s, s, n // s, s)
        Ts = T.view(B, n // s, s, n // s, s)
        Ts[:, odd, :, even, :] = -(Ts[:, odd, :, odd, :] @ (Ls[:, odd, :, even, :] @ Ts[:, even, :, even, :]))
        s *= 2
    T = T[:, :n0, :n0] if n != n0 else T
    return T.reshape(batch + (n0, n0))


def syrk_from_tril(T: Tensor, base: int = 512) -> Tensor:
    """``C = Tᵀ T`` for lower-triangular ``T`` (LAPACK ``lauum``) by the
    recursion, for ``T = [[T11, 0], [T21, T22]]``::

        TᵀT = [[T11ᵀT11 + T21ᵀT21, (T22ᵀT21)ᵀ], [T22ᵀT21, T22ᵀT22]]

    ≈ ⅔n³ flops in contiguous GEMMs instead of the dense 2n³."""
    m = T.shape[-1]
    if m <= base:
        return T.T @ T
    h = m // 2
    T11, T21, T22 = T[:h, :h], T[h:, :h], T[h:, h:]
    C11 = syrk_from_tril(T11, base) + T21.T @ T21
    C21 = T22.T @ T21
    C22 = syrk_from_tril(T22, base)
    return torch.cat([torch.cat([C11, C21.T], dim=-1), torch.cat([C21, C22], dim=-1)], dim=-2)


def chol_and_tri_inverse(K: Tensor, config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """``(L, T = L⁻¹)`` of ``K + jitter·I`` under the escalating ladder.

    An f32 ``[n, n]`` of a shape the fused kernel takes (n % 128 == 0,
    n ≥ 256) goes through :func:`pygpr_torch.ops.chol_inverse.cholesky_inverse`
    (the CUDA kernel on the card, its plain version on the CPU), one host
    sync per rung; anything else through :func:`safe_cholesky` and
    :func:`tri_inverse_doubling`.  Not differentiable.
    """
    if K.dtype == torch.float32 and chol_inverse.takes(K):
        for k in range(config.jitter_rungs):
            L, T = chol_inverse.cholesky_inverse(add_diag(K, config.jitter * 10.0**k))
            if bool(torch.isfinite(L).all()):
                break
        return L, T
    L = safe_cholesky(K, config).chol
    return L, tri_inverse_doubling(L)


def inv_from_chol(L: Tensor) -> Tensor:
    """K⁻¹ from its Cholesky factor."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape[:-2] + (n, n))
    return cholesky_solve(L, eye)


def spd_solve(K: Tensor, b: Tensor, config: Config = DEFAULT) -> Tensor:
    """One-shot SPD solve with the jitter ladder."""
    return cholesky_solve(safe_cholesky(K, config).chol, b)
