"""Fused Cholesky factor and triangular inverse (kernel K2).

Counterpart of ``pygpr_tpu/ops/pallas_cholesky.py::cholesky_inverse_pallas``
and ``cholesky_inverse_pallas_rolled``: one sweep gives ``L`` with
``K = L Lᵀ`` and ``T = L⁻¹``, both lower triangular with exact zeros
above the diagonal, for the fast NLML gradient (``K⁻¹ = TᵀT``).

On a CUDA tensor :func:`cholesky_inverse` launches ``csrc/chol_inverse.cu``
(f32 only); on a CPU tensor it runs :func:`cholesky_inverse_plain`, the
same right-looking sweep over 128-wide panels in torch ops, with the
kernel's blocking: each diagonal block factored and inverted as tiles of
32, the rows below it and T's band by products with its inverse, and each
panel's rank-128 products subtracted from the trailing matrix and from the
right-hand side of L T = I in panel order.  Neither guards a non-positive
pivot: its NaN spreads through the rest of the factor, which is the jitter
ladder's signal (``ops.linalg``).  Neither writes the caller's ``K``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch

#: panel width; NB in csrc/chol_inverse.cu
PANEL = 128
#: the diagonal block's tiles; TW in csrc/chol_inverse.cu
TILE = 32
#: largest n of ``cholesky_inverse_pallas``; the JAX package hands a larger
#: n to ``cholesky_inverse_pallas_rolled``
MAX_FUSED_N = 5632


def takes(K: torch.Tensor) -> bool:
    """Shape rule of the kernel: one square [n, n], n % 128 == 0, n ≥ 256
    (the union of the two TPU kernels' domains, without their split)."""
    n = K.shape[-1]
    return K.ndim == 2 and K.shape[0] == n and n % 128 == 0 and n >= 256


def _factor_block(W: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking Cholesky of a diagonal tile, NaN on a
    non-positive pivot (one warp's ``chol32``)."""
    A = W.clone()
    nb = A.shape[0]
    for j in range(nb):
        piv = torch.sqrt(A[j, j])
        A[j + 1:, j] = A[j + 1:, j] / piv
        A[j, j] = piv
        c = A[j + 1:, j]
        A[j + 1:, j + 1:] -= torch.outer(c, c)
    return torch.tril(A)


def _factor_diag(A: torch.Tensor) -> torch.Tensor:
    """D with A = D Dᵀ for the lower triangle of a diagonal block, as tiles
    of 32: factor a tile, solve the rows below it, subtract their rank-32
    product from the rest."""
    D = A.clone()
    nb = D.shape[0]
    for t in range(0, nb, TILE):
        e = t + TILE
        D[t:e, t:e] = _factor_block(D[t:e, t:e])
        if e < nb:
            D[e:, t:e] = torch.linalg.solve_triangular(D[t:e, t:e], D[e:, t:e].mT, upper=False).mT
            D[e:, e:] -= D[e:, t:e] @ D[e:, t:e].mT
    return torch.tril(D)


def _invert_diag(D: torch.Tensor) -> torch.Tensor:
    """X = D⁻¹ of a lower-triangular ``[..., nb, nb]`` by recursive halving
    down to tiles of 32, each tile by a triangular solve:
    X = [[X₀, 0], [−X₁ (D₁₀ X₀), X₁]].  Only the lower triangle is read."""
    nb = D.shape[-1]
    if nb == TILE:
        return torch.linalg.solve_triangular(D, torch.eye(TILE, dtype=D.dtype, device=D.device), upper=False)
    h = nb // 2
    X0 = _invert_diag(D[..., :h, :h])
    X1 = _invert_diag(D[..., h:, h:])
    X = torch.zeros_like(D)
    X[..., :h, :h] = X0
    X[..., h:, h:] = X1
    X[..., h:, :h] = -(X1 @ (D[..., h:, :h] @ X0))
    return X


def cholesky_inverse_plain(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in torch ops, on any device and dtype."""
    n = K.shape[-1]
    A = K.clone()  # the trailing matrix; the kernel keeps it in L's storage
    L = torch.zeros_like(K)
    T = torch.zeros_like(K)  # below the diagonal blocks: B, the right-hand side of L T = I
    for lo in range(0, n, PANEL):
        hi = lo + PANEL
        D = _factor_diag(A[lo:hi, lo:hi])
        X = _invert_diag(D)
        L[lo:hi, lo:hi] = D
        T[lo:hi, lo:hi] = X
        if lo:
            T[lo:hi, :lo] = X @ T[lo:hi, :lo]
        if hi < n:
            # the panel's rank-128 products are subtracted in panel order:
            # one long f32 sum would swamp its small late terms and bias
            # the pivots
            P = A[hi:, lo:hi] @ X.mT
            L[hi:, lo:hi] = P
            A[hi:, hi:] -= P @ P.mT
            T[hi:, :hi] -= P @ T[lo:hi, :hi]
    return L, T


def _lib():
    from pygpr_torch.ops import _build

    lib = _build.load("chol_inverse")
    fn = lib.chol_inverse_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cholesky_inverse_cuda(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/chol_inverse.cu`` on PyTorch's current stream.

    ``K``: f32, contiguous, on a CUDA device, with a shape :func:`takes`.
    Raises on anything else.
    """
    if K.device.type != "cuda":
        raise ValueError("cholesky_inverse_cuda: K must be on a CUDA device")
    if K.dtype != torch.float32:
        raise TypeError("cholesky_inverse_cuda: the kernel takes float32 only")
    if not takes(K):
        raise ValueError(f"cholesky_inverse_cuda: K must be [n, n], n % 128 == 0, n >= 256; got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError("cholesky_inverse_cuda: K must be contiguous")
    fn = _lib()
    n = K.shape[0]
    opts = dict(dtype=torch.float32, device=K.device)
    L = torch.empty((n, n), **opts)
    T = torch.empty((n, n), **opts)
    P = torch.empty((PANEL, n), **opts)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    err = fn(K.data_ptr(), L.data_ptr(), T.data_ptr(), P.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"chol_inverse kernel launch failed: CUDA error {err}")
    cholesky_inverse_cuda.launches += 1
    cholesky_inverse_cuda.shapes[(n,)] += 1
    if n > MAX_FUSED_N:
        cholesky_inverse_cuda.rolled_launches += 1
    return L, T


#: kernel launches since the count was last set to 0
cholesky_inverse_cuda.launches = 0
#: of those, launches at n > MAX_FUSED_N (``cholesky_inverse_pallas_rolled``'s
#: domain); the rest are ``cholesky_inverse_pallas``'s
cholesky_inverse_cuda.rolled_launches = 0
#: the launches by shape (n,)
cholesky_inverse_cuda.shapes = collections.Counter()


def cholesky_inverse(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(L, T = L⁻¹)`` of SPD ``K`` with a shape :func:`takes`.

    CPU tensors take :func:`cholesky_inverse_plain`; CUDA tensors launch
    the kernel (f32 only) or raise.  Indefinite input gives non-finite L.
    """
    if not takes(K):
        raise ValueError(f"cholesky_inverse: K must be [n, n], n % 128 == 0, n >= 256; got {tuple(K.shape)}")
    if K.device.type == "cpu":
        return cholesky_inverse_plain(K)
    return cholesky_inverse_cuda(K)
