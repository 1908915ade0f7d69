"""Fused Cholesky factor and triangular inverse (kernel K2).

Counterpart of ``pygpr_tpu/ops/pallas_cholesky.py::cholesky_inverse_pallas``
and ``cholesky_inverse_pallas_rolled``: one sweep gives ``L`` with
``K = L Lᵀ`` and ``T = L⁻¹``, both lower triangular with exact zeros
above the diagonal, for the fast NLML gradient (``K⁻¹ = TᵀT``).

On a CUDA tensor :func:`cholesky_inverse` launches ``csrc/chol_inverse.cu``
(f32 only); on a CPU tensor it runs :func:`cholesky_inverse_plain`, the
same left-looking algorithm over 64-wide panels in torch ops.  Neither
guards a non-positive pivot: its NaN spreads through the rest of the
factor, which is the jitter ladder's signal (``ops.linalg``).  Neither
writes the caller's ``K``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch

#: panel width; NB in csrc/chol_inverse.cu
PANEL = 64
#: most k-splits of one left-looking product (sizes the scratch)
MAX_SPLITS = 16
#: largest n of ``cholesky_inverse_pallas``; the JAX package hands a larger
#: n to ``cholesky_inverse_pallas_rolled``
MAX_FUSED_N = 5632


def takes(K: torch.Tensor) -> bool:
    """Shape rule of the kernel: one square [n, n], n % 128 == 0, n ≥ 256
    (the union of the two TPU kernels' domains, without their split)."""
    n = K.shape[-1]
    return K.ndim == 2 and K.shape[0] == n and n % 128 == 0 and n >= 256


def _factor_block(W: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking Cholesky of a diagonal block, NaN on a
    non-positive pivot (the kernel's one-block loop)."""
    A = W.clone()
    nb = A.shape[0]
    for j in range(nb):
        piv = torch.sqrt(A[j, j])
        A[j + 1:, j] = A[j + 1:, j] / piv
        A[j, j] = piv
        c = A[j + 1:, j]
        A[j + 1:, j + 1:] -= torch.outer(c, c)
    return torch.tril(A)


def cholesky_inverse_plain(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's algorithm in torch ops, on any device and dtype."""
    n = K.shape[-1]
    L = torch.zeros_like(K)
    T = torch.zeros_like(K)
    eye = torch.eye(PANEL, dtype=K.dtype, device=K.device)
    for lo in range(0, n, PANEL):
        hi = lo + PANEL
        # the update subtracts short k-chunks from K, in order, as the
        # kernel's split-k does: one long f32 sum would swamp its small
        # late terms and bias the pivots
        W = K[lo:, lo:hi].clone()
        for c in range(0, lo, PANEL):
            W -= L[lo:, c:c + PANEL] @ L[lo:hi, c:c + PANEL].T
        D = _factor_block(W[:PANEL])
        Dinv = torch.linalg.solve_triangular(D, eye, upper=False)
        L[lo:hi, lo:hi] = D
        T[lo:hi, lo:hi] = Dinv
        L[hi:, lo:hi] = W[PANEL:] @ Dinv.T
        if lo:
            T[lo:hi, :lo] = -(Dinv @ (L[lo:hi, :lo] @ T[:lo, :lo]))
    return L, T


def _lib():
    from pygpr_torch.ops import _build

    lib = _build.load("chol_inverse")
    fn = lib.chol_inverse_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
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
    W = torch.empty((n, PANEL), **opts)
    X = torch.empty((PANEL, n), **opts)
    P = torch.empty((MAX_SPLITS * n * PANEL,), **opts)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    err = fn(
        K.data_ptr(), L.data_ptr(), T.data_ptr(), W.data_ptr(), X.data_ptr(),
        P.data_ptr(), P.numel(), n, stream,
    )
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
