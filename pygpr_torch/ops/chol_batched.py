"""Batched blocked Cholesky factor (kernel K3).

Counterpart of two TPU kernels of ``pygpr_tpu/ops/pallas_cholesky.py``:
``cholesky_pallas`` (one ``[n, n]`` or a grid over ``[nb, n, n]``,
n ≤ 1024, resident in VMEM) and ``cholesky_pallas_batched`` (``[nb, n, n]``,
nb ≥ 2, n % 128 == 0, streamed from HBM with the nb pivot chains advancing
together).  One kernel family takes both: ``K = L Lᵀ`` for ``[n, n]`` or
``[nb, n, n]`` f32, n and nb at run time, with exact zeros above the
diagonal.

On a CUDA tensor :func:`cholesky_batched` launches
``csrc/chol_batched.cu`` (f32 only); on a CPU tensor it runs
:func:`cholesky_batched_plain`, the same right-looking algorithm over
64-wide panels in torch ops: each diagonal block factored as 2×2 tiles of
32 as the kernel's warps do it (``csrc/small_chol.cuh``) and inverted,
and the rows below it multiplied by the inverse's transpose.  On
``cholesky_pallas_batched``'s domain (:func:`batched_domain`) the plain
version follows the schedule the kernel takes there for stacks large
enough to keep the card busy: outer panels of 128 columns, each two
64-wide panels, the second panel's columns brought up to date with the
first's rows before it is factored, and the trailing matrix updated once
an outer panel, each 64-wide panel's product subtracted on its own, in
panel order.  In the kernel both schedules give every entry the same
operations in the same order, and so the same bits.
n is padded to a multiple of 64 with an identity tail, as
``cholesky_pallas`` pads to 128.  Neither version guards a non-positive
pivot: its NaN fills the rest of that matrix's factor and no other, which
is the per-matrix signal of the jitter ladder (``ops.linalg``).  Neither
writes the caller's ``K``.
"""

from __future__ import annotations

import collections
import ctypes

import torch

#: panel width; NB in csrc/chol_batched.cu
PANEL = 64
#: the diagonal block's sub-tile: one warp's factorization (csrc/small_chol.cuh)
TILE = 32
#: outer panel on :func:`batched_domain`; W in csrc/chol_batched.cu
OUTER = 128


def batched_domain(nb: int, n: int) -> bool:
    """Whether a stack of ``nb`` matrices ``[n, n]`` lies in
    ``cholesky_pallas_batched``'s domain (B5); the rest is
    ``cholesky_pallas``'s (B4)."""
    return nb >= 2 and n % 128 == 0 and n >= 256


def _padded(n: int) -> int:
    return max(-(-n // PANEL) * PANEL, PANEL)


def _factor_tile(A: torch.Tensor) -> torch.Tensor:
    """Unblocked right-looking Cholesky of a stack of tiles ``[nb, w, w]``
    (lower triangles), NaN on a non-positive pivot: one warp's ``chol32``."""
    A = A.clone()
    for j in range(A.shape[-1]):
        piv = torch.sqrt(A[:, j, j])
        A[:, j + 1:, j] /= piv[:, None]
        A[:, j, j] = piv
        c = A[:, j + 1:, j]
        A[:, j + 1:, j + 1:] -= c[:, :, None] * c[:, None, :]
    return torch.tril(A)


def _solve_rows(B: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``B D⁻ᵀ`` for ``B`` ``[nb, r, w]`` and a lower factor ``D``
    ``[nb, w, w]``: forward substitution column by column, right-looking,
    each column divided by ``D[k, k]`` (the kernel's ``trsm32``, a row a
    lane).  Elementwise, so a NaN in ``D`` reaches every row."""
    X = B.clone()
    for k in range(D.shape[-1]):
        X[:, :, k] /= D[:, k, k, None]
        X[:, :, k + 1:] -= X[:, :, k, None] * D[:, None, k + 1:, k]
    return X


def _factor_diag(A: torch.Tensor) -> torch.Tensor:
    """Factor a stack of diagonal blocks ``[nb, 64, 64]`` (lower triangles
    read) as 2×2 tiles of 32: ``D00``, ``D10 = A10 D00⁻ᵀ``,
    ``D11 = chol(A11 − D10 D10ᵀ)``."""
    D00 = _factor_tile(A[:, :TILE, :TILE])
    D10 = _solve_rows(A[:, TILE:, :TILE], D00)
    D11 = _factor_tile(A[:, TILE:, TILE:] - D10 @ D10.mT)
    D = torch.zeros_like(A)
    D[:, :TILE, :TILE] = D00
    D[:, TILE:, :TILE] = D10
    D[:, TILE:, TILE:] = D11
    return D


def cholesky_batched_plain(K: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in torch ops, on any device and dtype."""
    A = K if K.ndim == 3 else K[None]
    nb, n, _ = A.shape
    n_pad = _padded(n)
    W = torch.zeros((nb, n_pad, n_pad), dtype=K.dtype, device=K.device)
    W[:, :n, :n] = torch.tril(A)
    tail = torch.arange(n, n_pad, device=K.device)
    W[:, tail, tail] = 1.0
    eye = torch.eye(PANEL, dtype=K.dtype, device=K.device).expand(nb, PANEL, PANEL)
    outer = OUTER if batched_domain(nb, n) else PANEL
    for lo in range(0, n_pad, outer):
        end = lo + outer
        groups = []  # each 64-wide panel's rows below the outer panel
        for s in range(lo, end, PANEL):
            hi = s + PANEL
            D = _factor_diag(W[:, s:hi, s:hi])
            W[:, s:hi, s:hi] = D
            if hi == n_pad:
                break
            Dinv = torch.linalg.solve_triangular(D, eye, upper=False)
            X = W[:, hi:, s:hi] @ Dinv.mT
            W[:, hi:, s:hi] = X
            # the outer panel's later columns now, the trailing matrix after it
            W[:, hi:, hi:end] -= X @ X[:, :end - hi].mT
            groups.append(X[:, end - hi:])
        # each panel's rank-64 product leaves the trailing matrix on its own,
        # in panel order, as the kernel's does
        for X in groups:
            W[:, end:, end:] -= X @ X.mT
    L = torch.tril(W)[:, :n, :n]
    return L if K.ndim == 3 else L[0]


def _lib():
    """The kernel's C entry and the size of the scratch it needs."""
    from pygpr_torch.ops import _build

    lib = _build.load("chol_batched")
    fn = lib.chol_batched_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.chol_batched_scratch_floats
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    return fn, size


def cholesky_batched_cuda(K: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/chol_batched.cu`` on PyTorch's current stream.

    ``K``: ``[n, n]`` or ``[nb, n, n]``, f32, contiguous, on a CUDA device.
    Raises on anything else.
    """
    if K.device.type != "cuda":
        raise ValueError("cholesky_batched_cuda: K must be on a CUDA device")
    if K.dtype != torch.float32:
        raise TypeError("cholesky_batched_cuda: the kernel takes float32 only")
    if K.ndim not in (2, 3) or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"cholesky_batched_cuda: K must be [n, n] or [nb, n, n], got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError("cholesky_batched_cuda: K must be contiguous")
    n = K.shape[-1]
    nb = K.shape[0] if K.ndim == 3 else 1
    if K.numel() == 0:
        return torch.empty_like(K)
    fn, scratch_floats = _lib()
    n_pad = _padded(n)
    opts = dict(dtype=torch.float32, device=K.device)
    L = torch.empty((nb, n_pad, n_pad), **opts)
    # the next diagonal block; on a large stack in B5's domain also its
    # inverse and the outer panel's rows, k-major
    floats = scratch_floats(nb, n, n_pad)
    if floats < 0:
        raise RuntimeError("chol_batched kernel: could not read the CUDA device")
    scratch = torch.empty((floats,), **opts)
    stream = torch.cuda.current_stream(K.device).cuda_stream
    err = fn(K.data_ptr(), L.data_ptr(), scratch.data_ptr(), nb, n, n_pad, stream)
    if err != 0:
        raise RuntimeError(f"chol_batched kernel launch failed: CUDA error {err}")
    cholesky_batched_cuda.launches += 1
    cholesky_batched_cuda.shapes[(nb, n)] += 1
    if batched_domain(nb, n):
        cholesky_batched_cuda.batched_launches += 1
    if n_pad != n:
        L = L[:, :n, :n].contiguous()
    return L if K.ndim == 3 else L[0]


#: kernel launches since the count was last set to 0
cholesky_batched_cuda.launches = 0
#: of those, launches on a stack in ``cholesky_pallas_batched``'s domain
#: (nb ≥ 2, n % 128 == 0, n ≥ 256); the rest are ``cholesky_pallas``'s
cholesky_batched_cuda.batched_launches = 0
#: the launches by shape (nb, n)
cholesky_batched_cuda.shapes = collections.Counter()


def cholesky_batched(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``K``, ``[n, n]`` or ``[nb, n, n]``.

    CPU tensors take :func:`cholesky_batched_plain`; CUDA tensors launch
    the kernel (f32 only) or raise.  An indefinite matrix gives a
    non-finite factor, and only that matrix.
    """
    if K.device.type == "cpu":
        return cholesky_batched_plain(K)
    return cholesky_batched_cuda(K)
