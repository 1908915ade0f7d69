"""Fused RBF + white-noise train gram (kernel K1).

Counterpart of ``pygpr_tpu/ops/pallas_kernels.py``.  For the canonical
``Sum((RBF(), WhiteNoise()))`` with packed ``params = [σ, ℓ₁..ℓ_d, σₙ]``:

    K = σ² exp(−‖(x − x')⊙ℓ‖²) + σₙ² I

On a CUDA tensor :func:`rbf_noise_gram` launches the hand-written kernel
in ``csrc/rbf_noise_gram.cu`` (f32 only); on a CPU tensor it runs
:func:`rbf_noise_gram_plain`, the same arithmetic in torch ops.  Both
use direct differences Σₖ(xℓᵢₖ − xℓⱼₖ)², not the matmul trick, so the
diagonal is exact.

The backward is the Pallas kernel's custom VJP as torch ops: every
gradient is a reduction or one GEMM over W = K̄ ⊙ K.  The fast NLML
gradient does not use it (``Sum.gram_adjoint`` covers it); the ``"ad"``
gradient mode does.
"""

from __future__ import annotations

import collections
import ctypes

import torch

#: widest input the kernel stages in its 48 KB of static shared memory
MAX_DIM = 64


def rbf_noise_gram_plain(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops, on any device and dtype."""
    sig, ls, sig_n = params[0], params[1:-1], params[-1]
    xl = x * ls
    n, d = x.shape
    sqd = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    for k in range(d):
        diff = xl[:, k, None] - xl[None, :, k]
        sqd = sqd + diff * diff
    K = torch.square(sig) * torch.exp(-sqd)
    K.diagonal().add_(torch.square(sig_n))
    return K


def _lib():
    from pygpr_torch.ops import _build

    lib = _build.load("rbf_noise_gram")
    fn = lib.rbf_noise_gram_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rbf_noise_gram_cuda(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rbf_noise_gram.cu`` on PyTorch's current stream.

    ``x`` [n, d] and ``params`` [d + 2]: f32, contiguous, on one CUDA
    device, 1 ≤ d ≤ :data:`MAX_DIM`.  Raises on anything else.
    """
    if x.device.type != "cuda" or params.device != x.device:
        raise ValueError("rbf_noise_gram_cuda: x and params must share a CUDA device")
    if x.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("rbf_noise_gram_cuda: the kernel takes float32 only")
    if x.ndim != 2 or not 1 <= x.shape[1] <= MAX_DIM or x.shape[0] < 1:
        raise ValueError(f"rbf_noise_gram_cuda: x must be [n, d<={MAX_DIM}], got {tuple(x.shape)}")
    n, d = x.shape
    if params.shape != (d + 2,):
        raise ValueError(f"rbf_noise_gram_cuda: params must be [{d + 2}], got {tuple(params.shape)}")
    if not (x.is_contiguous() and params.is_contiguous()):
        raise ValueError("rbf_noise_gram_cuda: inputs must be contiguous")
    fn = _lib()
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), params.data_ptr(), out.data_ptr(), n, d, stream)
    if err != 0:
        raise RuntimeError(f"rbf_noise_gram kernel launch failed: CUDA error {err}")
    rbf_noise_gram_cuda.launches += 1
    rbf_noise_gram_cuda.shapes[(n, d)] += 1
    return out


#: kernel launches since the count was last set to 0
rbf_noise_gram_cuda.launches = 0
#: the same launches by shape (n, d)
rbf_noise_gram_cuda.shapes = collections.Counter()


def _gram(params, x):
    if x.device.type == "cpu":
        return rbf_noise_gram_plain(params, x)
    return rbf_noise_gram_cuda(params, x)


class _RbfNoiseGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, x):
        K = _gram(params, x)
        ctx.save_for_backward(params, x, K)
        return K

    @staticmethod
    def backward(ctx, Kbar):
        params, x, K = ctx.saved_tensors
        sig, ls, sig_n = params[0], params[1:-1], params[-1]
        diag_kbar = Kbar.diagonal().sum()
        # W = K̄ ⊙ R with R the RBF part: only σ̄ sees the noise diagonal,
        # so correct the scalar sum; x̄ℓ is blind to it (xℓᵢ − xℓᵢ = 0).
        W = Kbar * K
        sig_bar = (2.0 / sig) * (W.sum() - torch.square(sig_n) * diag_kbar)
        noise_bar = 2.0 * sig_n * diag_kbar
        xl = x * ls
        Wsym = W + W.T
        xl_bar = -2.0 * (Wsym.sum(dim=1, keepdim=True) * xl - Wsym @ xl)
        ls_bar = (xl_bar * x).sum(dim=0)
        params_bar = torch.cat([sig_bar[None], ls_bar, noise_bar[None]])
        x_bar = xl_bar * ls if ctx.needs_input_grad[1] else None
        return params_bar, x_bar


def rbf_noise_gram(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable K = σ² exp(−‖(x−x')⊙ℓ‖²) + σₙ² I.

    CPU tensors take :func:`rbf_noise_gram_plain`; CUDA tensors launch
    the kernel (f32 only) or raise.
    """
    return _RbfNoiseGram.apply(params, x)


def takes(x: torch.Tensor) -> bool:
    """Dtype and shape rule of the dispatch in ``ops.kernels.train_gram``."""
    return x.dtype == torch.float32 and x.ndim == 2 and 1 <= x.shape[1] <= MAX_DIM


def matches_rbf_noise(kern) -> bool:
    """True iff ``kern`` is the canonical RBF+WhiteNoise sum that
    :func:`rbf_noise_gram` implements."""
    from pygpr_torch.ops.kernels import RBF, Sum, WhiteNoise

    return (
        isinstance(kern, Sum)
        and len(kern.kernels) == 2
        and isinstance(kern.kernels[0], RBF)
        and isinstance(kern.kernels[1], WhiteNoise)
    )
