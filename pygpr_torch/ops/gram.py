"""Fused RBF + white-noise train grams (kernel K1), one or a stack.

Counterpart of ``pygpr_tpu/ops/pallas_kernels.py``.  For the canonical
``Sum((RBF(), WhiteNoise()))`` with packed ``params = [σ, ℓ₁..ℓ_d, σₙ]``:

    K = σ² exp(−‖(x − x')⊙ℓ‖²) + σₙ² I

A stack is the JAX package's ``jax.vmap`` of the Pallas gram written out
as a batch axis: ``x [nb, n, d]`` or one shared ``x [n, d]``, with
``params [nb, d + 2]`` or one shared ``[d + 2]``, give ``[nb, n, n]``; an
unbatched pair gives ``[n, n]``.  On a CUDA tensor :func:`rbf_noise_gram`
launches the hand-written kernel in ``csrc/rbf_noise_gram.cu`` once for
the whole stack (f32 only; a shared x or θ is passed with batch stride 0,
never copied); on a CPU tensor it runs :func:`rbf_noise_gram_plain`, the
same arithmetic in torch ops.  Both use direct differences
Σₖ(xℓᵢₖ − xℓⱼₖ)², not the matmul trick, so the diagonal is exact.

The backward is the Pallas kernel's custom VJP as torch ops under
``vmap``: every gradient is a reduction or one batched GEMM over
W = K̄ ⊙ K, reduced over the stack for a shared input.  The fast NLML
gradient does not use it (``Sum.gram_adjoint`` covers it); the ``"ad"``
gradient mode and the samplers' autograd do.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

#: widest input the kernel stages in shared memory
MAX_DIM = 64


def rbf_noise_gram_plain(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops, on any device and dtype, over
    the same batched shapes as :func:`rbf_noise_gram`."""
    sig, ls, sig_n = params[..., 0], params[..., 1:-1], params[..., -1]
    xl = x * ls[..., None, :]
    n, d = x.shape[-2:]
    sqd = torch.zeros(xl.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    for k in range(d):
        diff = xl[..., :, None, k] - xl[..., None, :, k]
        sqd = sqd + diff * diff
    K = torch.square(sig)[..., None, None] * torch.exp(-sqd)
    K.diagonal(dim1=-2, dim2=-1).add_(torch.square(sig_n)[..., None])
    return K


@functools.lru_cache(maxsize=None)
def _lib():
    from pygpr_torch.ops import _build

    fn = _build.load("rbf_noise_gram").rbf_noise_gram_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _batch_stride(t: torch.Tensor, core: int, name: str) -> int:
    """The batch stride (elements) to pass for ``t``, ``[*core dims]`` or
    ``[nb, *core dims]``: 0 for one shared core (unbatched, or one
    contiguous core expanded with stride 0), else the stride of a
    contiguous stack."""
    batched = t.ndim > core
    if batched and t.stride(0) == 0 and t[0].is_contiguous():
        return 0
    if t.is_contiguous():
        return t.stride(0) if batched else 0
    raise ValueError(f"rbf_noise_gram_cuda: {name} must be contiguous, or one contiguous {name} expanded")


def stack_bytes(nb: int, n: int, d: int, nx: int, nparams: int) -> float:
    """Bytes a call must move: each of the ``nx`` distinct inputs
    ``[n, d]`` and ``nparams`` distinct θ ``[d + 2]`` read once (1 when
    shared by the stack, else nb), and the nb grams written once."""
    return 4.0 * (nb * n * n + nx * n * d + nparams * (d + 2))


def rbf_noise_gram_cuda(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rbf_noise_gram.cu`` once on PyTorch's current stream.

    ``x`` [n, d] or [nb, n, d] and ``params`` [d + 2] or [nb, d + 2]: f32,
    on one CUDA device, 1 ≤ d ≤ :data:`MAX_DIM`, contiguous or one
    contiguous tensor expanded along the stack (batch stride 0).  Returns
    ``[nb, n, n]`` if either is batched, else ``[n, n]``.  Raises on
    anything else.
    """
    dev = x.device
    if dev.type != "cuda" or params.device != dev:
        raise ValueError("rbf_noise_gram_cuda: x and params must share a CUDA device")
    if x.dtype != torch.float32 or params.dtype != torch.float32:
        raise TypeError("rbf_noise_gram_cuda: the kernel takes float32 only")
    batched_x, batched_p = x.ndim == 3, params.ndim == 2
    if not (batched_x or x.ndim == 2) or not 1 <= x.shape[-1] <= MAX_DIM or x.shape[-2] < 1:
        raise ValueError(f"rbf_noise_gram_cuda: x must be [n, d<={MAX_DIM}] or [nb, n, d], got {tuple(x.shape)}")
    n, d = x.shape[-2], x.shape[-1]
    if not (batched_p or params.ndim == 1) or params.shape[-1] != d + 2:
        raise ValueError(f"rbf_noise_gram_cuda: params must be [{d + 2}] or [nb, {d + 2}], got {tuple(params.shape)}")
    nb = x.shape[0] if batched_x else params.shape[0] if batched_p else 1
    if nb < 1 or (batched_x and batched_p and params.shape[0] != nb):
        raise ValueError(f"rbf_noise_gram_cuda: x {tuple(x.shape)} and params {tuple(params.shape)} "
                         "disagree on the stack")
    x_stride = _batch_stride(x, 2, "x")
    p_stride = _batch_stride(params, 1, "params")
    nx, nparams = (nb if x_stride else 1), (nb if p_stride else 1)
    fn = _lib()
    out = torch.empty((nb, n, n) if batched_x or batched_p else (n, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(x.data_ptr(), x_stride, params.data_ptr(), p_stride, out.data_ptr(), nb, n, d, stream)
    if err != 0:
        raise RuntimeError(f"rbf_noise_gram kernel launch failed: CUDA error {err}")
    rbf_noise_gram_cuda.launches += 1
    rbf_noise_gram_cuda.matrices += nb
    rbf_noise_gram_cuda.shapes[(nb, n, d, nx, nparams)] += 1
    return out


#: kernel launches since the count was last set to 0
rbf_noise_gram_cuda.launches = 0
#: grams those launches wrote (nb a launch)
rbf_noise_gram_cuda.matrices = 0
#: the same launches by (nb, n, d, nx, nparams): the stack's shape and how
#: many distinct x and θ it read (1 when shared, else nb)
rbf_noise_gram_cuda.shapes = collections.Counter()


def _gram(params, x):
    if x.device.type == "cpu":
        return rbf_noise_gram_plain(params, x)
    return rbf_noise_gram_cuda(params, x)


def _sum_to(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A cotangent over the stack summed to a shared input's rank."""
    return t.sum(0) if t.ndim > ndim else t


class _RbfNoiseGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, x):
        K = _gram(params, x)
        ctx.save_for_backward(params, x, K)
        return K

    @staticmethod
    def backward(ctx, Kbar):
        params, x, K = ctx.saved_tensors
        sig, ls, sig_n = params[..., 0], params[..., 1:-1], params[..., -1]
        diag_kbar = Kbar.diagonal(dim1=-2, dim2=-1).sum(-1)
        # W = K̄ ⊙ R with R the RBF part: only σ̄ sees the noise diagonal,
        # so correct the scalar sum; x̄ℓ is blind to it (xℓᵢ − xℓᵢ = 0).
        W = Kbar * K
        sig_bar = (2.0 / sig) * (W.sum((-2, -1)) - torch.square(sig_n) * diag_kbar)
        noise_bar = 2.0 * sig_n * diag_kbar
        xl = x * ls[..., None, :]
        Wsym = W + W.mT
        del W  # a [16, 6400, 6400] stack's W is 2.6 GB
        xl_bar = -2.0 * (Wsym.sum(-1, keepdim=True) * xl - Wsym @ xl)
        ls_bar = (xl_bar * x).sum(-2)
        params_bar = torch.cat([sig_bar[..., None], ls_bar, noise_bar[..., None]], dim=-1)
        x_bar = _sum_to(xl_bar * ls[..., None, :], x.ndim) if ctx.needs_input_grad[1] else None
        return _sum_to(params_bar, params.ndim), x_bar


def rbf_noise_gram(params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Differentiable K = σ² exp(−‖(x−x')⊙ℓ‖²) + σₙ² I, one or a stack
    (shapes as :func:`rbf_noise_gram_cuda`'s).

    CPU tensors take :func:`rbf_noise_gram_plain`; CUDA tensors launch
    the kernel once (f32 only) or raise.
    """
    return _RbfNoiseGram.apply(params, x)


def takes(x: torch.Tensor) -> bool:
    """Dtype and shape rule of the dispatch in ``ops.kernels.train_gram``:
    f32 ``[n, d]`` or ``[nb, n, d]``, d ≤ MAX_DIM."""
    return x.dtype == torch.float32 and x.ndim in (2, 3) and 1 <= x.shape[-1] <= MAX_DIM


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
