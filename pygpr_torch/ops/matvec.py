"""Fused RBF gram-matvec, the gram never stored (kernel K4).

Counterpart of ``pygpr_tpu/ops/pallas_matvec.py``.  For the bare
:class:`~pygpr_torch.ops.kernels.RBF` signal kernel with
``theta = [σ, ℓ₁..ℓ_d]``:

    out = σ² exp(−‖(xᵢ − xⱼ)⊙ℓ‖²) @ V,    x [n, d], V [n, k] → [n, k]

On a CUDA tensor :func:`rbf_gram_matvec` launches the hand-written kernel
in ``csrc/rbf_gram_matvec.cu`` (f32 only), in the regime, template width
and column-sweep splits that :func:`plan` picks; on a CPU tensor it runs
:func:`rbf_gram_matvec_plain`, the same function in torch ops, one tile
of rows at a time.  Both use direct differences Σₘ(xℓᵢₘ − xℓⱼₘ)², not
the matmul trick, so the diagonal is exact.  The noise term is the
caller's (``models.iterative.gram_matvec`` adds ``(σₙ² + jitter)·V``).

The backward is the Pallas kernel's custom VJP: every cotangent comes
from ONE more launch of the same kernel on the batched columns
``[W̄, x∘V, x²∘V, x∘W̄]`` and a few reductions; the ``x∘W̄`` columns are
left out when x needs no gradient (the iterative NLML never asks for it).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from pygpr_torch.ops.gram import MAX_DIM

#: largest tile of the plain version, in elements of its [rows, n] block
PLAIN_TILE_ELEMS = 1 << 25
#: widest V the wrapper takes
MAX_COLS = 16 * 65535
#: the kernel's narrow templates (each thread holds every column of V): a
#: width k ≤ 16 runs at the first of these that is ≥ k
NARROW_WIDTHS = (1, 2, 4, 5, 8, 9, 12, 16)
#: the wide templates' columns of V a block (k > 16), with the rows a
#: block of each.  These tables and :func:`narrow_rows` copy the kernel's
#: geometry; the first launch holds them against the library's own
#: (``rbf_gram_matvec_geometry``) and raises if they differ
WIDE_ROWS = {48: 128, 128: 128}
#: column points a step of each regime (csrc: TC and BK); a split of the
#: column sweep holds at least two steps
STEP = {"narrow": 256, "wide": 32}
#: the plan splits the column sweep until the grid holds this many blocks
#: an SM, or the splits would fall below two steps each.  It counts blocks
#: of the grid, not blocks resident at once (the widths 5 to 9 fit one
#: block an SM); 2 was chosen in a trial on the H100, where 8 read slower
#: at k = 8 and 9
BLOCKS_PER_SM = 2
#: streaming multiprocessors of an H100 SXM, for a plan made without a card
H100_SMS = 132


def narrow_rows(width: int) -> int:
    """Rows a narrow block owns: 32 lanes times the rows a thread holds
    (csrc: Narrow<KC>::R, as registers allow)."""
    return 32 * (8 if width <= 9 else 2)


def template_width(k: int) -> int:
    """The template that runs V of width k: the first narrow width ≥ k, or
    for k > 16 the wide block width of least padding (the larger on a tie)."""
    if k <= NARROW_WIDTHS[-1]:
        return next(w for w in NARROW_WIDTHS if w >= k)
    return min(WIDE_ROWS, key=lambda bn: (-(-k // bn) * bn, -bn))


def plan(n: int, k: int, sms: int = H100_SMS) -> dict:
    """K4's launch for x [n, d], V [n, k] on a card of ``sms`` SMs: regime,
    template width, rows a block, column tiles, splits of the column sweep
    and the blocks of the grid."""
    width = template_width(k)
    regime = "narrow" if width <= NARROW_WIDTHS[-1] else "wide"
    rows, step = geometry(width)
    col_tiles = 1 if regime == "narrow" else -(-k // width)
    tiles = -(-n // rows) * col_tiles
    max_splits = max(1, n // (2 * step))
    splits = 1
    while tiles * splits < BLOCKS_PER_SM * sms and 2 * splits <= max_splits:
        splits *= 2
    return {"regime": regime, "width": width, "rows": rows, "col_tiles": col_tiles, "splits": splits,
            "blocks": tiles * splits}


def rbf_gram_matvec_plain(theta: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops, on any device and dtype: one
    ``[rows, n]`` tile of exponentials at a time, times V."""
    sig, ls = theta[0], theta[1:]
    xl = x * ls
    n, d = x.shape
    rows = max(1, PLAIN_TILE_ELEMS // n)
    outs = []
    for lo in range(0, n, rows):
        xr = xl[lo:lo + rows]
        sqd = torch.zeros((xr.shape[0], n), dtype=x.dtype, device=x.device)
        for m in range(d):
            diff = xr[:, m, None] - xl[None, :, m]
            sqd = sqd + diff * diff
        outs.append(torch.exp(-sqd) @ v)
    return torch.square(sig) * torch.cat(outs)


def geometry(width: int) -> tuple:
    """(rows a block, column points a step) of template ``width``, as
    :func:`plan` counts them."""
    if width in WIDE_ROWS:
        return WIDE_ROWS[width], STEP["wide"]
    return narrow_rows(width), STEP["narrow"]


@functools.lru_cache(maxsize=None)
def _lib():
    from pygpr_torch.ops import _build

    lib = _build.load("rbf_gram_matvec")
    geom = lib.rbf_gram_matvec_geometry
    geom.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    geom.restype = ctypes.c_int
    for width in NARROW_WIDTHS + tuple(WIDE_ROWS):
        got = (ctypes.c_int * 2)()
        err = geom(width, got)
        if err != 0 or tuple(got) != geometry(width):
            raise RuntimeError(f"rbf_gram_matvec: the plan's geometry of width {width}, {geometry(width)}, "
                               f"is not the kernel's ({'none' if err else tuple(got)})")
    fn = lib.rbf_gram_matvec_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rbf_gram_matvec_cuda(theta: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/rbf_gram_matvec.cu`` on PyTorch's current stream.

    ``x`` [n, d], ``theta`` [d + 1] and ``v`` [n, k]: f32, contiguous, on
    one CUDA device, 1 ≤ d ≤ :data:`MAX_DIM`, 1 ≤ k ≤ :data:`MAX_COLS`.
    Raises on anything else.  When :func:`plan` splits the column sweep,
    a scratch ``[splits, n, k]`` holds the splits' sums.
    """
    if x.device.type != "cuda" or theta.device != x.device or v.device != x.device:
        raise ValueError("rbf_gram_matvec_cuda: theta, x and v must share a CUDA device")
    if x.dtype != torch.float32 or theta.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("rbf_gram_matvec_cuda: the kernel takes float32 only")
    if x.ndim != 2 or not 1 <= x.shape[1] <= MAX_DIM or x.shape[0] < 1:
        raise ValueError(f"rbf_gram_matvec_cuda: x must be [n, d<={MAX_DIM}], got {tuple(x.shape)}")
    n, d = x.shape
    if theta.shape != (d + 1,):
        raise ValueError(f"rbf_gram_matvec_cuda: theta must be [{d + 1}], got {tuple(theta.shape)}")
    if v.ndim != 2 or v.shape[0] != n or not 1 <= v.shape[1] <= MAX_COLS:
        raise ValueError(f"rbf_gram_matvec_cuda: v must be [{n}, 1..{MAX_COLS}], got {tuple(v.shape)}")
    if not (x.is_contiguous() and theta.is_contiguous() and v.is_contiguous()):
        raise ValueError("rbf_gram_matvec_cuda: inputs must be contiguous")
    fn = _lib()
    k = v.shape[1]
    p = plan(n, k, _sms(x.device))
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    part = torch.empty((p["splits"], n, k), dtype=torch.float32, device=x.device) if p["splits"] > 1 else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), theta.data_ptr(), v.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
             n, d, k, p["width"], p["splits"], stream)
    if err != 0:
        raise RuntimeError(f"rbf_gram_matvec kernel launch failed: CUDA error {err}")
    rbf_gram_matvec_cuda.launches += 1
    rbf_gram_matvec_cuda.shapes[(n, d, k)] += 1
    return out


#: kernel launches since the count was last set to 0
rbf_gram_matvec_cuda.launches = 0
#: the same launches by shape (n, d, k)
rbf_gram_matvec_cuda.shapes = collections.Counter()


def _matvec(theta, x, v):
    if x.device.type == "cpu":
        return rbf_gram_matvec_plain(theta, x, v)
    return rbf_gram_matvec_cuda(theta, x, v)


class _RbfGramMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, x, v):
        theta, x, v = theta.contiguous(), x.contiguous(), v.contiguous()
        out = _matvec(theta, x, v)
        ctx.save_for_backward(theta, x, v, out)
        return out

    @staticmethod
    def backward(ctx, wbar):
        theta, x, v, out = ctx.saved_tensors
        need_x = ctx.needs_input_grad[1]
        sig, ls = theta[0], theta[1:]
        n, d = x.shape
        k = v.shape[1]
        wbar = wbar.contiguous()
        xm = x[:, :, None]
        # one launch gives every cotangent: K W̄ (→ v̄), K(x∘V), K(x²∘V)
        # (→ ℓ̄) and, only when x needs one, K(x∘W̄) (→ x̄)
        cols = [wbar, (xm * v[:, None, :]).reshape(n, d * k), (xm * xm * v[:, None, :]).reshape(n, d * k)]
        if need_x:
            cols.append((xm * wbar[:, None, :]).reshape(n, d * k))
        big = _matvec(theta, x, torch.cat(cols, dim=1))
        vbar = big[:, :k]
        kxv = big[:, k:k + d * k].reshape(n, d, k)
        kx2v = big[:, k + d * k:k + 2 * d * k].reshape(n, d, k)

        # ∂K/∂σ = 2K/σ  ⇒  σ̄ = (2/σ)·Σ W̄∘out
        r = torch.sum(wbar * out, dim=1)
        sig_bar = (2.0 / sig) * torch.sum(r)
        # ∂K/∂ℓₘ = −2ℓₘ (xₘ − x'ₘ)² K, with (x − x')² = x² − 2xx' + x'²
        term_r = torch.einsum("nk,ndk->nd", wbar, kxv)
        t1 = r @ torch.square(x)
        t2 = torch.sum(x * term_r, dim=0)
        t3 = torch.einsum("nk,ndk->d", wbar, kx2v)
        ls_bar = -2.0 * ls * (t1 - 2.0 * t2 + t3)
        theta_bar = torch.cat([sig_bar[None], ls_bar])

        x_bar = None
        if need_x:
            # x appears in K's rows and columns
            kxw = big[:, k + 2 * d * k:].reshape(n, d, k)
            c = torch.sum(v * vbar, dim=1)
            term_c = torch.einsum("nk,ndk->nd", v, kxw)
            x_bar = -2.0 * torch.square(ls)[None, :] * (x * (r + c)[:, None] - term_r - term_c)
        return theta_bar, x_bar, vbar


def rbf_gram_matvec(theta: torch.Tensor, x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable ``K_RBF(x, x) @ v`` with the gram never stored.

    ``theta = [σ, ℓ₁..ℓ_d]`` (signal kernel only), ``v: [n, k]``.  CPU
    tensors take :func:`rbf_gram_matvec_plain`; CUDA tensors launch the
    kernel (f32 only) or raise.  Differentiable in all three arguments;
    the backward is one more launch.
    """
    return _RbfGramMatvec.apply(theta, x, v)


def supported(kern, x: torch.Tensor) -> bool:
    """True iff the fused path computes ``kern`` exactly: a bare
    :class:`~pygpr_torch.ops.kernels.RBF` signal kernel on an f32
    ``[n, d]`` input of a width the kernel takes."""
    from pygpr_torch.ops.kernels import RBF

    return type(kern) is RBF and x.dtype == torch.float32 and x.ndim == 2 and 1 <= x.shape[1] <= MAX_DIM
