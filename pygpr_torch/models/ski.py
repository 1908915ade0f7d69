"""SKI / KISS-GP — structured kernel interpolation on a uniform grid.

Counterpart of ``pygpr_tpu/models/ski.py``.  SKI (Wilson & Nickisch, ICML
2015) approximates the gram by interpolating every datapoint onto a fixed
Cartesian grid,

    K(x, x)  ≈  W · K_grid · Wᵀ,

with ``W [n, G]`` a sparse cubic-interpolation matrix (4 nodes per
dimension per point) and, for a kernel that is a tensor product over
dimensions (RBF, ``Separable``), ``K_grid = σ²·T₁ ⊗ … ⊗ T_d`` with
``(T_j)_{ab} = φ(ℓ_j·h_j·|a−b|)``.  Two paths:

  * **Krylov**: the matvec ``(W·K_grid·Wᵀ + σₙ²I)·v`` (per-axis dense
    GEMMs for the Kronecker factor, a gather for ``W`` and an
    ``index_add_`` for ``Wᵀ``) injected into the port's matrix-free engine
    (:mod:`pygpr_torch.models.iterative`): PCG, pivoted-Cholesky
    preconditioner, SLQ log-determinant, Hutchinson gradient, Adam fit.
    On the card ``index_add_`` is an f32 atomic, so the order of its sums
    varies from run to run.
  * **Direct Woodbury** (``G ≤ direct_max``): exact O(G³) NLML from three
    hyperparameter-free statistics (``Z = WᵀW``, ``Wᵀy``, ``yᵀy``), the
    laddered Cholesky of each grid factor and of ``Z`` (K3 on the card for
    an f32 ``[g, g]`` with g ≤ 1024, ``ops/linalg.py``), and a QR of the
    stacked capacitance system.

The interpolation geometry (indices and weights) is host NumPy, computed
once.  The streamed statistics are accumulated in f64 NumPy
(``np.bincount`` over the tap pairs), not in a native library.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor, default_dtype
from pygpr_torch.models import iterative
from pygpr_torch.ops.kernels import RBF, Kernel, Separable
from pygpr_torch.ops.linalg import cholesky_solve, safe_cholesky, solve_lower

Tensor = torch.Tensor

__all__ = [
    "Grid",
    "make_grid",
    "interp_weights",
    "grid_gram_factors",
    "kron_matvec",
    "interp_matvec",
    "interp_t_matvec",
    "make_ski_matvec",
    "ski_gram_matvec",
    "nlml_value_and_grad",
    "fit",
    "predict",
    "SKIStats",
    "compute_stats",
    "compute_stats_streamed",
    "nlml_direct",
    "fit_direct",
    "predict_direct",
    "SKIGP",
]


class Grid(NamedTuple):
    """Uniform Cartesian product grid: ``lo[j] + h[j]·i`` for
    ``i < sizes[j]``."""

    lo: np.ndarray      #: [d] first node per dimension
    h: np.ndarray       #: [d] spacing per dimension
    sizes: Tuple[int, ...]

    @property
    def total(self) -> int:
        return int(np.prod(self.sizes))

    def axis_points(self, j: int) -> np.ndarray:
        return self.lo[j] + self.h[j] * np.arange(self.sizes[j])


def make_grid(x, sizes) -> Grid:
    """Bounding-box grid with a 2-cell margin (full cubic stencils).

    ``sizes``: int (same per dim) or per-dimension sequence.  Host NumPy.
    """
    x = _host(x)
    d = x.shape[-1]
    if isinstance(sizes, (int, np.integer)):
        sizes = (int(sizes),) * d
    sizes = tuple(int(s) for s in sizes)
    if len(sizes) != d:
        raise ValueError(f"need {d} grid sizes, got {len(sizes)}")
    if min(sizes) < 8:
        raise ValueError("grid needs >= 8 nodes per dimension")
    mins = x.min(axis=0).astype(np.float64)
    maxs = x.max(axis=0).astype(np.float64)
    span = np.maximum(maxs - mins, 1e-12)
    # margin: interior span covers the data with >=2 spare cells/side
    h = span / (np.asarray(sizes) - 5)
    lo = mins - 2.0 * h
    return Grid(lo=lo, h=h, sizes=sizes)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)


def _cubic_taps(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Keys cubic-convolution stencil (a = −1/2).

    ``t``: fractional grid coordinate, any shape.  Returns ``(i0, w4)``
    with ``i0 = floor(t) − 1`` (leftmost tap) and ``w4[..., 4]`` the tap
    weights (rows sum to 1; reproduces quadratics exactly).
    """
    i0 = np.floor(t).astype(np.int64) - 1
    s = t - np.floor(t)  # in [0, 1)
    # distances |t - tap| are 1+s, s, 1-s, 2-s for taps i0..i0+3
    w = np.empty(t.shape + (4,), dtype=np.float64)
    u = 1.0 + s  # in [1, 2): outer branch  -0.5u³ + 2.5u² - 4u + 2
    w[..., 0] = ((-0.5 * u + 2.5) * u - 4.0) * u + 2.0
    u = s        # in [0, 1): inner branch   1.5u³ - 2.5u² + 1
    w[..., 1] = (1.5 * u - 2.5) * u * u + 1.0
    u = 1.0 - s
    w[..., 2] = (1.5 * u - 2.5) * u * u + 1.0
    u = 2.0 - s
    w[..., 3] = ((-0.5 * u + 2.5) * u - 4.0) * u + 2.0
    return i0, w


def interp_weights(x, grid: Grid) -> Tuple[np.ndarray, np.ndarray]:
    """Per-dimension cubic stencils for every point (host NumPy).

    Returns ``(idx [n, d, 4] int32, wts [n, d, 4] float64)`` — the sparse
    rows of ``W`` in tensor-product form.  Stencils are clamped at the
    boundary.
    """
    x = np.asarray(_host(x), np.float64)
    n, d = x.shape
    idx = np.empty((n, d, 4), np.int64)
    wts = np.empty((n, d, 4), np.float64)
    for j in range(d):
        t = (x[:, j] - grid.lo[j]) / grid.h[j]
        i0, w4 = _cubic_taps(t)
        i0 = np.clip(i0, 0, grid.sizes[j] - 4)
        idx[:, j, :] = i0[:, None] + np.arange(4)[None, :]
        wts[:, j, :] = w4
    return idx.astype(np.int32), wts


def _strides(sizes: Tuple[int, ...]) -> np.ndarray:
    d = len(sizes)
    strides = np.ones(d, np.int64)
    for j in range(d - 2, -1, -1):
        strides[j] = strides[j + 1] * sizes[j + 1]
    return strides


def _flat_taps(idx, wts, sizes: Tuple[int, ...]):
    """Yield ``(flat_index [n], weight [n])`` per tensor-product tap, over
    the 4^d stencil combinations (tensors or NumPy arrays alike)."""
    d = len(sizes)
    strides = _strides(sizes)
    for combo in itertools.product(range(4), repeat=d):
        flat = idx[:, 0, combo[0]].astype(np.int64) if isinstance(idx, np.ndarray) else idx[:, 0, combo[0]].long()
        flat = flat * int(strides[0])
        w = wts[:, 0, combo[0]]
        for j in range(1, d):
            fj = idx[:, j, combo[j]]
            flat = flat + (fj.astype(np.int64) if isinstance(fj, np.ndarray) else fj.long()) * int(strides[j])
            w = w * wts[:, j, combo[j]]
        yield flat, w


def interp_matvec(idx: Tensor, wts: Tensor, sizes: Tuple[int, ...], u: Tensor) -> Tensor:
    """``W @ u``: grid values ``u [G, k]`` → point values ``[n, k]``."""
    out = None
    for flat, w in _flat_taps(idx, wts, sizes):
        term = w[:, None] * u[flat]
        out = term if out is None else out + term
    return out


def interp_t_matvec(idx: Tensor, wts: Tensor, sizes: Tuple[int, ...], v: Tensor, total: int) -> Tensor:
    """``Wᵀ @ v``: point values ``v [n, k]`` → grid ``[G, k]``
    (``index_add`` over the 4^d taps; f32 atomics on the card)."""
    out = torch.zeros((total, v.shape[-1]), dtype=v.dtype, device=v.device)
    for flat, w in _flat_taps(idx, wts, sizes):
        out = out.index_add(0, flat, w[:, None] * v)
    return out


def _rbf_profile(r: Tensor) -> Tensor:
    return torch.exp(-torch.square(r))


def _profile_of(kern: Kernel):
    """1-D correlation profile φ(r) of a grid-factorizable kernel: RBF
    and ``Separable`` factorize over a Cartesian grid; anything else
    raises."""
    if isinstance(kern, Separable):
        return kern.profile_fn
    if isinstance(kern, RBF):
        return _rbf_profile
    raise ValueError(
        "SKI's Kronecker grid gram requires a separable kernel (RBF "
        f"or Separable); got {type(kern).__name__}"
    )


def _axis_diff(grid: Grid, j: int, dtype, device) -> Tensor:
    pts = torch.arange(grid.sizes[j], dtype=dtype, device=device) * torch.as_tensor(grid.h[j], dtype=dtype)
    return pts[:, None] - pts[None, :]


def grid_gram_factors(theta: Tensor, grid: Grid, dtype, profile=None) -> Sequence[Tensor]:
    """Per-dimension grid grams ``T_j [g_j, g_j]`` on ``theta``'s device.

    ``K_grid = σ²·T₁ ⊗ … ⊗ T_d`` with ``(T_j)_{ab} = φ(ℓ_j·h_j·|a−b|)``
    (``φ`` defaults to the RBF profile); σ² is folded into the first
    factor.  Differentiable in ``theta = [σ, ℓ…]``.
    """
    profile = _rbf_profile if profile is None else profile
    sig, ls = theta[0], theta[1:]
    factors = []
    for j in range(len(grid.sizes)):
        t = profile(torch.abs(ls[j]) * torch.abs(_axis_diff(grid, j, dtype, theta.device)))
        if j == 0:
            t = torch.square(sig) * t
        factors.append(t)
    return factors


def kron_matvec(factors: Sequence[Tensor], sizes: Tuple[int, ...], u: Tensor) -> Tensor:
    """``(T₁ ⊗ … ⊗ T_d) @ u`` for ``u [G, k]`` by per-axis GEMMs: reshape
    to ``[g₁, …, g_d, k]`` and contract each grid axis with its factor."""
    k = u.shape[-1]
    t = u.reshape(tuple(sizes) + (k,))
    for j, f in enumerate(factors):
        t = torch.movedim(torch.tensordot(f, t, dims=([1], [j])), 0, j)
    return t.reshape(int(np.prod(sizes)), k)


def _as_cols(v: Tensor) -> Tuple[Tensor, bool]:
    return (v[:, None], True) if v.ndim == 1 else (v, False)


def _geometry(x, grid: Grid, device=None):
    """``(x tensor, idx, wts)``: x on its device (NumPy → ``device``), the
    stencils on the same device, the weights in x's dtype."""
    xt = as_tensor(x, device)
    idx_np, wts_np = interp_weights(xt, grid)
    return (xt, torch.as_tensor(idx_np, device=xt.device),
            torch.as_tensor(wts_np, dtype=xt.dtype, device=xt.device))


def make_ski_matvec(kern: Kernel, x, grid: Grid, *, config: Config = DEFAULT,
                    device=None) -> Callable[[Tensor, Tensor], Tensor]:
    """Build the injectable ``matvec(params, v)`` for the Krylov engine:
    ``(W·K_grid·Wᵀ + (σₙ²+jitter)·I) @ v``.

    ``params = [σ, ℓ₁…ℓ_d, σₙ]`` packed.  Only kernels that factorize
    over a Cartesian grid are accepted; others raise.
    """
    profile = _profile_of(kern)
    _, idx, wts = _geometry(x, grid, device)
    sizes, total = grid.sizes, grid.total

    def matvec(params: Tensor, v: Tensor) -> Tensor:
        theta, sn = params[:-1], params[-1]
        sn2 = sn * sn + config.jitter
        v2, vec = _as_cols(v)
        u = interp_t_matvec(idx, wts, sizes, v2, total)
        u = kron_matvec(grid_gram_factors(theta, grid, v2.dtype, profile), sizes, u)
        out = interp_matvec(idx, wts, sizes, u) + sn2 * v2
        return out[:, 0] if vec else out

    return matvec


def ski_gram_matvec(kern: Kernel, params: Tensor, x, grid: Grid, v: Tensor, *,
                    config: Config = DEFAULT) -> Tensor:
    """One-shot ``(K_SKI + σₙ²I) @ v`` (convenience/test entry)."""
    return make_ski_matvec(kern, x, grid, config=config, device=v.device)(params, v)


def _cross_cols(theta: Tensor, grid: Grid, q_idx: Tensor, q_wts: Tensor, x_idx: Tensor, x_wts: Tensor,
                config: Config, profile=None) -> Tensor:
    """``K_SKI(x, q) [n, c] = W_x · K_grid · W_qᵀ`` (columns = queries)."""
    c = q_idx.shape[0]
    b = interp_t_matvec(q_idx, q_wts, grid.sizes, torch.eye(c, dtype=q_wts.dtype, device=q_wts.device),
                        grid.total)
    b = kron_matvec(grid_gram_factors(theta, grid, q_wts.dtype, profile), grid.sizes, b)
    return interp_matvec(x_idx, x_wts, grid.sizes, b)


def nlml_value_and_grad(kern: Kernel, params: Tensor, x, y: Tensor, probes: Tensor, grid: Grid,
                        **kwargs) -> Tuple[Tensor, Tensor]:
    """Estimated NLML value/gradient on the SKI operator: the Krylov
    engine's estimator (:func:`iterative.nlml_value_and_grad`) with the
    structured matvec injected.  Same keywords."""
    config = kwargs.get("config", DEFAULT)
    xt = as_tensor(x, y.device)
    mv = make_ski_matvec(kern, xt, grid, config=config)
    return iterative.nlml_value_and_grad(kern, params, xt, y, probes, matvec=mv, **kwargs)


def fit(kern: Kernel, params0: Tensor, x, y: Tensor, probes: Tensor, grid: Grid, **kwargs):
    """Adam in log-space on the SKI NLML gradient (:func:`iterative.fit`
    with the structured matvec).  Returns ``(params, nlml_trace)``."""
    config = kwargs.get("config", DEFAULT)
    xt = as_tensor(x, y.device)
    mv = make_ski_matvec(kern, xt, grid, config=config)
    return iterative.fit(kern, params0, xt, y, probes, matvec=mv, **kwargs)


def predict(kern: Kernel, params: Tensor, x, y: Tensor, xp, grid: Grid, *, var: str = "diag", rank: int = 64,
            cg_tol: float = 1e-6, max_cg: int = 512, query_chunk: int = 256,
            config: Config = DEFAULT) -> Tuple[Tensor, Optional[Tensor]]:
    """Posterior mean / diagonal variance on the SKI operator.

    Mean ``= K*ᵀ K⁻¹ y`` with both the solve and the cross product in SKI
    form (one CG + one interpolation chain).  Variance mirrors
    ``iterative.predict``: chunked CG on SKI cross columns, exact prior
    diagonal, floored at σₙ².  The last chunk is padded with the first
    query, so that padded stencils stay on the grid.  ``var="full"`` is
    unsupported.
    """
    if var == "full":
        raise ValueError("ski.predict is matrix-free; use models.exact_gp for "
                         "full posterior covariance at small n.")
    with torch.no_grad():
        xt, x_idx, x_wts = _geometry(x, grid, y.device)
        xp_h = np.asarray(_host(xp))
        profile = _profile_of(kern)
        mv = make_ski_matvec(kern, xt, grid, config=config)
        p_sg = params.detach()
        theta = p_sg[:-1]
        sn2 = p_sg[-1] * p_sg[-1] + config.jitter
        L = iterative.pivoted_cholesky(kern, theta, xt, rank, config=config)
        pre = iterative.make_preconditioner(L, sn2, xt.shape[0])
        mvp = lambda v: mv(p_sg, v)
        alpha, _ = iterative.cg_solve(mvp, y[:, None], precond_inv=pre.apply_inv, tol=cg_tol, max_iter=max_cg)

        nq = xp_h.shape[0]
        nb = -(-nq // query_chunk)
        pad = nb * query_chunk - nq
        xp_p = np.concatenate([xp_h, np.repeat(xp_h[:1], pad, axis=0)], axis=0)
        q_idx_np, q_wts_np = interp_weights(xp_p, grid)
        q_idx = torch.as_tensor(q_idx_np, device=xt.device)
        q_wts = torch.as_tensor(q_wts_np, dtype=xt.dtype, device=xt.device)
        chunks = [slice(i * query_chunk, (i + 1) * query_chunk) for i in range(nb)]
        cols = lambda c: _cross_cols(theta, grid, q_idx[c], q_wts[c], x_idx, x_wts, config, profile)
        mean = torch.cat([(cols(c).T @ alpha)[:, 0] for c in chunks])[:nq]
        if var == "none":
            return mean, None
        kd = kern.diag(theta, torch.as_tensor(xp_p, dtype=xt.dtype, device=xt.device), config=config)
        out = []
        for c in chunks:
            ks = cols(c)
            w, _ = iterative.cg_solve(mvp, ks, precond_inv=pre.apply_inv, tol=cg_tol, max_iter=max_cg)
            out.append(kd[c] - torch.sum(ks * w, dim=0) + sn2)
        return mean, torch.maximum(torch.cat(out)[:nq], sn2)


class SKIGP:
    """Stateful wrapper in the house OO style (cf. :class:`IterativeGP`).

    For ``G = grid.total ≤ direct_max`` (default 4096) the model runs the
    **direct Woodbury path**: exact O(G³) NLML under L-BFGS and
    capacitance-matrix predicts, n-independent per iteration.  Larger
    grids take the Krylov path (Adam on the estimated gradient).  NumPy
    inputs go to ``device`` (``"cuda"`` unless given).

    >>> model = SKIGP(x, y, grid_size=256)
    >>> model.train()
    >>> mean, var = model.predict(xs)
    """

    def __init__(self, x, y, kern: Optional[Kernel] = None, *, grid_size=128, num_probes: int = 16,
                 rank: int = 64, seed: int = 0, direct_max: int = 4096, config: Config = DEFAULT, device=None):
        self.kern = kern if kern is not None else RBF()
        self.x = as_tensor(x, device)
        self.y = as_tensor(y, self.x.device)
        self.grid = make_grid(self.x, grid_size)
        self.rank = rank
        self.config = config
        self.direct = self.grid.total <= direct_max
        self.stats = compute_stats(self.x, self.y, self.grid) if self.direct else None
        self.probes = torch.as_tensor(iterative.make_probes(self.x.shape[0], num_probes, seed), dtype=self.x.dtype,
                                      device=self.x.device)
        self.params = iterative.init_params(self.kern, self.x, config)

    def train(self, iters: int = 100, **kwargs):
        """Direct path: L-BFGS on the exact NLML (returns the final NLML
        as a 1-element trace).  Krylov path: Adam on the estimated
        gradient (returns the per-iteration trace)."""
        if self.direct:
            for k in ("learning_rate", "max_cg", "cg_tol", "num_lanczos", "block"):
                kwargs.pop(k, None)  # Krylov-only knobs
            res = fit_direct(self.kern, self.params, self.x, self.y, self.grid, stats=self.stats,
                             config=self.config, max_iter=iters, **kwargs)
            self.params = res.params
            return res.value.reshape(1)
        self.params, trace = fit(self.kern, self.params, self.x, self.y, self.probes, self.grid, iters=iters,
                                 rank=self.rank, config=self.config, **kwargs)
        return trace

    def predict(self, xp, var: str = "diag"):
        if self.direct:
            return predict_direct(self.kern, self.params, self.x, self.y, xp, self.grid, var=var,
                                  stats=self.stats, config=self.config)
        return predict(self.kern, self.params, self.x, self.y, xp, self.grid, var=var, rank=self.rank,
                       config=self.config)


# --------------------------------------------------------------------
# Direct Woodbury path — PSD by construction, n-independent NLML
# --------------------------------------------------------------------
#
# The Krylov path runs CG on W·K_grid·Wᵀ + σₙ²I.  In f32 the grid gram's
# eigenvalue tail sits below round-off, and the interpolation
# concentration ‖Wᵀ‖² ~ n/G amplifies the resulting negative-eigenvalue
# noise to the σₙ² scale, so at n/G ≳ 50 CG stalls or diverges.  The
# direct path factors each grid factor with the laddered Cholesky
# (T_j + εI = L_j L_jᵀ), so
#
#     K_SKI = Φ Φᵀ,      Φ = W · (L₁ ⊗ … ⊗ L_d)   [n, G]
#
# is PSD by construction, and solves through the G×G capacitance matrix
#
#     M = σₙ²·I_G + Φᵀ Φ = σₙ²·I + Bᵀ (WᵀW) B .
#
# Woodbury gives A⁻¹ = (I − Φ M⁻¹ Φᵀ)/σₙ² and the exact
# log|A| = (n−G)·log σₙ² + log|M|; the NLML needs only Z = WᵀW, Wᵀy and
# yᵀy, computed once per dataset, so an evaluation is O(G³) at any n.


class SKIStats(NamedTuple):
    """Hyperparameter-independent sufficient statistics of (x, y)."""

    z: Tensor     #: [G, G] WᵀW
    wty: Tensor   #: [G]    Wᵀy
    yty: Tensor   #: scalar yᵀy
    n: int        #: number of data points


def compute_stats(x, y, grid: Grid) -> SKIStats:
    """One-time O(n·16^d) accumulation of the direct-path statistics on
    y's device (``index_add`` over the tap pairs; f32 atomics on the
    card)."""
    y = as_tensor(y)
    _, idx, wts = _geometry(x, grid, y.device)
    wts = wts.to(y.dtype)
    total = grid.total
    taps = list(_flat_taps(idx, wts, grid.sizes))
    z = torch.zeros(total * total, dtype=y.dtype, device=y.device)
    wty = torch.zeros(total, dtype=y.dtype, device=y.device)
    for fa, wa in taps:
        wty.index_add_(0, fa, wa * y)
        for fb, wb in taps:
            z.index_add_(0, fa * total + fb, wa * wb)
    return SKIStats(z=z.reshape(total, total), wty=wty, yty=torch.dot(y, y), n=int(y.shape[0]))


#: entries of one ``np.bincount`` call of the streamed accumulator
_BINCOUNT_ENTRIES = 1 << 23


def _accumulate(xc, yc, grid: Grid, z: np.ndarray, wty: np.ndarray) -> None:
    """Add one chunk's tap pairs to the f64 statistics ``z`` (flat
    ``[G·G]``) and ``wty``, by ``np.bincount`` over all 16^d pairs of a
    sub-chunk at once."""
    g_total = grid.total
    idx, wts = interp_weights(xc, grid)
    y64 = np.asarray(yc, np.float64)
    taps = list(_flat_taps(idx, wts, grid.sizes))
    flats = np.stack([f for f, _ in taps])                  # [T, m]
    ws = np.stack([w for _, w in taps])                     # [T, m]
    wty += np.bincount(flats.ravel(), weights=(ws * y64).ravel(), minlength=g_total)
    ntap = len(taps)
    step = max(1, _BINCOUNT_ENTRIES // (ntap * ntap))
    for s0 in range(0, flats.shape[1], step):
        fa, wa = flats[:, s0:s0 + step], ws[:, s0:s0 + step]
        keys = fa[:, None, :] * g_total + fa[None, :, :]
        z += np.bincount(keys.ravel(), weights=(wa[:, None, :] * wa[None, :, :]).ravel(), minlength=g_total * g_total)


def compute_stats_streamed(source, grid: Grid, *, chunk: int = 262_144, device=None, dtype=None) -> SKIStats:
    """Out-of-core statistics: chunks of ``source`` accumulated in f64 on
    the host (NumPy ``bincount`` over the tap pairs) — strictly more
    accurate than the f32 device scatter of :func:`compute_stats` — in
    O(G²) memory.

    ``source`` is an object with ``iter_chunks(chunk)`` (a memory-mapped
    dataset) or an ``(x, y)`` pair of arrays or memmaps.  The statistics
    end on ``device`` (``"cuda"`` unless given) in ``dtype`` (the device's
    default: f32 on the card, f64 on the CPU).
    """
    g_total = grid.total
    z = np.zeros(g_total * g_total, np.float64)
    wty = np.zeros(g_total, np.float64)
    yty = 0.0
    n = 0

    def chunks():
        if hasattr(source, "iter_chunks"):
            yield from source.iter_chunks(chunk)
            return
        x_all, y_all = source
        for s0 in range(0, np.asarray(x_all).shape[0], chunk):
            yield np.asarray(_host(x_all[s0:s0 + chunk])), np.asarray(_host(y_all[s0:s0 + chunk]))

    for xc, yc in chunks():
        n += xc.shape[0]
        _accumulate(xc, yc, grid, z, wty)
        y64 = np.asarray(yc, np.float64)
        yty += float(y64 @ y64)

    dev = torch.device("cuda" if device is None else device)
    dtype = default_dtype(dev) if dtype is None else dtype
    put = lambda a: as_tensor(np.asarray(a), dev).to(dtype)
    return SKIStats(z=put(z.reshape(g_total, g_total)), wty=put(wty), yty=put(np.float64(yty)), n=n)


def _grid_chol_factors(theta: Tensor, grid: Grid, dtype, config: Config, profile=None) -> Sequence[Tensor]:
    """Laddered Cholesky of each per-dimension grid gram.

    Returns ``[L_j]`` with ``T_j + ε_j I = L_j L_jᵀ`` (ladder-chosen ε_j;
    on the card an f32 ``[g, g]`` with g ≤ 1024 goes to K3); |σ| is folded
    into the first factor so ``B = L₁ ⊗ … ⊗ L_d`` satisfies ``B Bᵀ =
    K_grid`` exactly as computed.
    """
    profile = _rbf_profile if profile is None else profile
    sig, ls = torch.abs(theta[0]), theta[1:]
    factors = []
    for j in range(len(grid.sizes)):
        t = profile(torch.abs(ls[j]) * torch.abs(_axis_diff(grid, j, dtype, theta.device)))
        L = safe_cholesky(t, config).chol
        if j == 0:
            L = sig * L
        factors.append(L)
    return factors


def _capacitance(theta: Tensor, sn2: Tensor, stats: SKIStats, grid: Grid, config: Config, profile=None):
    """Triangular factor of ``M = σₙ²I + Bᵀ Z B`` without forming M.

    ``‖BᵀZB‖`` grows linearly in n, so at n ≳ 10⁶ the σₙ²·I term falls
    below f32 round-off of the sum.  Instead factor the (hyperparameter-
    independent) ``Z = R_z R_zᵀ``, form ``C = R_zᵀ B`` and QR the stack

        [ C ; √σₙ²·I ]  =  Q·R_m    ⇒    M = R_mᵀ R_m,

    whose σₙ block enters at ‖C‖ ≈ √‖S‖ scale.  Returns ``(Ls, Lm)`` with
    ``Lm = R_mᵀ`` lower-triangular, ``M = Lm·Lmᵀ``; R's row signs are the
    library's, so log-determinants use ``log|diag|``.
    """
    Ls = _grid_chol_factors(theta, grid, stats.z.dtype, config, profile)
    rz = safe_cholesky(stats.z, config).chol                   # Z ≈ R_z R_zᵀ (lower)
    c = kron_matvec([L.T for L in Ls], grid.sizes, rz).T       # R_zᵀ B
    eye = torch.eye(grid.total, dtype=c.dtype, device=c.device)
    _, r_m = torch.linalg.qr(torch.cat([c, torch.sqrt(sn2) * eye], dim=0), mode="reduced")
    return Ls, r_m.T


def _solve_lower_refined(lm: Tensor, c: Tensor, steps: int = 2) -> Tensor:
    """``lm⁻¹c`` with iterative refinement (two residual-correction passes;
    differentiable, so a gradient through it inherits the correction)."""
    u = solve_lower(lm, c)
    vec = c.ndim == 1
    for _ in range(steps):
        cu = c[:, None] if vec else c
        uu = u[:, None] if vec else u
        r = cu - lm @ uu
        u = u + solve_lower(lm, r[:, 0] if vec else r)
    return u


def _m_solve_refined(lm: Tensor, b: Tensor, steps: int = 2) -> Tensor:
    """``(Lm·Lmᵀ)⁻¹ b`` with iterative refinement (see above)."""
    x = cholesky_solve(lm, b)
    vec = b.ndim == 1
    for _ in range(steps):
        bv = b[:, None] if vec else b
        xv = x[:, None] if vec else x
        r = bv - lm @ (lm.T @ xv)
        x = x + cholesky_solve(lm, r[:, 0] if vec else r)
    return x


def _nlml_direct_value(kern, params, stats, grid, config):
    """NLML value via the capacitance QR + refined solves (primal)."""
    profile = _profile_of(kern)
    theta, sn = params[:-1], params[-1]
    sn2 = sn * sn + config.jitter
    Ls, Lm = _capacitance(theta, sn2, stats, grid, config, profile)
    c = kron_matvec([L.T for L in Ls], grid.sizes, stats.wty[:, None])[:, 0]   # Φᵀy
    u = _solve_lower_refined(Lm, c)
    quad = (stats.yty - torch.dot(u, u)) / sn2
    logdet = (stats.n - grid.total) * torch.log(sn2) + 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(Lm))))
    value = 0.5 * (quad + logdet + stats.n * math.log(2.0 * math.pi))
    return value, (Ls, Lm, c, sn2)


def _kron_dense(factors):
    """Materialize ``⊗ factors`` (direct path only — G ≤ direct_max)."""
    out = factors[0]
    for f in factors[1:]:
        out = torch.kron(out, f)
    return out


def _nlml_direct_value_and_grad(kern, params, stats, grid, config):
    """Analytic value+gradient of the direct-path NLML.

    The model depends on the factorization only through ``K_grid``, so the
    gradient has a closed form in well-conditioned pieces (dense
    counterpart ``loss.py:107-121``)::

        ∂nlml/∂K_g = ½ (WᵀA⁻¹W − q qᵀ),    q = WᵀA⁻¹y,
        WᵀA⁻¹W = (Z − (ZB)·M⁻¹·(ZB)ᵀ)/σₙ²,
        q       = (Wᵀy − ZB·M⁻¹·Φᵀy)/σₙ²,
        ∂nlml/∂σₙ² = ½[tr A⁻¹ − ‖A⁻¹y‖²]   (Woodbury traces below),

    contracted against the Kronecker-structured ∂K_g/∂θ, whose factors
    are plain profile derivatives (``torch.func.jacfwd``).  Cholesky and
    QR appear only inside M-solves, stabilized by iterative refinement.
    """
    from torch.func import jacfwd

    profile = _profile_of(kern)
    theta, sn = params[:-1], params[-1]
    dt, dev = stats.z.dtype, stats.z.device
    value, (Ls, Lm, c, sn2) = _nlml_direct_value(kern, params, stats, grid, config)

    sizes = grid.sizes
    w = _m_solve_refined(Lm, c)                                  # M⁻¹Φᵀy [G]
    bw = kron_matvec(Ls, sizes, w[:, None])[:, 0]                # B w
    zb_t = kron_matvec([L.T for L in Ls], sizes, stats.z)        # BᵀZ [G, G]
    minv_zbt = _m_solve_refined(Lm, zb_t)                        # M⁻¹BᵀZ
    # WᵀA⁻¹W = (Z − (BᵀZ)ᵀ M⁻¹ (BᵀZ)) / σₙ²
    p_mat = (stats.z - zb_t.T @ minv_zbt) / sn2
    q_vec = (stats.wty - (stats.z @ bw[:, None])[:, 0]) / sn2
    e_mat = 0.5 * (p_mat - torch.outer(q_vec, q_vec))

    # Kronecker derivative factors of K_g = σ²·⊗T_j(ℓ_j)
    sig, ls = theta[0], theta[1:]
    t_list, d_list = [], []
    for j in range(len(sizes)):
        diff = torch.abs(_axis_diff(grid, j, dt, dev))
        fj = lambda l, diff=diff: profile(torch.abs(l) * diff)
        t_list.append(fj(ls[j]))
        d_list.append(jacfwd(fj)(ls[j]))

    kg = torch.square(sig) * _kron_dense(t_list)
    grads = [2.0 / sig * torch.sum(e_mat * kg)]                  # dK/dσ = 2K/σ
    for j in range(len(sizes)):
        facs = list(t_list)
        facs[j] = d_list[j]
        grads.append(torch.sum(e_mat * (torch.square(sig) * _kron_dense(facs))))

    # σₙ gradient via Woodbury traces (all from G-sized pieces):
    # tr A⁻¹ = (n − G + σₙ²·tr M⁻¹)/σₙ²,
    # ‖A⁻¹y‖² = (yᵀy − cᵀw − σₙ²‖w‖²)/σₙ⁴.
    g_total = grid.total
    linv = solve_lower(Lm, torch.eye(g_total, dtype=dt, device=dev))
    tr_minv = torch.sum(torch.square(linv))
    tr_ainv = (stats.n - g_total + sn2 * tr_minv) / sn2
    ainv_y_sq = (stats.yty - torch.dot(c, w) - sn2 * torch.dot(w, w)) / (sn2 * sn2)
    d_sn2 = 0.5 * (tr_ainv - ainv_y_sq)
    grads.append(d_sn2 * 2.0 * sn)                               # dsn2/dsn = 2σₙ
    return value, torch.stack(grads)


class _NlmlDirect(torch.autograd.Function):
    """The direct NLML whose backward is the analytic gradient, computed in
    the forward pass; the statistics are constants."""

    @staticmethod
    def forward(ctx, params, kern, stats, grid, config):
        value, grad = _nlml_direct_value_and_grad(kern, params, stats, grid, config)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, ct):
        (grad,) = ctx.saved_tensors
        return ct * grad, None, None, None, None


def nlml_direct(kern: Kernel, params: Tensor, stats: SKIStats, grid: Grid, *, config: Config = DEFAULT,
                analytic_grad: bool = True) -> Tensor:
    """Exact NLML of the SKI model — O(G³), independent of n.

    Dense counterpart: ``loss.py:107-109``; the quadratic and the
    log-determinant are Woodbury identities through the capacitance
    matrix.  By default the gradient is the analytic one
    (:func:`_nlml_direct_value_and_grad`, computed with the value);
    ``analytic_grad=False`` keeps plain autograd through the ladder's
    Cholesky and the QR, for validation.
    """
    if not analytic_grad:
        value, _ = _nlml_direct_value(kern, params, stats, grid, config)
        return value
    return _NlmlDirect.apply(params, kern, stats, grid, config)


def fit_direct(kern: Kernel, params0: Tensor, x, y, grid: Grid, *, stats: Optional[SKIStats] = None,
               config: Config = DEFAULT, max_iter: int = 100, tol: float = 1e-4):
    """L-BFGS (log-space) on the exact SKI NLML, O(G³) an iteration at any
    n after the one statistics pass.  Returns the port's
    :class:`~pygpr_torch.optimize.lbfgs.FitResult`."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    if stats is None:
        stats = compute_stats(x, y, grid)
    params0 = torch.as_tensor(params0, dtype=stats.z.dtype, device=stats.z.device)
    u0 = torch.log(torch.abs(params0))
    res = minimize_lbfgs(lambda u: nlml_direct(kern, torch.exp(u), stats, grid, config=config), u0,
                         max_iter=max_iter, tol=tol)
    return res._replace(params=torch.exp(res.params))


def predict_direct(kern: Kernel, params: Tensor, x, y, xp, grid: Grid, *, var: str = "diag",
                   stats: Optional[SKIStats] = None, config: Config = DEFAULT) -> Tuple[Tensor, Optional[Tensor]]:
    """Posterior mean/variance through the capacitance matrix.

    ``mean = Φ* M⁻¹ Φᵀy`` (no n-space solve at all);
    ``var_i = k**_ii − φ*ᵢ(I − σₙ²M⁻¹)φ*ᵢᵀ + σₙ²`` with the two G×G
    kernels ``P₀ = BBᵀ`` and ``R = BM⁻¹Bᵀ`` gathered on the 16^d query tap
    pairs — no [nq, G] feature matrix is materialized.
    """
    if var == "full":
        raise ValueError("ski.predict_direct is structured; use models.exact_gp "
                         "for dense posterior covariance at small n.")
    if stats is None:
        stats = compute_stats(x, y, grid)
    with torch.no_grad():
        profile = _profile_of(kern)
        theta, sn = params[:-1], params[-1]
        dt, dev = stats.z.dtype, stats.z.device
        sn2 = sn * sn + config.jitter
        Ls, Lm = _capacitance(theta, sn2, stats, grid, config, profile)
        c = kron_matvec([L.T for L in Ls], grid.sizes, stats.wty[:, None])[:, 0]
        beta = _m_solve_refined(Lm, c)                            # M⁻¹Φᵀy [G]
        bvec = kron_matvec(Ls, grid.sizes, beta[:, None])[:, 0]   # B M⁻¹Φᵀy

        xp_h = np.asarray(_host(xp))
        q_idx_np, q_wts_np = interp_weights(xp_h, grid)
        q_idx = torch.as_tensor(q_idx_np, device=dev)
        q_wts = torch.as_tensor(q_wts_np, dtype=dt, device=dev)
        mean = interp_matvec(q_idx, q_wts, grid.sizes, bvec[:, None])[:, 0]
        if var == "none":
            return mean, None

        # G×G posterior kernels: φ*(I − σₙ²M⁻¹)φ*ᵀ with φ* = w*B is
        # w*(P₀ − σₙ²R)w*ᵀ
        eye = torch.eye(grid.total, dtype=dt, device=dev)
        b_right = kron_matvec(Ls, grid.sizes, eye)                # B
        p0 = b_right @ b_right.T                                  # BBᵀ
        minv_bt = _m_solve_refined(Lm, b_right.T)                 # M⁻¹Bᵀ
        post = p0 - sn2 * (b_right @ minv_bt)
        taps = list(_flat_taps(q_idx, q_wts, grid.sizes))
        d = torch.zeros(xp_h.shape[0], dtype=dt, device=dev)
        for fa, wa in taps:
            for fb, wb in taps:
                d = d + wa * wb * post[fa, fb]
        kd = kern.diag(theta, torch.as_tensor(xp_h, dtype=dt, device=dev), config=config)
        v = kd - d + sn2
        return mean, torch.maximum(v, sn2)
