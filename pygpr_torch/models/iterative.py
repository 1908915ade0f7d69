"""Matrix-free iterative exact GP: fused matvec + PCG + SLQ log-determinant.

Counterpart of ``pygpr_tpu/models/iterative.py``, the third large-N
strategy beside the grBCM committee and SGPR: Krylov methods on a gram
operator that is never stored, for n where the n×n gram does not fit
(at n = 131072 the f32 gram alone is 64 GiB).

  * :func:`gram_matvec` computes ``(K + σₙ²I)·V``.  A bare f32
    :class:`~pygpr_torch.ops.kernels.RBF` goes through the fused kernel
    K4 (``ops/matvec.py``: the CUDA kernel on the card, its plain version
    on the CPU); any other kernel or dtype through the blocked torch path
    (:func:`_blocked_rows`), ``[block, n]`` tiles of ``kern.matrix``, the
    counterpart of the JAX package's XLA path.
  * :func:`cg_solve`: batched preconditioned conjugate gradients, every
    right-hand side advancing in lock step as one ``[n, k]`` matvec.  The
    JAX ``while_loop`` is a Python loop here: its stop test reads one
    boolean from the device each step (one host sync an iteration).
  * :func:`pivoted_cholesky` / :func:`make_preconditioner`: a rank-r
    partial pivoted Cholesky turned into the Woodbury preconditioner
    ``P = σₙ²I + LᵀL`` with O(nr) inverse, inverse square root and an
    exact ``log|P|``.
  * :func:`slq_logdet`: stochastic Lanczos quadrature of
    ``tr log P^{-1/2} K P^{-1/2}`` from Rademacher probes.
  * :func:`nlml_value_and_grad`: the estimated NLML and its Hutchinson
    gradient, ``torch.autograd.grad`` of a two-matvec surrogate, which
    on the fused path is K4's backward (one more launch each).

Probes are NumPy (:func:`make_probes`, the JAX package's generator), so
both packages get the same probes.  The kernel is the noise-free signal
kernel, ``params = [θ_kernel…, σₙ]``, and the predictive variance
includes σₙ² (``models/sgpr.py``'s conventions).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.sgpr import _check_noise_free, init_params  # noqa: F401
from pygpr_torch.ops import matvec as fused
from pygpr_torch.ops.kernels import Kernel
from pygpr_torch.optimize.adam import Adam

Tensor = torch.Tensor

__all__ = [
    "gram_matvec",
    "cross_matvec",
    "pivoted_cholesky",
    "Preconditioner",
    "make_preconditioner",
    "cg_solve",
    "slq_logdet",
    "make_probes",
    "nlml_value_and_grad",
    "fit",
    "predict",
    "IterativeGP",
    "init_params",
]


def make_probes(n: int, num: int = 16, seed: int = 0) -> np.ndarray:
    """Rademacher probe matrix ``[n, num]`` (float32), NumPy, drawn as the
    JAX package draws it, so the same seed gives the same probes."""
    rng = np.random.default_rng(seed)
    return (2.0 * rng.integers(0, 2, size=(n, num)) - 1.0).astype(np.float32)


class _BlockedRows(torch.autograd.Function):
    """``K(rows, x) @ v`` one ``[block, n]`` tile at a time, forward and
    backward: the backward recomputes each tile and takes its vector-
    Jacobian product in θ, so no tile outlives its step."""

    @staticmethod
    def forward(ctx, theta, rows, x, v, kern, block, config):
        ctx.kern, ctx.block, ctx.config = kern, block, config
        ctx.save_for_backward(theta, rows, x, v)
        # matrix(θ, x, xp) rows index xp, so the tile goes in the xp slot
        return torch.cat([kern.matrix(theta, x, rows[lo:lo + block], config=config) @ v
                          for lo in range(0, rows.shape[0], block)])

    @staticmethod
    def backward(ctx, gout):
        if any(ctx.needs_input_grad[1:4]):
            raise NotImplementedError("the blocked matvec is differentiable in the kernel parameters only")
        theta, rows, x, v = ctx.saved_tensors
        theta = theta.detach().requires_grad_(True)
        grad = torch.zeros_like(theta)
        for lo in range(0, rows.shape[0], ctx.block):
            with torch.enable_grad():
                # a scalar: grad_outputs would import torch's symbolic shapes
                tile = ctx.kern.matrix(theta, x, rows[lo:lo + ctx.block], config=ctx.config) @ v
                s = torch.sum(tile * gout[lo:lo + ctx.block])
            grad += torch.autograd.grad(s, theta)[0]
        return grad, None, None, None, None, None, None


def _blocked_rows(kern: Kernel, theta, rows, x, v, block: int, config: Config) -> Tensor:
    """``K(rows, x) @ v`` in ``[block, n]`` tiles: ``rows: [m, d]``,
    ``x: [n, d]``, ``v: [n, k]`` → ``[m, k]``.  One tile lives at a
    time, in the backward too, so the gradient in θ is matrix-free."""
    return _BlockedRows.apply(theta, rows, x, v, kern, block, config)


def gram_matvec(kern: Kernel, params, x, v, *, block: int = 2048, config: Config = DEFAULT) -> Tensor:
    """Matrix-free ``(K_signal(x, x) + (σₙ² + jitter)·I) @ v``.

    ``v`` may be ``[n]`` or ``[n, k]``.  Differentiable in ``params`` (the
    fused path also in x and v).  A bare f32 RBF goes through the fused
    kernel K4 (on a CUDA tensor the kernel launches or raises); anything
    else through the blocked path.
    """
    theta, sn = params[..., :-1], params[..., -1]
    sn2 = sn * sn + config.jitter
    vec = v.ndim == 1
    v2 = v[:, None] if vec else v
    if fused.supported(kern, x):
        out = fused.rbf_gram_matvec(theta, x, v2) + sn2 * v2
    else:
        out = _blocked_rows(kern, theta, x, x, v2, block, config) + sn2 * v2
    return out[:, 0] if vec else out


def cross_matvec(kern: Kernel, params, xp, x, v, *, block: int = 2048, config: Config = DEFAULT) -> Tensor:
    """Matrix-free ``K(xp, x) @ v``, the signal kernel only: the cross
    block carries no observation noise."""
    theta = params[..., :-1]
    vec = v.ndim == 1
    v2 = v[:, None] if vec else v
    out = _blocked_rows(kern, theta, xp, x, v2, block, config)
    return out[:, 0] if vec else out


def pivoted_cholesky(kern: Kernel, theta, x, rank: int, *, config: Config = DEFAULT, return_pivots: bool = False):
    """Partial pivoted Cholesky ``K_signal ≈ LᵀL`` with ``L: [rank, n]``.

    Greedy diagonal pivoting: each of the ``rank`` steps evaluates one
    kernel row, O(rank·n·d) in all.  The pivot stays on the device (no
    host sync); ``argmax`` takes the first maximum, as JAX's does, which
    decides step 0, where the diagonal is the constant σ².
    ``return_pivots=True`` also returns the pivot indices ``[rank]``.
    """
    n = x.shape[0]
    dres = kern.diag(theta, x, config=config)
    L = torch.zeros((rank, n), dtype=x.dtype, device=x.device)
    pivs = torch.zeros((rank,), dtype=torch.int32, device=x.device)
    for i in range(rank):
        p = torch.argmax(dres).reshape(1)
        row = kern.matrix(theta, x, x.index_select(0, p), config=config)[0]
        row = row - L.index_select(1, p)[:, 0] @ L
        piv = torch.clamp_min(dres.index_select(0, p), 1e-12)
        l = row / torch.sqrt(piv)
        L[i] = l
        dres = torch.clamp_min(dres - torch.square(l), 0.0)
        pivs[i] = p[0]
    if return_pivots:
        return L, pivs
    return L


class Preconditioner(NamedTuple):
    """Woodbury form of ``P = σₙ²I + LᵀL`` from the pivoted Cholesky,
    diagonalized once (``LLᵀ = W S² Wᵀ``, ``V = LᵀW S⁻¹`` orthonormal),
    so that ``P = σₙ²I + V S² Vᵀ``."""

    v: Tensor            #: [n, r] orthonormal columns (zeroed if s²≈0)
    s2: Tensor           #: [r] eigenvalues of LLᵀ (≥ 0)
    sn2: Tensor          #: scalar noise variance
    half_logdet: Tensor  #: ½ log|P| (exact)

    def _woodbury(self, u, coef):
        u2 = u[:, None] if u.ndim == 1 else u
        out = u2 + self.v @ (coef[:, None] * (self.v.T @ u2))
        return out[:, 0] if u.ndim == 1 else out

    def apply_inv(self, u: Tensor) -> Tensor:
        """``P⁻¹u = (u − V diag(s²/(σₙ²+s²)) Vᵀu) / σₙ²``.

        IEEE f32 products are load-bearing (TF32 stays off): a projection
        error of 1e-3 is amplified by 1/σₙ² and stalls CG.
        """
        return self._woodbury(u, -self.s2 / (self.sn2 + self.s2)) / self.sn2

    def apply_inv_sqrt(self, u: Tensor) -> Tensor:
        """``P^{-1/2}u``, symmetric, used to whiten the SLQ operator."""
        coef = torch.sqrt(self.sn2 / (self.sn2 + self.s2)) - 1.0
        return self._woodbury(u, coef) / torch.sqrt(self.sn2)


def make_preconditioner(L: Tensor, sn2, n: int) -> Preconditioner:
    """The Woodbury preconditioner of ``L: [r, n]``, with the exact
    ``log|P| = (n − r)·log σₙ² + Σₖ log(σₙ² + s²ₖ)``.

    Built in f64 whatever ``L``'s dtype, then cast back: the JAX package
    builds it in the input's dtype, but in f32 on an H100 cuSOLVER's eigh
    of the r × r Gram ``LLᵀ`` (entries near 6e3 on SKI's 96 × 96 Krylov
    problem) returns small eigenpairs that the 1e-10 cut keeps, their
    columns of V are not orthonormal, and preconditioned CG stalled at a
    true relative residual of 0.13–0.39 after 256 steps in 3 of 5 runs (the
    mean's RMSE 0.04–0.30); built in f64, CG met cg_tol 1e-3 and the RMSE
    read 0.0034–0.0036 in all 5.  In f64 the build is the JAX package's."""
    r = L.shape[0]
    L64 = L.double()
    sn2 = torch.as_tensor(sn2, dtype=torch.float64, device=L.device)
    s2, W = torch.linalg.eigh(L64 @ L64.T)
    s2 = torch.clamp_min(s2, 0.0)
    good = s2 > 1e-10 * torch.clamp_min(torch.max(s2), 1e-30)
    inv_s = torch.where(good, 1.0 / torch.sqrt(torch.where(good, s2, 1.0)), 0.0)
    V = L64.T @ (W * inv_s)
    s2 = torch.where(good, s2, 0.0)
    half_logdet = 0.5 * ((n - r) * torch.log(sn2) + torch.sum(torch.log(sn2 + s2)))
    return Preconditioner(*(t.to(L.dtype) for t in (V, s2, sn2, half_logdet)))


def cg_solve(
    matvec: Callable[[Tensor], Tensor],
    b: Tensor,
    *,
    precond_inv: Optional[Callable[[Tensor], Tensor]] = None,
    tol: float = 1e-6,
    max_iter: int = 512,
) -> Tuple[Tensor, int]:
    """Batched preconditioned CG: solve ``A X = B`` for SPD ``A``.

    ``b: [n, k]``; all k systems advance in lock step until every column
    satisfies ``‖r‖ ≤ tol·‖b‖`` (or ``max_iter``), so each iteration is
    one ``[n, k]`` matvec and the iterates are the JAX package's.  The
    stop test is one host read a step.  Returns ``(X, iterations)``.
    """
    minv = precond_inv if precond_inv is not None else (lambda u: u)
    bnorm = torch.sqrt(torch.sum(torch.square(b), dim=0))
    target = tol * torch.clamp_min(bnorm, 1e-30)
    x = torch.zeros_like(b)
    r = b
    d = minv(r)
    rz = torch.sum(r * d, dim=0)
    it = 0
    while it < max_iter and bool(torch.any(torch.sqrt(torch.sum(torch.square(r), dim=0)) > target)):
        q = matvec(d)
        dq = torch.sum(d * q, dim=0)
        alpha = torch.where(dq > 0, rz / torch.clamp_min(dq, 1e-30), 0.0)
        x = x + alpha * d
        r = r - alpha * q
        z = minv(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz > 0, rz_new / torch.clamp_min(rz, 1e-30), 0.0)
        d = z + beta * d
        rz = rz_new
        it += 1
    return x, it


def _lanczos_tridiag(matvec: Callable[[Tensor], Tensor], z: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    """Batched Lanczos with full reorthogonalization against the
    ``[m, n, p]`` history: ``z: [n, p]`` → ``alphas [m, p]``,
    ``betas [m−1, p]``."""
    n, p = z.shape
    v = z / torch.sqrt(torch.sum(torch.square(z), dim=0))
    Q = torch.zeros((m, n, p), dtype=z.dtype, device=z.device)
    alphas = torch.zeros((m, p), dtype=z.dtype, device=z.device)
    betas = torch.zeros((m, p), dtype=z.dtype, device=z.device)
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((p,), dtype=z.dtype, device=z.device)
    for j in range(m):
        Q[j] = v
        w = matvec(v) - beta_prev * v_prev
        alpha = torch.sum(v * w, dim=0)
        w = w - alpha * v
        # rows of Q beyond j are zero and contribute nothing
        proj = torch.einsum("mnp,np->mp", Q, w)
        w = w - torch.einsum("mnp,mp->np", Q, proj)
        beta = torch.sqrt(torch.clamp_min(torch.sum(torch.square(w), dim=0), 0.0))
        alphas[j] = alpha
        betas[j] = beta
        v_prev, v, beta_prev = v, w / torch.clamp_min(beta, 1e-30), beta
    return alphas, betas[: m - 1]


def slq_logdet(matvec: Callable[[Tensor], Tensor], probes: Tensor, *, num_lanczos: int = 20) -> Tensor:
    """Stochastic Lanczos quadrature estimate of ``tr log A``:
    ``(1/p) Σᵢ ‖zᵢ‖² · e₁ᵀ log(Tᵢ) e₁`` with ``Tᵢ`` the m×m Lanczos
    tridiagonal of probe ``zᵢ``."""
    alphas, betas = _lanczos_tridiag(matvec, probes, num_lanczos)
    T = torch.diag_embed(alphas.T) + torch.diag_embed(betas.T, 1) + torch.diag_embed(betas.T, -1)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp_min(evals, 1e-30)
    quad = torch.sum(torch.square(evecs[:, 0, :]) * torch.log(evals), dim=-1)
    znorm2 = torch.sum(torch.square(probes), dim=0)
    return torch.mean(znorm2 * quad)


def _default_matvec(kern, x, block, config):
    """The single-device matvec factory: ``mv(params, v)``."""
    return lambda p, v: gram_matvec(kern, p, x, v, block=block, config=config)


def _solver_pieces(kern, params, x, rank, block, config, matvec=None):
    """Preconditioner and matvec closures at detached params: the
    solver's internals are not part of the differentiated objective.
    ``matvec(params, v)`` may be injected."""
    if matvec is None:
        matvec = _default_matvec(kern, x, block, config)
    p_sg = params.detach()
    sn = p_sg[-1]
    sn2 = sn * sn + config.jitter
    with torch.no_grad():
        L = pivoted_cholesky(kern, p_sg[:-1], x, rank, config=config)
        pre = make_preconditioner(L, sn2, x.shape[0])
    return pre, (lambda v: matvec(p_sg, v)), matvec


def nlml_value_and_grad(
    kern: Kernel,
    params,
    x,
    y,
    probes,
    *,
    rank: int = 64,
    num_lanczos: int = 20,
    cg_tol: float = 1e-5,
    max_cg: int = 512,
    block: int = 2048,
    config: Config = DEFAULT,
    matvec: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Estimated NLML value and gradient with no O(n³) step.

    Value: ``½yᵀα + ½(log|P| + tr log P^{-1/2}KP^{-1/2}) + ½n log 2π``,
    the quadratic term by CG, the log-determinant by SLQ.  Gradient: the
    Hutchinson estimator, ``torch.autograd.grad`` of the surrogate
    ``s(θ) = −½ α̂ᵀK(θ)α̂ + (1/2p) Σᵢ ûᵢᵀK(θ)ẑᵢ`` with ``α̂, ûᵢ`` the
    detached CG solutions of ``[y, probes]``.
    """
    _check_noise_free(kern)
    n = y.shape[0]
    pre, mv, matvec = _solver_pieces(kern, params, x, rank, block, config, matvec)
    with torch.no_grad():
        B = torch.cat([y[:, None], probes], dim=1)
        sol, _ = cg_solve(mv, B, precond_inv=pre.apply_inv, tol=cg_tol, max_iter=max_cg)
        alpha, U = sol[:, 0], sol[:, 1:]
        tr_log_m = slq_logdet(lambda v: pre.apply_inv_sqrt(mv(pre.apply_inv_sqrt(v))), probes,
                              num_lanczos=num_lanczos)
        value = (torch.dot(y, alpha) * 0.5 + pre.half_logdet + 0.5 * tr_log_m
                 + 0.5 * n * math.log(2.0 * math.pi))
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        quad = -0.5 * torch.dot(alpha, matvec(p, alpha))
        trace = 0.5 * torch.sum(U * matvec(p, probes)) / probes.shape[1]
        (grad,) = torch.autograd.grad(quad + trace, p)
    return value, grad


def fit(
    kern: Kernel,
    params0,
    x,
    y,
    probes,
    *,
    rank: int = 64,
    num_lanczos: int = 20,
    cg_tol: float = 1e-4,
    max_cg: int = 256,
    block: int = 2048,
    learning_rate: float = 0.05,
    iters: int = 100,
    config: Config = DEFAULT,
    matvec: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
):
    """Adam in log space on the estimated NLML gradient.

    Fixed probes are common random numbers, so the trajectory is
    deterministic; Adam, not L-BFGS, since the gradient is a stochastic
    estimate.  The update is optax's ``adam(learning_rate)``
    (:class:`~pygpr_torch.optimize.adam.Adam`), so the iterates are the JAX
    package's.  Returns ``(params, nlml_trace [iters])``.
    """
    _check_noise_free(kern)
    u = torch.log(torch.abs(params0.detach()))
    opt = Adam([u], learning_rate)
    trace = []
    for _ in range(iters):
        p = torch.exp(u)
        v, g = nlml_value_and_grad(
            kern, p, x, y, probes, rank=rank, num_lanczos=num_lanczos, cg_tol=cg_tol,
            max_cg=max_cg, block=block, config=config, matvec=matvec,
        )
        (u,) = opt.step([u], [g * p])  # d/d(log p)
        trace.append(v)
    return torch.exp(u), torch.stack(trace)


def predict(
    kern: Kernel,
    params,
    x,
    y,
    xp,
    *,
    var: str = "diag",
    rank: int = 64,
    cg_tol: float = 1e-6,
    max_cg: int = 512,
    block: int = 2048,
    query_chunk: int = 256,
    config: Config = DEFAULT,
) -> Tuple[Tensor, Optional[Tensor]]:
    """Matrix-free posterior mean and diagonal variance.

    The mean ``K*ᵀ K⁻¹ y`` is one CG solve and one cross matvec.  The
    diagonal variance solves ``K⁻¹k*`` by batched CG over chunks of
    ``query_chunk`` queries; the last chunk is padded with zero rows, as
    the JAX package pads it, so its lock-step iterates are the same.  The
    variance includes σₙ² and is floored there.  ``var="full"`` is
    refused: a dense posterior defeats the matrix-free point (use
    ``models.exact_gp``).
    """
    _check_noise_free(kern)
    if var == "full":
        raise ValueError(
            "iterative.predict is matrix-free; full posterior "
            "covariance is dense — use models.exact_gp for that."
        )
    with torch.no_grad():
        pre, mv, _ = _solver_pieces(kern, params, x, rank, block, config)
        alpha, _ = cg_solve(mv, y[:, None], precond_inv=pre.apply_inv, tol=cg_tol, max_iter=max_cg)
        mean = cross_matvec(kern, params, xp, x, alpha[:, 0], block=block, config=config)
        if var == "none":
            return mean, None
        theta, sn = params[..., :-1], params[..., -1]
        sn2 = sn * sn + config.jitter
        nq = xp.shape[0]
        pad = -(-nq // query_chunk) * query_chunk - nq
        xp_p = torch.cat([xp, xp.new_zeros((pad, xp.shape[-1]))])
        out = []
        for lo in range(0, nq + pad, query_chunk):
            q = xp_p[lo:lo + query_chunk]
            ks = kern.matrix(theta, x, q, config=config)  # [c, n]
            w, _ = cg_solve(mv, ks.T, precond_inv=pre.apply_inv, tol=cg_tol, max_iter=max_cg)
            out.append(kern.diag(theta, q, config=config) - torch.sum(ks.T * w, dim=0) + sn2)
        # the exact predictive variance is ≥ σₙ² (a Schur complement of a
        # PSD block matrix); the floor absorbs CG truncation error
        return mean, torch.maximum(torch.cat(out)[:nq], sn2)


class IterativeGP:
    """Stateful wrapper in the house style (cf. ``ExactGP``).

    NumPy inputs go to ``device`` (``"cuda"`` unless given, see
    ``config.as_tensor``); tensors stay where they are.

    >>> model = IterativeGP(x, y, RBF(), num_probes=16)
    >>> model.train(iters=80)
    >>> mean, var = model.predict(xs)
    """

    def __init__(self, x, y, cov: Kernel, *, num_probes: int = 16, rank: int = 64, block: int = 2048,
                 seed: int = 0, config: Config = DEFAULT, device=None):
        _check_noise_free(cov)
        self.x = as_tensor(x, device)
        self.y = as_tensor(y, self.x.device)
        self.cov = cov
        self.config = config
        self.rank = rank
        self.block = block
        self._seed = seed
        self.probes = self._probes(num_probes)
        self.params = init_params(cov, self.x, config)

    def _probes(self, num: int) -> Tensor:
        return torch.as_tensor(make_probes(self.x.shape[0], num, self._seed), dtype=self.x.dtype,
                               device=self.x.device)

    def set_params(self, params) -> None:
        self.params = as_tensor(params, self.x.device)

    def set_data(self, x, y) -> None:
        """Rebind the training data; probes are drawn anew at the new n
        with the stored seed."""
        self.x = as_tensor(x, self.x.device)
        self.y = as_tensor(y, self.x.device)
        if self.probes.shape[0] != self.x.shape[0]:
            self.probes = self._probes(self.probes.shape[1])

    def nlml(self) -> Tensor:
        v, _ = nlml_value_and_grad(self.cov, self.params, self.x, self.y, self.probes, rank=self.rank,
                                   block=self.block, config=self.config)
        return v

    def train(self, iters: Optional[int] = None, learning_rate: float = 0.05, max_iter: Optional[int] = None, **kw):
        """Adam fit; ``max_iter`` is an alias of ``iters``."""
        iters = iters if iters is not None else (max_iter or 100)
        params, trace = fit(self.cov, self.params, self.x, self.y, self.probes, rank=self.rank, block=self.block,
                            learning_rate=learning_rate, iters=iters, config=self.config, **kw)
        self.params = params
        return trace

    def predict(self, xp, var: str = "diag"):
        return predict(self.cov, self.params, self.x, self.y, as_tensor(xp, self.x.device), var=var,
                       rank=self.rank, block=self.block, config=self.config)
