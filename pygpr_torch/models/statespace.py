"""State-space (Kalman) GP: exact O(n) inference for 1-D Matérn GPs,
in O(log n) depth by parallel scans.

Counterpart of ``pygpr_tpu/models/statespace.py``.  A 1-D GP with a
Matérn-ν kernel is exactly a linear-Gaussian state-space model
(Hartikainen & Särkkä 2010) with a d-dimensional state (d = ν + ½ ∈
{1, 2, 3}), so Kalman filtering gives the EXACT marginal likelihood and
posterior in O(n·d³).  Two formulations:

  * :func:`_filter_seq` / :func:`_smooth_seq` — the textbook recursions
    as Python loops over the steps: the correctness oracle, for small n
    on the CPU only;
  * the **parallel-scan filter/smoother** (Särkkä & García-Fernández,
    IEEE TAC 2021): filtering as an associative operation on per-step
    elements (A, b, C, η, J), combined by :func:`associative_scan` in
    log₂n rounds — the production path.

Matrices are carried lane-major, ``[d, d, n]`` (state dims leading, time
last), and all small-matrix algebra is d-unrolled elementwise
multiply-adds over n (:func:`_bmm`, :func:`_bmv`) with closed-form d ≤ 3
inverses (:func:`_inv`): on the card each is a few elementwise kernels
over n, never a batched GEMM of n tiny matrices.

``torch`` has no public associative scan, so :func:`associative_scan` is
the JAX package's odd/even recursion (``jax.lax.associative_scan``)
written over the last axis of a tuple of tensors, for any n, with the
same combine order and the same ``reverse`` convention: the filter, the
smoother and the adjoint gradient share it.

Exactness anchors (tested against the JAX package and the dense
pipeline): ``nlml_ss`` equals the dense ``likelihood.nlml`` with
``Sum((Matern(ν), WhiteNoise))`` and the smoothed posterior equals the
dense exact-GP predict, with the inverse-lengthscale convention
``r = ℓ|t−t′|`` of ``ops/kernels.py::Matern``.

Time points must be SORTED ascending (sort on the host); duplicates are
allowed (Δt = 0 steps carry A = I, Q = 0, with no special case).  The
JAX package splits the posterior and the gradients into several XLA
programs to bound the TPU's compile time; the port computes the same
results in one call each.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor

Tensor = torch.Tensor


# --------------------------------------------------------------------
# lane-major [d, d, n] small-matrix algebra
# --------------------------------------------------------------------


def _bmm(a: Tensor, b: Tensor) -> Tensor:
    """[d,k,n] @ [k,m,n] per lane — k-unrolled elementwise multiply-adds
    over [d, m, n] (b may be a [k, 1, n] column)."""
    out = a[:, 0, None, :] * b[None, 0]
    for k in range(1, a.shape[1]):
        out = out + a[:, k, None, :] * b[None, k]
    return out


def _bmv(a: Tensor, v: Tensor) -> Tensor:
    """[d,k,n] @ [k,n] per lane."""
    out = a[:, 0] * v[None, 0]
    for k in range(1, a.shape[1]):
        out = out + a[:, k] * v[None, k]
    return out


def _t(a: Tensor) -> Tensor:
    return a.transpose(0, 1)


def _inv(m: Tensor) -> Tensor:
    """Closed-form inverse of [d,d,n] stacks, d ∈ {1,2,3} (adjugate /
    determinant — no LAPACK, no layout change)."""
    d = m.shape[0]
    if d == 1:
        return 1.0 / m
    if d == 2:
        det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        adj = torch.stack([torch.stack([m[1, 1], -m[0, 1]]), torch.stack([-m[1, 0], m[0, 0]])])
        return adj / det
    c00 = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    c01 = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
    c02 = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
    c10 = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
    c11 = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
    c12 = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
    c20 = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
    c21 = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
    c22 = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = m[0, 0] * c00 + m[0, 1] * c10 + m[0, 2] * c20
    adj = torch.stack([torch.stack([c00, c01, c02]), torch.stack([c10, c11, c12]), torch.stack([c20, c21, c22])])
    return adj / det


# --------------------------------------------------------------------
# the parallel scan
# --------------------------------------------------------------------


def associative_scan(fn: Callable, elems: Sequence[Tensor], reverse: bool = False) -> Tuple[Tensor, ...]:
    """Inclusive scan of the associative ``fn`` over the last axis of
    every tensor of ``elems`` (a tuple; all share the last axis n, any n),
    in O(log n) rounds of batched ``fn`` calls: the odd/even recursion of
    ``jax.lax.associative_scan``, with its combine order.

    ``fn(a, b)`` takes two tuples whose tensors have a common last axis and
    combines ``a`` (earlier) with ``b`` (later).  ``reverse=True`` scans
    the flipped sequence and flips the result back, so there ``fn``'s
    first argument is the combined LATER suffix and the second the earlier
    element, as in JAX."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(torch.flip(e, (-1,)) for e in elems)

    def scan(es):
        n = es[0].shape[-1]
        if n < 2:
            return es
        reduced = fn(tuple(e[..., 0:-1:2] for e in es), tuple(e[..., 1::2] for e in es))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(e[..., :-1] for e in odd), tuple(e[..., 2::2] for e in es))
        else:
            even = fn(odd, tuple(e[..., 2::2] for e in es))
        even = tuple(torch.cat([e[..., :1], r], dim=-1) for e, r in zip(es, even))
        return tuple(_interleave(a, b) for a, b in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(e, (-1,)) for e in out)
    return out


def _interleave(a: Tensor, b: Tensor) -> Tensor:
    """[..., a0, b0, a1, b1, …] along the last axis (len a − len b ∈ {0, 1})."""
    na, nb = a.shape[-1], b.shape[-1]
    if na > nb:
        b = torch.cat([b, torch.zeros_like(a[..., :1])], dim=-1)
    out = torch.stack([a, b], dim=-1).flatten(-2)
    return out[..., :na + nb]


# --------------------------------------------------------------------
# SDE representation of the Matérn family (house convention r = ℓτ)
# --------------------------------------------------------------------


def _ssm_dim(nu: float) -> int:
    return {0.5: 1, 1.5: 2, 2.5: 3}[nu]


def _ssm_constants(nu: float, sig: Tensor, ls: Tensor, dtype):
    """(λ, P∞) for Matérn-ν with variance σ² and inverse lengthscale ℓ.
    λ = √(2ν)·ℓ in the √(2ν)r convention of ``ops/kernels.Matern``; the
    observed coordinate is state 0."""
    d = _ssm_dim(nu)
    lam = math.sqrt(2.0 * nu) * torch.abs(ls)
    s2 = torch.square(sig)
    if d == 1:
        p_inf = s2.reshape(1, 1)
    elif d == 2:
        p_inf = torch.diag(torch.stack([s2, s2 * torch.square(lam)]))
    else:
        l2 = torch.square(lam)
        k = s2 * l2 / 3.0
        z = torch.zeros((), dtype=dtype, device=sig.device)
        p_inf = torch.stack([torch.stack([s2, z, -k]), torch.stack([z, k, z]),
                             torch.stack([-k, z, s2 * torch.square(l2)])])
    return lam, p_inf


def _transitions(nu: float, lam: Tensor, p_inf: Tensor, dt: Tensor):
    """Lane-major (A, Q) over steps: A = e^{−λΔt}·Σ_k N^kΔt^k/k! with the
    nilpotent N = F + λI (the Matérn state matrix has one eigenvalue −λ
    of full multiplicity), Q = P∞ − A P∞ Aᵀ (stationary process).
    Returns ``[d, d, n]`` pairs."""
    d = p_inf.shape[0]
    one = torch.ones((), dtype=p_inf.dtype, device=p_inf.device)
    zero = torch.zeros((), dtype=p_inf.dtype, device=p_inf.device)
    if d == 1:
        n_mat = torch.zeros((1, 1), dtype=p_inf.dtype, device=p_inf.device)
    elif d == 2:
        # N = F + λI for F = [[0,1],[−λ², −2λ]] — N² = 0
        n_mat = torch.stack([torch.stack([lam, one]), torch.stack([-torch.square(lam), -lam])])
    else:
        # N = F + λI for F = [[0,1,0],[0,0,1],[−λ³,−3λ²,−3λ]] — N³ = 0
        l2 = torch.square(lam)
        n_mat = torch.stack([torch.stack([lam, one, zero]), torch.stack([zero, lam, one]),
                             torch.stack([-l2 * lam, -3.0 * l2, -2.0 * lam])])
    eye = torch.eye(d, dtype=p_inf.dtype, device=p_inf.device)
    decay = torch.exp(-lam * dt)                      # [n]
    a = eye[:, :, None] + n_mat[:, :, None] * dt
    if d == 3:
        n2 = n_mat @ n_mat
        a = a + 0.5 * n2[:, :, None] * torch.square(dt)
    a = decay * a                                     # [d, d, n]
    p_b = p_inf[:, :, None].expand(a.shape)
    q = p_b - _bmm(_bmm(a, p_b), _t(a))
    return a, q


def _prep(nu, params, t, y, config):
    dtype = y.dtype
    sig, ls, sn = params[0], params[1], params[2]
    lam, p_inf = _ssm_constants(nu, sig, ls, dtype)
    dt = torch.diff(t, prepend=t[:1])                 # dt[0] = 0
    a_s, q_s = _transitions(nu, lam, p_inf, dt)
    # step 0 folds the stationary prior: A₀ ← 0 (kills the virtual
    # pre-sample state), Q₀ ← P∞ so P̄₁ = P∞ exactly
    a_s = torch.cat([torch.zeros_like(a_s[:, :, :1]), a_s[:, :, 1:]], dim=-1)
    q_s = torch.cat([p_inf[:, :, None], q_s[:, :, 1:]], dim=-1)
    return a_s, q_s, p_inf, torch.square(sn)


# --------------------------------------------------------------------
# sequential filter / smoother (correctness oracle, small n)
# --------------------------------------------------------------------


def _filter_seq(a_s, q_s, p0, y, r_var, mask):
    """Textbook Kalman filter, one Python step a time point.  ``mask[i]=0``
    skips the measurement update (prediction-only steps).  Lane-major in
    and out."""
    d, n = p0.shape[0], y.shape[0]
    m = torch.zeros(d, dtype=p0.dtype, device=p0.device)
    p = p0
    ms, ps, lls = [], [], []
    two_pi = 2.0 * math.pi
    for i in range(n):
        a, q, yi, mi = a_s[:, :, i], q_s[:, :, i], y[i], mask[i]
        m = a @ m
        p = a @ p @ a.T + q
        s = p[0, 0] + r_var
        v = yi - m[0]
        k = p[:, 0] / s
        m = m + mi * k * v
        p = p - mi * torch.outer(k, k) * s
        lls.append(mi * 0.5 * (torch.log(two_pi * s) + torch.square(v) / s))
        ms.append(m)
        ps.append(p)
    return torch.stack(ms, dim=-1), torch.stack(ps, dim=-1), torch.sum(torch.stack(lls))


def _smooth_seq(a_s, q_s, ms, ps):
    """RTS smoother, one Python step a time point, backwards.  Lane-major
    in and out."""
    n = ms.shape[-1]
    m_next, p_next = ms[:, -1], ps[:, :, -1]
    out_m, out_p = [m_next], [p_next]
    for i in range(n - 2, -1, -1):
        a_next, q_next = a_s[:, :, i + 1], q_s[:, :, i + 1]
        m_f, p_f = ms[:, i], ps[:, :, i]
        p_pred = a_next @ p_f @ a_next.T + q_next
        g = torch.linalg.solve(p_pred.T, (p_f @ a_next.T).T).T
        m_next = m_f + g @ (m_next - a_next @ m_f)
        p_next = p_f + g @ (p_next - p_pred) @ g.T
        out_m.append(m_next)
        out_p.append(p_next)
    return torch.stack(out_m[::-1], dim=-1), torch.stack(out_p[::-1], dim=-1)


# --------------------------------------------------------------------
# parallel (associative-scan) filter / smoother — the production path
# --------------------------------------------------------------------


def _filter_elements(a_s, q_s, y, r_var, mask):
    """Per-step filter elements (A, b, C, η, J) — vectors as [d,1,n]
    columns so that every leaf is rank 3.  Masked steps (mask=0) degrade
    to pure prediction elements (A_i, 0, Q_i, 0, 0)."""
    s = q_s[0, 0] + r_var                             # [n]
    k = q_s[:, 0] / s                                 # [d, n]
    a_row = a_s[0]                                    # [d, n]  (HA)
    ikh_a = a_s - mask * k[:, None, :] * a_row[None, :, :]
    b = mask * k * y                                  # [d, n]
    c = q_s - mask * k[:, None, :] * q_s[0][None, :, :]
    eta = mask * a_row * (y / s)                      # [d, n]
    j = mask * a_row[:, None, :] * a_row[None, :, :] / s
    return ikh_a, b[:, None, :], c, eta[:, None, :], j


def _filter_combine(e1, e2):
    """Associative combination of filter elements (arg0 earlier)."""
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    eye = torch.eye(a1.shape[0], dtype=a1.dtype, device=a1.device)[:, :, None]
    m_inv = _inv(eye + _bmm(c1, j2))
    a = _bmm(a2, _bmm(m_inv, a1))
    b_out = _bmm(a2, _bmm(m_inv, b1 + _bmm(c1, eta2))) + b2
    c_out = _bmm(a2, _bmm(_bmm(m_inv, c1), _t(a2))) + c2
    mt_inv = _inv(eye + _bmm(j2, c1))
    eta_out = _bmm(_t(a1), _bmm(mt_inv, eta2 - _bmm(j2, b1))) + eta1
    j_out = _bmm(_t(a1), _bmm(_bmm(mt_inv, j2), a1)) + j1
    return a, b_out, c_out, eta_out, j_out


def _filtered(prefix, p0):
    """Filtered (m [d,n], P [d,d,n]) from the prefix elements applied to
    (m₀ = 0, P₀ = p0); A₀ = 0 already killed the p0 dependence, but the
    general form is kept."""
    a_c, b_c, c_c = prefix[0], prefix[1], prefix[2]
    p0_b = p0[:, :, None].expand(a_c.shape)
    return b_c[:, 0, :], c_c + _bmm(a_c, _bmm(p0_b, _t(a_c)))


def _filter_assoc(a_s, q_s, p0, y, r_var, mask):
    """Parallel-scan Kalman filter (Särkkä & García-Fernández 2021,
    lemmas 7-8), combined in log₂n rounds.  Returns filtered
    (m [d,n], P [d,d,n])."""
    elems = _filter_elements(a_s, q_s, y, r_var, mask)
    return _filtered(associative_scan(_filter_combine, elems), p0)


def _smooth_build(a_s, q_s, ms, ps):
    """Smoother gain/offset elements from the filtered states →
    ``(E [d,d,n], g [d,1,n], L [d,d,n])`` (last element = identity on the
    final filtered state)."""
    d = ms.shape[0]
    a_next, q_next = a_s[:, :, 1:], q_s[:, :, 1:]
    m_f, p_f = ms[:, :-1], ps[:, :, :-1]
    p_pred = _bmm(_bmm(a_next, p_f), _t(a_next)) + q_next
    g = _bmm(_bmm(p_f, _t(a_next)), _inv(p_pred))     # [d, d, n−1]
    gm = m_f - _bmv(g, _bmv(a_next, m_f))
    l_mat = p_f - _bmm(_bmm(g, p_pred), _t(g))
    e_all = torch.cat([g, torch.zeros((d, d, 1), dtype=ms.dtype, device=ms.device)], dim=-1)
    g_all = torch.cat([gm, ms[:, -1:]], dim=-1)[:, None, :]
    l_all = torch.cat([l_mat, ps[:, :, -1:]], dim=-1)
    return e_all, g_all, l_all


def _smooth_combine(suffix, elem):
    """Composition of affine smoother elements.  In the reversed scan
    arg0 is the combined LATER suffix and arg1 the earlier element; the
    recursion x_i = f_i(x_{i+1}) composes as f_elem ∘ f_suffix."""
    ea, ga, la = suffix
    eb, gb, lb = elem
    return _bmm(eb, ea), _bmm(eb, ga) + gb, _bmm(eb, _bmm(la, _t(eb))) + lb


def _smooth_scan(e_all, g_all, l_all):
    """Reversed associative scan over the affine smoother elements →
    smoothed (m [d,n], P [d,d,n])."""
    _, g_c, l_c = associative_scan(_smooth_combine, (e_all, g_all, l_all), reverse=True)
    return g_c[:, 0, :], l_c


def _smooth_assoc(a_s, q_s, ms, ps):
    """Parallel-scan RTS smoother (same paper, lemmas 9-10): build +
    reversed scan."""
    return _smooth_scan(*_smooth_build(a_s, q_s, ms, ps))


# --------------------------------------------------------------------
# public API
# --------------------------------------------------------------------


def _innovations(a_s, q_s, p_inf, r_var, ms, ps, y):
    """(m̄, P̄, S, v) of the innovation decomposition from the filtered
    states: m̄_i = A_i m_{i−1}, P̄_i = A_i P_{i−1} A_iᵀ + Q_i (i=0: prior)."""
    d = ms.shape[0]
    m_prev = torch.cat([torch.zeros((d, 1), dtype=ms.dtype, device=ms.device), ms[:, :-1]], dim=-1)
    p_prev = torch.cat([p_inf[:, :, None], ps[:, :, :-1]], dim=-1)
    m_bar = _bmv(a_s, m_prev)
    p_bar = _bmm(_bmm(a_s, p_prev), _t(a_s)) + q_s
    s = p_bar[0, 0] + r_var
    v = y - m_bar[0]
    return m_prev, p_prev, p_bar, s, v


def _nlml_terms(s, v):
    return 0.5 * torch.sum(torch.log(2.0 * math.pi * s) + torch.square(v) / s)


def nlml_ss(nu: float, params: Tensor, t: Tensor, y: Tensor, config: Config = DEFAULT, *,
            parallel: bool = True) -> Tensor:
    """Exact NLML of the 1-D Matérn-ν GP with observation noise: the dense
    ``likelihood.nlml`` of ``Sum((Matern(ν), WhiteNoise))``, at O(n) work
    and O(log n) depth.

    ``params = [σ, ℓ, σₙ]``; ``t`` sorted ascending, shape [n].
    ``parallel=True`` computes the filtered states with the associative
    scan and the innovation decomposition vectorized; ``parallel=False``
    is the sequential oracle (small n).  Differentiable by autograd.
    """
    mask = torch.ones_like(y)
    a_s, q_s, p_inf, r_var = _prep(nu, params, t, y, config)
    if not parallel:
        _, _, val = _filter_seq(a_s, q_s, p_inf, y, r_var, mask)
        return val
    ms, ps = _filter_assoc(a_s, q_s, p_inf, y, r_var, mask)
    _, _, _, s, v = _innovations(a_s, q_s, p_inf, r_var, ms, ps, y)
    return _nlml_terms(s, v)


def posterior_ss(nu: float, params: Tensor, t: Tensor, y: Tensor, tq, config: Config = DEFAULT, *,
                 parallel: bool = True) -> Tuple[Tensor, Tensor]:
    """Exact posterior mean/variance of the latent f at query times ``tq``:
    the queries are merged into the chain as unobserved steps (mask = 0:
    pure prediction), filtered and RTS-smoothed, and read back.

    The merge is host data prep (NumPy stable sort).  Returns
    ``(mean [nq], var [nq])`` of the LATENT function (add σₙ² for the
    observation-space predictive).
    """
    dtype, dev = y.dtype, y.device
    n = t.shape[0]
    t_h = t.detach().cpu().numpy() if isinstance(t, Tensor) else np.asarray(t)
    tq_h = tq.detach().cpu().numpy() if isinstance(tq, Tensor) else np.asarray(tq)
    nq = tq_h.shape[0]
    t_all = np.concatenate([t_h, tq_h])
    order = np.argsort(t_all, kind="stable")
    order_t = torch.as_tensor(order, device=dev)
    t_sorted = torch.as_tensor(t_all[order], dtype=dtype, device=dev)
    y_all = torch.cat([y, torch.zeros(nq, dtype=dtype, device=dev)])[order_t]
    mask = torch.cat([torch.ones(n, dtype=dtype, device=dev), torch.zeros(nq, dtype=dtype, device=dev)])[order_t]
    qpos = torch.as_tensor(np.argsort(order, kind="stable")[n:], device=dev)

    a_s, q_s, p_inf, r_var = _prep(nu, params, t_sorted, y_all, config)
    if parallel:
        ms, ps = _filter_assoc(a_s, q_s, p_inf, y_all, r_var, mask)
        ms_s, ps_s = _smooth_assoc(a_s, q_s, ms, ps)
    else:
        ms, ps, _ = _filter_seq(a_s, q_s, p_inf, y_all, r_var, mask)
        ms_s, ps_s = _smooth_seq(a_s, q_s, ms, ps)
    return ms_s[0][qpos], ps_s[0, 0][qpos]


class _NlmlFwdGrad(torch.autograd.Function):
    """NLML whose forward also takes ∂/∂θ by FORWARD mode (one
    ``torch.func.jvp`` a hyperparameter) and whose backward scales it."""

    @staticmethod
    def forward(ctx, params, nu, t, y, config):
        from torch.func import jvp

        f = lambda q: nlml_ss(nu, q, t, y, config)
        basis = torch.eye(params.shape[0], dtype=params.dtype, device=params.device)
        val, jac = None, []
        for e in basis:
            val, tan = jvp(f, (params,), (e,))
            jac.append(tan)
        ctx.save_for_backward(torch.stack(jac))
        return val

    @staticmethod
    def backward(ctx, g):
        (jac,) = ctx.saved_tensors
        return g * jac, None, None, None, None


def nlml_ss_fwdgrad(nu: float, params: Tensor, t: Tensor, y: Tensor, config: Config = DEFAULT) -> Tensor:
    """:func:`nlml_ss` whose gradient is computed by FORWARD mode during
    the forward pass (an autograd function: the same derivative as reverse
    mode, another evaluation order, and nothing of the scan kept for a
    backward pass)."""
    return _NlmlFwdGrad.apply(params, nu, t, y, config)


def _filter_combine_jvp(p1, p2):
    """Combine for (element, tangent-tuple) pairs: the primal
    :func:`_filter_combine` once, and its derivative along every tangent
    direction written out (the product rule on each ``_bmm`` and
    d(M⁻¹) = −M⁻¹ dM M⁻¹) — associative, since the jvp of an associative
    operation is associative on (primal, tangent) pairs."""
    e1, dts1 = p1
    e2, dts2 = p2
    a1, b1, c1, eta1, j1 = e1
    a2, b2, c2, eta2, j2 = e2
    eye = torch.eye(a1.shape[0], dtype=a1.dtype, device=a1.device)[:, :, None]
    a2t, a1t = _t(a2), _t(a1)
    m_inv = _inv(eye + _bmm(c1, j2))
    mt_inv = _inv(eye + _bmm(j2, c1))
    ma1 = _bmm(m_inv, a1)
    rb = b1 + _bmm(c1, eta2)
    mrb = _bmm(m_inv, rb)
    mc1 = _bmm(m_inv, c1)
    re = eta2 - _bmm(j2, b1)
    mre = _bmm(mt_inv, re)
    mj2 = _bmm(mt_inv, j2)
    mj2a1 = _bmm(mj2, a1)
    out = (_bmm(a2, ma1), _bmm(a2, mrb) + b2, _bmm(a2, _bmm(mc1, a2t)) + c2, _bmm(a1t, mre) + eta1,
           _bmm(a1t, mj2a1) + j1)
    douts = []
    for (da1, db1, dc1, deta1, dj1), (da2, db2, dc2, deta2, dj2) in zip(dts1, dts2):
        dm_inv = -_bmm(m_inv, _bmm(_bmm(dc1, j2) + _bmm(c1, dj2), m_inv))
        dmt_inv = -_bmm(mt_inv, _bmm(_bmm(dj2, c1) + _bmm(j2, dc1), mt_inv))
        dma1 = _bmm(dm_inv, a1) + _bmm(m_inv, da1)
        dmrb = _bmm(dm_inv, rb) + _bmm(m_inv, db1 + _bmm(dc1, eta2) + _bmm(c1, deta2))
        dmc1 = _bmm(dm_inv, c1) + _bmm(m_inv, dc1)
        dmre = _bmm(dmt_inv, re) + _bmm(mt_inv, deta2 - _bmm(dj2, b1) - _bmm(j2, db1))
        dmj2a1 = _bmm(_bmm(dmt_inv, j2) + _bmm(mt_inv, dj2), a1) + _bmm(mj2, da1)
        da2t, da1t = _t(da2), _t(da1)
        douts.append((
            _bmm(da2, ma1) + _bmm(a2, dma1),
            _bmm(da2, mrb) + _bmm(a2, dmrb) + db2,
            _bmm(da2, _bmm(mc1, a2t)) + _bmm(a2, _bmm(dmc1, a2t) + _bmm(mc1, da2t)) + dc2,
            _bmm(da1t, mre) + _bmm(a1t, dmre) + deta1,
            _bmm(da1t, mj2a1) + _bmm(a1t, dmj2a1) + dj1,
        ))
    return out, tuple(douts)


def _nlml_from_prefix(prefix, a_s, q_s, p_inf, r_var, y):
    ms, ps = _filtered(prefix, p_inf)
    _, _, _, s, v = _innovations(a_s, q_s, p_inf, r_var, ms, ps, y)
    return _nlml_terms(s, v)


def nlml_ss_value_and_grad(nu: float, params: Tensor, t: Tensor, y: Tensor,
                           config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Exact (NLML, ∂NLML/∂θ) by forward mode through ONE scan over
    (element, tangent) pairs: the elements and their tangents along each
    hyperparameter come from ``torch.func.jvp`` of the elementwise prep,
    the scan combines them with :func:`_filter_combine_jvp`, and the
    innovation NLML is differentiated along each direction.  Every leaf
    stays lane-major ``[d, ·, n]``; the tangents are a tuple of bundles,
    one a hyperparameter, never a stacked array."""
    from torch.func import jvp

    mask = torch.ones_like(y)
    params = params.detach()

    def bundle_of(p):
        a_s, q_s, p_inf, r_var = _prep(nu, p, t, y, config)
        return _filter_elements(a_s, q_s, y, r_var, mask), a_s, q_s, p_inf, r_var

    primal = bundle_of(params)
    basis = torch.eye(params.shape[0], dtype=params.dtype, device=params.device)
    tans = [jvp(bundle_of, (params,), (e,))[1] for e in basis]
    elems, a_s, q_s, p_inf, r_var = primal
    k = len(elems)
    leaves = tuple(elems) + tuple(leaf for tn in tans for leaf in tn[0])

    def combine(x1, x2):
        split = lambda x: (x[:k], tuple(x[k * (i + 1):k * (i + 2)] for i in range(len(tans))))
        out, douts = _filter_combine_jvp(split(x1), split(x2))
        return tuple(out) + tuple(leaf for dt in douts for leaf in dt)

    scanned = associative_scan(combine, leaves)
    prefix = scanned[:k]
    grads, val = [], None
    for i, tn in enumerate(tans):
        dprefix = scanned[k * (i + 1):k * (i + 2)]
        val, g = jvp(lambda pre, a, q, pi, r: _nlml_from_prefix(pre, a, q, pi, r, y),
                     (prefix, a_s, q_s, p_inf, r_var), (dprefix, tn[1], tn[2], tn[3], tn[4]))
        grads.append(g)
    return val, torch.stack(grads)


# --------------------------------------------------------------------
# Adjoint-scan exact gradient — the n = 10⁶ gradient path
# --------------------------------------------------------------------
#
# The exact ADJOINT of the innovation (prediction-error) decomposition,
# reverse-mode differentiation of the filter recursion reorganised as ONE
# backward associative scan (derivation in the JAX package's module):
#
#   NLML = Σₜ ½(log 2πSₜ + vₜ²/Sₜ),    eₜ = vₜ/Sₜ,
#   cₜ = ½(1/Sₜ − vₜ²/Sₜ²),            Λₜ = Aₜ₊₁(I − KₜH),
#   ḡₜ := ∂NLML/∂m̄ₜ = −Hᵀeₜ + Λₜᵀḡₜ₊₁,
#   Γₜ := ∂NLML/∂P̄ₜ = cₜHᵀH + sym(Λₜᵀḡₜ₊₁ eₜᵀH) + ΛₜᵀΓₜ₊₁Λₜ,
#
# an affine backward recursion in (ḡ, Γ) that closes under composition of
# elements (E, u, C, h).  The gradient is then the θ-gradient of a LINEAR
# functional of (A(θ), Q(θ), σₙ²(θ)) with the adjoints held fixed:
#
#   ∂NLML/∂θ = ∂θ[ Σₜ ḡₜᵀ(Aₜ(θ) mₜ₋₁) + Σₜ ⟨Γₜ, Aₜ(θ)Pₜ₋₁Aₜ(θ)ᵀ + Qₜ(θ)⟩
#                 + (Σₜ cₜ + indirect gain terms)·σₙ²(θ) ].
#
# The arithmetic is reverse-mode autograd's own, so it matches autograd to
# round-off in f64 and f32; tied steps (Δt = 0: A ≡ I, Q ≡ 0) contribute
# zero through the functional with no special case.


def _adj_stage_a(nu, params, t, y, config=DEFAULT):
    """Adjoint-gradient stage A: prep + parallel filter + innovation NLML
    value + per-step adjoint elements.  Returns
    ``(elems, m_prev, p_prev, (c, e, w_r), val)`` with
    ``elems = (Λ [d,d,n], u [d,1,n], C [d,d,n], h [d,1,n])``."""
    d = _ssm_dim(nu)
    dtype, dev = y.dtype, y.device
    mask = torch.ones_like(y)
    a_s, q_s, p_inf, r_var = _prep(nu, params, t, y, config)
    ms, ps = _filter_assoc(a_s, q_s, p_inf, y, r_var, mask)
    m_prev, p_prev, p_bar, s, v = _innovations(a_s, q_s, p_inf, r_var, ms, ps, y)
    val = _nlml_terms(s, v)
    e_in = v / s
    c = 0.5 * (1.0 / s - torch.square(v) / torch.square(s))
    k = p_bar[:, 0] / s                                   # gain [d, n]
    col0 = (torch.arange(d, device=dev) == 0).to(dtype)  # H row
    ikh = torch.eye(d, dtype=dtype, device=dev)[:, :, None] - k[:, None, :] * col0[None, :, None]
    a_next = torch.cat([a_s[:, :, 1:], torch.zeros((d, d, 1), dtype=dtype, device=dev)], dim=-1)
    lam = _bmm(a_next, ikh)
    u = -(col0[:, None, None] * e_in[None, None, :])      # −Hᵀe [d,1,n]
    h = -u                                                # +Hᵀe
    c_mat = c[None, None, :] * col0[:, None, None] * col0[None, :, None]
    w_r = _bmv(a_next, k)                                 # A_{t+1}K_t
    return (lam, u, c_mat, h), m_prev, p_prev, (c, e_in, w_r), val


def _adj_combine(suffix, elem):
    """Composition of adjoint affine elements.  In the reversed scan arg0
    is the combined LATER suffix, arg1 the earlier element; the result is
    f_elem ∘ f_suffix."""
    es, us, cs, hs = suffix
    ee, ue, ce, he = elem
    eet = _t(ee)
    g_mid = _bmm(eet, us)                   # E_eᵀ u_s  [d,1,n]
    cross = _bmm(g_mid, _t(he))             # outer(E_eᵀu_s, h_e)
    c_out = ce + 0.5 * (cross + _t(cross)) + _bmm(eet, _bmm(cs, ee))
    return _bmm(es, ee), ue + g_mid, c_out, he + _bmm(eet, hs)


def _adj_stage_b(elems):
    """Adjoint-gradient stage B: the reversed associative scan over the
    (E, u, C, h) elements.  Returns ``(ḡ [d,n], Γ [d,d,n])``."""
    _, u_c, c_c, _ = associative_scan(_adj_combine, elems, reverse=True)
    return u_c[:, 0, :], c_c


def _adj_stage_c(nu, params, t, y, gbar, gam, m_prev, p_prev, aux, config=DEFAULT):
    """Adjoint-gradient stage C: ∂NLML/∂θ as the autograd gradient of the
    LINEAR functional of (A(θ), Q(θ), σₙ²(θ)) whose coefficients are the
    detached adjoints — elementwise in n.

    The σₙ² coefficient has three parts: the direct Σcₜ, plus the two
    INDIRECT per-step paths of R through the gain — δmₜ = −Kₜeₜ·δR and
    δPₜ = KₜKₜᵀ·δR — weighted by the NEXT step's adjoints (wₜ = Aₜ₊₁Kₜ):
    Σₜ[−eₜ·ḡₜ₊₁ᵀwₜ + wₜᵀΓₜ₊₁wₜ].
    """
    c, e_in, w_r = aux
    gbar_n = torch.cat([gbar[:, 1:], torch.zeros_like(gbar[:, :1])], dim=-1)           # ḡ_{t+1}
    gam_n = torch.cat([gam[:, :, 1:], torch.zeros_like(gam[:, :, :1])], dim=-1)        # Γ_{t+1}
    r_coef = (torch.sum(c) - torch.sum(e_in * torch.sum(gbar_n * w_r, dim=0))
              + torch.sum(w_r[:, None, :] * gam_n * w_r[None, :, :]))
    gbar, gam, m_prev, p_prev, r_coef = (z.detach() for z in (gbar, gam, m_prev, p_prev, r_coef))
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        a_s, q_s, _p_inf, r_var = _prep(nu, p, t, y, config)
        m_bar = _bmv(a_s, m_prev)
        p_bar = _bmm(_bmm(a_s, p_prev), _t(a_s)) + q_s
        functional = torch.sum(gbar * m_bar) + torch.sum(gam * p_bar) + r_coef * r_var
        (g,) = torch.autograd.grad(functional, p)
    return g


def nlml_ss_adjoint_value_and_grad(nu: float, params: Tensor, t: Tensor, y: Tensor,
                                   config: Config = DEFAULT) -> Tuple[Tensor, Tensor]:
    """Exact (NLML, ∂NLML/∂θ) by the adjoint scan: stage A is the filter
    (one scan), stage B one backward affine scan over the (E, u, C, h)
    adjoint elements, and stage C — the only differentiated part — an
    elementwise linear functional.  No scan is differentiated, so memory
    stays a few [d, d, n] arrays at any n: the n = 10⁶ gradient path.

    Reference contract: ``MLE.loss_and_grad`` (PyGPR ``loss.py:84-128``),
    the same exact quantities at a scale the dense pipeline cannot hold.
    """
    with torch.no_grad():
        params = params.detach()
        elems, m_prev, p_prev, aux, val = _adj_stage_a(nu, params, t, y, config)
        gbar, gam = _adj_stage_b(elems)
        del elems
    grad = _adj_stage_c(nu, params, t, y, gbar, gam, m_prev, p_prev, aux, config)
    return val, grad


class FitSSResult(NamedTuple):
    params: Tensor
    nlml: Tensor
    converged: Tensor


def _default_params(like: Tensor) -> Tensor:
    return torch.tensor([1.0, 1.0, 0.3], dtype=like.dtype, device=like.device)


def fit_ss(nu: float, t: Tensor, y: Tensor, params0: Optional[Tensor] = None, *, max_iter: int = 150,
           tol: float = 1e-4, config: Config = DEFAULT) -> FitSSResult:
    """L-BFGS on the O(n) exact NLML, log-space (``fit_mle`` policy)."""
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs

    if params0 is None:
        params0 = _default_params(y)
    u0 = torch.log(torch.abs(params0))
    res = minimize_lbfgs(lambda u: nlml_ss(nu, torch.exp(u), t, y, config), u0, max_iter=max_iter, tol=tol)
    return FitSSResult(params=torch.exp(res.params), nlml=res.value, converged=res.converged)


def fit_ss_large(nu: float, t: Tensor, y: Tensor, params0: Optional[Tensor] = None, *, max_iter: int = 100,
                 tol: Optional[float] = None, grad_method: str = "auto", config: Config = DEFAULT) -> FitSSResult:
    """Hyperparameter fit for large n: SciPy L-BFGS-B on the host, one
    value + gradient call an evaluation, log-space.

    ``tol`` is SciPy's ``ftol``; the default is dtype-aware (1e-9 for f64,
    1e-6 for f32 — an f32 objective cannot satisfy f64-grade decrease
    tests, which would report ``converged=False`` on a converged fit).

    ``grad_method``: ``"ad"`` is reverse-mode autograd through the scan
    (its memory keeps every round's temporaries); ``"adjoint"`` is
    :func:`nlml_ss_adjoint_value_and_grad`; ``"auto"`` (default) picks the
    adjoint from n ≥ 200 000, the JAX package's rule.  ``"fisher"`` is
    kept as an alias of ``"adjoint"``.
    """
    from scipy.optimize import minimize

    if params0 is None:
        params0 = _default_params(y)
    u0 = np.log(np.abs(np.asarray(torch.as_tensor(params0).detach().cpu(), np.float64)))
    if grad_method == "auto":
        grad_method = "adjoint" if t.shape[0] >= 200_000 else "ad"
    as_p = lambda u: torch.as_tensor(u, dtype=y.dtype, device=y.device)

    if grad_method in ("adjoint", "fisher"):
        def f(u):
            p = torch.exp(as_p(u))
            v, g = nlml_ss_adjoint_value_and_grad(nu, p, t, y, config)
            # chain rule to log-space: ∂/∂u = ∂/∂p · p
            return float(v), g.detach().cpu().numpy().astype(np.float64) * np.exp(u)
    else:
        def f(u):
            uu = as_p(u).requires_grad_(True)
            with torch.enable_grad():
                v = nlml_ss(nu, torch.exp(uu), t, y, config)
                (g,) = torch.autograd.grad(v, uu)
            return float(v.detach()), g.cpu().numpy().astype(np.float64)

    if tol is None:
        tol = 1e-9 if y.dtype == torch.float64 else 1e-6
    res = minimize(f, u0, jac=True, method="L-BFGS-B", options={"maxiter": max_iter, "ftol": tol, "gtol": 1e-5})
    return FitSSResult(params=torch.exp(as_p(res.x)), nlml=as_p(res.fun), converged=torch.tensor(bool(res.success)))


class StateSpaceGP:
    """OO wrapper for 1-D Matérn time series.  NumPy inputs go to
    ``device`` (``"cuda"`` unless given, see ``config.as_tensor``).

    >>> gp = StateSpaceGP(t, y, nu=1.5)
    >>> gp.train()
    >>> mean, var = gp.predict(tq)
    """

    def __init__(self, t, y, nu: float = 1.5, params=None, config: Config = DEFAULT, device=None):
        t = as_tensor(t, device)
        assert t.ndim == 1, "StateSpaceGP is for 1-D time series"
        self.t = t
        self.y = as_tensor(y, t.device)
        self.nu = nu
        self.config = config
        self.params = _default_params(self.y) if params is None else as_tensor(params, t.device)

    def train(self, max_iter: int = 150, **kwargs) -> FitSSResult:
        res = fit_ss(self.nu, self.t, self.y, self.params, max_iter=max_iter, config=self.config, **kwargs)
        self.params = res.params
        return res

    def nlml(self) -> float:
        with torch.no_grad():
            return float(nlml_ss(self.nu, self.params, self.t, self.y, self.config))

    def predict(self, tq, observation: bool = False):
        with torch.no_grad():
            mean, var = posterior_ss(self.nu, self.params, self.t, self.y, tq, self.config)
            if observation:
                var = var + torch.square(self.params[-1])
        return mean, var
