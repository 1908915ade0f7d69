"""L-BFGS hyperparameter fits.

Counterpart of ``pygpr_tpu/optimize/lbfgs.py``, which runs optax's
L-BFGS (``optax.lbfgs`` with its default zoom line search) inside one
``lax.while_loop``.  This module is the same algorithm written out in
torch, step for step: the scaled-identity two-loop preconditioner with
``memory_size`` pairs, the zoom line search of Nocedal and Wright
(Algorithms 3.5 and 3.6) with the approximate-decrease test of Hager and
Zhang, and the same stopping rule, so that the two packages take the
same iterates up to round-off.  ``torch.optim.LBFGS`` takes other
iterates and, from the reference's inits (noise 1e-4), can stall in
another basin or step into NaN; optax's line search treats a non-finite
value as a failed step.

The parameters are a short vector, so the line search runs its scalar
logic on the host in float64 (one host read of the value and slope per
evaluation, which the NLML's jitter ladder pays anyway).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.models.likelihood import nlml, nlml_fast
from pygpr_torch.ops.kernels import Kernel

Tensor = torch.Tensor

# optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one"), the line search of optax.lbfgs
_LS_STEPS = 20
_INCREASE = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5


class FitResult(NamedTuple):
    """Result of a minimization."""

    params: Tensor     #: optimized parameters
    value: Tensor      #: final objective value
    grad_norm: Tensor  #: final gradient 2-norm
    iters: Tensor      #: iterations taken
    converged: Tensor  #: grad_norm < tol at exit


def _value_and_grad(fun, u: Tensor):
    u = u.detach().requires_grad_(True)
    with torch.enable_grad():
        v = fun(u)
        (g,) = torch.autograd.grad(v, u)
    return v.detach(), g


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc**2 * r1 + -(db**2) * r2) / denom
    B = (-(dc**3) * r1 + db**3 * r2) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Minimizer of the quadratic through (a, fa, fpa) and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _zoom_linesearch(vg, params: Tensor, d: Tensor, value: Tensor, grad: Tensor):
    """Step size along ``d`` from ``params`` satisfying the strong Wolfe
    conditions, as optax's zoom line search computes it.  Returns
    ``(stepsize, value, grad)`` at the chosen step.  Scalars are numpy
    float64, whose NaN and inf follow IEEE as jnp's do (the caller
    silences numpy's warnings about them)."""
    f64 = np.float64
    f0, s0 = f64(value.item()), f64(torch.dot(d, grad).item())

    def on_line(t):
        v, g = vg(params + t * d)
        return v, g, f64(v.item()), f64(torch.dot(g, d).item())

    def errors(t, v, s):
        dec = v - f0 - _SLOPE_RTOL * t * s0
        approx = np.maximum(s - (2 * _SLOPE_RTOL - 1.0) * s0, v - f0 - _APPROX_DEC_RTOL * np.abs(f0))
        dec = np.maximum(np.minimum(approx, dec), 0.0)
        curv = np.maximum(np.abs(s) - _CURV_RTOL * np.abs(s0), 0.0)
        dec, curv = (np.inf if np.isnan(e) else e for e in (dec, curv))
        return dec, curv, np.maximum(dec, curv)

    count, found, done, failed = 0, False, False, False
    t, vt, gt, ft, st = f64(0.0), value, grad, f0, s0
    lo, f_lo, s_lo = f64(0.0), f0, s0
    hi, f_hi, s_hi = f64(0.0), f0, s0
    ref, f_ref = f64(0.0), f0
    safe = (f64(0.0), value, grad, f0)
    dec = f64(np.inf)
    while not (done or failed):
        if not found:
            # Algorithm 3.5: grow the step until an interval brackets it
            new = f64(1.0) if count == 0 else _INCREASE * t
            v, g, fv, sv = on_line(new)
            dec, curv, err = errors(new, fv, sv)
            if dec <= 0.0:
                safe = (new, v, g, fv)
            high_new = dec > 0.0 or (fv >= ft and count > 0)
            low_new = sv >= 0.0 and not high_new
            if low_new:
                lo, f_lo, s_lo, hi, f_hi, s_hi = new, fv, sv, t, ft, st
            else:
                lo, f_lo, s_lo, hi, f_hi, s_hi = t, ft, st, new, fv, sv
            ref, f_ref = lo, f_lo
            found = high_new or low_new or err <= 0.0
            done = err <= 0.0
            failed = count + 1 >= _LS_STEPS and not done
        else:
            # Algorithm 3.6: shrink the interval by safeguarded interpolation
            delta = np.abs(hi - lo)
            left, right = np.minimum(hi, lo), np.maximum(hi, lo)
            mid_c = _cubicmin(lo, f_lo, s_lo, hi, f_hi, ref, f_ref)
            mid_q = _quadmin(lo, f_lo, s_lo, hi, f_hi)
            if left + 0.2 * delta < mid_c < right - 0.2 * delta:
                new = mid_c
            elif left + 0.1 * delta < mid_q < right - 0.1 * delta:
                new = mid_q
            else:
                new = (lo + hi) / 2.0
            v, g, fv, sv = on_line(new)
            dec, curv, err = errors(new, fv, sv)
            if dec <= 0.0 and fv < safe[3]:
                safe = (new, v, g, fv)
            done = err <= 0.0
            high_mid = dec > 0.0 or fv >= f_lo
            high_lo = sv * (hi - lo) >= 0.0 and not high_mid
            if high_mid or high_lo:
                ref, f_ref = hi, f_hi
            else:
                ref, f_ref = lo, f_lo
            if high_mid:
                hi, f_hi, s_hi = new, fv, sv
            elif high_lo:
                hi, f_hi, s_hi = lo, f_lo, s_lo
            if not high_mid:
                lo, f_lo, s_lo = new, fv, sv
            too_small = delta <= _INTERVAL_THRESHOLD
            failed = (count + 1 >= _LS_STEPS or (too_small and safe[0] > 0.0)) and not done
        count += 1
        t, vt, gt, ft, st = new, v, g, fv, sv
    if failed and (safe[0] > 0.0 or np.isinf(dec)):
        # no step met both conditions: take the best with sufficient
        # decrease, or none when every step left the domain (inf or NaN)
        t, vt, gt = safe[0], safe[1], safe[2]
    return float(t), vt, gt


def _precondition(g: Tensor, dw, du, rho, scale: float, idx: int, memory_size: int) -> Tensor:
    """optax's two-loop product of the L-BFGS inverse-Hessian estimate
    with ``g`` over the circular memory (empty slots have weight 0)."""
    order = [(idx + j) % memory_size for j in range(memory_size)]
    vec, alphas = g, {}
    for i in reversed(order):
        alphas[i] = rho[i] * torch.dot(dw[i], vec).item()
        vec = vec + (-alphas[i]) * du[i]
    vec = scale * vec
    for i in order:
        beta = rho[i] * torch.dot(du[i], vec).item()
        vec = vec + (alphas[i] - beta) * dw[i]
    return vec


def minimize_lbfgs(
    fun: Callable[[Tensor], Tensor],
    x0: Tensor,
    *,
    max_iter: int = 200,
    tol: float = 1e-4,
    memory_size: int = 15,
) -> FitResult:
    """Minimize the scalar ``fun`` from ``x0`` with L-BFGS: at least one
    iteration, then until ``‖∇f‖₂ < tol`` or ``max_iter`` iterations."""
    m = memory_size
    params = x0.detach().clone()
    zeros = torch.zeros_like(params)
    dw, du, rho = [zeros] * m, [zeros] * m, [0.0] * m
    prev_params, prev_grad = zeros, zeros
    value, grad = None, zeros
    it = 0
    while it == 0 or (it < max_iter and torch.linalg.vector_norm(grad).item() >= tol):
        if value is None or not math.isfinite(value.item()):
            value, grad = _value_and_grad(fun, params)
        # the memory pair of the step just taken (none before the first)
        if it > 0:
            s, y = params - prev_params, grad - prev_grad
            sy = torch.dot(y, s).item()
            yy = torch.dot(y, y).item()
            slot = (it - 1) % m
            dw[slot], du[slot], rho[slot] = s, y, 0.0 if sy == 0.0 else 1.0 / sy
            scale = sy / yy if yy > 0.0 else 1.0
        else:
            with np.errstate(divide="ignore"):
                scale = float(np.minimum(1.0, 1.0 / np.float64(torch.linalg.vector_norm(grad).item())))
        d = -_precondition(grad, dw, du, rho, scale, it % m, m)
        prev_params, prev_grad = params, grad
        with np.errstate(all="ignore"):
            t, value, grad = _zoom_linesearch(lambda u: _value_and_grad(fun, u), params, d, value, grad)
        params = params + t * d
        it += 1
    gnorm = torch.linalg.vector_norm(grad)
    return FitResult(params=params, value=value, grad_norm=gnorm, iters=torch.tensor(it), converged=gnorm < tol)


def _stack(results):
    return FitResult(*(torch.stack(list(f)) for f in zip(*results)))


def fit_mle(
    kern: Kernel,
    params0,
    x,
    y,
    *,
    config: Config = DEFAULT,
    max_iter: int = 200,
    tol: float = 1e-4,
    memory_size: int = 15,
    log_space: bool = True,
    objective=None,
    device=None,
) -> FitResult:
    """Fit kernel hyperparameters by minimizing the NLML with L-BFGS.

    ``objective`` replaces the criterion with any
    ``f(kern, params, x, y, config) -> scalar``.  ``log_space=True``
    searches u = log θ and returns θ = exp(u): from the reference's
    inits (noise 1e-4) the raw landscape is badly scaled.  A leading
    committee axis ``[nc, n, d]`` fits each expert on its own.

    NumPy ``x``/``y`` go to ``device`` ("cuda" unless given; no GPU
    raises); tensors stay where they are, and ``params0`` follows ``x``.
    """
    x = as_tensor(x, device)
    y = as_tensor(y, x.device)
    params0 = torch.as_tensor(params0, dtype=x.dtype, device=x.device)
    if objective is None:
        objective = nlml_fast if config.grad_mode == "fast" else nlml

    def solve_one(p0, xx, yy):
        if log_space:
            res = minimize_lbfgs(
                lambda u: objective(kern, torch.exp(u), xx, yy, config),
                torch.log(torch.abs(p0)),
                max_iter=max_iter, tol=tol, memory_size=memory_size,
            )
            return res._replace(params=torch.exp(res.params))
        return minimize_lbfgs(
            lambda q: objective(kern, q, xx, yy, config),
            p0, max_iter=max_iter, tol=tol, memory_size=memory_size,
        )

    if x.ndim == 3:
        return _stack(
            solve_one(params0[i] if params0.ndim == 2 else params0, x[i], y[i])
            for i in range(x.shape[0])
        )
    return solve_one(params0, x, y)


def fit_map(kern: Kernel, params0, x, y, priors, **kwargs) -> FitResult:
    """MAP fit: minimize ``nlml(θ) − Σᵢ log pᵢ(θᵢ)``.

    ``priors`` aligns with the packed parameter vector
    (:mod:`pygpr_torch.models.priors`); ``None`` entries are flat.  Same
    keywords, committee axis and log-space default as :func:`fit_mle`.
    """
    from pygpr_torch.models.priors import log_prior

    config = kwargs.get("config", DEFAULT)
    base = nlml_fast if config.grad_mode == "fast" else nlml

    def objective(k, p, xx, yy, cfg):
        return base(k, p, xx, yy, cfg) - log_prior(priors, p)

    return fit_mle(kern, params0, x, y, objective=objective, **kwargs)
