"""No-U-Turn Sampler (NUTS) over GP hyperparameters.

Counterpart of ``pygpr_tpu/sample/nuts.py``: multinomial NUTS (Hoffman
and Gelman 2014; Betancourt 2017, app. A.3) in its iterative form, a
checkpoint buffer of ``max_depth + 1`` slots holding sub-trajectory left
endpoints so that every dyadic sub-tree U-turn check of the recursive
algorithm runs in O(max_depth) memory (Phan and Pradhan 2019, §A), with
the momentum-sum U-turn criterion, two dual-averaging warmup phases
(Stan's γ = 0.05, t₀ = 10, κ = 0.75) around a Welford pass that estimates
a diagonal metric.

The JAX package ``vmap``s its chains through two nested
``lax.while_loop``s; under ``vmap`` a loop runs until every chain stops,
and a chain that has stopped keeps its carry frozen.  Here the chains lie
on a leading axis and the loops run on the host while any chain is
active, with masked updates:

  * the doublings: one "any active" flag read on the host per doubling.
    Every chain active at doubling k has depth k, so the leaves of a
    subtree run in lock step and the leaf index (and the checkpoint slot
    arithmetic) is one host integer;
  * the leaves of a subtree: one flag read per leaf, beside the ladder's
    own sync of the gradient's factorization, so that a subtree that
    turns at its second leaf does not spend the other 2^k − 2 gradients.

A chain that has stopped takes no further draw or gradient into its
state: its entries of each batched draw are ignored, and its leapfrog is
evaluated at its transition's start (a point already factored, so its
discarded gradient adds no rung of the jitter ladder).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops.kernels import Kernel
from pygpr_torch.sample.mcmc import _data, _draw, _start, _value_and_grad, log_posterior_fn

Tensor = torch.Tensor

_DIVERGENCE = 1000.0     # Stan's energy-error divergence threshold
_DA_GAMMA = 0.05         # dual-averaging shrinkage
_DA_T0 = 10.0            # dual-averaging iteration offset
_DA_KAPPA = 0.75         # dual-averaging decay


class NUTSResult(NamedTuple):
    samples: Tensor          #: [C, n_samples, nhp] θ-space draws
    log_prob: Tensor         #: [C, n_samples] unnormalized log-posterior
    accept_rate: Tensor      #: [C] mean accept statistic (sampling phase)
    step_size: Tensor        #: [C] adapted leapfrog step size
    tree_depth: Tensor       #: [C] mean tree depth (sampling phase)
    divergence_rate: Tensor  #: [C] fraction of divergent transitions
    inv_mass: Tensor         #: [C, nhp] adapted diagonal inverse metric


def _popcount(i, nbits: int):
    """Set bits of ``i`` (an integer or an integer tensor) below ``nbits``."""
    acc = i * 0
    for b in range(nbits):
        acc = acc + ((i >> b) & 1)
    return acc


def _trailing_ones(i, nbits: int):
    # trailing_ones(n) = ctz(n+1); ctz(x) = popcount((x & -x) − 1)
    x = i + 1
    return _popcount((x & -x) - 1, nbits + 1)


def _nuts_transition(vg: Callable, u: Tensor, lp_u: Tensor, grad_u: Tensor, generator: torch.Generator,
                     eps: Tensor, inv_mass: Tensor, max_depth: int):
    """One multinomial-NUTS transition of the chains ``u [C, nhp]``, with
    step ``eps [C]`` and metric ``inv_mass [C, nhp]``.  Returns
    ``(u', lp', grad', accept_stat [C], depth [C], diverged [C])``.

    The carries are grouped for the masked updates: the trajectory's
    vectors ``[C, k, nhp]``, its scalars ``[C, k]`` and its two flags
    (turning, diverging) ``[C, 2]``."""
    C, nhp = u.shape
    nbits = max_depth + 1
    slots = max_depth + 1

    def kinetic(p):
        return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

    p0 = _draw(generator, (C, nhp), u) * torch.sqrt(1.0 / inv_mass)
    h0 = -lp_u + kinetic(p0)
    zero = torch.zeros_like(lp_u)
    # the trajectory: vectors (q_l, p_l, g_l, q_r, p_r, g_r, rho, prop_q,
    # prop_g), scalars (log_w, prop_lp, sum_alpha, n_alpha), flags
    tv = torch.stack([u, p0, grad_u, u, p0, grad_u, p0, u, grad_u], dim=1)
    ts = torch.stack([zero, lp_u, zero, zero], dim=1)
    tf = torch.zeros((C, 2), dtype=torch.bool, device=u.device)
    depth_c = torch.zeros(C, dtype=torch.int64, device=u.device)

    for depth in range(max_depth):
        active = ~tf.any(dim=1)
        if not bool(active.any()):
            break
        n_leaf = 1 << depth
        draws = _draw(generator, (n_leaf + 2, C), u, "uniform")
        go_right = draws[0] < 0.5
        step = torch.where(go_right, eps, -eps)[:, None]
        side = go_right[:, None, None]
        # the subtree: vectors (q, p, g, rho_prefix, prop_q, prop_g),
        # scalars (log_w_sub, prop_lp, sum_alpha, n_alpha), flags, and the
        # checkpoints (v, rho) of its even leaves [C, 2, slots, nhp]
        start = torch.where(side, tv[:, 3:6], tv[:, 0:3])
        sv = torch.cat([start, torch.zeros_like(u)[:, None], start[:, 0:1], start[:, 2:3]], dim=1)
        ss = torch.stack([torch.full_like(lp_u, -math.inf), torch.full_like(lp_u, -math.inf), zero, zero], dim=1)
        sf = torch.zeros((C, 2), dtype=torch.bool, device=u.device)
        ck = torch.zeros((C, 2, slots, nhp), dtype=u.dtype, device=u.device)

        # ---- one doubling: 2^depth leaves from the chosen endpoint --------
        for i in range(n_leaf):
            live = active & ~sf.any(dim=1)
            if i > 0 and not bool(live.any()):
                break
            q, p, g, rho_prefix, prop_q, prop_g = sv.unbind(1)
            log_w_sub, prop_lp, sum_alpha, n_alpha = ss.unbind(1)
            p_half = p + 0.5 * step * g
            q = q + step * inv_mass * p_half
            lp_q, g = vg(torch.where(live[:, None], q, u))
            p = p_half + 0.5 * step * g
            d_e = -lp_q + kinetic(p) - h0
            bad = ~torch.isfinite(d_e)
            diverging = bad | (d_e > _DIVERGENCE)
            log_w = torch.where(bad, -math.inf, -d_e)
            alpha = torch.where(bad, 0.0, torch.clamp_max(torch.exp(-d_e), 1.0))
            v = inv_mass * p
            rho_after = rho_prefix + p

            # progressive multinomial proposal within the subtree
            new_tot = torch.logaddexp(log_w_sub, log_w)
            take = torch.log(draws[2 + i]) < log_w - new_tot
            turning = torch.zeros_like(live)
            if i & 1 == 0:
                # checkpoint store (even leaf) at slot popcount(i)
                slot = _popcount(i, nbits)
                ck[:, :, slot] = torch.where(live[:, None, None], torch.stack([v, rho_prefix], dim=1),
                                             ck[:, :, slot])
            else:
                # dyadic U-turn checks (odd leaf): slots idx_min..idx_max
                idx_max = _popcount(i >> 1, nbits)
                idx_min = idx_max - _trailing_ones(i, nbits) + 1
                lo, hi = max(idx_min, 0), min(idx_max, slots - 1) + 1
                if lo < hi:
                    rho_rng = rho_after[:, None, :] - ck[:, 1, lo:hi]
                    c1 = torch.sum(rho_rng * ck[:, 0, lo:hi], dim=-1) < 0.0
                    c2 = torch.sum(rho_rng * v[:, None, :], dim=-1) < 0.0
                    turning = torch.any(c1 | c2, dim=-1)
            t1 = take[:, None]
            sv_new = torch.stack([q, p, g, rho_after, torch.where(t1, q, prop_q), torch.where(t1, g, prop_g)], dim=1)
            ss_new = torch.stack([new_tot, torch.where(take, lp_q, prop_lp), sum_alpha + alpha, n_alpha + 1.0], dim=1)
            sv = torch.where(live[:, None, None], sv_new, sv)
            ss = torch.where(live[:, None], ss_new, ss)
            sf = torch.where(live[:, None], torch.stack([turning, diverging], dim=1), sf)

        ok = active & ~sf.any(dim=1)
        # biased progressive sampling across the doubling
        take = ok & (torch.log(draws[1]) < ss[:, 0] - ts[:, 0])
        t1 = take[:, None, None]
        prop = torch.where(t1, sv[:, 4:6], tv[:, 7:9])
        log_w = torch.where(ok, torch.logaddexp(ts[:, 0], ss[:, 0]), ts[:, 0])
        prop_lp = torch.where(take, ss[:, 1], ts[:, 1])
        # extend the endpoint the subtree grew from
        grow = ok[:, None, None]
        left = torch.where(grow & ~side, sv[:, 0:3], tv[:, 0:3])
        right = torch.where(grow & side, sv[:, 0:3], tv[:, 3:6])
        rho = torch.where(grow[:, 0], tv[:, 6] + sv[:, 3], tv[:, 6])
        # merged-trajectory U-turn check (momentum-sum criterion)
        turn_top = ((torch.sum(rho * inv_mass * left[:, 1], dim=-1) < 0.0)
                    | (torch.sum(rho * inv_mass * right[:, 1], dim=-1) < 0.0))
        tv_new = torch.cat([left, right, rho[:, None], prop], dim=1)
        ts_new = torch.stack([log_w, prop_lp, ts[:, 2] + ss[:, 2], ts[:, 3] + ss[:, 3]], dim=1)
        tf_new = torch.stack([sf[:, 0] | (ok & turn_top), sf[:, 1]], dim=1)
        tv = torch.where(active[:, None, None], tv_new, tv)
        ts = torch.where(active[:, None], ts_new, ts)
        tf = torch.where(active[:, None], tf_new, tf)
        depth_c = depth_c + active.to(depth_c.dtype)

    accept_stat = ts[:, 2] / torch.clamp_min(ts[:, 3], 1.0)
    return tv[:, 7], ts[:, 1], tv[:, 8], accept_stat, depth_c, tf[:, 1]


def _dual_avg_update(m, h_bar, log_eps_bar, stat, mu, dtype=None):
    """One Nesterov dual-averaging step (m is 1-based)."""
    mf = float(m)
    h_bar = (1.0 - 1.0 / (mf + _DA_T0)) * h_bar + stat / (mf + _DA_T0)
    log_eps = mu - math.sqrt(mf) / _DA_GAMMA * h_bar
    w = mf ** (-_DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return h_bar, log_eps_bar, log_eps


def run_nuts(lp: Callable[[Tensor], Tensor], u0: Tensor, generator: torch.Generator, *, n_samples: int,
             n_warmup: int, max_depth: int = 6, target_accept: float = 0.8, init_step: float = 0.1,
             adapt_mass: bool = True, sync_fn: Callable[[Tensor], Tensor] = lambda s: s):
    """NUTS chains on a log-density ``lp`` that maps ``[C, nhp]`` to ``[C]``:
    warmup (dual averaging, and a diagonal-metric Welford pass unless
    ``adapt_mass`` is False), then sampling.  ``u0`` is ``[C, nhp]``, or
    ``[nhp]`` for one chain (then the results have no chain axis).  Returns
    the fields of :class:`NUTSResult`, the draws in u."""
    one = u0.ndim == 1
    u = u0[None] if one else u0
    dtype = u.dtype
    C, nhp = u.shape

    def vg(q):
        return _value_and_grad(lp, q)

    lp_u, g_u = vg(u)
    nw1 = n_warmup // 2 if adapt_mass else n_warmup
    nw2 = n_warmup - nw1
    discard = max(nw1 // 4, 1)

    def warm_phase(u, lp_u, g_u, log_eps0, nw, inv_mass, collect):
        """Dual-averaging warmup; optionally Welford-collect u."""
        mu = math.log(10.0) + log_eps0
        h_bar = torch.zeros(C, dtype=dtype, device=u.device)
        log_eps_bar, log_eps = log_eps0, log_eps0
        w_cnt = torch.zeros(C, dtype=dtype, device=u.device)
        w_mean = torch.zeros((C, nhp), dtype=dtype, device=u.device)
        w_m2 = torch.zeros((C, nhp), dtype=dtype, device=u.device)
        for m in range(1, nw + 1):
            u, lp_u, g_u, alpha, _, _ = _nuts_transition(vg, u, lp_u, g_u, generator, torch.exp(log_eps), inv_mass,
                                                          max_depth)
            stat = sync_fn(target_accept - alpha)
            h_bar, log_eps_bar, log_eps = _dual_avg_update(m, h_bar, log_eps_bar, stat, mu, dtype)
            if collect:
                take = float(m > discard)
                cnt = w_cnt + take
                delta = u - w_mean
                w_mean = w_mean + take * delta / torch.clamp_min(cnt, 1.0)[:, None]
                w_m2 = w_m2 + take * delta * (u - w_mean)
                w_cnt = cnt
        return u, lp_u, g_u, log_eps_bar, w_cnt, w_m2

    inv_mass = torch.ones((C, nhp), dtype=dtype, device=u.device)
    log_eps = torch.full((C,), math.log(init_step), dtype=dtype, device=u.device)
    u, lp_u, g_u, log_eps, w_cnt, w_m2 = warm_phase(u, lp_u, g_u, log_eps, nw1, inv_mass, adapt_mass)
    if adapt_mass and nw2 > 0:
        # Stan-style regularized diagonal metric from the Welford pass
        var = w_m2 / torch.clamp_min(w_cnt - 1.0, 1.0)[:, None]
        n_eff = torch.clamp_min(w_cnt, 1.0)[:, None]
        inv_mass = torch.where((w_cnt > 2.0)[:, None], (n_eff / (n_eff + 5.0)) * var + (5.0 / (n_eff + 5.0)) * 1e-3,
                               inv_mass)
        u, lp_u, g_u, log_eps, _, _ = warm_phase(u, lp_u, g_u, log_eps, nw2, inv_mass, False)

    eps = torch.exp(log_eps)
    us, lps, alphas, depths, divs = [], [], [], [], []
    for _ in range(n_samples):
        u, lp_u, g_u, alpha, depth, div = _nuts_transition(vg, u, lp_u, g_u, generator, eps, inv_mass, max_depth)
        us.append(u)
        lps.append(lp_u)
        alphas.append(alpha)
        depths.append(depth.to(dtype))
        divs.append(div.to(dtype))
    out = (torch.stack(us, dim=1), torch.stack(lps, dim=1), torch.stack(alphas, 1).mean(1), eps,
           torch.stack(depths, 1).mean(1), torch.stack(divs, 1).mean(1), inv_mass)
    return tuple(o[0] for o in out) if one else out


def sample_posterior_nuts(kern: Kernel, x: Tensor, y: Tensor, generator: torch.Generator, params0=None, *,
                          n_samples: int = 500, n_warmup: int = 500, n_chains: int = 4, max_depth: int = 6,
                          target_accept: float = 0.8, init_step: float = 0.1, adapt_mass: bool = True,
                          prior_std: float = 3.0, jitter_init: float = 0.5, config: Config = DEFAULT,
                          sync_fn: Callable[[Tensor], Tensor] = lambda s: s, priors=None,
                          device=None) -> NUTSResult:
    """NUTS over log-hyperparameters with ``n_chains`` chains on a leading
    axis; posterior, chain jitter, priors, ``sync_fn`` and ``device`` as
    :func:`pygpr_torch.sample.mcmc.sample_posterior`.  Each leaf costs one
    NLML gradient of every active chain, at most ``2^max_depth − 1`` a
    transition.  Returns θ-space draws ``[n_chains, n_samples, nhp]`` and
    the adaptation's diagnostics."""
    x, y = _data(x, y, device)
    u0s = _start(kern, x, params0, n_chains, jitter_init, generator)
    lp = log_posterior_fn(kern, x, y, prior_std, config, priors)
    us, lps, acc, eps, depth, div, inv_mass = run_nuts(
        lp, u0s, generator, n_samples=n_samples, n_warmup=n_warmup, max_depth=max_depth,
        target_accept=target_accept, init_step=init_step, adapt_mass=adapt_mass, sync_fn=sync_fn)
    return NUTSResult(torch.exp(us), lps, acc, eps, depth, div, inv_mass)
