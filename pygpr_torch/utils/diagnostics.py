"""Numerical-failure detection and health reports.

Counterpart of ``pygpr_tpu/utils/diagnostics.py``:

  * :func:`check_state`: inspect a (possibly batched) ``GPState``:
    factorization success, jitter escalation, non-finite weights;
  * :func:`expert_mask`: the healthy-expert mask for grBCM aggregation;
  * :func:`summarize`: a host dict for logs;
  * :func:`checkify_nlml`: an NLML closure that raises on a non-finite
    value.  ``jax.experimental.checkify`` has no torch counterpart: the
    closure reads the value's finiteness once on the host and raises a
    ``ValueError`` with the JAX package's message.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config

Tensor = torch.Tensor


class StateHealth(NamedTuple):
    ok: Tensor              #: factorization success flag(s)
    jitter: Tensor          #: jitter used per (batched) factorization
    escalated: Tensor       #: jitter above the config base rung?
    finite_weights: Tensor  #: w = K⁻¹y finite?


def check_state(state, config: Config = DEFAULT) -> StateHealth:
    """Health report for a :class:`pygpr_torch.models.exact_gp.GPState`."""
    w = state.weights
    finite = torch.isfinite(w).flatten(1).all(dim=1) if w.ndim > 1 else torch.isfinite(w).all()
    return StateHealth(ok=state.ok.to(torch.bool), jitter=state.jitter, escalated=state.jitter > config.jitter * 1.5,
                       finite_weights=finite)


def expert_mask(state) -> Tensor:
    """Keep-mask over a batched expert state: an expert stays in the
    committee iff its factorization succeeded and its weights are finite."""
    h = check_state(state)
    return h.ok & h.finite_weights


def summarize(state, config: Config = DEFAULT) -> Dict:
    """Host dict summary for logs."""
    h = check_state(state, config)
    ok = np.atleast_1d(h.ok.cpu().numpy())
    esc = np.atleast_1d(h.escalated.cpu().numpy())
    return {"n_experts": int(ok.size), "n_failed": int((~ok).sum()), "n_jitter_escalated": int(esc.sum()),
            "max_jitter": float(h.jitter.max())}


def checkify_nlml(kern, x, y, config: Config = DEFAULT):
    """``nlml(params) -> value`` that raises ``ValueError`` on a non-finite
    value instead of returning it.  The JAX package's checkified closure
    returns ``(err, value)`` for ``err.throw()``; no caller needs the
    error object here, so the closure raises at once and returns the
    value alone."""
    from pygpr_torch.models.likelihood import nlml

    def f(params):
        val = nlml(kern, params, x, y, config)
        if not bool(torch.isfinite(val).all()):
            raise ValueError("NLML is non-finite (failed factorization?)")
        return val

    return f
