"""Checkpointed, resumable hyperparameter fitting.

Counterpart of ``pygpr_tpu/optimize/resumable.py``.  The L-BFGS fit runs
in segments of ``segment_iters`` iterations, persisting ``(params,
iteration count)`` after each (``utils.checkpoint``, the JAX package's npz
layout, atomic, rank 0 only) and resuming from the last checkpoint when
called again on the same path, also from one the JAX package wrote.  The
L-BFGS curvature memory is not persisted: a restart costs a few
iterations, and the checkpoint stays one parameter vector.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops.kernels import Kernel
from pygpr_torch.optimize.lbfgs import FitResult, fit_mle
from pygpr_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def fit_mle_resumable(kern: Kernel, params0, x, y, ckpt_path: str, *, config: Config = DEFAULT,
                      max_iter: int = 1000, segment_iters: int = 100, tol: float = 1e-4, log_space: bool = True,
                      device=None) -> FitResult:
    """:func:`pygpr_torch.optimize.fit_mle` with segment checkpoints.

    Calling it again with the same ``ckpt_path`` resumes from the last
    completed segment (a committee's whole ``[nc, nhp]`` block is one
    checkpoint).  ``iters`` of the result counts every segment's
    iterations, those before the resume included."""
    x = as_tensor(x, device)
    params = torch.as_tensor(params0, dtype=x.dtype, device=x.device)
    done = 0
    if os.path.exists(ckpt_path):
        (params,), meta = load_checkpoint(ckpt_path, (params,))
        done = int(meta.get("iters", 0))

    res: Optional[FitResult] = None
    while done < max_iter:
        step = min(segment_iters, max_iter - done)
        res = fit_mle(kern, params, x, y, config=config, max_iter=step, tol=tol, log_space=log_space)
        params = res.params
        taken = int(torch.max(torch.atleast_1d(res.iters)))
        done += taken
        save_checkpoint(ckpt_path, (params,), meta={"iters": done})
        if bool(torch.all(torch.atleast_1d(res.converged))) or taken == 0:
            break  # converged, or no progress: avoid spinning
    if res is None:  # already past max_iter at restore time
        res = fit_mle(kern, params, x, y, config=config, max_iter=1, tol=tol, log_space=log_space)
    return res._replace(iters=torch.tensor(done))
