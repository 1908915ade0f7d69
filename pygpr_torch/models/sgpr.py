"""Conventions of the models that take a noise-free signal kernel.

Counterpart of the two helpers of ``pygpr_tpu/models/sgpr.py`` that the
iterative GP (``models/iterative.py``) shares with SGPR: the kernel is
the signal kernel alone (e.g. ``RBF()``), and the Gaussian observation
noise σₙ is the LAST entry of the packed ``params = [θ_kernel…, σₙ]``,
so :class:`~pygpr_torch.ops.kernels.WhiteNoise` must not be a summand.
The SGPR model itself is still to be ported.
"""

from __future__ import annotations

import torch

from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.ops.kernels import Kernel, Sum, WhiteNoise


def _check_noise_free(kern: Kernel) -> None:
    parts = kern.kernels if isinstance(kern, Sum) else (kern,)
    if any(isinstance(k, WhiteNoise) for k in parts):
        raise ValueError(
            "SGPR takes a noise-free signal kernel; the observation "
            "noise is the last packed parameter (params = [θ_kernel…, "
            "σₙ]).  Drop WhiteNoise from the kernel."
        )


def init_params(kern: Kernel, x, config: Config = DEFAULT) -> torch.Tensor:
    """``[θ_kernel… (all ones), σₙ=1]``.

    σₙ starts at 1, not at the reference's 1e-4 noise init: the fits of
    these models run in log space, where 1 is a well-scaled start.
    """
    p = kern.init_params(x, config)
    return torch.cat([p, torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)], dim=-1)
