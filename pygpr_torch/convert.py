"""Carry state across from the JAX package as NumPy arrays.

A posterior state (one GP or a committee's batched state), a grBCM
``FitInfo``, an ``IterativeGP``, an ``SGPRState`` or a parameter vector
of ``pygpr_tpu``
becomes the port's own through ``np.asarray`` of each field; nothing here
imports the JAX package.  The packed parameter order is the same in both, e.g.
``[σ, ℓ₁..ℓ_d, σₙ]`` for ``Sum((RBF(), WhiteNoise()))``, so the kernel
expression is rebuilt from the port's classes by name
(:func:`kernel_from_names`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pygpr_torch.models.exact_gp import GPState
from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.models.grbcm import FitInfo
from pygpr_torch.models.iterative import IterativeGP
from pygpr_torch.models.sgpr import SGPRState
from pygpr_torch.ops.kernels import RBF, Kernel, Sum, WhiteNoise

_KERNELS = {"RBF": RBF, "WhiteNoise": WhiteNoise}


def kernel_from_names(*names: str) -> Kernel:
    """The port's kernel for the JAX kernel's class names: one name gives
    that kernel, several their ``Sum`` in the order given."""
    unknown = [n for n in names if n not in _KERNELS]
    if unknown or not names:
        raise ValueError(f"no port of kernel(s) {unknown or names}; the port has {sorted(_KERNELS)}")
    parts = [_KERNELS[n]() for n in names]
    return parts[0] if len(parts) == 1 else Sum(parts)


def params_from_numpy(p, device, dtype=None) -> torch.Tensor:
    """A packed parameter vector ``[nhp]`` (or a committee's ``[nc, nhp]``,
    such as ``FitInfo.params_l``) as a tensor on ``device``; dtype follows
    the array unless given."""
    return torch.as_tensor(np.asarray(p), dtype=dtype, device=device)


def state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> GPState:
    """A ``GPState`` from NumPy copies of the JAX ``GPState`` fields (x, y,
    params, chol, weights, jitter, ok and, where present, tinv), for
    example ``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``.
    A committee's batched state (leading ``nc`` on every field) comes
    across the same way."""
    missing = [f for f in GPState._fields if f != "tinv" and f not in arrays]
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {missing}")
    fields = {
        f: torch.tensor(np.asarray(arrays[f]), device=device)
        for f in GPState._fields
        if arrays.get(f) is not None
    }
    return GPState(**fields)


def fit_info_from_numpy(arrays: Mapping[str, np.ndarray], device) -> FitInfo:
    """A grBCM ``FitInfo`` from NumPy copies of the JAX ``FitInfo``
    fields (params_g, params_l, nlml_g, nlml_l, ok_l)."""
    missing = [f for f in FitInfo._fields if f not in arrays]
    if missing:
        raise ValueError(f"fit_info_from_numpy: missing fields {missing}")
    return FitInfo(**{f: torch.tensor(np.asarray(arrays[f]), device=device) for f in FitInfo._fields})


def iterative_gp_from_numpy(arrays: Mapping[str, np.ndarray], kern: Kernel, device, *, rank: int = 64,
                            block: int = 2048, config: Config = DEFAULT) -> IterativeGP:
    """The port's ``IterativeGP`` from NumPy copies of a JAX
    ``IterativeGP``'s arrays (x, y, params, probes), for example
    ``{k: np.asarray(getattr(m, k)) for k in ("x", "y", "params", "probes")}``
    with ``rank=m.rank, block=m.block``.  The probes are carried across,
    not drawn again, so the estimator is the same function."""
    missing = [f for f in ("x", "y", "params", "probes") if f not in arrays]
    if missing:
        raise ValueError(f"iterative_gp_from_numpy: missing arrays {missing}")
    probes = np.asarray(arrays["probes"])
    model = IterativeGP(np.array(arrays["x"]), np.array(arrays["y"]), kern, num_probes=probes.shape[1],
                        rank=rank, block=block, config=config, device=device)
    model.set_params(np.array(arrays["params"]))
    model.probes = torch.tensor(probes, dtype=model.x.dtype, device=model.x.device)
    return model


def sgpr_state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> SGPRState:
    """An ``SGPRState`` from NumPy copies of the JAX ``SGPRState`` fields
    (z, params, tinv_kuu, tinv_b, c, ok), for example
    ``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``.  Its
    ``params`` are the packed ``[θ…, σₙ]`` that the predict reads."""
    missing = [f for f in SGPRState._fields if f not in arrays]
    if missing:
        raise ValueError(f"sgpr_state_from_numpy: missing fields {missing}")
    return SGPRState(**{f: torch.tensor(np.asarray(arrays[f]), device=device) for f in SGPRState._fields})
