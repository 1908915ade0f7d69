"""Carry state across from the JAX package as NumPy arrays.

A posterior state (one GP or a committee's batched state), a grBCM
``FitInfo``, an ``IterativeGP``, an ``SGPRState``, an observation
likelihood, SVGP's ``SVGPParams``, the deep GP's ``DGPParams``, an
``RFFBasis``, a ``LaplaceState``, an ``EPState``, a SKI ``Grid`` or
``SKIStats``, a ``KronState``, the wrapper models' states (``FitTPResult``,
``FitWarpedResult`` and its warp, ``MFState``, ``HGPState``, ``DKLFit``
and its ``DeepKernel``, ``GPLVMResult``, ``DerivGPState``) or a parameter
vector of ``pygpr_tpu``
becomes the port's own through ``np.asarray`` of each field; nothing here
imports the JAX package.  The packed parameter order is the same in both, e.g.
``[σ, ℓ₁..ℓ_d, σₙ]`` for ``Sum((RBF(), WhiteNoise()))``, so the kernel
expression is rebuilt from the port's classes: by name
(:func:`kernel_from_names`), or, for kernels that take arguments
(``nu``, ``order``, ``q``, ``profile``, ``dims``, ``axis``,
``n_outputs``, ``rank``, children), from a plain nested description
(:func:`kernel_spec` reads it off either package's kernel,
:func:`kernel_from_spec` builds the port's).  Means likewise
(:func:`mean_from_spec`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pygpr_torch.models import means, obs, warped
from pygpr_torch.models.derivative import DerivGPState
from pygpr_torch.models.dkl import DeepKernel, DKLFit
from pygpr_torch.models.gplvm import GPLVMResult
from pygpr_torch.models.heteroscedastic import HGPState
from pygpr_torch.models.multifidelity import MFState
from pygpr_torch.models.tprocess import FitTPResult
from pygpr_torch.models.warped import FitWarpedResult
from pygpr_torch.models.deepgp import DGPParams, LayerParams
from pygpr_torch.models.ep import EPState
from pygpr_torch.models.laplace import LaplaceState
from pygpr_torch.models.rff import RFFBasis
from pygpr_torch.models.svgp import SVGPParams
from pygpr_torch.models.exact_gp import GPState
from pygpr_torch.config import DEFAULT, Config
from pygpr_torch.models.grbcm import FitInfo
from pygpr_torch.models.iterative import IterativeGP
from pygpr_torch.models.kronecker import KronState
from pygpr_torch.models.ski import Grid, SKIStats
from pygpr_torch.models.sgpr import SGPRState
from pygpr_torch.ops import coregion, fixed_noise, kernels
from pygpr_torch.ops.kernels import Kernel, Sum

#: every kernel class of the port by name, for :func:`kernel_from_spec`
_SPEC_KERNELS = {
    cls.__name__: cls
    for cls in (kernels.RBF, kernels.WhiteNoise, kernels.Sum, kernels.Product, kernels.Matern, kernels.ArcCosine,
                kernels.RationalQuadratic, kernels.Periodic, kernels.Constant, kernels.SpectralMixture,
                kernels.Linear, kernels.Separable, kernels.ActiveDims, kernels.ChangePoint, coregion.ICM,
                coregion.TaskNoise, fixed_noise.FixedNoise, DeepKernel)
}
#: the arguments each kernel class takes besides its children
_SPEC_ARGS = {"Matern": ("nu",), "ArcCosine": ("order",), "SpectralMixture": ("q",), "Separable": ("profile",),
              "ActiveDims": ("dims",), "ChangePoint": ("axis",), "ICM": ("n_outputs", "rank"),
              "TaskNoise": ("n_outputs",), "DeepKernel": ("widths", "seed")}
#: where each kernel class keeps its children, in its constructor's order
_SPEC_CHILDREN = {"Sum": "kernels", "Product": "kernels", "ActiveDims": ("base",), "FixedNoise": ("base",),
                  "ICM": ("base",), "ChangePoint": ("k1", "k2"), "DeepKernel": ("base",)}
#: the kernel classes that take no arguments, for :func:`kernel_from_names`
_KERNELS = {n: cls for n, cls in _SPEC_KERNELS.items() if n not in _SPEC_ARGS and n not in _SPEC_CHILDREN}
_MEANS = {cls.__name__: cls for cls in (means.ZeroMean, means.ConstantMean, means.LinearMean)}


def kernel_spec(kern) -> tuple:
    """``(class name, {argument: value}, [child specs])`` of a kernel of
    either package, read off its attributes, e.g.
    ``("Sum", {}, [("Matern", {"nu": 2.5}, []), ("WhiteNoise", {}, [])])``."""
    name = type(kern).__name__
    args = {a: getattr(kern, a) for a in _SPEC_ARGS.get(name, ())}
    where = _SPEC_CHILDREN.get(name, ())
    children = getattr(kern, where) if isinstance(where, str) else [getattr(kern, a) for a in where]
    return name, args, [kernel_spec(k) for k in children]


def kernel_from_spec(spec) -> Kernel:
    """The port's kernel for a description from :func:`kernel_spec`."""
    name, args, children = spec
    if name not in _SPEC_KERNELS:
        raise ValueError(f"no port of kernel {name!r}; the port has {sorted(_SPEC_KERNELS)}")
    kids = [kernel_from_spec(c) for c in children]
    if _SPEC_CHILDREN.get(name) == "kernels":
        return _SPEC_KERNELS[name](kids)
    return _SPEC_KERNELS[name](*kids, **args)


def mean_from_spec(spec) -> means.Mean:
    """The port's mean for its class name (``"LinearMean"``) or
    ``(name, {})``, as the JAX package's mean classes take no arguments."""
    name = spec if isinstance(spec, str) else spec[0]
    if name not in _MEANS:
        raise ValueError(f"no port of mean {name!r}; the port has {sorted(_MEANS)}")
    return _MEANS[name]()


def kernel_from_names(*names: str) -> Kernel:
    """The port's kernel for the JAX kernel's class names, of classes that
    take no arguments: one name gives that kernel, several their ``Sum``
    in the order given."""
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


def _fields_from_numpy(cls, arrays: Mapping[str, np.ndarray], device, what: str):
    missing = [f for f in cls._fields if f not in arrays]
    if missing:
        raise ValueError(f"{what}: missing fields {missing}")
    return cls(**{f: torch.tensor(np.asarray(arrays[f]), device=device) for f in cls._fields})


def likelihood_from_name(name: str, **args):
    """The port's observation likelihood for the JAX class's name, with
    its constructor's arguments (``nu`` of ``StudentTLik``), e.g.
    ``likelihood_from_name(type(lik).__name__, **vars(lik))``.  Its
    trainable parameters are a plain vector, carried by
    :func:`params_from_numpy`."""
    if name not in obs.LIKELIHOODS:
        raise ValueError(f"no port of likelihood {name!r}; the port has {sorted(obs.LIKELIHOODS)}")
    return obs.LIKELIHOODS[name](**args)


def svgp_params_from_numpy(arrays: Mapping[str, np.ndarray], device) -> SVGPParams:
    """SVGP's ``SVGPParams`` from NumPy copies of the JAX fields
    (log_theta, lik, z, m_w, ls_raw)."""
    return _fields_from_numpy(SVGPParams, arrays, device, "svgp_params_from_numpy")


def dgp_params_from_numpy(layers, lik, device) -> DGPParams:
    """The deep GP's ``DGPParams`` from one mapping of NumPy arrays per
    layer (log_theta, z, m_w, ls_raw) and the likelihood's parameters."""
    return DGPParams(layers=tuple(_fields_from_numpy(LayerParams, a, device, "dgp_params_from_numpy")
                                  for a in layers), lik=torch.tensor(np.asarray(lik), device=device))


def rff_basis_from_numpy(arrays: Mapping[str, np.ndarray], device) -> RFFBasis:
    """An ``RFFBasis`` (freqs, phases) from NumPy copies of the JAX one."""
    return _fields_from_numpy(RFFBasis, arrays, device, "rff_basis_from_numpy")


def laplace_state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> LaplaceState:
    """A ``LaplaceState`` from NumPy copies of the JAX fields."""
    return _fields_from_numpy(LaplaceState, arrays, device, "laplace_state_from_numpy")


def ep_state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> EPState:
    """An ``EPState`` from NumPy copies of the JAX fields."""
    return _fields_from_numpy(EPState, arrays, device, "ep_state_from_numpy")


def grid_from_numpy(lo, h, sizes) -> Grid:
    """A SKI ``Grid`` from the JAX one's fields (``lo``, ``h``: NumPy
    ``[d]``; ``sizes``: a tuple), e.g. ``grid_from_numpy(*jax_grid)``.  The
    geometry is host NumPy in both packages."""
    return Grid(lo=np.asarray(lo, np.float64), h=np.asarray(h, np.float64), sizes=tuple(int(s) for s in sizes))


def ski_stats_from_numpy(arrays: Mapping[str, np.ndarray], device, dtype=None) -> SKIStats:
    """``SKIStats`` from NumPy copies of the JAX fields (z, wty, yty and the
    count n), for example ``{k: np.asarray(v) for k, v in
    jax_stats._asdict().items()}``; dtype follows the arrays unless given."""
    missing = [f for f in SKIStats._fields if f not in arrays]
    if missing:
        raise ValueError(f"ski_stats_from_numpy: missing fields {missing}")
    put = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return SKIStats(z=put(arrays["z"]), wty=put(arrays["wty"]), yty=put(arrays["yty"]), n=int(arrays["n"]))


def kron_state_from_numpy(arrays: Mapping[str, object], device) -> KronState:
    """A ``KronState`` from NumPy copies of the JAX fields: ``axes`` and
    ``eigvecs`` as sequences of arrays, the rest arrays.  Eigenvectors
    carried across keep the JAX package's signs, so the port's
    ``predict_kron`` on the state is the JAX package's function."""
    missing = [f for f in KronState._fields if f not in arrays]
    if missing:
        raise ValueError(f"kron_state_from_numpy: missing fields {missing}")
    put = lambda a: torch.tensor(np.asarray(a), device=device)
    return KronState(axes=tuple(put(a) for a in arrays["axes"]), params=put(arrays["params"]),
                     eigvecs=tuple(put(q) for q in arrays["eigvecs"]), denom=put(arrays["denom"]),
                     alpha=put(arrays["alpha"]), nlml=put(arrays["nlml"]), ok=put(arrays["ok"]))


def _nested_from_numpy(cls, arrays: Mapping[str, object], device, what: str, states=()):
    """``cls`` from NumPy copies of the JAX fields; the fields named in
    ``states`` are nested ``GPState`` mappings, a float field stays a
    float."""
    missing = [f for f in cls._fields if f not in arrays]
    if missing:
        raise ValueError(f"{what}: missing fields {missing}")

    def put(f):
        a = arrays[f]
        if f in states:
            return state_from_numpy(a, device)
        return a if isinstance(a, float) else torch.tensor(np.asarray(a), device=device)

    return cls(**{f: put(f) for f in cls._fields})


def tp_result_from_numpy(arrays: Mapping[str, object], device) -> FitTPResult:
    """The Student-t process's ``FitTPResult`` (``state`` a mapping of
    ``GPState`` fields; params, nu, nlml, converged)."""
    return _nested_from_numpy(FitTPResult, arrays, device, "tp_result_from_numpy", ("state",))


def warp_from_name(name: str, **args):
    """The port's warp for the JAX class's name and its constructor's
    arguments (``n_terms`` of ``TanhWarp``), e.g.
    ``warp_from_name(type(w).__name__, **vars(w))``."""
    kinds = {c.__name__: c for c in (warped.TanhWarp, warped.LogWarp, warped.IdentityWarp)}
    if name not in kinds:
        raise ValueError(f"no port of warp {name!r}; the port has {sorted(kinds)}")
    return kinds[name](**args)


def warped_result_from_numpy(arrays: Mapping[str, object], device) -> FitWarpedResult:
    """The warped GP's ``FitWarpedResult`` (``state`` a mapping of
    ``GPState`` fields; params, warp_params, nlml, converged)."""
    return _nested_from_numpy(FitWarpedResult, arrays, device, "warped_result_from_numpy", ("state",))


def mf_state_from_numpy(arrays: Mapping[str, object], device) -> MFState:
    """The multi-fidelity ``MFState`` (``state_lo`` and ``state_d``
    mappings of ``GPState`` fields; rho, params_lo, params_d, nlml_lo,
    nlml_d)."""
    return _nested_from_numpy(MFState, arrays, device, "mf_state_from_numpy", ("state_lo", "state_d"))


def hgp_state_from_numpy(arrays: Mapping[str, object], device) -> HGPState:
    """The heteroscedastic GP's ``HGPState`` (``state_mean`` and
    ``state_noise`` mappings of ``GPState`` fields; ``z_mean`` a float)."""
    out = _nested_from_numpy(HGPState, arrays, device, "hgp_state_from_numpy", ("state_mean", "state_noise"))
    return out._replace(z_mean=float(out.z_mean))


def dkl_fit_from_numpy(arrays: Mapping[str, np.ndarray], device) -> DKLFit:
    """DKL's ``DKLFit`` (params, nlml, converged); the ``DeepKernel``
    itself comes across by :func:`kernel_spec` and :func:`kernel_from_spec`."""
    return _fields_from_numpy(DKLFit, arrays, device, "dkl_fit_from_numpy")


def gplvm_result_from_numpy(arrays: Mapping[str, np.ndarray], device) -> GPLVMResult:
    """The GPLVM's ``GPLVMResult`` (latents, params, value, grad_norm, iters)."""
    return _fields_from_numpy(GPLVMResult, arrays, device, "gplvm_result_from_numpy")


def deriv_state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> DerivGPState:
    """The derivative GP's ``DerivGPState`` (chol, weights, jitter, ok)."""
    return _fields_from_numpy(DerivGPState, arrays, device, "deriv_state_from_numpy")
