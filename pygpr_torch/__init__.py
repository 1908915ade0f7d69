"""pygpr_torch — the PyTorch and CUDA port of pygpr_tpu.

A second package beside the JAX one, which stays the reference.  It
covers the exact GP (the NLML and its fast gradient, the L-BFGS fit,
factorize, predict, posterior draws and online extension) on every
kernel of the JAX package (``RBF``, ``WhiteNoise``, ``Sum``, ``Product``,
``Matern``, ``RationalQuadratic``, ``Periodic``, ``Constant``,
``SpectralMixture``, ``Linear``, ``ArcCosine``, ``Separable``,
``ActiveDims``, ``ChangePoint``), the multi-output ``ICM`` and
``TaskNoise``, the known-noise ``FixedNoise`` and the prior means
(``means``, ``fit_gp_mean``); the reference PyGPR's own API (the SciPy
drivers ``CG`` and ``NelderMead``, the quadratic solvers, the parabolic
step size, ``OptTrace``, the scikit-learn wrapper ``SKWrap``, and
``pygpr_torch.compat``, the reference's spellings); the grBCM committee
(fit, factorize, aggregate, serve) with the PoE family, plus the designs
that partition a committee, the matrix-free iterative GP (Krylov NLML,
Adam fit, CG predict) and sparse SGPR (collapsed ELBO, L-BFGS fit,
predict) on the bare ``RBF()``; MCMC over the hyperparameters (RWM, HMC,
NUTS) and elliptical slice sampling of latents; the non-Gaussian and
variational models (observation likelihoods, ``LaplaceGP``, ``EPGP``,
``SVGP``, random Fourier features, ``DeepGP``); the structured exact models
(``KroneckerGP`` on a grid, the state-space ``StateSpaceGP`` for 1-D
Matérn time series with its parallel scans and adjoint gradient, and SKI,
``SKIGP``, with its direct Woodbury and Krylov paths); the wrapper models
(deep kernel learning, ``DeepKernel`` and ``fit_dkl``; ``WarpedGP``; the
Student-t process ``TProcess``; ``HeteroscedasticGP``; multi-fidelity
co-kriging, ``MultiFidelityGP``; the gradient-enhanced ``DerivativeGP``;
``GPLVM``), the utilities (checkpoints, the memory-mapped
``utils.dataset.BinaryDataset``, state diagnostics, profiling) and the
optimizers on top of them (``fit_mle_resumable``, Bayesian optimization,
``BayesOpt``); and the benchmark entry points
(``pygpr_torch.bench``, with its stage probe
``pygpr_torch.bench.mfu_probe``).  On an NVIDIA H100 the train gram of
``Sum((RBF(), WhiteNoise()))``, the fused Cholesky plus triangular
inverse, the batched Cholesky, the fused gram-matvec and the probe's
per-block Cholesky and triangular inverse run in hand-written CUDA
kernels (``pygpr_torch/csrc``), built with ``nvcc`` at first use.

Tensors run on their own device.  NumPy inputs go to ``device="cuda"``
unless the caller passes ``device="cpu"``; without a GPU that raises.
The namespace is flat, as the JAX package's is.
"""

from pygpr_torch.config import DEFAULT, Config, as_tensor, default_dtype
from pygpr_torch.ops.kernels import (
    RBF,
    ActiveDims,
    ArcCosine,
    ChangePoint,
    Constant,
    Kernel,
    Linear,
    Matern,
    Periodic,
    Product,
    RationalQuadratic,
    Separable,
    SpectralMixture,
    Sum,
    WhiteNoise,
    kernel_and_grad,
    kernel_diag,
    kernel_matrix,
    sq_distance,
    train_gram,
)
from pygpr_torch.ops.linalg import (
    add_diag,
    chol_and_tri_inverse,
    cholesky_solve,
    inv_from_chol,
    safe_cholesky,
    spd_solve,
)
from pygpr_torch.models.exact_gp import (
    GPR,
    ExactGP,
    GPState,
    extend_state,
    factorize,
    fit_predict,
    precompute_tinv,
    predict,
    sample_predictive,
)
from pygpr_torch.models.likelihood import (
    MLE,
    Loss,
    log_likelihood_batched,
    nlml,
    nlml_and_grad_analytic,
    nlml_fast,
    nlml_value_and_grad,
)
from pygpr_torch.models import (
    committee,
    deepgp,
    ep,
    grbcm,
    heteroscedastic,
    iterative,
    kronecker,
    laplace,
    means,
    metrics,
    multifidelity,
    obs,
    priors,
    rff,
    sgpr,
    ski,
    statespace,
    svgp,
    tprocess,
    warped,
)
from pygpr_torch.models.dkl import DeepKernel, fit_dkl
from pygpr_torch.models.warped import WarpedGP
from pygpr_torch.models.tprocess import TProcess
from pygpr_torch.models.multifidelity import MultiFidelityGP
from pygpr_torch.models.heteroscedastic import HeteroscedasticGP
from pygpr_torch.models.derivative import DerivativeGP
from pygpr_torch.models.gplvm import GPLVM
from pygpr_torch.ops.coregion import ICM, TaskNoise, stack_outputs, with_task
from pygpr_torch.ops.fixed_noise import FixedNoise, with_noise
from pygpr_torch.models.means import ConstantMean, LinearMean, Mean, ZeroMean, fit_gp_mean
from pygpr_torch.models.priors import Gamma, HalfNormal, LogNormal
from pygpr_torch.models.grbcm import GRBCM
from pygpr_torch.models.iterative import IterativeGP
from pygpr_torch.models.kronecker import KroneckerGP
from pygpr_torch.models.ski import SKIGP
from pygpr_torch.models.statespace import StateSpaceGP
from pygpr_torch.models.sgpr import SGPR
from pygpr_torch.models.svgp import SVGP
from pygpr_torch.models.obs import BernoulliLogit, BernoulliProbit, GaussianLik, PoissonLik, StudentTLik
from pygpr_torch.models.laplace import LaplaceGP
from pygpr_torch.models.ep import EPGP
from pygpr_torch.models.deepgp import DeepGP
from pygpr_torch.models.rff import fit_rff
from pygpr_torch.models.metrics import loo_cv, loo_nlpd
from pygpr_torch.models.committee import aggregate_committee, fit_committee, predict_committee
from pygpr_torch.optimize import (
    CG,
    BayesOpt,
    BFGSQuad,
    CGQuad,
    FitResult,
    NelderMead,
    Opt,
    fit_map,
    fit_mle,
    get_learn_rate,
    hessian,
    learn_rate,
    minimize_lbfgs,
)
from pygpr_torch import convert, interop, optimize, sample, utils
from pygpr_torch.sample import (
    Matern1,
    Sobol,
    Uniform,
    cluster_samples,
    euclidean_dist,
    sample_gp,
    sample_latent,
    sample_posterior,
    sample_posterior_hmc,
    sample_posterior_nuts,
)
from pygpr_torch.interop import SK_WRAP, SKWrap
from pygpr_torch.utils import OptTrace
