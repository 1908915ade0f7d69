"""The reference's names, bound to the port.

Counterpart of ``pygpr_tpu/compat.py``, with the same ``__all__``: a user
of the reference PyGPR (``PyGPR/__init__.py``) switches the import and
keeps the code, now on the card::

    from pygpr_torch.compat import (
        Exact_GP, Squared_exponential, White_noise, Compose,
        MLE, CG, Nelder_Mead, GRBCM, UNIFORM, MATERN1, sample_gp, ...
    )

Semantics follow the reference except where it is broken (PARITY.md:
``GRBCM.train``, ``log_likelihood_batched``, ``sample_gp``'s stale API,
``SK_WRAP``'s stale dirty flag).  NumPy data go to the GPU unless a
model is given ``device="cpu"``.
"""

from pygpr_torch.interop.sklearn import SK_WRAP
from pygpr_torch.models.exact_gp import ExactGP as Exact_GP
from pygpr_torch.models.exact_gp import GPR
from pygpr_torch.models.grbcm import GRBCM
from pygpr_torch.models.likelihood import MLE, Loss, log_likelihood_batched
from pygpr_torch.ops.kernels import Kernel as Covar
from pygpr_torch.ops.kernels import RBF as Squared_exponential
from pygpr_torch.ops.kernels import Sum as Compose
from pygpr_torch.ops.kernels import WhiteNoise as White_noise
from pygpr_torch.optimize.classic import CG, BFGSQuad as BFGS_Quad
from pygpr_torch.optimize.classic import CGQuad as CG_Quad
from pygpr_torch.optimize.classic import NelderMead as Nelder_Mead
from pygpr_torch.optimize.classic import Opt, hessian
from pygpr_torch.optimize.step_size import get_learn_rate
from pygpr_torch.sample.designs import (
    Matern1 as MATERN1,
    Uniform as UNIFORM,
    cluster_samples,
    euclidean_dist,
    sample_gp,
)

__all__ = [
    "GPR", "Exact_GP",
    "Squared_exponential", "Covar", "Compose", "White_noise",
    "Loss", "MLE",
    "Opt", "CG", "Nelder_Mead", "BFGS_Quad", "CG_Quad", "hessian",
    "GRBCM", "log_likelihood_batched",
    "UNIFORM", "MATERN1", "sample_gp", "cluster_samples",
    "euclidean_dist",
    "SK_WRAP", "get_learn_rate",
]
