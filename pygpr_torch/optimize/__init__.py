"""Hyperparameter optimizers: the L-BFGS fits (``lbfgs``), the
reference's SciPy drivers and quadratic solvers (``classic``), the
parabolic step size (``step_size``), the checkpointed fit
(``resumable``) and Bayesian optimization (``bayesopt``)."""

from pygpr_torch.optimize.classic import CG, BFGSQuad, CGQuad, NelderMead, Opt, hessian
from pygpr_torch.optimize.lbfgs import FitResult, fit_map, fit_mle, minimize_lbfgs
from pygpr_torch.optimize.step_size import get_learn_rate, learn_rate
from pygpr_torch.optimize.resumable import fit_mle_resumable
from pygpr_torch.optimize.bayesopt import (
    BayesOpt,
    expected_improvement,
    log_expected_improvement,
    lower_confidence_bound,
    probability_of_improvement,
    propose,
    propose_batch,
    thompson_sample,
)
