"""Hyperparameter optimizers: the L-BFGS fits (``lbfgs``), the
reference's SciPy drivers and quadratic solvers (``classic``) and the
parabolic step size (``step_size``)."""

from pygpr_torch.optimize.classic import CG, BFGSQuad, CGQuad, NelderMead, Opt, hessian
from pygpr_torch.optimize.lbfgs import FitResult, fit_map, fit_mle, minimize_lbfgs
from pygpr_torch.optimize.step_size import get_learn_rate, learn_rate
