"""Exact GP model, NLML and priors; the structured exact models."""

from pygpr_torch.models import kronecker, ski, statespace
from pygpr_torch.models.kronecker import KroneckerGP
from pygpr_torch.models.ski import SKIGP
from pygpr_torch.models.statespace import StateSpaceGP
