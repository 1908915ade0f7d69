"""Utilities: the optimizer trace (``trace``)."""

from pygpr_torch.utils.trace import OptTrace
