"""Utilities: the optimizer trace (``trace``), checkpoints
(``checkpoint``), the memory-mapped dataset (``dataset``), state
diagnostics (``diagnostics``) and profiling (``profiling``)."""

from pygpr_torch.utils.trace import OptTrace
from pygpr_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from pygpr_torch.utils.diagnostics import check_state, checkify_nlml, expert_mask, summarize
from pygpr_torch.utils.profiling import annotate, trace
