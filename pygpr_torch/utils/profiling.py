"""Tracing and profiling helpers.

Counterpart of ``pygpr_tpu/utils/profiling.py``.  :func:`annotate` runs a
function under ``torch.profiler.record_function``, a labeled range in a
profile (and an NVTX range on the card); :func:`trace` profiles a block
over the CPU and, where there is one, the CUDA device, and writes a Chrome
trace (``trace.json``, for Perfetto or ``chrome://tracing``) into its
directory.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
from typing import Callable, Iterator, Optional

import torch


def annotate(name: str):
    """Decorator: run the function under ``record_function(name)``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile a block and write ``log_dir/trace.json`` (default
    ``pygpr_trace`` under the temporary directory):

    >>> with trace("traces"):
    ...     fit_mle(...)
    """
    from torch.profiler import ProfilerActivity, profile

    log_dir = os.path.join(tempfile.gettempdir(), "pygpr_trace") if log_dir is None else log_dir
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
