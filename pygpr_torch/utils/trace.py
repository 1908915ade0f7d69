"""Optimizer-trajectory tracing.

Counterpart of ``pygpr_tpu/utils/trace.py`` (NumPy, copied so that the
port imports nothing of the JAX package).  The reference's only
observability channel is the ``opt.dat`` text file each optimizer driver
writes: params, loss, grad-norm per iteration.  :class:`OptTrace` writes
that file, byte for byte as the JAX package does, and a structured JSONL
log beside it.
"""

from __future__ import annotations

import json
from typing import IO, Optional

import numpy as np


class OptTrace:
    """Writes the reference's ``opt.dat`` format and a JSONL log."""

    def __init__(self, dat_path: Optional[str] = "opt.dat", jsonl_path: Optional[str] = None):
        self._dat: Optional[IO] = open(dat_path, "w") if dat_path else None
        self._jsonl: Optional[IO] = open(jsonl_path, "w") if jsonl_path else None
        self.iter = 0

    def log(self, params, loss=None, grad_norm=None, **extra) -> None:
        params = np.asarray(params)
        if self._dat is not None:
            # the reference's format: params... [loss [grad_norm]]
            fields = list(params.ravel())
            if loss is not None:
                fields.append(loss)
            if grad_norm is not None:
                fields.append(grad_norm)
            print(*fields, file=self._dat)
        if self._jsonl is not None:
            rec = {"iter": self.iter, "params": params.ravel().tolist()}
            if loss is not None:
                rec["loss"] = float(loss)
            if grad_norm is not None:
                rec["grad_norm"] = float(grad_norm)
            rec.update({k: (float(v) if np.isscalar(v) else np.asarray(v).tolist()) for k, v in extra.items()})
            print(json.dumps(rec), file=self._jsonl)
        self.iter += 1

    def close(self) -> None:
        for f in (self._dat, self._jsonl):
            if f is not None:
                f.close()
        self._dat = self._jsonl = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
