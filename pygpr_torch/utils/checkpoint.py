"""Checkpoint and resume.

Counterpart of ``pygpr_tpu/utils/checkpoint.py``, with its file layout:
a plain ``.npz`` archive of a flat tree, the leaves as ``leaf_0``,
``leaf_1``, … in the JAX package's flattening order (tuples, lists and
NamedTuples in order, dicts by sorted key, ``None`` an empty subtree), the
tree's description as ``__treedef__`` and JSON metadata as ``__meta__``,
both UTF-8 bytes.  A checkpoint written by either package loads in the
other.  The write is atomic (``mkstemp`` + ``os.replace``) and made by
rank 0 only.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _flatten(tree) -> Tuple[List[Any], str]:
    """``(leaves, description)`` in the JAX package's order; the
    description follows ``str`` of a JAX ``PyTreeDef``."""
    if tree is None:
        return [], "None"
    if _is_namedtuple(tree):
        parts = [_flatten(c) for c in tree]
        return ([leaf for p in parts for leaf in p[0]],
                f"CustomNode(namedtuple[{type(tree).__name__}], [{', '.join(p[1] for p in parts)}])")
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(c) for c in tree]
        inner = ", ".join(p[1] for p in parts)
        desc = f"[{inner}]" if isinstance(tree, list) else f"({inner}{',' if len(parts) == 1 else ''})"
        return [leaf for p in parts for leaf in p[0]], desc
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                "{" + ", ".join(f"{k!r}: {p[1]}" for k, p in zip(keys, parts)) + "}")
    return [tree], "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(c, leaves) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves) for c in like)
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    return next(leaves)


def _rank() -> int:
    """This process's rank in ``torch.distributed`` when it is
    initialized, else 0."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, meta: Dict | None = None) -> None:
    """Atomically write a tree of tensors or arrays (+ JSON-able metadata)."""
    if _rank() != 0:
        return
    leaves, desc = _flatten(tree)
    payload = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(f"PyTreeDef({desc})".encode(), dtype=np.uint8)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, like: Any):
    """Restore a tree saved by :func:`save_checkpoint` (of either package)
    into the structure of ``like``: a tensor leaf of ``like`` comes back
    as a tensor of its device and dtype, any other leaf as the stored
    NumPy array.  Returns ``(tree, meta)``."""
    leaves_like, _ = _flatten(like)
    with np.load(path) as z:
        stored = [z[f"leaf_{i}"] for i in range(len(leaves_like))]
        meta = json.loads(bytes(z["__meta__"]).decode())
    leaves = [torch.as_tensor(a, dtype=l.dtype, device=l.device) if isinstance(l, torch.Tensor) else a
              for a, l in zip(stored, leaves_like)]
    return _unflatten(like, iter(leaves)), meta
