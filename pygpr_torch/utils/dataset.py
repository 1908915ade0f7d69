"""Out-of-core dataset layer: memory-mapped storage and a prefetching
minibatch reader.

Counterpart of ``pygpr_tpu/utils/dataset.py``, with its file format: one
flat float32 file ``[n, d+1]`` (x columns, then y), opened with
``np.memmap`` so that the OS page cache does the caching.  A file written
by either package opens in the other, and ``minibatches(seed=…)`` yields
the same batches bit for bit: the same NumPy permutations, and the rows
copied out of the map by NumPy fancy indexing (the JAX package's native
gather copies the same rows).  The gather runs on a background thread,
so batch ``k+1`` is read while the device computes on batch ``k``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Tuple

import numpy as np

__all__ = ["BinaryDataset"]


class BinaryDataset:
    """Memory-mapped ``[n, d+1]`` float32 dataset (x columns, then y)."""

    MAGIC = "pygpr-bin-v1"

    def __init__(self, path: str, dim: int):
        self.path = path
        self.dim = int(dim)
        row = self.dim + 1
        size = os.path.getsize(path)
        if size % (4 * row) != 0:
            raise ValueError(f"{path}: size {size} not a multiple of {4 * row}-byte rows (dim={dim})")
        self.n = size // (4 * row)
        self._mm = np.memmap(path, dtype=np.float32, mode="r", shape=(self.n, row))

    # ------------------------------------------------------------ io
    @classmethod
    def write(cls, path: str, x, y) -> "BinaryDataset":
        """Serialize (x, y) to the flat format and open it."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        if x.ndim != 2 or y.shape != (x.shape[0],):
            raise ValueError("need x [n, d] and y [n]")
        buf = np.concatenate([x, y[:, None]], axis=1)
        with open(path, "wb") as f:
            buf.tofile(f)
        return cls(path, x.shape[1])

    @property
    def x(self) -> np.ndarray:
        """Memory-mapped view of the inputs ``[n, d]`` (no copy)."""
        return self._mm[:, : self.dim]

    @property
    def y(self) -> np.ndarray:
        """Memory-mapped view of the targets ``[n]`` (no copy)."""
        return self._mm[:, self.dim]

    # ------------------------------------------------------- readers
    def iter_chunks(self, chunk: int = 262_144) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Sequential ``(x_chunk, y_chunk)`` pairs (copies)."""
        for start in range(0, self.n, chunk):
            block = np.array(self._mm[start: start + chunk])
            yield block[:, : self.dim], block[:, self.dim]

    def _gather(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        out = self._mm[idx]   # fancy indexing copies the rows
        return out[:, : self.dim], out[:, self.dim]

    def minibatches(self, batch_size: int, *, seed: int = 0, epochs: int = 1, drop_last: bool = True,
                    prefetch: int = 2) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Shuffled minibatches with background prefetch: a fresh
        permutation per epoch from ``np.random.default_rng(seed)``;
        ``drop_last`` keeps every batch the same shape."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def producer():
            rng = np.random.default_rng(seed)
            try:
                for _ in range(epochs):
                    perm = rng.permutation(self.n)
                    end = self.n - self.n % batch_size if drop_last else self.n
                    for s in range(0, end, batch_size):
                        if stop.is_set():
                            return
                        q.put(self._gather(perm[s: s + batch_size]))
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            # drain so that the producer's blocked put() can finish
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
