"""Input-space designs and partitioning, on the host in NumPy.

Counterpart of ``pygpr_tpu/sample/designs.py`` (the reference's
``sampler.py``).  Designs and partitions are data preparation, not GP
compute: they run in NumPy and return NumPy arrays, which the entry points
put on the card.  Distances are summed over the coordinates in order, as
the JAX package's native data layer sums them, so that both packages
partition bit-identically.

  * :class:`Uniform` — seeded uniform box sampling.
  * :class:`Sobol` — scrambled Sobol box design (``scipy.stats.qmc``).
  * :class:`Matern1` — Matérn type-I hard-core point process:
    dart-throwing with a fixed candidate budget (``max_count``),
    accepting a candidate iff its distance to every accepted point
    exceeds ``min_dist`` (tolerance 1e-5); ``sample(n)`` shrinks
    ``min_dist`` ×0.9 until n points fit.
  * :func:`assign_clusters` / ``Matern1.partition`` — nearest-center
    partitioning of an oversampled uniform cloud, the grBCM expert
    shards; a short cluster is topped up with its nearest remaining
    points so every shard has the same size.
  * :func:`sample_gp` — a GP prior draw ``f = L·𝒩(0, I) (+ mean)``.
  * :func:`euclidean_dist` — the reference's squared-distance matrix.

Randomness: where the JAX package takes a key, these take ``key``: None
(the design's own seed), an int or a sequence of ints, or a
``numpy.random.Generator`` (one draw of it fixes the seed).  With no key
the streams are ``np.random.default_rng([seed, salt])``, the JAX
package's, so designs and partitions are bit-identical to its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pygpr_torch.config import DEFAULT, Config, as_tensor
from pygpr_torch.ops import linalg
from pygpr_torch.ops.kernels import Kernel, kernel_matrix, sq_distance

Key = Union[None, int, Sequence[int], np.random.Generator]


def _sq_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Squared distances ``[n, m]``, Σₜ (xₜ − yₜ)² summed in coordinate
    order."""
    d2 = np.zeros((x.shape[0], y.shape[0]))
    for t in range(x.shape[-1]):
        diff = x[:, None, t] - y[None, :, t]
        d2 += diff * diff
    return d2


def euclidean_dist(x, y):
    """Squared-distance matrix ``[n, m]`` between the rows of ``x [n, d]``
    and ``y [m, d]`` (the reference's ``euclidean_dist``, which returns the
    *squared* distance), by the matmul trick of ``ops.kernels.sq_distance``.
    A tensor where either input is one (on its device), else NumPy."""
    dev = next((a.device for a in (x, y) if isinstance(a, torch.Tensor)), None)
    xt = torch.as_tensor(x, device=dev)
    d = sq_distance(torch.as_tensor(y, dtype=xt.dtype, device=xt.device), xt)
    return d if dev is not None else d.numpy()


def _hard_core_accept(cand: np.ndarray, min_dist: float, tol: float) -> np.ndarray:
    """Sequential hard-core scan: a candidate is accepted iff its squared
    distance to every accepted point exceeds ``(min_dist + tol)²``; the
    first always is.  The acceptance mask ``[m]``."""
    lim2 = (min_dist + tol) ** 2
    mask = np.zeros((cand.shape[0],), bool)
    acc = np.empty_like(cand)
    k = 0
    for i, c in enumerate(cand):
        if k == 0 or np.all(_sq_dist(acc[:k], c[None])[:, 0] > lim2):
            acc[k] = c
            mask[i] = True
            k += 1
    return mask


def _fix_key(key: Key) -> Optional[list]:
    """A key as a list of ints, drawing once from a Generator, so that a
    design that draws several times draws the same stream each time."""
    if key is None:
        return None
    if isinstance(key, np.random.Generator):
        return [int(v) for v in key.integers(0, 2**32, size=2)]
    return [int(v) for v in np.atleast_1d(np.asarray(key)).ravel()]


class Uniform:
    """Seeded uniform box sampler (the reference's ``UNIFORM``)."""

    def __init__(self, seed: int):
        self.seed = seed

    def _host_rng(self, key: Key, salt: int = 0) -> np.random.Generator:
        key = _fix_key(key)
        return np.random.default_rng([self.seed, salt] if key is None else key + [salt])

    def _box(self, u: np.ndarray, mins, maxs) -> np.ndarray:
        mins_h = np.asarray(mins, np.float64)
        maxs_h = np.asarray(maxs, np.float64)
        return (mins_h + u * (maxs_h - mins_h)).astype(np.asarray(mins).dtype)

    def sample(self, n: int, mins, maxs, key: Key = None, salt: int = 0) -> np.ndarray:
        rng = self._host_rng(key, salt)
        return self._box(rng.uniform(size=(n, np.asarray(mins).shape[-1])), mins, maxs)


class Sobol(Uniform):
    """Owen-scrambled Sobol quasi-Monte-Carlo box design, seeded as
    :class:`Uniform`: lower discrepancy for inducing points, initial
    designs and committee centers."""

    def sample(self, n: int, mins, maxs, key: Key = None, salt: int = 0) -> np.ndarray:
        from scipy.stats import qmc

        eng = qmc.Sobol(d=np.asarray(mins).shape[-1], scramble=True, rng=self._host_rng(key, salt))
        return self._box(eng.random(n), mins, maxs)


class Matern1(Uniform):
    """Matérn type-I hard-core repulsive sampler (the reference's ``MATERN1``)."""

    def __init__(self, seed: int, max_count: int = 5000):
        super().__init__(seed)
        self.min_dist: Optional[float] = None
        self.max_count = max_count

    def sample_repulsion(self, mins, maxs, min_dist, key: Key = None) -> Tuple[np.ndarray, np.ndarray]:
        """Fixed-budget dart throwing: ``(points, accepted_mask)``, each
        ``max_count`` rows, accepted points first in acceptance order."""
        rng = self._host_rng(key)
        mins_h = np.asarray(mins, dtype=np.float64)
        maxs_h = np.asarray(maxs, dtype=np.float64)
        cand = mins_h + rng.uniform(size=(self.max_count, mins_h.shape[-1])) * (maxs_h - mins_h)
        cand_mask = _hard_core_accept(cand, float(min_dist), tol=1e-5)
        k = int(cand_mask.sum())
        accepted = np.zeros_like(cand)
        accepted[:k] = cand[cand_mask]
        mask = np.zeros((self.max_count,), bool)
        mask[:k] = True
        return accepted, mask

    def sample(self, n: int, mins, maxs, key: Key = None) -> np.ndarray:
        """Shrink ``min_dist`` ×0.9 from ``(vol / n)^(1/dim)`` until at
        least n points are accepted; the first n."""
        key = _fix_key(key)
        mins_a = np.asarray(mins, dtype=np.float64)
        maxs_a = np.asarray(maxs, dtype=np.float64)
        min_dist = float((float(np.prod(maxs_a - mins_a)) / n) ** (1.0 / mins_a.shape[-1]))
        pts, mask = self.sample_repulsion(mins_a, maxs_a, min_dist, key)
        while int(mask.sum()) < n:
            min_dist *= 0.9
            pts, mask = self.sample_repulsion(mins_a, maxs_a, min_dist, key)
        self.min_dist = min_dist
        return pts[mask][:n]

    def cluster_samples(self, xc, ns: int, mins, maxs, key: Key = None) -> np.ndarray:
        """Oversample 10·ns·nc uniform points and split them among the
        centers ``xc``: ``[nc, ns, dim]``."""
        # salt=1: a stream independent of the centers' draw
        x = Uniform.sample(self, 10 * ns * np.asarray(xc).shape[0], mins, maxs, key, salt=1)
        return assign_clusters(x, xc, ns)

    def partition(self, nc: int, ns: int, mins, maxs, key: Key = None) -> Tuple[np.ndarray, np.ndarray]:
        """Repulsive centers, then clustering: the grBCM expert shards
        ``(xpart [nc, ns, dim], xc [nc, dim])``."""
        key = _fix_key(key)
        xc = self.sample(nc, mins, maxs, key)
        return self.cluster_samples(xc, ns, mins, maxs, key), xc


def assign_clusters(x, xc, ns: int) -> np.ndarray:
    """Nearest-center assignment, ``[nc, ns, dim]``: per center the first
    ``ns`` points assigned to it, topped up with its nearest remaining
    points when the cluster is short."""
    orig = np.asarray(x)
    x_h = np.asarray(orig, np.float64)
    xc_h = np.asarray(xc, np.float64)
    n, nc = x_h.shape[0], xc_h.shape[0]
    d = _sq_dist(x_h, xc_h)  # [n, nc]
    idx = np.argmin(d, axis=1)  # the first nearest center on a tie
    out = np.empty((nc, ns, orig.shape[-1]), dtype=orig.dtype)
    for i in range(nc):
        rank = np.where(idx == i, np.arange(n, dtype=np.float64), n + d[:, i])
        out[i] = orig[np.argsort(rank, kind="stable")[:ns]]
    return out


def cluster_samples(x, xc) -> np.ndarray:
    """Partition an existing ``x`` among the centers in equal clusters of
    ``n // nc`` (the reference's free function)."""
    n, nc = np.asarray(x).shape[-2], np.asarray(xc).shape[-2]
    if n % nc:
        raise ValueError(f"cluster_samples: {n} points do not split into {nc} equal clusters")
    return assign_clusters(x, xc, n // nc)


def sample_gp(
    x,
    cov: Kernel,
    hp=None,
    mean=None,
    generator: Optional[torch.Generator] = None,
    config: Config = DEFAULT,
    device=None,
) -> torch.Tensor:
    """GP prior draw at ``x``: ``f = L·𝒩(0, I) (+ mean)``, through the
    jitter ladder.  ``generator`` (on ``x``'s device) takes the place of
    the key; ``None`` uses torch's default generator."""
    x = as_tensor(x, device)
    hp = cov.init_params(x, config) if hp is None else torch.as_tensor(hp, dtype=x.dtype, device=x.device)
    L = linalg.safe_cholesky(kernel_matrix(cov, hp, x, config=config), config).chol
    f = L @ torch.randn(x.shape[-2], generator=generator, dtype=x.dtype, device=x.device)
    return f if mean is None else f + torch.as_tensor(mean, dtype=x.dtype, device=x.device)
