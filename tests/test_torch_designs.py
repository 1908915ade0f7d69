"""Port parity for the designs that partition a committee: the seeded
streams give bit-identical designs and shards to the JAX package's, the
host helpers agree bit for bit with the JAX package's native data layer,
and a GP prior draw has the JAX package's factor and the prior's
moments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch.sample import designs as dt
from pygpr_tpu.sample import designs as dj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_matern1_partition_is_bit_equal_to_jax():
    lo, hi = np.zeros(2), np.full(2, 4.0)
    xp_j, xc_j = dj.Matern1(seed=0).partition(4, 60, lo, hi)
    m = dt.Matern1(seed=0)
    xp_t, xc_t = m.partition(4, 60, lo, hi)
    np.testing.assert_array_equal(xp_t, np.asarray(xp_j))
    np.testing.assert_array_equal(xc_t, np.asarray(xc_j))
    assert xp_t.shape == (4, 60, 2) and m.min_dist is not None


@pytest.mark.parametrize("design", ["Uniform", "Sobol"])
def test_box_designs_are_bit_equal_to_jax(design):
    lo, hi = np.zeros(3, np.float32), np.array([1.0, 2.0, 4.0], np.float32)
    want = np.asarray(getattr(dj, design)(7).sample(16, lo, hi, salt=2))
    got = getattr(dt, design)(7).sample(16, lo, hi, salt=2)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_assign_clusters_is_bit_equal_to_jax(rng):
    """Seven centers over 300 points into shards of 50: some clusters are
    short and are topped up with their nearest remaining points."""
    x = rng.uniform(size=(300, 3))
    xc = x[:7] + 0.01
    got = dt.assign_clusters(x, xc, 50)
    np.testing.assert_array_equal(got, np.asarray(dj.assign_clusters(jnp.asarray(x), jnp.asarray(xc), 50)))
    np.testing.assert_array_equal(dt.cluster_samples(x, xc[:3]), np.asarray(dj.cluster_samples(x, xc[:3])))
    with pytest.raises(ValueError):
        dt.cluster_samples(x[:299], xc[:3])


def test_keys_fix_the_stream():
    """A seed or a Generator in place of the key: the same key gives the
    same design, another key another one."""
    lo, hi = np.zeros(2), np.ones(2)
    u = dt.Uniform(0)
    np.testing.assert_array_equal(u.sample(5, lo, hi, key=3), u.sample(5, lo, hi, key=[3]))
    assert not np.array_equal(u.sample(5, lo, hi, key=3), u.sample(5, lo, hi, key=4))
    a = dt.Matern1(0, max_count=500).sample(10, lo, hi, key=np.random.default_rng(5))
    b = dt.Matern1(0, max_count=500).sample(10, lo, hi, key=np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


def test_host_helpers_are_bit_equal_to_jax_data_layer(rng):
    """The hard-core scan, the distance matrix and the nearest center
    against the JAX package's compiled data layer, bit for bit."""
    from pygpr_tpu import native as nj

    assert nj.get_lib() is not None
    cand = rng.uniform(size=(400, 2))
    x, xc = rng.uniform(size=(50, 3)), rng.uniform(size=(6, 3))
    mask = dt._hard_core_accept(cand, 0.05, 1e-5)
    want_mask, want_k = nj.hard_core_accept(cand, 0.05)
    np.testing.assert_array_equal(mask, want_mask)
    assert int(mask.sum()) == want_k > 1
    d = dt._sq_dist(x, xc)
    np.testing.assert_array_equal(d, nj.sq_dist_matrix(x, xc))
    np.testing.assert_array_equal(np.argmin(d, axis=1), nj.nearest_center(x, xc))


def test_sample_gp_factor_matches_jax_and_draws_have_its_moments(rng):
    x = rng.uniform(0, 2, size=(6, 2))
    hp = np.array([1.2, 0.9, 1.1])
    def gram_and_factor(hp, x):
        K = gj.kernel_matrix(gj.RBF(), hp, x)
        return K, gj.safe_cholesky(K).chol

    K, Lj = (np.asarray(a) for a in jax.jit(gram_and_factor)(jnp.asarray(hp), jnp.asarray(x)))
    xt = torch.tensor(x)
    Lt = gt.safe_cholesky(gt.kernel_matrix(gt.RBF(), torch.tensor(hp), xt)).chol
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=1e-8, atol=1e-10)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([dt.sample_gp(xt, gt.RBF(), hp, mean=0.5, generator=gen) for _ in range(1000)])
    sd = np.sqrt(np.diag(K))
    assert np.all(np.abs(draws.mean(0).numpy() - 0.5) < 5 * sd / np.sqrt(1000))
    np.testing.assert_allclose(torch.cov(draws.T).numpy(), K, atol=6 * np.sqrt(2.0 / 1000) * sd.max() ** 2)
