"""Port parity: NUTS (``pygpr_torch/sample/nuts.py``) against the JAX package.

The transition's draws are taken in another order than the JAX key tree
(the port's chains share one ``torch.Generator`` and stop at their own
depth), so the chains are held to the JAX tests' statistical checks
(``tests/test_nuts.py``) and the deterministic pieces bit for bit: the
checkpoint-slot arithmetic (``_popcount``, ``_trailing_ones``, the slot
window of each odd leaf) and the dual-averaging step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
from pygpr_torch.sample import effective_sample_size, posterior_moments, run_nuts, sample_posterior, split_rhat
from pygpr_torch.sample import nuts as nt
from pygpr_tpu.sample import nuts as nj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gp_problem(n=48, seed=0):
    """The JAX test's problem (tests/test_nuts.py)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 4, (n, 1)), axis=0)
    y = np.sin(2.0 * x[:, 0]) + 0.2 * rng.normal(size=n)
    return torch.tensor(x), torch.tensor(y), gt.Sum((gt.RBF(), gt.WhiteNoise()))


def test_bit_arithmetic_equals_jax():
    """``_popcount`` and ``_trailing_ones`` on host integers and on integer
    tensors equal the JAX package's, and every odd leaf's slot window
    ``[idx_min, idx_max]`` is the set of slots of the dyadic ranges ending
    there."""
    nbits = 8
    ii = np.arange(256, dtype=np.int32)
    pj = np.asarray(jax.vmap(lambda i: nj._popcount(i, nbits))(jnp.asarray(ii)))
    tj = np.asarray(jax.vmap(lambda i: nj._trailing_ones(i, nbits))(jnp.asarray(ii)))
    np.testing.assert_array_equal(nt._popcount(torch.tensor(ii), nbits).numpy(), pj)
    np.testing.assert_array_equal(nt._trailing_ones(torch.tensor(ii), nbits).numpy(), tj)
    assert [nt._popcount(int(i), nbits) for i in ii] == pj.tolist()
    assert [nt._trailing_ones(int(i), nbits) for i in ii] == tj.tolist()
    for n in range(1, 128, 2):
        slots = set()
        m = 1
        while (n + 1) % (1 << m) == 0:
            slots.add(bin(n + 1 - (1 << m)).count("1"))
            m += 1
        idx_max = nt._popcount(n >> 1, nbits)
        idx_min = idx_max - nt._trailing_ones(n, nbits) + 1
        assert slots == set(range(idx_min, idx_max + 1)), n


def test_dual_avg_update_equals_jax():
    """One dual-averaging step over a run of statistics, per chain, bit for
    bit against the JAX package's in f64, run eagerly: under ``jax.jit``
    XLA's simplifier rewrites the arithmetic and the step size moves by an
    ulp."""
    rng = np.random.default_rng(1)
    stats = rng.uniform(-0.5, 0.5, (40, 3))
    mu = np.log(10.0) + np.log(0.1) + rng.normal(size=3) * 0.1
    hj, ej = jnp.zeros(3), jnp.full(3, np.log(0.1))
    ht, et = torch.zeros(3, dtype=torch.float64), torch.full((3,), np.log(0.1), dtype=torch.float64)
    for m, s in enumerate(stats, start=1):
        hj, ej, lj = nj._dual_avg_update(jnp.int32(m), hj, ej, jnp.asarray(s), jnp.asarray(mu), jnp.float64)
        ht, et, lt = nt._dual_avg_update(m, ht, et, torch.tensor(s), torch.tensor(mu))
        for a, b in ((ht, hj), (et, ej), (lt, lj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.slow
def test_gaussian_target_exact():
    """The JAX test's correlated 2-D Gaussian: mean and covariance within
    MC error, no divergence, and trajectories that end by themselves
    (mean depth below max_depth).  About 22 s on one CPU thread (the
    transitions' host loop), under ``slow``; the short run below checks
    the same at a looser tolerance."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))

    def lp(u):
        return -0.5 * torch.sum((u @ prec) * u, dim=-1)

    u0s = torch.tensor(np.random.default_rng(1).normal(size=(4, 2)))
    us, _, acc, eps, depth, div, _ = run_nuts(lp, u0s, torch.Generator().manual_seed(0), n_samples=1500,
                                              n_warmup=500, max_depth=6)
    flat = us.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.12)
    assert np.all(div.numpy() == 0.0)
    assert np.all(acc.numpy() > 0.6)
    assert np.all(depth.numpy() < 6.0)
    assert np.all(eps.numpy() > 0.0)


def test_gaussian_target_short():
    """The same target at 150 + 300 transitions (about 4 s): the moments to
    three times the slow test's tolerances, which at 1200 correlated draws
    are still far inside what a wrong tree (biased to one direction, or
    never turning) gives."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))

    def lp(u):
        return -0.5 * torch.sum((u @ prec) * u, dim=-1)

    u0s = torch.tensor(np.random.default_rng(1).normal(size=(4, 2)))
    us, _, acc, _, depth, div, _ = run_nuts(lp, u0s, torch.Generator().manual_seed(0), n_samples=300,
                                            n_warmup=150, max_depth=6)
    flat = us.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.3)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.36)
    assert np.all(div.numpy() == 0.0)
    assert np.all(acc.numpy() > 0.6)
    assert np.all(depth.numpy() < 6.0)


def test_one_chain_without_chain_axis():
    """A ``[nhp]`` start runs one chain and returns no chain axis."""
    def lp(u):
        return -0.5 * torch.sum(u * u, dim=-1)

    us, lps, acc, eps, depth, div, im = run_nuts(lp, torch.zeros(2, dtype=torch.float64),
                                                 torch.Generator().manual_seed(2), n_samples=20, n_warmup=20)
    assert us.shape == (20, 2) and lps.shape == (20,) and im.shape == (2,)
    assert acc.ndim == eps.ndim == depth.ndim == div.ndim == 0


@pytest.mark.slow
def test_mass_adaptation_helps_anisotropic():
    """The JAX test's badly scaled Gaussian (std 1 against 30): the adapted
    diagonal metric picks up the scale separation.  About 15 s on one CPU
    thread, under ``slow``."""
    scales = torch.tensor([1.0, 30.0], dtype=torch.float64)

    def lp(u):
        return -0.5 * torch.sum((u / scales) ** 2, dim=-1)

    us, _, _, _, _, div, inv_mass = run_nuts(lp, torch.zeros(2, dtype=torch.float64),
                                             torch.Generator().manual_seed(3), n_samples=2500, n_warmup=800,
                                             max_depth=8)
    assert float(div) == 0.0
    im = inv_mass.numpy()
    assert im[1] / im[0] > 50.0
    flat = us.numpy()
    assert 20.0 < flat[:, 1].std() < 45.0
    assert 0.7 < flat[:, 0].std() < 1.4


def test_sync_fn_hook_and_no_mass():
    """``sync_fn`` sees the ``[C]`` dual-averaging statistic each warmup
    transition; ``adapt_mass=False`` keeps the unit metric."""
    calls = []

    def sync(s):
        calls.append(tuple(s.shape))
        return s

    x, y, cov = _gp_problem(n=24)
    res = gt.sample_posterior_nuts(cov, x, y, torch.Generator().manual_seed(5), n_samples=10, n_warmup=10,
                                   n_chains=2, adapt_mass=False, sync_fn=sync)
    assert calls == [(2,)] * 10
    assert torch.isfinite(res.samples).all()
    np.testing.assert_allclose(res.inv_mass.numpy(), 1.0)
    assert res.samples.shape == (2, 10, 3) and res.tree_depth.shape == (2,)


@pytest.mark.slow
def test_nuts_matches_rwm_on_gp_posterior():
    """The JAX test's agreement of NUTS with adaptive RWM on the same GP
    posterior (pooled moments within MC tolerance), R̂, divergences and
    NUTS's effective samples; about 65 s on one CPU thread, under ``slow``."""
    x, y, cov = _gp_problem()
    res_n = gt.sample_posterior_nuts(cov, x, y, torch.Generator().manual_seed(0), n_samples=400, n_warmup=400,
                                     n_chains=4, max_depth=6)
    res_r = sample_posterior(cov, x, y, torch.Generator().manual_seed(1), n_samples=6000, n_warmup=2000,
                             n_chains=4)
    mn, sn = posterior_moments(torch.log(res_n.samples))
    mr, sr = posterior_moments(torch.log(res_r.samples))
    np.testing.assert_allclose(mn.numpy(), mr.numpy(), atol=0.15)
    np.testing.assert_allclose(sn.numpy(), sr.numpy(), atol=0.12)
    assert np.all(split_rhat(torch.log(res_n.samples)).numpy() < 1.05)
    assert np.all(res_n.divergence_rate.numpy() < 0.02)
    ess_n = effective_sample_size(torch.log(res_n.samples))
    assert ess_n.min() > 0.1 * res_n.samples.shape[0] * res_n.samples.shape[1]
