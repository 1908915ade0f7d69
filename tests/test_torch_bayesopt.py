"""Port parity: Bayesian optimization against the JAX package.

The same seeded NumPy data go through both packages in f64: the
acquisition functions (LogEI also in its tail, where EI underflows, with
its gradient), ``propose`` from one raw sweep drawn from the JAX key and
given to both packages, the kriging believer's incremental state, and the
ask/tell loop's incremental ``tell``.  The JAX side runs once, under one
``jax.jit``, in a module fixture.

Run as a script, the file runs ``chip_smoke.py``'s BayesOpt problem with
the port on the CPU in f64 (Hartmann-6: 10 initial points, ask/tell with
``refit_every=5`` to 40 evaluations, proposals of 20 Adam steps, white
noise starting at 0.1) and prints its best value beside the
best of 50 uniform draws, the yardstick of the card's run:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bayesopt.py
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import exact_gp as et
from pygpr_torch.optimize import bayesopt as bt
from pygpr_tpu.models import exact_gp as ej
from pygpr_tpu.optimize import bayesopt as bj

RTOL = 1e-10
#: the Adam ascents from one raw sweep: 40 steps of each package's Adam on
#: acquisitions that agree to 1e-12
PROPOSE_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def branin_like(x):
    return np.sin(3 * x[:, 0]) + (x[:, 1] - 0.5) ** 2 + 0.5 * np.cos(5 * x[:, 1])


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    return x, branin_like(x), np.array([0.9, 2.0, 1.5, 0.05])


ACQS = ("log_ei", "ei", "lcb", "pi")


@pytest.fixture(scope="module")
def parity():
    x, y, p = _data()
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    key = jax.random.PRNGKey(3)
    mean = np.array([0.0, 1.0, 5.0, 10.0, 40.0, -0.5])
    var = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.3])
    lo, hi = np.zeros(2), np.ones(2)

    def run(x, y, p, mean, var, key):
        out = {"ei": bj.expected_improvement(mean, var, 0.0), "lcb": bj.lower_confidence_bound(mean, var, 2.0),
               "pi": bj.probability_of_improvement(mean, var, 0.0)}
        out["log_ei"], out["g_log_ei"] = jax.value_and_grad(
            lambda m: jnp.sum(bj.log_expected_improvement(m, var, 0.0)))(mean)
        out["log_ei"] = bj.log_expected_improvement(mean, var, 0.0)
        st = ej.factorize(cov, p, x, y)
        out["state"] = st._asdict()
        out["raw"] = lo + (hi - lo) * jax.random.uniform(key, (64, 2), dtype=x.dtype)
        for acq in ACQS:
            out[f"prop_{acq}"] = bj.propose(cov, st, (lo, hi), key, acq=acq, n_raw=64, n_starts=4, n_steps=40)
        x2 = jnp.asarray([[0.3, 0.7]])
        fantasy, _ = ej.predict(cov, st, x2, "none")
        out["ext"] = ej.extend_state(cov, st, x2, fantasy)._asdict()
        return out

    want = jax.jit(run)(*map(jnp.asarray, (x, y, p, mean, var)), key)
    return (x, y, p, mean, var), jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


COV = gt.Sum((gt.RBF(), gt.WhiteNoise()))


def test_acquisitions_match_jax(parity):
    (*_, mean, var), want = parity
    m, v = T(mean), T(var)
    best = torch.tensor(0.0, dtype=torch.float64)
    np.testing.assert_allclose(bt.expected_improvement(m, v, best).numpy(), want["ei"], rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(bt.lower_confidence_bound(m, v, 2.0).numpy(), want["lcb"], rtol=RTOL)
    np.testing.assert_allclose(bt.probability_of_improvement(m, v, best).numpy(), want["pi"], rtol=RTOL,
                               atol=1e-300)


def test_log_ei_tail_where_ei_underflows(parity):
    (*_, mean, var), want = parity
    m = T(mean).requires_grad_(True)
    lei = bt.log_expected_improvement(m, T(var), torch.tensor(0.0, dtype=torch.float64))
    (g,) = torch.autograd.grad(lei.sum(), m)
    np.testing.assert_allclose(lei.detach().numpy(), want["log_ei"], rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), want["g_log_ei"], rtol=1e-9)
    ei = bt.expected_improvement(T(mean), T(var), torch.tensor(0.0, dtype=torch.float64))
    assert ei[4].item() == 0.0                       # z = −40: φ(z) underflows in f64
    assert np.isfinite(lei[4].item()) and lei[4] < lei[3] < lei[2] < lei[1]
    np.testing.assert_allclose(torch.exp(lei[:3]).detach().numpy(), ei[:3].numpy(), rtol=1e-6)


@pytest.mark.parametrize("acq", ACQS)
def test_propose_from_the_jax_raw_sweep_matches_jax(parity, acq):
    _, want = parity
    st = convert.state_from_numpy(want["state"], "cpu")
    bounds = (torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64))
    xq = bt.propose_from_raw(COV, st, bounds, T(want["raw"]), acq=acq, n_starts=4, n_steps=40)
    np.testing.assert_allclose(xq.numpy(), want[f"prop_{acq}"], atol=PROPOSE_TOL)
    assert ((xq > 0) & (xq < 1)).all()


def test_kriging_believer_extends_as_the_jax_package(parity):
    _, want = parity
    st = convert.state_from_numpy(want["state"], "cpu")
    x2 = T([[0.3, 0.7]])
    fantasy, _ = et.predict(COV, st, x2, "none")
    ext = et.extend_state(COV, st, x2, fantasy)
    np.testing.assert_allclose(ext.weights.numpy(), want["ext"]["weights"], rtol=1e-9, atol=1e-11)
    bounds = (np.zeros(2), np.ones(2))
    gen = torch.Generator().manual_seed(0)
    batch = bt.propose_batch(COV, st, bounds, gen, 3, n_raw=64, n_starts=4, n_steps=20)
    assert batch.shape == (3, 2) and ((batch > 0) & (batch < 1)).all()
    assert torch.cdist(batch, batch)[~torch.eye(3, dtype=torch.bool)].min() > 1e-3
    ts = bt.propose_batch(COV, st, bounds, gen, 4, acq="thompson", n_raw=128)
    assert ts.shape == (4, 2) and ((ts >= 0) & (ts <= 1)).all()
    one = bt.thompson_sample(COV, st, bounds, gen, n_candidates=128)
    assert one.shape == (2,)


def test_tell_extends_incrementally_and_the_loop_improves():
    rng = np.random.default_rng(1)
    x0 = rng.uniform(size=(6, 2))
    opt = gt.BayesOpt(COV, x0, branin_like(x0), (np.zeros(2), np.ones(2)), refit_every=100, seed=0,
                      propose_kwargs=dict(n_raw=64, n_starts=4, n_steps=20), device="cpu")
    for _ in range(4):
        xn = opt.ask()
        opt.tell(xn, branin_like(xn[None].numpy()))
    full = et.factorize(COV, opt.params, opt.x, opt.y)
    np.testing.assert_allclose(opt.state.weights.numpy(), full.weights.numpy(), rtol=1e-6, atol=1e-8)
    assert opt.x.shape == (10, 2) and opt.best[1] <= float(branin_like(x0).min())
    assert opt.ask(q=2).shape == (2, 2)


# ----------------------------------------------------------------------
# script mode: the port's own Hartmann-6 run on the CPU
# ----------------------------------------------------------------------

#: Hartmann-6 (Dixon & Szegő 1978) on [0, 1]⁶: minimum −3.32237
H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
H6_A = np.array([[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                 [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
H6_P = 1e-4 * np.array([[1312, 1696, 5569, 124, 8283, 5886], [2329, 4135, 8307, 3736, 1004, 9991],
                        [2348, 1451, 3522, 2883, 3047, 6650], [4047, 8828, 8732, 5743, 1091, 381]])


def hartmann6(x):
    x = np.atleast_2d(x)
    return -np.sum(H6_ALPHA * np.exp(-np.sum(H6_A * (x[:, None, :] - H6_P) ** 2, axis=-1)), axis=-1)


def hartmann_run(device="cpu", dtype=np.float64, n_init=10, n_total=40, seed=0):
    """chip_smoke.py's BayesOpt problem: ``(best, best of 50 uniform
    draws from the same seed, seconds)``."""
    import time

    rng = np.random.default_rng(seed)
    x0 = rng.uniform(size=(n_init, 6)).astype(dtype)
    random_best = float(hartmann6(np.random.default_rng(seed).uniform(size=(50, 6))).min())
    t0 = time.perf_counter()
    opt = gt.BayesOpt(gt.Sum((gt.RBF(), gt.WhiteNoise())), x0, hartmann6(x0).astype(dtype),
                      (np.zeros(6, dtype), np.ones(6, dtype)), refit_every=5, seed=seed,
                      propose_kwargs=dict(n_steps=20), config=gt.Config(noise_init=0.1), device=device)
    while opt.x.shape[0] < n_total:
        xn = opt.ask()
        opt.tell(xn, hartmann6(xn.detach().cpu().double().numpy()).astype(dtype))
    return float(opt.best[1]), random_best, time.perf_counter() - t0


if __name__ == "__main__":
    best, rand, secs = hartmann_run()
    print(json.dumps({"port_cpu_f64_hartmann6": {"best": best, "random_best_of_50": rand, "seconds": secs,
                                                 "minimum": -3.32237}}), flush=True)
    sys.exit(0)
