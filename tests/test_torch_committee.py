"""Port parity for the PoE committee family (poe, gpoe, bcm, rbcm) and the
predictive metrics, against the JAX package on the CPU in f64 at rtol
1e-8 (1e-4 for fitted parameters, 1e-9 for the NLML at the optimum).
Inputs are made with NumPy from a seed; the JAX references come from one
compiled program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch.models import committee as ct_
from pygpr_torch.models import metrics as mt_
from pygpr_tpu.models import committee as cj_
from pygpr_tpu.models import metrics as mj_


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _covs():
    return gj.Sum((gj.RBF(), gj.WhiteNoise())), gt.Sum((gt.RBF(), gt.WhiteNoise()))


MASK = np.array([True, False, True])


@pytest.fixture(scope="module")
def ref():
    """A plain committee of three shards with per-expert parameters, and
    the JAX package's predictions by every method, masked or not, its
    shared committee fit and its metrics."""
    rng = np.random.default_rng(1)
    nc, n, d = 3, 24, 2
    x = rng.uniform(0, 4, (nc, n, d))
    data = dict(
        x=x, y=np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=(nc, n)), xs=rng.uniform(0, 4, (11, d)),
        p=np.tile([1.0, 0.9, 1.1, 0.1], (nc, 1)) * np.linspace(0.9, 1.1, nc)[:, None],
    )
    cj, _ = _covs()

    def run(data, mask):
        s = gj.factorize(cj, data["p"], data["x"], data["y"])
        out = {"prior_var": cj_.prior_variance(cj, data["p"], data["xs"])}
        for m in cj_.METHODS:
            out[m] = cj_.predict_committee(cj, s, data["xs"], m)
            out[m + "_masked"] = cj_.predict_committee(cj, s, data["xs"], m, mask=mask)
        out["fit"] = cj_.fit_committee(cj, data["x"], data["y"], max_iter=50)
        mean, var = out["rbcm"].mean, out["rbcm"].covar
        truth = jnp.sin(2.0 * data["xs"].sum(-1))
        out["metrics"] = (mj_.rmse(truth, mean), mj_.nlpd(truth, mean, var), mj_.standardized_mse(truth, mean, var))
        s0 = jax.tree_util.tree_map(lambda a: a[0], s)
        out["loo"] = (mj_.loo_cv(s0), mj_.loo_cv(gj.precompute_tinv(s0)))
        return out

    out = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, data), jnp.asarray(MASK))
    return data, jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-8, atol=1e-8):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _state(data, keep=slice(None)):
    _, ct = _covs()
    return gt.factorize(ct, _t(data["p"][keep]), _t(data["x"][keep]), _t(data["y"][keep]))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method", ["poe", "gpoe", "bcm", "rbcm"])
def test_predict_committee_matches_jax(method, masked, ref):
    data, want = ref
    _, ct = _covs()
    res = ct_.predict_committee(ct, _state(data), _t(data["xs"]), method, mask=torch.tensor(MASK) if masked else None)
    for g, w in zip(res, want[method + ("_masked" if masked else "")]):
        _close(g, w)


@pytest.mark.parametrize("method", ["poe", "gpoe", "bcm", "rbcm"])
def test_masked_expert_equals_removed_one(method, ref):
    data, _ = ref
    _, ct = _covs()
    xs = _t(data["xs"])
    masked = ct_.predict_committee(ct, _state(data), xs, method, mask=torch.tensor(MASK))
    removed = ct_.predict_committee(ct, _state(data, MASK), xs, method)
    _close(masked.mean, removed.mean.numpy(), rtol=1e-12, atol=1e-12)
    _close(masked.covar, removed.covar.numpy(), rtol=1e-12, atol=1e-12)


def test_committee_beta_rejects_unknown_method():
    with pytest.raises(ValueError):
        ct_.committee_beta("mean", torch.ones(2, 3), torch.ones(3))


def test_prior_variance_matches_jax(ref):
    data, want = ref
    _, ct = _covs()
    _close(ct_.prior_variance(ct, _t(data["p"]), _t(data["xs"])), want["prior_var"])
    _close(ct_.prior_variance(ct, _t(data["p"][0]), _t(data["xs"])), want["prior_var"][0])


def test_fit_committee_matches_jax(ref):
    data, want = ref
    _, ct = _covs()
    res = ct_.fit_committee(ct, _t(data["x"]), _t(data["y"]), max_iter=50)
    _close(res.params, want["fit"].params, rtol=1e-4, atol=0)
    _close(res.value, want["fit"].value, rtol=1e-9, atol=0)
    indep = ct_.fit_committee(ct, _t(data["x"]), _t(data["y"]), max_iter=20, shared=False)
    one = gt.fit_mle(ct, torch.ones(4, dtype=torch.float64), _t(data["x"][1]), _t(data["y"][1]), max_iter=20)
    _close(indep.params[1], one.params.numpy(), rtol=1e-12, atol=0)


def test_metrics_match_jax(ref):
    data, want = ref
    rbcm = want["rbcm"]
    truth = torch.sin(2.0 * _t(data["xs"]).sum(-1))
    mean, var = _t(rbcm.mean), _t(rbcm.covar)
    for g, w in zip((mt_.rmse(truth, mean), mt_.nlpd(truth, mean, var), mt_.standardized_mse(truth, mean, var)),
                    want["metrics"]):
        _close(g, w)
    s0 = gt.GPState(*(None if f is None else f[0] for f in _state(data)))
    for st, w in zip((s0, gt.precompute_tinv(s0)), want["loo"]):
        for g, ww in zip(mt_.loo_cv(st), w):
            _close(g, ww)
