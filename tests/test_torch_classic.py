"""Port parity: the reference PyGPR's own API — the SciPy drivers, the
quadratic solvers, the parabolic step size, ``OptTrace``, the
scikit-learn wrapper and ``compat`` — against the JAX package on the CPU
in f64.

``CG`` and ``NelderMead`` run over ``MLE`` of the same 30-point
``ExactGP`` in both packages (final parameters rtol 1e-4, loss rtol
1e-9, the same write-back); ``CGQuad``, ``BFGSQuad`` and ``hessian`` on a
NumPy quadratic are bit-equal; ``learn_rate`` and ``get_learn_rate`` agree
to 1e-10; ``OptTrace`` writes the same bytes; ``SKWrap`` over
``ExactGP``, ``SGPR`` and ``IterativeGP`` predicts what the JAX package's
functions give to 1e-8; ``compat`` has the JAX ``compat``'s names, each
bound to the port, and the reference's session runs on it.  The JAX
functions run once, under one ``jax.jit``, in a module fixture.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.base import clone

import pygpr_torch as gt
import pygpr_torch.compat as ct
import pygpr_tpu as gj
import pygpr_tpu.compat as cj
from pygpr_torch.optimize import classic as qt
from pygpr_tpu.optimize import classic as qj


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


COV_J = gj.Sum((gj.RBF(), gj.WhiteNoise()))


def _cov():
    return gt.Sum((gt.RBF(), gt.WhiteNoise()))


def _inputs():
    rng = np.random.default_rng(21)
    x = rng.uniform(0.0, 2.0, (30, 2))
    out = dict(x=x, y=np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=30), p0=np.array([1.0, 1.0, 1.0, 0.1]))
    # SKWrap over ExactGP (the JAX package's tests/test_interop_utils.py)
    xs = rng.uniform(size=(40, 2))
    out.update(sk_x=xs, sk_y=np.sin(xs.sum(-1)))
    x2 = rng.uniform(size=(25, 2)) + 5.0
    out.update(sk_x2=x2, sk_y2=np.cos(x2.sum(-1)))
    xo = rng.uniform(size=(30, 1))
    out.update(opt_x=xo, opt_y=np.sin(4 * xo[:, 0]) + 0.05 * rng.normal(size=30))
    xl = rng.uniform(0, 4, size=(300, 1))
    out.update(big_x=xl, big_y=np.sin(2 * xl[:, 0]) + 0.1 * rng.normal(size=300))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results for the functional parts: the posterior
    that SKWrap's ``fit`` + ``predict`` gives over ExactGP (init
    parameters: all ones, noise 1e-4), its L-BFGS fit, SGPR's and the
    iterative GP's predictions at their init parameters, and
    ``learn_rate`` on the NLML."""
    from pygpr_tpu.models import iterative, sgpr

    inp = _inputs()
    z = sgpr.init_inducing(inp["big_x"], 24, seed=0)

    def run(c, z):
        out = {}
        for key, x, y in (("fit", c["sk_x"], c["sk_y"]), ("refit", c["sk_x2"], c["sk_y2"])):
            out[key] = gj.fit_predict(COV_J, COV_J.init_params(x), x, y, x, var="diag")
        out["optimize"] = gj.fit_mle(COV_J, COV_J.init_params(c["opt_x"]), c["opt_x"], c["opt_y"], max_iter=50).params
        xq = c["big_x"][:50]
        ps = sgpr.init_params(gj.RBF(), c["big_x"])
        out["sgpr"] = sgpr.predict(gj.RBF(), sgpr.factorize(gj.RBF(), ps, c["big_x"], c["big_y"], z), xq, "diag")
        pi = iterative.init_params(gj.RBF(), c["big_x"])
        out["iterative"] = iterative.predict(gj.RBF(), pi, c["big_x"], c["big_y"], xq, var="diag", rank=32, block=64)
        fun = lambda p: gj.nlml(COV_J, p, c["x"], c["y"])
        grad = lambda p: gj.nlml_value_and_grad(COV_J, p, c["x"], c["y"])[1]
        out["learn_rate"] = gj.optimize.learn_rate(fun, grad, c["p0"], 1e-3)
        return out

    want = jax.jit(run)({k: jnp.asarray(v) for k, v in inp.items()}, jnp.asarray(z))
    return inp, jax.tree_util.tree_map(np.asarray, want)


@pytest.fixture(scope="module")
def drivers(tmp_path_factory):
    """In each package, over MLE of the same 30-point ExactGP from
    [1, 1, 1, 0.1]: ``get_learn_rate``, then Nelder-Mead, then CG, each
    with ``maxiter`` 20; the parameters the model holds after each."""
    inp = _inputs()
    out = {}
    for pkg, mod, mk in (("jax", qj, lambda: gj.ExactGP(jnp.asarray(inp["x"]), jnp.asarray(inp["y"]), COV_J)),
                         ("torch", qt, lambda: gt.ExactGP(inp["x"], inp["y"], _cov(), device="cpu"))):
        model = mk()
        model.set_params(inp["p0"])
        loss = (gj if pkg == "jax" else gt).MLE(model)
        d = tmp_path_factory.mktemp(pkg)
        rec = {"learn_rate": (gj if pkg == "jax" else gt).get_learn_rate(inp["p0"], loss, 1e-3)}
        nm = mod.NelderMead(loss, trace_path=str(d / "nm.dat"))
        nm.args["maxiter"] = 20
        nm.minimize()
        rec.update(nm=nm.res, after_nm=np.array(np.asarray(model.params), dtype=np.float64))
        cg = mod.CG(loss, trace_path=str(d / "cg.dat"))
        cg.args["maxiter"] = 20
        cg.minimize()
        rec.update(cg=cg.res, after_cg=np.array(np.asarray(model.params), dtype=np.float64), dir=d)
        out[pkg] = rec
    return inp, out


@pytest.mark.parametrize("which", ["nm", "cg"])
def test_scipy_drivers_match_jax(drivers, which):
    """The same iterates, and the reference's write-back: CG writes its
    result back even when it fails, Nelder-Mead only when it succeeds."""
    inp, out = drivers
    rj, rt = out["jax"][which], out["torch"][which]
    assert rt.success == rj.success and rt.nit == rj.nit
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-4)
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-9)
    after = out["torch"]["after_" + which]
    if which == "cg" or rt.success:
        np.testing.assert_array_equal(after, rt.x)
    else:
        np.testing.assert_array_equal(after, inp["p0"])
    np.testing.assert_allclose(after, out["jax"]["after_" + which], rtol=1e-4)
    lines = [len(open(out[p]["dir"] / f"{which}.dat").readlines()) for p in ("jax", "torch")]
    assert lines[0] == lines[1] > 0


def test_get_learn_rate_matches_jax(drivers):
    _, out = drivers
    np.testing.assert_allclose(out["torch"]["learn_rate"], out["jax"]["learn_rate"], rtol=1e-10)


def test_learn_rate_matches_jax(jax_side):
    inp, want = jax_side
    x, y, cov = _t(inp["x"]), _t(inp["y"]), _cov()
    gamma, J = gt.learn_rate(lambda p: gt.nlml(cov, p, x, y), lambda p: gt.nlml_value_and_grad(cov, p, x, y)[1],
                             _t(inp["p0"]), 1e-3)
    np.testing.assert_allclose(gamma.item(), want["learn_rate"][0], rtol=1e-10)
    np.testing.assert_allclose(J.numpy(), want["learn_rate"][1], rtol=1e-10)


def _quadratic(dim, seed):
    rng = np.random.RandomState(seed)
    L = rng.rand(dim, dim)
    H = L.T @ L
    J = rng.rand(dim)
    return H, J, rng.rand(dim)


@pytest.mark.parametrize("name", ["CGQuad", "BFGSQuad"])
@pytest.mark.parametrize("dim,seed", [(2, 23), (5, 443556), (7, 1233)])
def test_quadratic_solvers_bit_equal(name, dim, seed, tmp_path):
    """The reference's oracle (a random SPD quadratic) in both packages:
    the same iterates to the bit, the same trace file."""
    H, J, par = _quadratic(dim, seed)
    res = []
    for pkg, mod in (("jax", qj), ("torch", qt)):
        loss = (gj.Loss if pkg == "jax" else gt.Loss)(None)
        loss.loss = lambda x: np.dot(J, x) + np.dot(x, H @ x)
        loss.grad = lambda x: J + H @ x
        opt = getattr(mod, name)(loss, trace_path=str(tmp_path / f"{pkg}.dat"))
        res.append((opt.minimize(par=par), opt.x))
    assert res[0][0] == res[1][0] > 0
    np.testing.assert_array_equal(res[1][1], res[0][1])
    np.testing.assert_allclose(res[1][1], np.linalg.solve(H, -J), rtol=1e-3)
    assert filecmp.cmp(tmp_path / "jax.dat", tmp_path / "torch.dat", shallow=False)


def test_hessian_bit_equal():
    H, J, x = _quadratic(4, 0)
    jac = lambda v: J + H @ v
    np.testing.assert_array_equal(gt.hessian(x, jac, 1e-6), qj.hessian(x, jac, 1e-6))
    np.testing.assert_allclose(gt.hessian(x, jac, 1e-6), H, atol=1e-5)


def test_opt_trace_same_bytes(tmp_path):
    """The same calls write the same ``opt.dat`` and JSONL files."""
    from pygpr_tpu.utils import OptTrace as TraceJ

    for name, cls in (("jax", TraceJ), ("torch", gt.OptTrace)):
        with cls(str(tmp_path / f"{name}.dat"), str(tmp_path / f"{name}.jsonl")) as tr:
            tr.log(np.array([1.0, 2.5e-7, 3.0]), np.asarray(-12.25), 0.5)
            tr.log(np.array([[1.5], [2.0]]), loss=np.float64(1e-9))
            tr.log(np.asarray([3]), grad_norm=1e3, step=np.float32(0.1), vec=np.arange(2.0))
        no_dat = cls(None, str(tmp_path / f"{name}_only.jsonl"))
        no_dat.log(np.ones(2), 1.0)
        no_dat.close()
    for ext in (".dat", ".jsonl", "_only.jsonl"):
        assert filecmp.cmp(tmp_path / f"jax{ext}", tmp_path / f"torch{ext}", shallow=False), ext


def _exact(inp, key_x, key_y):
    return gt.ExactGP(inp[key_x], inp[key_y], _cov(), device="cpu")


def test_skwrap_fit_predict_and_clone(jax_side):
    inp, want = jax_side
    sk = gt.SKWrap(_exact(inp, "sk_x", "sk_y"))
    assert sk.fit(inp["sk_x"], inp["sk_y"]) is sk
    mean_j, var_j = want["fit"]
    yp = sk.predict(inp["sk_x"])
    assert isinstance(yp, np.ndarray)
    np.testing.assert_allclose(yp, mean_j, rtol=1e-8, atol=1e-8)
    mean, std = sk.predict(inp["sk_x"], return_std=True)
    np.testing.assert_allclose(std, np.sqrt(var_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(yp, inp["sk_y"], atol=1e-4)
    # a scikit-learn estimator with a torch model inside
    twin = clone(sk)
    assert twin is not sk and twin.model is not sk.model
    assert twin.get_params().keys() == {"model", "optimize", "max_iter"}
    np.testing.assert_array_equal(twin.fit(inp["sk_x"], inp["sk_y"]).predict(inp["sk_x"]), yp)


def test_skwrap_refit_not_stale(jax_side):
    """The reference's bug: a refit must drop the cached Cholesky."""
    inp, want = jax_side
    sk = gt.SKWrap(_exact(inp, "sk_x", "sk_y"))
    sk.fit(inp["sk_x"][:20], inp["sk_y"][:20])
    sk.predict(inp["sk_x"][:20])
    sk.fit(inp["sk_x2"], inp["sk_y2"])
    np.testing.assert_allclose(sk.predict(inp["sk_x2"]), want["refit"][0], rtol=1e-8, atol=1e-8)


def test_skwrap_optimize_runs_fit_mle(jax_side):
    inp, want = jax_side
    model = _exact(inp, "opt_x", "opt_y")
    gt.SKWrap(model, optimize=True, max_iter=50).fit(inp["opt_x"], inp["opt_y"])
    np.testing.assert_allclose(model.params.numpy(), want["optimize"], rtol=1e-4)


@pytest.mark.parametrize("kind", ["sgpr", "iterative"])
def test_skwrap_wraps_sgpr_and_iterative(jax_side, kind):
    """Beyond the reference: the same facade over SGPR and the iterative
    GP, predicting what the JAX package's functions give at the models'
    init parameters.  Fitted (``optimize=True``), SGPR passes the JAX
    package's own test's checks; the iterative GP's fit (Adam, parity in
    ``tests/test_torch_iterative.py``, seconds per 60 steps here) is held
    to its model's own ``train`` over 5 steps."""
    inp, want = jax_side
    x, y = inp["big_x"], inp["big_y"]

    def make():
        if kind == "sgpr":
            return gt.SGPR(x, y, gt.RBF(), m=24, device="cpu")
        return gt.IterativeGP(x, y, gt.RBF(), num_probes=8, rank=32, block=64, device="cpu")

    sk = gt.SKWrap(make())
    mean, std = sk.fit(x, y).predict(x[:50], return_std=True)
    np.testing.assert_allclose(mean, want[kind][0], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(std, np.sqrt(want[kind][1]), rtol=1e-8, atol=1e-8)
    if kind == "iterative":
        twin = make()
        twin.train(max_iter=5)
        sk = gt.SKWrap(make(), optimize=True, max_iter=5).fit(x, y)
        np.testing.assert_array_equal(sk.model.params.numpy(), twin.params.numpy())
        return
    sk = gt.SKWrap(make(), optimize=True, max_iter=60).fit(x, y)
    mean, std = sk.predict(x[:50], return_std=True)
    assert float(np.sqrt(np.mean((mean - np.sin(2 * x[:50, 0])) ** 2))) < 0.1
    assert np.all(std > 0)
    assert sk.score(x[:50], y[:50]) > 0.8


def test_skwrap_without_sklearn(jax_side, monkeypatch):
    """Where scikit-learn is not installed the wrapper keeps
    ``get_params``, ``set_params`` and ``score`` (R²), equal to
    scikit-learn's."""
    import importlib.util
    import sys

    from pygpr_torch.interop import sklearn as with_sk

    monkeypatch.setitem(sys.modules, "sklearn.base", None)
    spec = importlib.util.spec_from_file_location("_skwrap_alone", with_sk.__file__)
    alone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(alone)
    inp, _ = jax_side
    x, y = inp["sk_x"], inp["sk_y"]
    a, b = alone.SKWrap(_exact(inp, "sk_x", "sk_y")), with_sk.SKWrap(_exact(inp, "sk_x", "sk_y"))
    assert not isinstance(a, with_sk.BaseEstimator)
    assert a.get_params().keys() == b.get_params().keys()
    assert a.set_params(max_iter=7) is a and a.max_iter == 7
    a.fit(x, y), b.fit(x, y)
    yn = y + 0.01 * np.cos(7 * x[:, 0])
    w = np.linspace(0.5, 1.5, len(y))
    np.testing.assert_allclose(a.score(x, yn), b.score(x, yn), rtol=1e-12)
    np.testing.assert_allclose(a.score(x, yn, w), b.score(x, yn, w), rtol=1e-12)


def test_compat_names():
    """The JAX ``compat``'s ``__all__``, every name bound to the port."""
    assert ct.__all__ == cj.__all__
    for name in ct.__all__:
        obj = getattr(ct, name)
        assert obj.__module__.startswith("pygpr_torch."), name
        assert obj.__name__ == getattr(cj, name).__name__, name
    assert ct.Exact_GP is gt.ExactGP and ct.Compose is gt.Sum and ct.SK_WRAP is gt.SKWrap
    assert ct.Nelder_Mead is gt.NelderMead and ct.get_learn_rate is gt.get_learn_rate


def test_compat_reference_session(jax_side, rng):
    """``tests/test_compat.py``'s sessions under the reference's names,
    on the port."""
    from pygpr_torch.compat import (CG, GRBCM, MATERN1, MLE, UNIFORM, Compose, Covar, Exact_GP, Squared_exponential,
                                    White_noise, cluster_samples, euclidean_dist, log_likelihood_batched, sample_gp)

    x = _t(rng.uniform(size=(30, 2)))
    y = torch.sin(-x.sum(-1))
    cov = Compose([Squared_exponential(), White_noise()])
    gp = Exact_GP(x, y, cov)
    ys, _ = gp.predict(x, var="diag")
    np.testing.assert_allclose(ys.numpy(), y.numpy(), atol=1e-4)
    assert isinstance(cov, Covar)
    loss = MLE(gp)
    v, g = loss.loss_and_grad(gp.params.numpy())
    assert np.isfinite(v) and np.isfinite(g).all()
    assert CG is qt.CG

    xl = _t(rng.uniform(size=(3, 30, 2)))
    xg = _t(rng.uniform(size=(30, 2)))
    model = GRBCM(xl, torch.sin(xl.sum(-1)), xg, torch.sin(xg.sum(-1)), cov)
    ys, _ = model.predict(xl[0], var="diag")
    np.testing.assert_allclose(ys.numpy(), torch.sin(xl[0].sum(-1)).numpy(), atol=1e-4)
    assert log_likelihood_batched(cov, model.gpl.params, model.gpl.x, model.gpl.y).shape == (3,)

    xs = UNIFORM(seed=1).sample(20, np.zeros(2), np.ones(2))
    xc = MATERN1(seed=1).sample(5, np.zeros(2), np.ones(2))
    assert xs.shape == (20, 2) and xc.shape == (5, 2)
    assert euclidean_dist(xs, xc).shape == (20, 5)
    assert cluster_samples(xs, np.asarray(xc[:4])).shape == (4, 5, 2)
    f = sample_gp(_t(xs), Squared_exponential(), _t([1.0, 1.0, 1.0]))
    assert f.shape == (20,)

    hp = _t(rng.uniform(size=5))
    xk, xb = _t(rng.uniform(size=(12, 3))), _t(rng.uniform(size=(4, 12, 3)))
    assert cov.get_params_shape(xk) == [5] and cov.get_params_shape(xb) == [4, 5]
    assert cov.kernel(hp, xk).shape == (12, 12)
    assert cov.kernel(hp, xk, _t(rng.uniform(size=(7, 3)))).shape == (7, 12)
    krn, dkrn = cov.kernel_and_grad(hp, xk)
    assert krn.shape == (12, 12) and dkrn.shape == (5, 12, 12)
    var, covars = gp.predict_var(x[:6]), gp.predict_covar(x[:6])
    np.testing.assert_allclose(var.numpy(), np.maximum(np.diagonal(covars.numpy()), 1e-7), rtol=1e-6, atol=1e-9)
