"""Port parity: prior means, the fits over the new kernels, and prediction
with ICM and FixedNoise, against the JAX package on the CPU in f64.

The same NumPy inputs, made from a seed, go through both packages: the
mean functions and their inits, ``nlml_mean``, ``factorize_mean`` with
``predict_mean``, ``predict(var="diag")`` of ICM and FixedNoise (whose
query rows carry their own task index and noise column) at 1e-8, and
``fit_gp_mean`` and ``fit_mle`` at the existing fit parity's tolerances
(parameters rtol 1e-4, NLML rtol 1e-9).  The JAX side runs once, under
one ``jax.jit``, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import means as mt
from pygpr_tpu.models import means as mj


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


MEANS = ("ZeroMean", "ConstantMean", "LinearMean")
COV_J = gj.Sum((gj.RBF(), gj.WhiteNoise()))
#: the new kernels whose factorize + predict(var="diag") are compared
PREDICT_CASES = {
    "icm": gj.Sum((gj.ICM(gj.Matern(2.5), 3, 1), gj.TaskNoise(3))),
    "fixed_noise": gj.FixedNoise(gj.Matern(2.5)),
}
FIT_KERNEL = gj.Sum((gj.Matern(2.5), gj.WhiteNoise()))


def _inputs():
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 2.0, (64, 2))
    y = np.sin(2.0 * x.sum(-1)) + 0.5 * x.sum(-1) + 0.3 + 0.1 * rng.normal(size=64)
    xq = rng.uniform(0.0, 2.0, (20, 2))
    theta = np.r_[1.1, 0.9, 1.2, 0.2]
    # ICM: three tasks, scaled copies of one function
    xi = rng.uniform(0.0, 2.0, (48, 2))
    task = np.arange(48) % 3
    yi = (1.0 + 0.5 * task) * np.sin(2.0 * xi.sum(-1)) + 0.1 * rng.normal(size=48)
    xi = np.concatenate([xi, task[:, None].astype(float)], axis=1)
    xiq = np.concatenate([xq, (np.arange(20) % 3)[:, None].astype(float)], axis=1)
    pi = np.r_[1.0, 0.8, 1.1, 0.9, 1.2, 0.7, 0.5, 0.6, 0.4, 0.1, 0.15, 0.2]
    # FixedNoise: known variances in the last column; the queries' own
    xf = np.concatenate([x, rng.uniform(0.005, 0.05, (64, 1))], axis=1)
    xfq = np.concatenate([xq, rng.uniform(0.0, 0.05, (20, 1))], axis=1)
    pf = np.r_[1.1, 0.9, 1.2]
    return dict(x=x, y=y, xq=xq, theta=theta, xi=xi, yi=yi, xiq=xiq, pi=pi, xf=xf, xfq=xfq, pf=pf)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results for this file from one jitted program:
    per mean its values and init, ``nlml_mean`` and the posterior through
    ``factorize_mean``/``predict_mean``; ICM's and FixedNoise's
    ``predict(var="diag")``; ``fit_gp_mean`` with ``LinearMean`` and
    ``fit_mle`` of ``Sum(Matern(2.5), WhiteNoise)``."""
    inp = _inputs()

    def run(c):
        out = {}
        for name in MEANS:
            mean = getattr(mj, name)()
            pm = mean.init_params(c["x"], c["y"])
            theta = jnp.concatenate([c["theta"], pm + 0.1])
            state = mj.factorize_mean(COV_J, mean, theta, c["x"], c["y"])
            out[name] = {"init": pm, "init_no_y": mean.init_params(c["x"]), "value": mean(pm + 0.1, c["xq"]),
                         "nlml": mj.nlml_mean(COV_J, mean, theta, c["x"], c["y"]),
                         "predict": mj.predict_mean(COV_J, mean, theta, state, c["xq"], "diag"),
                         "predict_full": mj.predict_mean(COV_J, mean, theta, state, c["xq"], "full")}
        for name, kern, x, y, xq, p in (("icm", PREDICT_CASES["icm"], c["xi"], c["yi"], c["xiq"], c["pi"]),
                                        ("fixed_noise", PREDICT_CASES["fixed_noise"], c["xf"], c["y"], c["xfq"], c["pf"])):
            out[name] = gj.predict(kern, gj.factorize(kern, p, x, y), xq, var="diag")
        out["fit_gp_mean"] = mj.fit_gp_mean(COV_J, mj.LinearMean(), c["x"], c["y"])
        p0 = FIT_KERNEL.init_params(c["x"]).at[-1].set(0.1)
        out["fit_mle"] = gj.fit_mle(FIT_KERNEL, p0, c["x"], c["y"])
        return out

    want = jax.jit(run)({k: jnp.asarray(v) for k, v in inp.items()})
    return inp, jax.tree_util.tree_map(np.asarray, want)


def test_specs_and_names():
    """Each mean is carried by name; the kernels here by their spec."""
    for name in MEANS:
        assert type(convert.mean_from_spec(name)) is getattr(mt, name)
        assert type(convert.mean_from_spec((name, {}))) is getattr(mt, name)
    with pytest.raises(ValueError):
        convert.mean_from_spec("QuadraticMean")
    assert gt.fit_gp_mean is mt.fit_gp_mean and gt.LinearMean is mt.LinearMean


@pytest.mark.parametrize("name", MEANS)
def test_mean_functions_match_jax(jax_side, name):
    inp, want = jax_side
    w = want[name]
    mean = convert.mean_from_spec(name)
    x, y = _t(inp["x"]), _t(inp["y"])
    pm = mean.init_params(x, y)
    assert mean.n_params(2) == len(w["init"])
    np.testing.assert_allclose(pm.numpy(), w["init"], rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(mean.init_params(x).numpy(), w["init_no_y"])
    np.testing.assert_allclose(mean(_t(w["init"] + 0.1), _t(inp["xq"])).numpy(), w["value"], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", MEANS)
def test_nlml_and_predict_mean_match_jax(jax_side, name):
    inp, want = jax_side
    w = want[name]
    mean = convert.mean_from_spec(name)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    theta = _t(np.concatenate([inp["theta"], w["init"] + 0.1]))
    x, y = _t(inp["x"]), _t(inp["y"])
    np.testing.assert_allclose(mt.nlml_mean(cov, mean, theta, x, y).item(), w["nlml"], rtol=1e-8)
    state = mt.factorize_mean(cov, mean, theta, x, y)
    for var, key in (("diag", "predict"), ("full", "predict_full")):
        mu, c = mt.predict_mean(cov, mean, theta, state, _t(inp["xq"]), var)
        np.testing.assert_allclose(mu.numpy(), w[key][0], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(c.numpy(), w[key][1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", list(PREDICT_CASES))
def test_icm_and_fixed_noise_predict_match_jax(jax_side, name):
    """The port's factorize and predict pass the query rows' own task
    index and noise column to the kernel's diag."""
    inp, want = jax_side
    kern = convert.kernel_from_spec(convert.kernel_spec(PREDICT_CASES[name]))
    x, y, xq, p = ((inp["xi"], inp["yi"], inp["xiq"], inp["pi"]) if name == "icm"
                   else (inp["xf"], inp["y"], inp["xfq"], inp["pf"]))
    mean, var = gt.predict(kern, gt.factorize(kern, _t(p), _t(x), _t(y)), _t(xq), var="diag")
    np.testing.assert_allclose(mean.numpy(), want[name][0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), want[name][1], rtol=1e-8, atol=1e-10)


def test_fit_gp_mean_matches_jax(jax_side):
    """Kernel parameters in log space, mean parameters raw, from the
    joint init (noise 1e-4, the least-squares trend); the port's
    gradient is the fast closed form, the JAX package's autodiff
    through the Cholesky: the same optimum."""
    inp, want = jax_side
    w = want["fit_gp_mean"]
    res = mt.fit_gp_mean(gt.Sum((gt.RBF(), gt.WhiteNoise())), mt.LinearMean(), _t(inp["x"]), _t(inp["y"]))
    assert bool(res.converged) == bool(w.converged)
    np.testing.assert_allclose(res.params.numpy(), w.params, rtol=1e-4)
    np.testing.assert_allclose(res.value.item(), w.value, rtol=1e-9)


def test_fit_mle_new_kernel_matches_jax(jax_side):
    inp, want = jax_side
    w = want["fit_mle"]
    kern = convert.kernel_from_spec(convert.kernel_spec(FIT_KERNEL))
    p0 = kern.init_params(_t(inp["x"]))
    p0[-1] = 0.1
    res = gt.fit_mle(kern, p0, _t(inp["x"]), _t(inp["y"]))
    assert bool(res.converged) and bool(w.converged)
    assert res.iters.item() == int(w.iters)
    np.testing.assert_allclose(res.params.numpy(), w.params, rtol=1e-4)
    np.testing.assert_allclose(res.value.item(), w.value, rtol=1e-9)


def test_with_noise_and_tasks_match_jax():
    rng = np.random.default_rng(12)
    x = rng.uniform(size=(6, 2))
    from pygpr_tpu.ops import coregion as cj
    from pygpr_tpu.ops import fixed_noise as fj

    np.testing.assert_array_equal(gt.with_noise(x, 0.01), fj.with_noise(x, 0.01))
    np.testing.assert_array_equal(gt.with_noise(x, np.arange(6.0)), fj.with_noise(x, np.arange(6.0)))
    np.testing.assert_array_equal(gt.with_task(x, 2), np.asarray(cj.with_task(x, 2)))
    np.testing.assert_array_equal(gt.with_task(_t(x), 2).numpy(), np.asarray(cj.with_task(x, 2)))
    xs, ys = [x, x[:3] + 1.0], [np.ones(6), np.zeros(3)]
    for a, b in zip(gt.stack_outputs(xs, ys), cj.stack_outputs(xs, ys)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        gt.FixedNoise(gt.FixedNoise(gt.RBF()))
    with pytest.raises(ValueError):
        gt.ICM(gt.ICM(gt.RBF(), 2), 2)
