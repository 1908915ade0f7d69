"""Port parity: SVGP (``models/svgp.py``), random Fourier features and
pathwise draws (``models/rff.py``) and the deep GP (``models/deepgp.py``)
against the JAX package.

The same NumPy inputs go to both packages in f64, with the same
host-drawn minibatch schedules, spectral bases, path noise and
reparameterization noise (the JAX package draws all of them with NumPy
from a seed, and so does the port).  The JAX side runs once, under one
``jax.jit``, in a module fixture; its streamed SVGP fit jits its own step.
Values, gradients, predictions and Adam trajectories agree to 1e-8
relative (elementwise, or to the largest entry for an entry near zero);
the RFF L-BFGS fit runs 5 iterations in both and agrees to 1e-6.  The
SVGP bound at its Gaussian optimum equals the port's collapsed SGPR bound
to the JAX test's 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import deepgp as dt
from pygpr_torch.models import exact_gp as xt
from pygpr_torch.models import rff as rt
from pygpr_torch.models import sgpr as sgt
from pygpr_torch.models import svgp as vt
from pygpr_tpu.models import deepgp as dj
from pygpr_tpu.models import exact_gp as xj
from pygpr_tpu.models import obs as oj
from pygpr_tpu.models import rff as rj
from pygpr_tpu.models import svgp as vj

N, D, M = 48, 2, 8
BATCH, STEPS = 16, 6
RTOL = 1e-8
FIT_RTOL = 1e-6
N_FEAT = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 3.0, (N, D))
    f = np.sin(2.0 * x.sum(-1))
    return dict(
        x=x, xq=rng.uniform(0.0, 3.0, (7, D)),
        y_reg=f + 0.2 * rng.normal(size=N),
        y_bin=(f + 0.3 * rng.normal(size=N) > 0).astype(np.float64),
        z=x[rng.permutation(N)[:M]] + 0.05 * rng.normal(size=(M, D)),
        log_theta=np.log([1.2, 0.9, 1.1]), lik=np.array([math.log(0.3)]),
        m_w=0.3 * rng.normal(size=M), ls_raw=np.tril(0.2 * rng.normal(size=(M, M))),
        rff_params=np.array([1.1, 0.8, 1.2, 0.25]),
        weights_z=rng.normal(size=(3, N_FEAT)),
    )


def _vp(a, lik, mod):
    return mod.SVGPParams(log_theta=a["log_theta"], lik=lik, z=a["z"], m_w=a["m_w"], ls_raw=a["ls_raw"])


class _Dataset:
    """The streamed fit's dataset: ``.n``, ``.x`` and seeded shuffled full
    batches, in NumPy (the same batches for both packages)."""

    def __init__(self, x, y):
        self.x, self.y, self.n = x, y, x.shape[0]

    def minibatches(self, batch_size, *, seed=0, epochs=1):
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            perm = rng.permutation(self.n)
            for b in range(self.n // batch_size):
                idx = perm[b * batch_size:(b + 1) * batch_size]
                yield self.x[idx], self.y[idx]


@pytest.fixture(scope="module")
def parity():
    inp = _inputs()
    rbf = gj.RBF()
    basis = rj.make_basis(N_FEAT, D, seed=3, dtype=np.float64)
    noise = rj.make_path_noise(3, N_FEAT, N, seed=4, dtype=np.float64)

    def run(a, basis, noise):
        out = {}
        for name, lik, y in (("gauss", oj.GaussianLik(), a["y_reg"]), ("logit", oj.BernoulliLogit(), a["y_bin"])):
            lp = a["lik"] if name == "gauss" else jnp.zeros(0)
            vp = _vp(a, lp, vj)
            out[f"elbo_{name}"], out[f"elbo_{name}_grad"] = jax.value_and_grad(
                lambda v: vj.neg_elbo(rbf, lik, v, a["x"], y, scale=2.0))(vp)
            out[f"pred_{name}_f"] = vj.predict(rbf, lik, vp, a["xq"], "f")
            out[f"pred_{name}_y"] = vj.predict(rbf, lik, vp, a["xq"], "y")
            fit = vj.fit(rbf, lik, a["x"], y, a["z"], batch_size=BATCH, n_steps=STEPS, seed=2)
            out[f"fit_{name}"] = (fit.params._asdict(), fit.losses)
        vp = _vp(a, a["lik"], vj)
        out["opt_q"] = vj.optimal_q_gaussian(rbf, vp, a["x"], a["y_reg"])._asdict()
        out["kl"] = vj.kl_whitened(vp)
        # RFF
        p = a["rff_params"]
        out["phi"] = rj.feature_map(basis, p[:-1], a["x"])
        out["rff_gram"] = rj.gram(basis, p[:-1], a["x"], a["xq"])
        state = rj.factorize_rff(basis, p, a["x"], a["y_reg"])
        out["rff_state"] = state._asdict()
        out["rff_nlml"], out["rff_grad"] = jax.value_and_grad(lambda q: rj.nlml_rff(basis, q, a["x"], a["y_reg"]))(p)
        for var in ("diag", "full", "none"):
            out[f"rff_pred_{var}"] = rj.predict_rff(basis, state, a["xq"], var)
        out["rff_weights"] = rj.sample_weights(state, a["weights_z"])
        st, pf, v = rj.fit_rff(basis, a["x"], a["y_reg"], max_iter=5)
        out["rff_fit"] = (pf, v, st.theta_hat)
        cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
        gstate = xj.factorize(cov, p, a["x"], a["y_reg"])
        out["paths"] = rj.pathwise_draws(rbf, gstate, basis, noise, a["xq"])
        return out

    def run_dgp(a, params, eps):
        out = {}
        out["dgp_elbo"], out["dgp_grad"] = jax.value_and_grad(
            lambda q: dj.neg_elbo(kerns, oj.GaussianLik(), q, means, a["x"], a["y_reg"], eps, scale=1.5))(params)
        out["dgp_pred"] = dj.predict(kerns, oj.GaussianLik(), params, means, a["xq"], n_samples=4, seed=2)
        out["dgp_pred_f"] = dj.predict(kerns, oj.GaussianLik(), params, means, a["xq"], n_samples=4, seed=2,
                                       space="f")
        return out

    f64 = {k: jnp.asarray(v) for k, v in inp.items()}
    want = jax.tree.map(np.asarray, jax.jit(run)(f64, basis, noise))
    # deep GP: two layers of width 1; its init and fit draw on the host, so
    # they run outside the jitted program (the fit is one scan)
    kerns = (gj.RBF(), gj.RBF())
    params = dj.init_deep(kerns, oj.GaussianLik(), f64["x"], (1,), M, seed=1)
    means = dj.skip_means((1,), D, np.float64)
    eps = jnp.asarray(np.random.default_rng(6).standard_normal((2, 1, N)))
    want["dgp_init"] = jax.tree.map(np.asarray, params)
    want.update(jax.tree.map(np.asarray, jax.jit(run_dgp)(f64, params, eps)))
    fit = dj.fit(kerns, oj.GaussianLik(), f64["x"], f64["y_reg"], widths=(1,), m=M, n_samples=2, batch_size=BATCH,
                 n_steps=STEPS, seed=5)
    want["dgp_fit"] = jax.tree.map(np.asarray, (fit.params, fit.losses))
    ds = _Dataset(inp["x"], inp["y_reg"])
    res = vj.fit_streamed(gj.RBF(), oj.GaussianLik(), ds, jnp.asarray(inp["z"]), batch_size=BATCH, epochs=2,
                          seed=3)
    want["streamed"] = (jax.tree.map(np.asarray, res.params._asdict()), np.asarray(res.losses))
    want["basis"] = jax.tree.map(np.asarray, basis._asdict())
    want["basis_matern"] = jax.tree.map(np.asarray, rj.make_basis(N_FEAT, D, profile="matern", nu=2.5, seed=3,
                                                                  dtype=np.float64)._asdict())
    want["noise"] = jax.tree.map(np.asarray, noise._asdict())
    return inp, want


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=None):
    """Elementwise within ``rtol``, or within ``rtol`` of the largest entry
    (an entry near zero of a vector carries the vector's round-off)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if atol is None:
        atol = rtol * float(np.max(np.abs(want), initial=0.0))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _case(inp, name):
    if name == "gauss":
        return gt.GaussianLik(), T(inp["y_reg"]), T(inp["lik"])
    return gt.BernoulliLogit(), T(inp["y_bin"]), torch.zeros(0, dtype=torch.float64)


@pytest.mark.parametrize("name", ["gauss", "logit"])
def test_svgp_neg_elbo_grad_predict(parity, name):
    inp, want = parity
    lik, y, lp = _case(inp, name)
    vp = vt.SVGPParams(*(t.requires_grad_(True) for t in _vp({k: T(v) for k, v in inp.items()}, lp, vt)))
    v = vt.neg_elbo(gt.RBF(), lik, vp, T(inp["x"]), y, scale=2.0)
    grads = torch.autograd.grad(v, list(vp), allow_unused=True)
    close(v, want[f"elbo_{name}"])
    ref = want[f"elbo_{name}_grad"]
    for f, g in zip(vt.SVGPParams._fields, grads):
        if g is not None:
            close(g, getattr(ref, f))
    with torch.no_grad():
        for space in ("f", "y"):
            for g, w in zip(vt.predict(gt.RBF(), lik, vp, T(inp["xq"]), space), want[f"pred_{name}_{space}"]):
                close(g, w)


@pytest.mark.parametrize("name", ["gauss", "logit"])
def test_svgp_fit(parity, name):
    """Adam over the same host batches: the loss trace and the final state."""
    inp, want = parity
    lik, y, _ = _case(inp, name)
    res = vt.fit(gt.RBF(), lik, T(inp["x"]), y, T(inp["z"]), batch_size=BATCH, n_steps=STEPS, seed=2)
    params, losses = want[f"fit_{name}"]
    close(res.losses, losses)
    for f in vt.SVGPParams._fields:
        close(getattr(res.params, f), params[f])


def test_svgp_fit_streamed(parity):
    inp, want = parity
    ds = _Dataset(inp["x"], inp["y_reg"])
    res = vt.fit_streamed(gt.RBF(), gt.GaussianLik(), ds, inp["z"], batch_size=BATCH, epochs=2, seed=3,
                          device="cpu")
    params, losses = want["streamed"]
    close(res.losses, losses)
    for f in vt.SVGPParams._fields:
        close(getattr(res.params, f), params[f])


def test_svgp_optimal_q_is_the_collapsed_bound(parity):
    """``optimal_q_gaussian`` equals the JAX package's, and at it the SVGP
    bound is the port's own SGPR bound (the JAX test's identity, 1e-5)."""
    inp, want = parity
    vp = _vp({k: T(v) for k, v in inp.items()}, T(inp["lik"]), vt)
    q = vt.optimal_q_gaussian(gt.RBF(), vp, T(inp["x"]), T(inp["y_reg"]))
    for f in ("m_w", "ls_raw"):
        close(getattr(q, f), want["opt_q"][f])
    close(vt.kl_whitened(vp), want["kl"])
    got = vt.neg_elbo(gt.RBF(), gt.GaussianLik(), q, T(inp["x"]), T(inp["y_reg"]))
    p = torch.cat([torch.exp(vp.log_theta), torch.exp(vp.lik)])
    close(got, sgt.neg_elbo(gt.RBF(), p, T(inp["x"]), T(inp["y_reg"]), vp.z).item(), rtol=1e-5)


def test_svgp_wrapper_and_batches():
    """``make_batches`` is the JAX package's draw; the wrapper trains,
    predicts probabilities, and refuses ``batch_sharding``."""
    np.testing.assert_array_equal(vt.make_batches(50, 8, 13, seed=4), vj.make_batches(50, 8, 13, seed=4))
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 3, (40, 1))
    y = (np.sin(2 * x[:, 0]) > 0).astype(np.float64)
    model = gt.SVGP(x, y, gt.RBF(), gt.BernoulliLogit(), m=6, device="cpu")
    res = model.train(n_steps=20, batch_size=10)
    assert res.losses.shape == (20,) and torch.isfinite(res.losses).all()
    p, pv = model.predict(x[:5])
    assert ((p > 0) & (p < 1)).all() and torch.allclose(pv, p * (1 - p))
    assert torch.isfinite(model.neg_elbo())
    with pytest.raises(NotImplementedError):
        vt.fit(gt.RBF(), gt.BernoulliLogit(), T(x), T(y), T(x[:4]), batch_sharding=object())


def test_rff_basis_and_noise_are_the_jax_draws(parity):
    _, want = parity
    b = rt.make_basis(N_FEAT, D, seed=3, dtype=np.float64, device="cpu")
    m = rt.make_basis(N_FEAT, D, profile="matern", nu=2.5, seed=3, dtype=np.float64, device="cpu")
    z = rt.make_path_noise(3, N_FEAT, N, seed=4, dtype=np.float64, device="cpu")
    for got, ref in ((b, want["basis"]), (m, want["basis_matern"]), (z, want["noise"])):
        for f, arr in ref.items():
            np.testing.assert_array_equal(getattr(got, f).numpy(), arr)


def _basis(want):
    return convert.rff_basis_from_numpy(want["basis"], "cpu")


def test_rff_features_factorize_nlml_predict(parity):
    inp, want = parity
    basis, p = _basis(want), T(inp["rff_params"]).requires_grad_(True)
    close(rt.feature_map(basis, p[:-1], T(inp["x"])), want["phi"])
    close(rt.gram(basis, p[:-1], T(inp["x"]), T(inp["xq"])), want["rff_gram"])
    v = rt.nlml_rff(basis, p, T(inp["x"]), T(inp["y_reg"]))
    (g,) = torch.autograd.grad(v, p)
    close(v, want["rff_nlml"])
    close(g, want["rff_grad"])
    with torch.no_grad():
        st = rt.factorize_rff(basis, p, T(inp["x"]), T(inp["y_reg"]))
        for f in ("chol_a", "theta_hat", "jitter", "ok"):
            close(getattr(st, f), want["rff_state"][f])
        for var in ("diag", "full", "none"):
            mean, cov = rt.predict_rff(basis, st, T(inp["xq"]), var)
            close(mean, want[f"rff_pred_{var}"][0])
            assert (cov is None) == (var == "none")
            if cov is not None:
                close(cov, want[f"rff_pred_{var}"][1])
        close(rt.sample_weights(st, T(inp["weights_z"])), want["rff_weights"])


def test_fit_rff(parity):
    inp, want = parity
    st, p, v = gt.fit_rff(_basis(want), inp["x"], inp["y_reg"], max_iter=5, device="cpu")
    pf, vf, th = want["rff_fit"]
    close(p, pf, rtol=FIT_RTOL)
    close(v, vf, rtol=FIT_RTOL)
    close(st.theta_hat, th, rtol=FIT_RTOL)


def test_pathwise_draws(parity):
    inp, want = parity
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    gstate = xt.factorize(cov, T(inp["rff_params"]), T(inp["x"]), T(inp["y_reg"]))
    noise = rt.PathNoise(**{k: T(v) for k, v in want["noise"].items()})
    close(rt.pathwise_draws(gt.RBF(), gstate, _basis(want), noise, T(inp["xq"])), want["paths"])


def _dgp_params(want):
    layers, lik = want["dgp_init"]
    return convert.dgp_params_from_numpy([lp._asdict() if hasattr(lp, "_asdict") else lp for lp in layers], lik,
                                         "cpu")


def test_deepgp_init_bound_grad_predict(parity):
    inp, want = parity
    kerns = (gt.RBF(), gt.RBF())
    init = dt.init_deep(kerns, gt.GaussianLik(), T(inp["x"]), (1,), M, seed=1)
    ref = _dgp_params(want)
    for a, b in zip(dt._flatten(init), dt._flatten(ref)):
        close(a, b.numpy())
    leaves = [t.clone().requires_grad_(True) for t in dt._flatten(ref)]
    params = dt._unflatten(leaves, 2)
    means = dt.skip_means((1,), D, np.float64)
    eps = T(np.random.default_rng(6).standard_normal((2, 1, N)))
    v = dt.neg_elbo(kerns, gt.GaussianLik(), params, means, T(inp["x"]), T(inp["y_reg"]), eps, scale=1.5)
    grads = torch.autograd.grad(v, leaves, allow_unused=True)
    close(v, want["dgp_elbo"])
    gl, glik = want["dgp_grad"]
    ref_grads = [g for lp in gl for g in (lp._asdict().values() if hasattr(lp, "_asdict") else lp)] + [glik]
    for g, w in zip(grads, ref_grads):
        close(torch.zeros_like(leaves[0]) if g is None else g, w)
    with torch.no_grad():
        for space, key in (("y", "dgp_pred"), ("f", "dgp_pred_f")):
            got = dt.predict(kerns, gt.GaussianLik(), params, means, T(inp["xq"]), n_samples=4, seed=2, space=space)
            for g, w in zip(got, want[key]):
                close(g, w)


def test_deepgp_fit(parity):
    inp, want = parity
    model = gt.DeepGP(inp["x"], inp["y_reg"], widths=(1,), m=M, device="cpu")
    model.train(n_samples=2, batch_size=BATCH, n_steps=STEPS, seed=5)
    params, losses = want["dgp_fit"]
    close(model.losses, losses)
    layers, lik = params
    ref = [t for lp in layers for t in (lp._asdict().values() if hasattr(lp, "_asdict") else lp)] + [lik]
    for a, b in zip(dt._flatten(model.params), ref):
        close(a, b)
    mean, var = model.predict(inp["xq"], n_samples=3)
    assert torch.isfinite(mean).all() and (var >= 0).all()


def test_deepgp_depth_one_is_svgp(parity):
    """A depth-1 deep GP has no sampled layer: its bound is SVGP's."""
    inp, _ = parity
    a = {k: T(v) for k, v in inp.items()}
    lp = dt.LayerParams(log_theta=a["log_theta"], z=a["z"], m_w=a["m_w"][None], ls_raw=a["ls_raw"][None])
    params = dt.DGPParams(layers=(lp,), lik=a["lik"])
    eps = torch.zeros((1, 1, N), dtype=torch.float64)
    got = dt.neg_elbo((gt.RBF(),), gt.GaussianLik(), params, (), a["x"], a["y_reg"], eps, scale=1.5)
    want = vt.neg_elbo(gt.RBF(), gt.GaussianLik(), _vp(a, a["lik"], vt), a["x"], a["y_reg"], scale=1.5)
    close(got, want.item(), rtol=1e-12)
