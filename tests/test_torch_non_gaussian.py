"""Port parity: the observation likelihoods (``models/obs.py``), elliptical
slice sampling (``sample/ess.py``), the Laplace approximation
(``models/laplace.py``) and EP (``models/ep.py``) against the JAX package.

The same NumPy inputs go to both packages in f64; the JAX side runs once,
under one ``jax.jit``, in a module fixture.  The deterministic pieces
agree to 1e-8 relative (elementwise, or to the largest entry of a vector
for an entry near zero): the likelihoods' terms, Gauss-Hermite, Laplace's
mode, evidence, gradient (autograd through the unrolled Newton steps and
the double derivative of ``log_lik``, against the JAX package's own
gradient) and prediction, and EP's posterior, evidence, gradient and
prediction.  The Laplace fit runs 5 L-BFGS iterations in both packages and
they agree to 1e-6 (a line search magnifies round-off in its tests).
ESS is held transition for transition: the test reproduces the JAX
package's key schedule of ``sample_latent`` (``split(key, T)``, then
``k_nu, k_u, k_theta, k_loop = split(k, 4)``, each shrink
``k, k_th = split(k)``) and feeds those draws to the port's ``_ess_step``.
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
from pygpr_torch.models import ep as et
from pygpr_torch.models import laplace as lt
from pygpr_torch.models import obs as ot
from pygpr_torch.sample import ess as st
from pygpr_tpu.models import ep as ej
from pygpr_tpu.models import laplace as lj
from pygpr_tpu.models import obs as oj
from pygpr_tpu.sample import ess as sj

N, D = 40, 2
RTOL = 1e-8
FIT_ITERS = 5
FIT_RTOL = 1e-6
ESS_WARMUP, ESS_SAMPLES, ESS_N = 10, 20, 30
#: shrink draws reproduced per ESS transition (the loop takes a few)
MAX_SHRINKS = 40
LIKS = {"GaussianLik": {}, "BernoulliLogit": {}, "BernoulliProbit": {}, "StudentTLik": {"nu": 4.0},
        "PoissonLik": {}}


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
        x=x, xq=rng.uniform(0.0, 3.0, (9, D)),
        y_bin=(f + 0.3 * rng.normal(size=N) > 0).astype(np.float64),
        y_cnt=rng.poisson(np.exp(f)).astype(np.float64),
        y_reg=f + 0.2 * rng.normal(size=N) + np.where(rng.uniform(size=N) < 0.1, 3.0, 0.0),
        mu=rng.normal(size=N), var=rng.uniform(0.05, 2.0, N),
        params=np.array([1.3, 0.8, 1.1]), lp1=np.array([np.log(0.4)]), lp0=np.zeros(0),
        x_ess=rng.uniform(0.0, 3.0, (ESS_N, 1)),
    )


def _y(inp, name):
    return inp["y_bin"] if name.startswith("Bernoulli") else inp["y_cnt"] if name == "PoissonLik" else inp["y_reg"]


def _lp(inp, name):
    return inp["lp1"] if name in ("GaussianLik", "StudentTLik") else inp["lp0"]


#: the Laplace cases: likelihood by name
LAPLACE = ("BernoulliLogit", "PoissonLik", "StudentTLik")
#: the EP cases: probit (closed-form tilted moments), logit (Gauss-Hermite
#: fallback); the Gaussian's is the exact GP (test_ep_gaussian_is_the_exact_gp)
EP = ("BernoulliProbit", "BernoulliLogit")


def _ess_draws(key, n):
    """Per transition: the normal z [n], the uniforms u and θ, and
    MAX_SHRINKS shrink uniforms, by the JAX package's key schedule."""
    keys = jax.random.split(key, ESS_WARMUP + ESS_SAMPLES)

    def one(k):
        k_nu, k_u, k_theta, k_loop = jax.random.split(k, 4)
        z = jax.random.normal(k_nu, (n,), jnp.float64)
        u = jax.random.uniform(k_u, dtype=jnp.float64)
        th = jax.random.uniform(k_theta, dtype=jnp.float64, minval=0.0, maxval=2.0 * math.pi)

        def body(k, _):
            k, k_th = jax.random.split(k)
            return k, jax.random.uniform(k_th, dtype=jnp.float64)

        _, shrinks = jax.lax.scan(body, k_loop, None, length=MAX_SHRINKS)
        return z, u, th, shrinks

    return jax.vmap(one)(keys)


@pytest.fixture(scope="module")
def parity():
    inp = _inputs()
    liks = {name: getattr(oj, name)(**a) for name, a in LIKS.items()}
    rbf = gj.RBF()

    def run(a):
        out = {}
        for name, lik in liks.items():
            y, lp = _y(a, name), _lp(a, name)
            out[f"ell_{name}"] = lik.expected_log_lik(lp, y, a["mu"], a["var"])
            out[f"ll_{name}"] = lik.log_lik(lp, y, a["mu"])
            out[f"pred_{name}"] = lik.predict(lp, a["mu"], a["var"])
            if hasattr(lik, "tilted_moments"):
                out[f"tilted_{name}"] = lik.tilted_moments(lp, y, a["mu"], a["var"])
            out[f"gh_tilted_{name}"] = ej._tilted_moments(type("NoClosedForm", (), {"log_lik": lik.log_lik})(),
                                                          lp, y, a["mu"], a["var"])
        out["gh"] = oj.gauss_hermite(jnp.cos, a["mu"], a["var"])
        for name in LAPLACE:
            lik, y, lp = liks[name], _y(a, name), _lp(a, name)
            out[f"laplace_{name}"] = lj.posterior_mode(rbf, a["params"], lik, lp, a["x"], y)._asdict()
            out[f"laplace_{name}_grad"] = jax.grad(lambda p, l: lj.nlml(rbf, p, lik, l, a["x"], y),
                                                   argnums=(0, 1))(a["params"], lp)
            st_ = lj.posterior_mode(rbf, a["params"], lik, lp, a["x"], y)
            out[f"laplace_{name}_pred_f"] = lj.predict(rbf, st_, a["xq"], space="latent")
            out[f"laplace_{name}_pred_y"] = lj.predict(rbf, st_, a["xq"], lik)
        for name in EP:
            lik, y, lp = liks[name], _y(a, name), _lp(a, name)
            s = ej.posterior_ep(rbf, a["params"], lik, lp, a["x"], y)
            out[f"ep_{name}"] = s._asdict()
            out[f"ep_{name}_grad"] = jax.grad(lambda p, l: ej.nlml(rbf, p, lik, l, a["x"], y),
                                              argnums=(0, 1))(a["params"], lp)
            out[f"ep_{name}_pred_f"] = ej.predict(rbf, s, a["xq"], space="latent")
            out[f"ep_{name}_pred_y"] = ej.predict(rbf, s, a["xq"], lik)
        r = lj.fit(rbf, liks["BernoulliLogit"], a["x"], a["y_bin"], max_iter=FIT_ITERS)
        out["laplace_fit"] = (r.params, r.lik_params, r.nlml)
        # ESS on a logit model with the draws behind it
        key = jax.random.PRNGKey(3)
        y_ess = (jnp.sin(2.0 * a["x_ess"][:, 0]) > 0).astype(jnp.float64)
        res = sj.sample_latent(rbf, a["params"][:2], liks["BernoulliLogit"], a["lp0"], a["x_ess"], y_ess, key,
                               n_samples=ESS_SAMPLES, n_warmup=ESS_WARMUP)
        out["ess"] = res._asdict()
        out["ess_draws"] = _ess_draws(key, ESS_N)
        out["ess_mix"] = sj.predictive_latent_mixture(rbf, a["params"][:2], a["x_ess"], res, a["xq"][:, :1])
        return out

    want = jax.tree.map(np.asarray, jax.jit(run)({k: jnp.asarray(v) for k, v in inp.items()}))
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


def _lik(name):
    return convert.likelihood_from_name(name, **LIKS[name])


@pytest.mark.parametrize("name", list(LIKS))
def test_likelihood_terms(parity, name):
    inp, want = parity
    lik, y, lp = _lik(name), T(_y(inp, name)), T(_lp(inp, name))
    mu, var = T(inp["mu"]), T(inp["var"])
    close(lik.expected_log_lik(lp, y, mu, var), want[f"ell_{name}"])
    close(lik.log_lik(lp, y, mu), want[f"ll_{name}"])
    for g, w in zip(lik.predict(lp, mu, var), want[f"pred_{name}"]):
        close(g, w)
    if hasattr(lik, "tilted_moments"):
        for g, w in zip(lik.tilted_moments(lp, y, mu, var), want[f"tilted_{name}"]):
            close(g, w)
    no_closed_form = type("NoClosedForm", (), {"log_lik": lik.log_lik})()
    for g, w in zip(et._tilted_moments(no_closed_form, lp, y, mu, var), want[f"gh_tilted_{name}"]):
        close(g, w)
    assert lik.init_params(torch.float64).shape == (lik.n_params,)


def test_gauss_hermite(parity):
    inp, want = parity
    close(ot.gauss_hermite(torch.cos, T(inp["mu"]), T(inp["var"])), want["gh"])


def test_softplus_is_jax_softplus_beyond_20():
    t = torch.tensor([-40.0, 0.0, 19.0, 21.0, 40.0], dtype=torch.float64)
    close(ot.softplus(t), jax.nn.softplus(jnp.asarray(t.numpy())), rtol=1e-15)


@pytest.mark.parametrize("name", LAPLACE)
def test_laplace_mode_evidence_grad_predict(parity, name):
    inp, want = parity
    lik, y = _lik(name), T(_y(inp, name))
    p, lp = T(inp["params"]).requires_grad_(True), T(_lp(inp, name)).requires_grad_(True)
    s = lt.posterior_mode(gt.RBF(), p, lik, lp, T(inp["x"]), y)
    ref = want[f"laplace_{name}"]
    for f in ("f_hat", "a", "grad_ll", "w_sqrt", "chol_b", "nlml", "ok"):
        close(getattr(s, f), ref[f])
    gp_, glp = torch.autograd.grad(s.nlml, (p, lp), allow_unused=True)
    close(gp_, want[f"laplace_{name}_grad"][0])
    if lp.numel():
        close(glp, want[f"laplace_{name}_grad"][1])
    with torch.no_grad():
        sd = convert.laplace_state_from_numpy(ref, "cpu")
        for space, key in (("latent", "pred_f"), ("observation", "pred_y")):
            for g, w in zip(lt.predict(gt.RBF(), sd, T(inp["xq"]), lik, space=space), want[f"laplace_{name}_{key}"]):
                close(g, w)


@pytest.mark.parametrize("name", EP)
def test_ep_posterior_evidence_grad_predict(parity, name):
    inp, want = parity
    lik, y = _lik(name), T(_y(inp, name))
    p, lp = T(inp["params"]).requires_grad_(True), T(_lp(inp, name)).requires_grad_(True)
    s = et.posterior_ep(gt.RBF(), p, lik, lp, T(inp["x"]), y)
    ref = want[f"ep_{name}"]
    for f in ("tau", "nu", "mu", "sigma2", "w_pred", "w_sqrt", "chol_b", "nlml", "ok"):
        close(getattr(s, f), ref[f])
    close(s.delta, ref["delta"], atol=1e-12)
    gp_, glp = torch.autograd.grad(s.nlml, (p, lp), allow_unused=True)
    close(gp_, want[f"ep_{name}_grad"][0])
    if lp.numel():
        close(glp, want[f"ep_{name}_grad"][1])
    with torch.no_grad():
        sd = convert.ep_state_from_numpy(ref, "cpu")
        for space, key in (("latent", "pred_f"), ("observation", "pred_y")):
            for g, w in zip(et.predict(gt.RBF(), sd, T(inp["xq"]), lik, space=space), want[f"ep_{name}_{key}"]):
                close(g, w)


def test_laplace_fit_and_wrapper(parity):
    inp, want = parity
    model = gt.LaplaceGP(inp["x"], inp["y_bin"], gt.RBF(), gt.BernoulliLogit(), device="cpu")
    res = model.train(max_iter=FIT_ITERS)
    p, lp, v = want["laplace_fit"]
    close(res.params, p, rtol=FIT_RTOL)
    close(res.nlml, v, rtol=FIT_RTOL)
    assert res.lik_params.shape == lp.shape
    prob, pvar = model.predict(inp["xq"])
    assert ((prob > 0) & (prob < 1)).all() and torch.allclose(pvar, prob * (1 - prob))


def test_ep_fit_and_wrapper(parity):
    """The EP fit (the same L-BFGS as the Laplace fit above, on the
    evidence held to the JAX package's above; the JAX fit's compile would
    cost 5 s): the evidence falls and the result's evidence is the
    posterior's at the fitted parameters."""
    inp, _ = parity
    model = gt.EPGP(inp["x"], inp["y_bin"], gt.RBF(), gt.BernoulliProbit(), device="cpu")
    start = et.nlml(gt.RBF(), model.params, model.lik, model.lik_params, model.x, model.y)
    res = model.train(max_iter=FIT_ITERS)
    assert float(res.nlml) < float(start)
    again = et.nlml(gt.RBF(), res.params, model.lik, res.lik_params, model.x, model.y)
    close(res.nlml, again.item(), rtol=1e-12)
    mu, var = model.predict(inp["xq"], space="latent")
    assert torch.isfinite(mu).all() and (var > 0).all()


def test_ep_gaussian_is_the_exact_gp(parity):
    """With ``GaussianLik`` EP's evidence is the exact NLML of
    ``Sum(RBF, WhiteNoise)`` (the JAX test's anchor)."""
    inp, want = parity
    sn = math.exp(inp["lp1"][0])
    exact = gt.nlml(gt.Sum((gt.RBF(), gt.WhiteNoise())), T(np.r_[inp["params"][:2], sn]), T(inp["x"][:, :1]),
                    T(inp["y_reg"]))
    s = et.posterior_ep(gt.RBF(), T(inp["params"][:2]), _lik("GaussianLik"), T(inp["lp1"]), T(inp["x"][:, :1]),
                        T(inp["y_reg"]))
    close(s.nlml, exact.item(), rtol=1e-6)


def test_ess_trajectory(parity):
    """``_ess_step`` from the JAX package's draws: every post-warmup state
    and its log-likelihood."""
    inp, want = parity
    z, u, th, shrinks = (T(a) for a in want["ess_draws"])
    x, params = T(inp["x_ess"]), T(inp["params"][:2])
    y = (torch.sin(2.0 * x[:, 0]) > 0).to(torch.float64)
    lik = gt.BernoulliLogit()
    chol = gt.safe_cholesky(gt.RBF().matrix(params, x)).chol

    def log_l(f):
        return torch.sum(lik.log_lik(T(inp["lp0"]), y, f))

    f = torch.zeros(ESS_N, dtype=torch.float64)
    ll = log_l(f)
    states, lls = [], []
    for t in range(ESS_WARMUP + ESS_SAMPLES):
        it = iter(shrinks[t])
        f, ll = st._ess_step(log_l, chol, f, ll, z[t], u[t], th[t], lambda: next(it))
        states.append(f)
        lls.append(ll)
    close(torch.stack(states[ESS_WARMUP:]), want["ess"]["samples"])
    close(torch.stack(lls[ESS_WARMUP:]), want["ess"]["log_lik"])


def test_ess_predictive_latent_mixture(parity):
    inp, want = parity
    res = st.ESSResult(samples=T(want["ess"]["samples"]), log_lik=T(want["ess"]["log_lik"]))
    mean, var = st.predictive_latent_mixture(gt.RBF(), T(inp["params"][:2]), T(inp["x_ess"]), res,
                                             T(inp["xq"][:, :1]))
    close(mean, want["ess_mix"][0])
    close(var, want["ess_mix"][1])


def test_sample_latent_on_generator():
    """``sample_latent`` from a ``torch.Generator``: the JAX test's Gaussian
    check at a short run (the ESS draws' mean near the exact posterior
    mean), the same draws from the same seed, thinning."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.uniform(0, 3, (20, 1)))
    y = torch.sin(2.0 * x[:, 0]) + 0.3 * torch.tensor(rng.normal(size=20))
    lik, lp = gt.GaussianLik(), torch.tensor([math.log(0.3)], dtype=torch.float64)
    params = torch.tensor([1.0, 1.0], dtype=torch.float64)
    kw = dict(n_samples=300, n_warmup=100, thin=2)
    a = gt.sample_latent(gt.RBF(), params, lik, lp, x, y, torch.Generator().manual_seed(0), **kw)
    b = gt.sample_latent(gt.RBF(), params, lik, lp, x, y, torch.Generator().manual_seed(0), **kw)
    assert a.samples.shape == (300, 20) and torch.equal(a.samples, b.samples)
    K = gt.RBF().matrix(params, x)
    exact = K @ torch.linalg.solve(K + 0.09 * torch.eye(20, dtype=torch.float64), y)
    assert float(torch.max(torch.abs(a.samples.mean(0) - exact))) < 0.15


def fit_counts(n=2048, bits=32, iters=30, packages=("jax", "torch")):
    """Objective evaluations a L-BFGS iteration of ``chip_smoke.py``'s
    Laplace (logit) and EP (probit) fits, on its data cut to the first
    ``n`` points, in the JAX package and in the port on this CPU, in f32
    or f64: whether the count is the reference's."""
    import time

    import chip_smoke
    from pygpr_torch.bench import _large_n_target
    from pygpr_torch.optimize.lbfgs import minimize_lbfgs as lbfgs_t
    from pygpr_tpu.optimize.lbfgs import minimize_lbfgs as lbfgs_j

    xn = chip_smoke.ng_data()[1][:n]
    lab = (_large_n_target(xn) > 0).astype(np.float64)
    for name, mod_j, mod_t, lik in (("laplace", lj, lt, "BernoulliLogit"), ("ep", ej, et, "BernoulliProbit")):
        for pkg in packages:
            count = [0]
            t0 = time.perf_counter()
            if pkg == "jax":
                d = jnp.float32 if bits == 32 else jnp.float64
                x, y = jnp.asarray(xn, d), jnp.asarray(lab, d)
                kern, lk = gj.RBF(), getattr(gj, lik)()
                p0, lp0 = kern.init_params(x), lk.init_params(d)
                nk = p0.shape[0]

                def obj(u):
                    jax.debug.callback(lambda: count.__setitem__(0, count[0] + 1))
                    return mod_j.nlml(kern, jnp.exp(u[:nk]), lk, u[nk:], x, y)

                u0 = jnp.concatenate([jnp.log(jnp.abs(p0)), lp0])
                res = jax.jit(lambda u: lbfgs_j(obj, u, max_iter=iters))(u0)
                res = jax.block_until_ready(res)
            else:
                d = torch.float32 if bits == 32 else torch.float64
                x, y = torch.tensor(xn, dtype=d), torch.tensor(lab, dtype=d)
                kern, lk = gt.RBF(), getattr(gt, lik)()
                p0, lp0 = kern.init_params(x), lk.init_params(d, x.device)
                nk = p0.shape[0]

                def obj(u):
                    count[0] += 1
                    return mod_t.nlml(kern, torch.exp(u[:nk]), lk, u[nk:], x, y)

                res = lbfgs_t(obj, torch.cat([torch.log(torch.abs(p0)), lp0]), max_iter=iters)
            it = int(res.iters)
            print({"model": name, "package": pkg, "bits": bits, "n": n, "iters": it, "evaluations": count[0],
                   "per_iteration": count[0] / max(it, 1), "value": float(res.value),
                   "grad_norm": float(res.grad_norm), "seconds": time.perf_counter() - t0}, flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_non_gaussian.py [n] [32|64] [jax|torch]
    #   fit_counts: the evaluations of the Laplace and EP fits (both
    #   packages by default)
    import sys

    # the JAX package's f32 run as its users run it: x64 off
    jax.config.update("jax_enable_x64", sys.argv[2:3] != ["32"])
    torch.set_num_threads(1)
    fit_counts(*[int(a) for a in sys.argv[1:3]], packages=sys.argv[3:4] or ("jax", "torch"))
