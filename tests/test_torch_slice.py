"""Port parity for the exact-GP slice as a whole: NLML value and
gradient, the L-BFGS fit, factorize and predict, against the JAX package
on the CPU in f64; the f32 path through the plain kernel versions; the
device policy; and the port's independence from JAX."""

import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch.ops import chol_inverse, gram


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parent.parent


def make_data(n, dim, seed):
    """bench.py::make_data in f64."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim))
    y = np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)
    params = np.ones(dim + 2)
    params[-1] = 0.1
    return x, y, params


def _covs():
    return gj.Sum((gj.RBF(), gj.WhiteNoise())), gt.Sum((gt.RBF(), gt.WhiteNoise()))


def _committee(rng, nc=3, n=24, d=2):
    x = rng.uniform(0, 2, size=(nc, n, d))
    y = np.sin(2 * x.sum(-1)) + 0.1 * rng.normal(size=(nc, n))
    p = np.tile([1.0, 1.1, 0.9, 0.2], (nc, 1)) * np.linspace(0.8, 1.2, nc)[:, None]
    return x, y, p


@pytest.fixture(scope="module")
def likelihoods():
    """Per input form, the data and the JAX package's NLML values and
    gradients in every mode, from one compiled program."""
    cj, _ = _covs()
    x, y, p = _committee(np.random.default_rng(0))
    forms = {
        "single": make_data(48, 2, 1),
        "committee": (x, y, p),
        "committee_shared_params": (x, y, p[0]),
    }

    def run(forms):
        out = {}
        for form, (x, y, p) in forms.items():
            out[form] = {
                mode: gj.nlml_value_and_grad(cj, p, x, y, gj.Config(grad_mode=mode)) for mode in ("fast", "ad")
            }
            if form == "committee_shared_params":
                continue
            out[form]["nlml"] = gj.nlml(cj, p, x, y)
            out[form]["analytic"] = gj.nlml_and_grad_analytic(cj, p, x, y)
            out[form]["fast_autodiff"] = jax.grad(lambda r: jnp.sum(gj.nlml_fast(cj, r, x, y)))(p)
        return out

    want = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, forms))
    return forms, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("mode", ["fast", "ad"])
@pytest.mark.parametrize("form", ["single", "committee", "committee_shared_params"])
def test_nlml_value_and_grad_matches_jax(mode, form, likelihoods):
    _, ct = _covs()
    x, y, p = likelihoods[0][form]
    vj, gj_ = likelihoods[1][form][mode]
    vt, gt_ = gt.nlml_value_and_grad(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y), gt.Config(grad_mode=mode))
    np.testing.assert_allclose(vt.numpy(), vj, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(gt_.numpy(), gj_, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("form", ["single", "committee"])
def test_nlml_values_analytic_and_fast_grad_match_jax(form, likelihoods):
    _, ct = _covs()
    x, y, p = likelihoods[0][form]
    want = likelihoods[1][form]
    tx, ty = torch.tensor(x), torch.tensor(y)
    tp = torch.tensor(p, requires_grad=True)
    (g_fast,) = torch.autograd.grad(torch.sum(gt.nlml_fast(ct, tp, tx, ty)), tp)
    tp = tp.detach()
    np.testing.assert_allclose(gt.nlml(ct, tp, tx, ty).numpy(), want["nlml"], rtol=1e-8)
    np.testing.assert_allclose(gt.log_likelihood_batched(ct, tp, tx, ty).numpy(), want["nlml"], rtol=1e-8)
    for a, b in zip(gt.nlml_and_grad_analytic(ct, tp, tx, ty), want["analytic"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(g_fast.numpy(), want["fast_autodiff"], rtol=1e-8, atol=1e-8)


def test_mle_wrapper_matches_jax():
    cj, ct = _covs()
    x, y, p = make_data(32, 2, 4)

    class Model:
        pass

    mj, mt = Model(), Model()
    mj.cov, mj.x, mj.y = cj, jnp.asarray(x), jnp.asarray(y)
    mt.cov, mt.x, mt.y = ct, torch.tensor(x), torch.tensor(y)
    lj, lt = gj.MLE(mj), gt.MLE(mt)
    vj, g_j = lj.loss_and_grad(p)
    vt, g_t = lt.loss_and_grad(p)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(lt.loss(p), lj.loss(p), rtol=1e-10)
    np.testing.assert_allclose(lt.grad(p), g_j, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("init", ["make_data", "reference"])
def test_fit_mle_matches_jax(init):
    """The port's L-BFGS is optax's, step for step: the same number of
    iterations and the same optimum (params rtol 1e-4, NLML rtol 1e-9),
    also from the reference's init (noise 1e-4), where a different line
    search can end in another basin."""
    cj, ct = _covs()
    x, y, p = make_data(128, 2, 3 if init == "make_data" else 0)
    if init == "reference":
        # torch.optim.LBFGS(line_search_fn="strong_wolfe") ends in NaN here
        p = np.asarray(cj.init_params(jnp.asarray(x)))
    rj = gj.fit_mle(cj, jnp.asarray(p), jnp.asarray(x), jnp.asarray(y))
    rt = gt.fit_mle(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y))
    assert bool(rj.converged) and bool(rt.converged)
    assert rt.iters.item() == int(rj.iters)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), rtol=1e-4)
    np.testing.assert_allclose(rt.value.item(), float(rj.value), rtol=1e-9)
    assert rt.grad_norm.item() < 1e-4


def test_fit_map_matches_jax():
    from pygpr_tpu.models import priors as pj

    cj, ct = _covs()
    x, y, p = make_data(40, 1, 5)
    prj = [pj.Gamma(2.0, 1.0), pj.LogNormal(0.0, 1.0), pj.HalfNormal(0.5)]
    prt = [gt.priors.Gamma(2.0, 1.0), gt.priors.LogNormal(0.0, 1.0), gt.priors.HalfNormal(0.5)]
    rj = gj.fit_map(cj, jnp.asarray(p), jnp.asarray(x), jnp.asarray(y), prj, tol=1e-6)
    rt = gt.fit_map(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y), prt, tol=1e-6)
    np.testing.assert_allclose(rt.params.numpy(), np.asarray(rj.params), rtol=1e-4)
    np.testing.assert_allclose(rt.value.item(), float(rj.value), rtol=1e-9)
    theta = torch.tensor(p)
    np.testing.assert_allclose(
        gt.priors.log_prior(prt, theta).item(), float(pj.log_prior(prj, jnp.asarray(p))), rtol=1e-12)


def test_fit_mle_committee_equals_stacked(rng):
    _, ct = _covs()
    x, y, p = _committee(rng, nc=2, n=20)
    tx, ty, tp = torch.tensor(x), torch.tensor(y), torch.tensor(p)
    rb = gt.fit_mle(ct, tp, tx, ty, max_iter=50)
    for i in range(2):
        ri = gt.fit_mle(ct, tp[i], tx[i], ty[i], max_iter=50)
        np.testing.assert_allclose(rb.params[i].numpy(), ri.params.numpy(), rtol=1e-12)
        assert rb.iters[i] == ri.iters


@pytest.fixture(scope="module")
def served():
    """Data, a JAX state with and without T = L⁻¹, and the JAX package's
    predictions in every mode, from one compiled program."""
    cj, _ = _covs()
    x, y, _ = make_data(60, 2, 6)
    p = np.array([1.2, 0.9, 1.1, 0.15])
    xs = np.random.default_rng(6).uniform(0, 2, size=(15, 2))

    def run(p, x, y, xs):
        s0 = gj.factorize(cj, p, x, y)
        s1 = gj.precompute_tinv(s0)
        preds = {(var, t): gj.predict(cj, s, xs, var) for var in ("full", "diag", "none") for t, s in ((False, s0), (True, s1))}
        return s1, preds

    state, preds = jax.jit(run)(*(jnp.asarray(a) for a in (p, x, y, xs)))
    return (x, y, p, xs), state, preds


@pytest.mark.parametrize("var", ["full", "diag", "none"])
@pytest.mark.parametrize("tinv", [False, True])
def test_factorize_predict_matches_jax(var, tinv, served):
    (x, y, p, xs), sj, preds = served
    _, ct = _covs()
    st = gt.factorize(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y))
    if tinv:
        st = gt.precompute_tinv(st)
        np.testing.assert_allclose(st.tinv.numpy(), np.asarray(sj.tinv), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(st.chol.numpy(), np.asarray(sj.chol), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(st.weights.numpy(), np.asarray(sj.weights), rtol=1e-8, atol=1e-8)
    mj, vj = preds[(var, tinv)]
    mt, vt = gt.predict(ct, st, xs, var)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-8, atol=1e-8)
    if var == "none":
        assert vt is None and vj is None
    else:
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8, atol=1e-8)


def test_committee_factorize_predict_matches_jax(rng):
    cj, ct = _covs()
    x, y, p = _committee(rng)
    xs = rng.uniform(0, 2, size=(7, 2))

    def run(p, x, y, xs):
        s = gj.precompute_tinv(gj.factorize(cj, p, x, y))
        return [gj.predict(cj, s, xs, var) for var in ("diag", "full")] + [gj.fit_predict(cj, p, x, y, xs)]

    want = jax.jit(run)(*(jnp.asarray(a) for a in (p, x, y, xs)))
    st = gt.precompute_tinv(gt.factorize(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y)))
    got = [gt.predict(ct, st, torch.tensor(xs), var) for var in ("diag", "full")]
    got.append(gt.fit_predict(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y), torch.tensor(xs)))
    for (mt, vt), (mj, vj) in zip(got, want):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8, atol=1e-8)


def test_exact_gp_cpu_matches_jax(served):
    """The ExactGP wrapper on device="cpu" predicts what the JAX package's
    factorize + predict give for the same parameters."""
    (x, y, p, xs), _, preds = served
    _, ct = _covs()
    mt = gt.ExactGP(x, y, ct, device="cpu")
    np.testing.assert_array_equal(mt.params.numpy(), [1.0, 1.0, 1.0, 1e-4])
    mt.set_params(p)
    for var in ("full", "diag"):
        for u, v in zip(mt.predict(xs, var), preds[(var, False)]):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-8, atol=1e-8)
    mt.prepare_serving()
    np.testing.assert_allclose(mt.predict_var(xs).numpy(), np.asarray(preds[("diag", True)][1]), rtol=1e-8)
    np.testing.assert_allclose(mt.predict_covar(xs).numpy(), np.asarray(preds[("full", True)][1]), rtol=1e-8, atol=1e-8)
    assert mt.state.x.device.type == "cpu"


def test_numpy_entry_points_default_to_cuda():
    """NumPy input goes to the GPU unless device="cpu": without a GPU the
    entry points raise instead of running on the CPU."""
    _, ct = _covs()
    x, y, p = make_data(16, 2, 9)
    calls = [
        lambda: gt.ExactGP(x, y, ct),
        lambda: gt.factorize(ct, p, x, y),
        lambda: gt.fit_mle(ct, p, x, y, max_iter=1),
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call() is not None
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert gt.ExactGP(x, y, ct, device="cpu").x.device.type == "cpu"
    assert gt.factorize(ct, p, x, y, device="cpu").chol.device.type == "cpu"


def test_f32_slice_runs_through_both_plain_kernels(monkeypatch):
    """An f32 NLML value + fast gradient on the CPU goes through the plain
    versions of both kernels and agrees with f64 to the bounds the card
    is held to (value 1e-4, gradient 1e-2 relative)."""
    calls = []
    for mod, name in ((gram, "rbf_noise_gram_plain"), (chol_inverse, "cholesky_inverse_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    _, ct = _covs()
    x, y, p = make_data(256, 3, 42)
    v32, g32 = gt.nlml_value_and_grad(ct, *(torch.tensor(a, dtype=torch.float32) for a in (p, x, y)))
    assert sorted(set(calls)) == ["cholesky_inverse_plain", "rbf_noise_gram_plain"]
    v64, g64 = gt.nlml_value_and_grad(ct, *(torch.tensor(a) for a in (p, x, y)))
    assert abs(v32.item() - v64.item()) <= 1e-4 * abs(v64.item())
    assert torch.linalg.norm(g32.double() - g64) <= 1e-2 * torch.linalg.norm(g64)


@pytest.fixture(scope="module")
def extended():
    """A served state, the new points, and the JAX package's extended
    state and posterior factor, from one compiled program."""
    cj, _ = _covs()
    x, y, _ = make_data(40, 2, 11)
    x2, y2, _ = make_data(6, 2, 12)
    x2[0] = x[3]  # a duplicated point: its Schur pivot needs the ladder
    p = np.array([1.1, 0.9, 1.2, 0.05])
    xs = np.random.default_rng(13).uniform(0, 2, size=(8, 2))

    def run(p, x, y, x2, y2, xs):
        s = gj.precompute_tinv(gj.factorize(cj, p, x, y))
        e = gj.extend_state(cj, s, x2, y2)
        mean, cov = gj.predict(cj, e, xs, "full")
        return e, mean, gj.safe_cholesky(cov).chol

    want = jax.jit(run)(*(jnp.asarray(a) for a in (p, x, y, x2, y2, xs)))
    return (x, y, x2, y2, p, xs), jax.tree_util.tree_map(np.asarray, want)


def test_extend_state_matches_jax_and_refactorizing(extended):
    (x, y, x2, y2, p, xs), (ej, _, _) = extended
    _, ct = _covs()
    s = gt.precompute_tinv(gt.factorize(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y)))
    e = gt.extend_state(ct, s, x2, y2)
    for f in ("x", "y", "chol", "weights", "jitter", "ok", "tinv"):
        np.testing.assert_allclose(getattr(e, f).numpy(), getattr(ej, f), rtol=1e-8, atol=1e-8)
    full = gt.factorize(ct, torch.tensor(p), torch.cat([e.x[:40], e.x[40:]]), e.y)
    np.testing.assert_allclose(e.chol.numpy(), full.chol.numpy(), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(e.weights.numpy(), full.weights.numpy(), rtol=1e-6, atol=1e-6)
    model = gt.ExactGP(x, y, ct, device="cpu")
    model.set_params(p)
    model.update()
    model.add_data(x2, y2)
    np.testing.assert_allclose(model.state.chol.numpy(), e.chol.numpy(), rtol=1e-12, atol=1e-12)
    assert model.x.shape == (46, 2) and not model.need_upd


def test_extend_state_committee_is_per_expert(rng):
    _, ct = _covs()
    x, y, p = _committee(rng, nc=2, n=20)
    x2, y2 = rng.uniform(0, 2, size=(3, 2)), rng.normal(size=3)
    s = gt.factorize(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y))
    e = gt.extend_state(ct, s, x2, y2)
    for i in range(2):
        si = gt.factorize(ct, torch.tensor(p[i]), torch.tensor(x[i]), torch.tensor(y[i]))
        ei = gt.extend_state(ct, si, x2, y2)
        np.testing.assert_allclose(e.chol[i].numpy(), ei.chol.numpy(), rtol=1e-12, atol=1e-12)


def test_sample_predictive_matches_jax_and_its_moments(extended):
    """The deterministic part of the draws (mean and the laddered factor
    of the predictive covariance) against JAX at 1e-8; the draws' mean
    and covariance within Monte-Carlo tolerance."""
    (x, y, x2, y2, p, xs), (_, mj, lj) = extended
    _, ct = _covs()
    s = gt.extend_state(ct, gt.factorize(ct, torch.tensor(p), torch.tensor(x), torch.tensor(y)), x2, y2)
    mean, lp = gt.models.exact_gp.predictive_factor(ct, s, xs)
    np.testing.assert_allclose(mean.numpy(), mj, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(lp.numpy(), lj, rtol=1e-8, atol=1e-8)
    n = 2000
    draws = gt.sample_predictive(ct, s, xs, torch.Generator().manual_seed(1), n)
    assert draws.shape == (n, 8)
    cov = lp @ lp.T
    sd = torch.sqrt(torch.diagonal(cov))
    assert torch.all(torch.abs(draws.mean(0) - mean) < 5 * sd / np.sqrt(n))
    assert torch.all(torch.abs(torch.cov(draws.T) - cov) < 6 * torch.outer(sd, sd) * np.sqrt(2.0 / n))
    s2 = gt.factorize(ct, torch.tensor(np.stack([p, p])), torch.tensor(np.stack([x, x])), torch.tensor(np.stack([y, y])))
    assert gt.sample_predictive(ct, s2, xs, None, 3).shape == (2, 3, 8)


def test_port_never_imports_jax():
    code = (
        "import sys, pygpr_torch, pygpr_torch.convert, pygpr_torch.models.grbcm, "
        "pygpr_torch.models.committee, pygpr_torch.models.metrics, pygpr_torch.sample, "
        "pygpr_torch.sample.designs, pygpr_torch.ops.chol_batched; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'pygpr_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|pygpr_tpu)\b", re.MULTILINE)
    for path in list((ROOT / "pygpr_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not imports.search(path.read_text()), path
