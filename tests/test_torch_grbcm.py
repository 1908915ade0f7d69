"""Port parity for the grBCM committee: augmentation, aggregation, the
fits, prediction, posterior draws and the ``GRBCM`` wrapper, against the
JAX package on the CPU in f64 (its default path), at rtol 1e-8 for what
is computed from the same parameters, 1e-4 for fitted parameters and
1e-9 for the NLML at the optimum.  Inputs are made with NumPy from a seed;
the JAX references come from one compiled program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import exact_gp
from pygpr_torch.models import grbcm as gbt
from pygpr_torch.ops import linalg
from pygpr_tpu.models import grbcm as gbj


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
    """A small committee (nc = 3, nls = 20, ng = 12, d = 2), aggregation
    inputs, and every JAX result the tests compare with."""
    rng = np.random.default_rng(0)
    nc, nls, ng, d, nq = 3, 20, 12, 2, 9
    f = lambda x: np.sin(2.0 * x.sum(-1))  # noqa: E731
    data = dict(
        xl=rng.uniform(0, 4, (nc, nls, d)),
        xg=rng.uniform(0, 4, (ng, d)),
        xs=rng.uniform(0, 4, (nq, d)),
    )
    data["yl"] = f(data["xl"]) + 0.1 * rng.normal(size=(nc, nls))
    data["yg"] = f(data["xg"]) + 0.1 * rng.normal(size=ng)
    A = rng.standard_normal((nc + 1, nq, nq))
    agg = dict(
        ys_g=rng.normal(size=nq), var_g=rng.uniform(0.5, 1.0, nq),
        ys_l=rng.normal(size=(nc, nq)), var_l=rng.uniform(0.1, 0.9, (nc, nq)),
        covars=A @ np.swapaxes(A, -1, -2) / nq + np.eye(nq),
    )
    cj, _ = _covs()

    def run(data, agg, mask):
        xl, yl, xg, yg, xs = (data[k] for k in ("xl", "yl", "xg", "yg", "xs"))
        out = {"augment": gbj.augment(xl, yl, xg, yg)}
        out["fit_shared"] = gbj.fit(cj, xl, yl, xg, yg, shared=True, max_iter=50)[0]
        out["fit_indep"] = gbj.fit(cj, xl, yl, xg, yg, shared=False, max_iter=50)[0]
        info = out["fit_shared"]
        x_aug, y_aug = out["augment"]
        sg = gj.factorize(cj, info.params_g, xg, yg)
        sl = gj.factorize(cj, info.params_l, x_aug, y_aug)
        sgt, slt = gj.precompute_tinv(sg), gj.precompute_tinv(sl)
        for var in ("diag", "full"):
            for m in (None, mask):
                out[f"predict_{var}_{m is not None}"] = gbj.predict(cj, info.params_g, info.params_l, sg, sl, xs, var, mask=m)
        out["predict_tinv"] = gbj.predict(cj, info.params_g, info.params_l, sgt, slt, xs, "diag", mask=mask)
        full = out["predict_full_True"]
        out["predictive_chol"] = gj.safe_cholesky(full.covar).chol
        out["agg_diag"] = gbj.aggregate(agg["ys_g"], agg["var_g"], agg["ys_l"], agg["var_l"])
        out["agg_mask"] = gbj.aggregate(agg["ys_g"], agg["var_g"], agg["ys_l"], agg["var_l"], mask=mask)
        out["agg_full"] = gbj.aggregate_full_covar(out["agg_diag"].beta, agg["covars"][0], agg["covars"][1:])
        return out

    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    out = jax.jit(run)(to_j(data), to_j(agg), jnp.asarray(MASK))
    return data, agg, jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-8, atol=1e-8):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _states(data, info):
    """The port's factorized states for the given fitted parameters."""
    _, ct = _covs()
    x_aug, y_aug = gbt.augment(*(_t(data[k]) for k in ("xl", "yl", "xg", "yg")))
    sg = gt.factorize(ct, _t(info.params_g), _t(data["xg"]), _t(data["yg"]))
    sl = gt.factorize(ct, _t(info.params_l), x_aug, y_aug)
    return sg, sl


def test_augment_matches_jax(ref):
    data, _, want = ref
    got = gbt.augment(*(_t(data[k]) for k in ("xl", "yl", "xg", "yg")))
    for g, w in zip(got, want["augment"]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("form", ["agg_diag", "agg_mask", "agg_full"])
def test_aggregate_matches_jax(form, ref):
    _, agg, want = ref
    a = {k: _t(v) for k, v in agg.items()}
    if form == "agg_full":
        beta = _t(want["agg_diag"].beta)
        _close(gbt.aggregate_full_covar(beta, a["covars"][0], a["covars"][1:]), want[form])
        return
    mask = torch.tensor(MASK) if form == "agg_mask" else None
    got = gbt.aggregate(a["ys_g"], a["var_g"], a["ys_l"], a["var_l"], mask=mask)
    for g, w in zip(got, want[form]):
        _close(g, w)


@pytest.mark.parametrize("shared", [True, False])
def test_fit_matches_jax(shared, ref):
    data, _, want = ref
    _, ct = _covs()
    info, x_aug, _ = gbt.fit(ct, *(_t(data[k]) for k in ("xl", "yl", "xg", "yg")), shared=shared, max_iter=50)
    w = want["fit_shared" if shared else "fit_indep"]
    np.testing.assert_array_equal(x_aug.numpy(), want["augment"][0])
    _close(info.params_g, w.params_g, rtol=1e-4, atol=0)
    _close(info.params_l, w.params_l, rtol=1e-4, atol=0)
    _close(info.nlml_g, w.nlml_g, rtol=1e-9, atol=0)
    _close(info.nlml_l, w.nlml_l, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(info.ok_l.numpy(), w.ok_l)


def test_stream_equals_batch_visible(ref, monkeypatch):
    """The streamed fit (experts' NLMLs one at a time, the JAX package's
    lax.map) gives the batch-visible fit; a committee whose stack is above
    the batched size is factored and predicted one expert at a time, with
    the batch-visible results."""
    data, _, _ = ref
    _, ct = _covs()
    args = [_t(data[k]) for k in ("xl", "yl", "xg", "yg")]
    info_b, x_aug, y_aug = gbt.fit(ct, *args, shared=True, max_iter=50)
    info_s, _, _ = gbt.fit(ct, *args, shared=True, stream=True, max_iter=50)
    _close(info_s.params_l, info_b.params_l, rtol=1e-6, atol=0)
    _close(info_s.nlml_l, info_b.nlml_l, rtol=1e-10, atol=0)
    xs = _t(data["xs"])
    sb = gt.factorize(ct, info_b.params_l, x_aug, y_aug)
    pb = {var: gt.predict(ct, sb, xs, var) for var in ("diag", "full")}
    tb = gt.precompute_tinv(sb)
    _close(tb.tinv, torch.stack([linalg.tri_inverse_doubling(c) for c in sb.chol]), rtol=1e-12, atol=1e-12)
    monkeypatch.setattr(exact_gp, "BATCHED_STACK_BYTES", 0)
    ss = gt.factorize(ct, info_b.params_l, x_aug, y_aug)
    for f in ("chol", "weights", "jitter", "ok"):
        _close(getattr(ss, f), getattr(sb, f), rtol=1e-12, atol=1e-12)
    for var in ("diag", "full"):
        for a, b in zip(gt.predict(ct, ss, xs, var), pb[var]):
            _close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype,per_expert", [(torch.float32, False), (torch.float64, True)])
def test_per_expert_above_the_batched_stack_size(dtype, per_expert):
    """BASELINE config 4's [16, 6400, 6400] stack: 2.6 GB in f32 is
    batched, 5.2 GB in f64 goes one expert at a time."""
    x = torch.empty((16, 6400, 2), dtype=dtype, device="meta")
    assert exact_gp._per_expert(x) == per_expert
    assert not exact_gp._per_expert(x[0])


def test_segmented_fit_equals_unsegmented(ref):
    """One segment as long as the fit takes the unsegmented iterates.
    Segments of 3 iterations restart the curvature memory, so they take
    another path to the same optimum: both stop at a gradient norm of 1e-4
    where the optimum is flat in the noise, so the summed NLML agrees to
    1e-6 and the parameters to 1e-2."""
    data, _, _ = ref
    _, ct = _covs()
    args = [_t(data[k]) for k in ("xl", "yl", "xg", "yg")]
    whole, _, _ = gbt.fit(ct, *args, shared=True, max_iter=60)
    one, _, _ = gbt.fit(ct, *args, shared=True, max_iter=60, segment_iters=60)
    np.testing.assert_array_equal(one.params_l.numpy(), whole.params_l.numpy())
    seg, _, _ = gbt.fit(ct, *args, shared=True, max_iter=60, segment_iters=3)
    _close(seg.nlml_l.sum(), whole.nlml_l.sum(), rtol=1e-6, atol=0)
    _close(seg.params_l, whole.params_l, rtol=1e-2, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("var", ["diag", "full"])
def test_predict_matches_jax(var, masked, ref):
    data, _, want = ref
    _, ct = _covs()
    info = want["fit_shared"]
    sg, sl = _states(data, info)
    res = gbt.predict(
        ct, _t(info.params_g), _t(info.params_l), sg, sl, _t(data["xs"]), var,
        mask=torch.tensor(MASK) if masked else None,
    )
    for g, w in zip(res, want[f"predict_{var}_{masked}"]):
        _close(g, w)


def test_grbcm_end_to_end_matches_jax(ref):
    """GRBCM: train (the shared fit), prepare_serving, predict."""
    data, _, want = ref
    _, ct = _covs()
    info = want["fit_shared"]
    model = gbt.GRBCM(*(data[k] for k in ("xl", "yl", "xg", "yg")), ct, device="cpu")
    got = model.train(max_iter=50)
    _close(got.params_l, info.params_l, rtol=1e-4, atol=0)
    _close(got.nlml_l, info.nlml_l, rtol=1e-9, atol=0)
    # predictions from the JAX package's own parameters, carried across
    info_t = convert.fit_info_from_numpy(info._asdict(), "cpu")
    model.gpg.set_params(info_t.params_g)
    model.gpl.set_params(info_t.params_l)
    model.mask = torch.tensor(MASK)
    model.prepare_serving()
    assert model.gpg.state.tinv is not None and model.gpl.state.tinv.shape == model.gpl.state.chol.shape
    mean, var = model.predict(data["xs"], "diag")
    w = want["predict_tinv"]
    _close(mean, w.mean)
    _close(var, w.covar)
    _close(model.beta, w.beta)
    _close(model.prec, w.prec)


def test_sample_predictive_matches_jax_and_its_moments(ref):
    """The draws' deterministic part (mean and the laddered factor of the
    aggregated covariance) against JAX at 1e-8; the draws' mean and
    covariance within Monte-Carlo tolerance (2000 draws)."""
    data, _, want = ref
    _, ct = _covs()
    info = want["fit_shared"]
    sg, sl = _states(data, info)
    args = (ct, _t(info.params_g), _t(info.params_l), sg, sl, _t(data["xs"]))
    res = gbt.predict(*args, "full", mask=torch.tensor(MASK))
    _close(res.mean, want["predict_full_True"].mean)
    _close(gt.safe_cholesky(res.covar).chol, want["predictive_chol"])
    gen = torch.Generator().manual_seed(0)
    draws = gbt.sample_predictive(*args, gen, 2000, mask=torch.tensor(MASK))
    assert draws.shape == (2000, 9)
    sd = torch.sqrt(torch.diagonal(res.covar))
    assert torch.all(torch.abs(draws.mean(0) - res.mean) < 5 * sd / np.sqrt(2000))
    emp = torch.cov(draws.T)
    scale = torch.outer(sd, sd)
    assert torch.all(torch.abs(emp - res.covar) < 6 * scale * np.sqrt(2.0 / 2000))
