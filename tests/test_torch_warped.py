"""Port parity: the warped GP against the JAX package.

The same seeded NumPy data go through both packages in f64: the warps
(forward, derivative, the bisection inverse to 1e-12, the init), the
warped NLML and its gradient in the kernel and warp parameters (which
reach the NLML through the targets), the observation-space prediction
and NLPD on a JAX state carried across by ``convert``, the joint fit and
the wrapper.  The Gauss-Hermite nodes are the same bits.  The JAX side
runs once, under one ``jax.jit``, in a module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of ``nlml_warped`` (value and gradient) at the start of
``chip_smoke.py``'s warped fit (x of ``make_data(4096, 3)``, y =
exp(sin(2Σx) + 0.1ε), ``TanhWarp(3)``):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_warped.py [n]
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import warped as wt
from pygpr_tpu.models import warped as wj

#: closed forms (relative), the bisection inverse (absolute), fits
RTOL, INV_TOL, FIT_TOL = 1e-10, 1e-12, 1e-8
#: L-BFGS iterations of the compared fits: on this problem the two
#: packages' iterates agree to 3e-11 up to 20 iterations, then part about
#: tenfold every 5 (1e-9 at 25, 2e-8 at 30) in the warp's flat valley,
#: where the objective and its gradient still agree to 1e-10
FIT_ITERS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=40, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2, (n, d))
    y = np.exp(np.sin(2 * x.sum(-1)) + 0.1 * rng.normal(size=n))
    xq = rng.uniform(0, 2, (7, d))
    yq = np.exp(np.sin(2 * xq.sum(-1)))
    wp = np.array([-1.0, 0.5, -0.8, 0.3, 1.2, -1.5, -2.0, 0.0, -0.4])
    z = np.linspace(-3.0, 4.0, 23)
    return dict(x=x, y=y, xq=xq, yq=yq, wp=wp, z=z, p=np.array([1.1, 0.9, 1.2, 0.2]))


@pytest.fixture(scope="module")
def parity():
    inp = _data()
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    tw = wj.TanhWarp(3)
    wp0 = np.asarray(tw.init_params(jnp.asarray(inp["y"])))

    def run(x, y, xq, yq, wp, z, p, wp0):
        out = {"fwd": tw.forward(wp, z), "deriv": tw.deriv(wp, z), "inv": tw.inverse(wp, z)}
        out["nlml"], (out["g_p"], out["g_wp"]) = jax.value_and_grad(
            lambda q, w: wj.nlml_warped(cov, q, tw, w, x, y), argnums=(0, 1))(p, wp)
        out["nlml_identity"] = wj.nlml_warped(cov, p, wj.IdentityWarp(), jnp.zeros(0), x, y)
        out["nlml_log"] = wj.nlml_warped(cov, p, wj.LogWarp(), jnp.zeros(0), x, y)
        st = wj.factorize_warped(cov, p, tw, wp, x, y)
        out["state"] = st._asdict()
        out["pred"] = wj.predict_warped(cov, st, tw, wp, xq)
        out["nlpd"] = wj.nlpd_warped(cov, st, tw, wp, xq, yq)
        res = wj.fit_warped(cov, tw, x, y, p, wp0, max_iter=FIT_ITERS)
        out["fit"] = res._asdict() | {"state": res.state._asdict()}
        return out

    want = jax.jit(run)(**{k: jnp.asarray(v) for k, v in inp.items()}, wp0=wp0)
    return inp, wp0, jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


COV = gt.Sum((gt.RBF(), gt.WhiteNoise()))
TW = wt.TanhWarp(3)


def test_gauss_hermite_nodes_are_the_same_bits():
    assert np.array_equal(wt._GH_X, wj._GH_X) and np.array_equal(wt._GH_W, wj._GH_W)


def test_tanh_warp_forward_deriv_inverse_and_init_match_jax(parity):
    inp, wp0, want = parity
    wp, z = T(inp["wp"]), T(inp["z"])
    np.testing.assert_allclose(TW.forward(wp, z).numpy(), want["fwd"], rtol=RTOL)
    np.testing.assert_allclose(TW.deriv(wp, z).numpy(), want["deriv"], rtol=RTOL)
    inv = TW.inverse(wp, z)
    np.testing.assert_allclose(inv.numpy(), want["inv"], rtol=0, atol=INV_TOL)
    np.testing.assert_allclose(TW.forward(wp, inv).numpy(), inp["z"], rtol=0, atol=INV_TOL)
    assert np.array_equal(TW.init_params(T(inp["y"])).numpy(), wp0)


def test_nlml_warped_value_and_gradient_match_jax(parity):
    inp, _, want = parity
    q, w = T(inp["p"]).requires_grad_(True), T(inp["wp"]).requires_grad_(True)
    x, y = T(inp["x"]), T(inp["y"])
    v = wt.nlml_warped(COV, q, TW, w, x, y)
    gq, gw = torch.autograd.grad(v, (q, w))
    np.testing.assert_allclose(v.item(), want["nlml"], rtol=RTOL)
    np.testing.assert_allclose(gq.numpy(), want["g_p"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gw.numpy(), want["g_wp"], rtol=1e-9, atol=1e-11)
    e = torch.zeros(0, dtype=torch.float64)
    np.testing.assert_allclose(wt.nlml_warped(COV, T(inp["p"]), wt.IdentityWarp(), e, x, y).item(),
                               want["nlml_identity"], rtol=RTOL)
    np.testing.assert_allclose(wt.nlml_warped(COV, T(inp["p"]), wt.LogWarp(), e, x, y).item(),
                               want["nlml_log"], rtol=RTOL)


def test_predict_and_nlpd_on_jax_state_match_jax(parity):
    inp, _, want = parity
    st = convert.state_from_numpy(want["state"], "cpu")
    wp = T(inp["wp"])
    mean, var, median = wt.predict_warped(COV, st, TW, wp, T(inp["xq"]))
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], rtol=1e-9)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], rtol=1e-8)
    np.testing.assert_allclose(median.numpy(), want["pred"][2], rtol=1e-9)
    np.testing.assert_allclose(wt.nlpd_warped(COV, st, TW, wp, T(inp["xq"]), T(inp["yq"])).item(), want["nlpd"],
                               rtol=1e-9)


def test_fit_warped_matches_jax_and_carries_across(parity):
    inp, _, want = parity
    res = wt.fit_warped(COV, TW, T(inp["x"]), T(inp["y"]), T(inp["p"]), max_iter=FIT_ITERS)
    w = want["fit"]
    np.testing.assert_allclose(res.params.numpy(), w["params"], atol=FIT_TOL)
    np.testing.assert_allclose(res.warp_params.numpy(), w["warp_params"], atol=FIT_TOL)
    np.testing.assert_allclose(res.nlml.item(), w["nlml"], atol=FIT_TOL)
    carried = convert.warped_result_from_numpy(w, "cpu")
    warp = convert.warp_from_name("TanhWarp", n_terms=3)
    a = wt.predict_warped(COV, carried.state, warp, carried.warp_params, T(inp["xq"]))
    b = wt.predict_warped(COV, res.state, TW, res.warp_params, T(inp["xq"]))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=1e-6)


def test_wrapper_trains_and_predicts(parity):
    inp, _, want = parity
    model = gt.WarpedGP(inp["x"], inp["y"], COV, wt.TanhWarp(3), device="cpu")
    model.params = T(inp["p"])
    model.train(max_iter=FIT_ITERS)
    np.testing.assert_allclose(model.params.numpy(), want["fit"]["params"], atol=FIT_TOL)
    mean, var, median = model.predict(inp["xq"])
    assert (var >= 0).all() and torch.isfinite(mean).all() and torch.isfinite(median).all()


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_data(n=4096, dim=3, seed=42):
    """chip_smoke.py's warped problem: make_data's x, y = exp(sin(2Σx) +
    0.1ε) with ε from a generator of its own (seed 5); f32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim)).astype(np.float32)
    eps = np.random.default_rng(5).normal(size=n)
    return x, np.exp(np.sin(2.0 * x.sum(-1)) + 0.1 * eps).astype(np.float32)


def _jax_run(dtype, n="4096"):
    from tests._jax_gaps import setup_jax

    dt = setup_jax(dtype)
    x, y = (jnp.asarray(a.astype(dt)) for a in smoke_data(int(n)))
    cov, tw = gj.Sum((gj.RBF(), gj.WhiteNoise())), wj.TanhWarp(3)
    p0, wp0 = jnp.asarray([1.0, 1.0, 1.0, 1.0, 0.1], dt), tw.init_params(y)
    v, (gp_, gw) = jax.jit(jax.value_and_grad(lambda q, w: wj.nlml_warped(cov, q, tw, w, x, y), argnums=(0, 1)))(
        p0, wp0)
    return {"value": float(v), "grad": np.r_[np.asarray(gp_, np.float64), np.asarray(gw, np.float64)].tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
