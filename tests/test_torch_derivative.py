"""Port parity: the gradient-enhanced GP against the JAX package.

The same seeded NumPy data go through both packages in f64: the joint
value–gradient gram built by autodiff of the kernel (``torch.func`` in the
port, ``jax.grad``/``jax.jacfwd`` in the JAX package) for the three
kernels of ``tests/test_derivative.py``, with coincident points (the
mixed Hessian's diagonal, where RBF's clamp is straight-through), the
joint NLML and its gradient in the kernel parameters and both noise
scales, the prediction with the posterior mean gradient on a JAX state
carried across by ``convert``, the fit, the wrapper and the rejection of
a white-noise term.  The JAX side runs once, under one ``jax.jit``, in a
module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU on ``chip_smoke.py``'s problem (d = 3, 256 points with
values and gradients of sin(2Σx), a [1024, 1024] joint gram, ``RBF``,
θ = [1, 1, 1, 1], σ_f = σ_g = 0.01): the joint gram, the NLML and its
gradient:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_derivative.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import derivative as dt
from pygpr_tpu.models import derivative as dj

RTOL, FIT_TOL = 1e-10, 1e-8
KINDS = ("RBF", "RationalQuadratic", "Sum")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kernels(pkg, kind):
    return {"RBF": pkg.RBF(), "RationalQuadratic": pkg.RationalQuadratic(),
            "Sum": pkg.Sum((pkg.RBF(), pkg.RBF()))}[kind]


def f_and_grad(x):
    """sin(2Σx) and its gradient."""
    s = x.sum(-1)
    return np.sin(2 * s), np.repeat(2 * np.cos(2 * s)[:, None], x.shape[1], axis=1)


def _data(n=6, ng=5, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2, (n, d))
    xg = np.concatenate([x[:3], rng.uniform(0, 2, (ng - 3, d))])   # three points with both
    y, _ = f_and_grad(x)
    _, g = f_and_grad(xg)
    y = y + 0.01 * rng.normal(size=n)
    g = g + 0.01 * rng.normal(size=g.shape)
    xq = rng.uniform(0, 2, (7, d))
    ps = {k: 0.6 + rng.uniform(size=kernels(gj, k).n_params(d)) for k in KINDS}
    return x, xg, y, g, xq, ps


@pytest.fixture(scope="module")
def parity():
    x, xg, y, g, xq, ps = _data()

    def run(x, xg, y, g, xq, ps):
        out = {f"K_{k}": dj.joint_gram(kernels(gj, k), ps[k], x, xg) for k in KINDS}
        out["K_same"] = dj.joint_gram(gj.RBF(), ps["RBF"], xg, xg)
        kern, p = gj.RBF(), ps["RBF"]
        out["nlml"], out["g_nlml"] = jax.value_and_grad(
            lambda u: dj.nlml(kern, u[:3], x, y, xg, g, sigma_f=u[3], sigma_g=u[4]))(
            jnp.concatenate([p, jnp.asarray([0.05, 0.1])]))
        st = dj.factorize(kern, p, x, y, xg, g)
        out["state"] = st._asdict()
        out["pred"] = dj.predict(kern, p, st, x, xg, xq, grad_out=True)
        return out

    want = jax.jit(run)(*map(jnp.asarray, (x, xg, y, g, xq)), {k: jnp.asarray(v) for k, v in ps.items()})
    # the fit returns the noise scales as Python floats, so it runs outside
    # jit, its L-BFGS as one compiled program
    import pygpr_tpu.optimize.lbfgs as lj

    plain = lj.minimize_lbfgs
    lj.minimize_lbfgs = lambda fun, u0, **kw: jax.jit(lambda u: plain(fun, u, **kw))(u0)
    try:
        res, sf, sg = dj.fit(gj.RBF(), jnp.asarray(ps["RBF"]), *map(jnp.asarray, (x, y, xg, g)), max_iter=30)
    finally:
        lj.minimize_lbfgs = plain
    want = jax.tree.map(np.asarray, want) | {"fit": np.asarray(res.params)}
    return (x, xg, y, g, xq, ps), want, (sf, sg)


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("kind", KINDS)
def test_joint_gram_with_coincident_points_matches_jax(parity, kind):
    (x, xg, *_, ps), want, _ = parity
    K = dt.joint_gram(kernels(gt, kind), T(ps[kind]), T(x), T(xg)).numpy()
    np.testing.assert_allclose(K, want[f"K_{kind}"], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(K, K.T, atol=1e-12)


def test_hessian_block_diagonal_at_a_equals_b(parity):
    """The gradient–gradient block of xg with itself: every point meets
    itself, the second derivative of the clamped squared distance."""
    (_, xg, *_, ps), want, _ = parity
    K = dt.joint_gram(gt.RBF(), T(ps["RBF"]), T(xg), T(xg)).numpy()
    np.testing.assert_allclose(K, want["K_same"], rtol=1e-12, atol=1e-12)
    # RBF: ∂²k/∂aₗ∂bₗ at a = b is 2σ²ℓₗ²
    sig, ls = ps["RBF"][0], ps["RBF"][1:]
    n, d = xg.shape
    np.testing.assert_allclose(np.diag(K)[n:], np.tile(2 * sig**2 * ls**2, n), rtol=1e-12)


def test_nlml_and_gradient_in_params_and_noise_match_jax(parity):
    (x, xg, y, g, _, ps), want, _ = parity
    u = T(np.r_[ps["RBF"], 0.05, 0.1]).requires_grad_(True)
    v = dt.nlml(gt.RBF(), u[:3], T(x), T(y), T(xg), T(g), sigma_f=u[3], sigma_g=u[4])
    (gu,) = torch.autograd.grad(v, u)
    np.testing.assert_allclose(v.item(), want["nlml"], rtol=RTOL)
    np.testing.assert_allclose(gu.numpy(), want["g_nlml"], rtol=1e-9, atol=1e-11)


def test_predict_with_gradients_on_jax_state_matches_jax(parity):
    (x, xg, y, g, xq, ps), want, _ = parity
    st = convert.deriv_state_from_numpy(want["state"], "cpu")
    mean, var, gm = dt.predict(gt.RBF(), T(ps["RBF"]), st, T(x), T(xg), T(xq), grad_out=True)
    for a, b in zip((mean, var, gm), want["pred"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-10)
    own = dt.factorize(gt.RBF(), T(ps["RBF"]), T(x), T(y), T(xg), T(g))
    np.testing.assert_allclose(own.weights.numpy(), want["state"]["weights"], rtol=1e-8, atol=1e-9)


def test_fit_through_the_wrapper_matches_jax(parity):
    """``DerivativeGP.train`` (``fit`` with both noise scales) against the
    JAX package's ``fit`` from the same start."""
    (x, xg, y, g, xq, ps), want, (sf, sg) = parity
    model = gt.DerivativeGP(x, y, xg, g, device="cpu")
    model.params = T(ps["RBF"])
    mean, var, gm = model.train(max_iter=30).predict(xq, grad_out=True)
    np.testing.assert_allclose(model.params.numpy(), want["fit"], atol=FIT_TOL)
    np.testing.assert_allclose([model.sigma_f, model.sigma_g], [sf, sg], atol=FIT_TOL)
    assert gm.shape == xq.shape and (var > 0).all()


def test_white_noise_anywhere_is_rejected():
    for kern in (gt.WhiteNoise(), gt.Sum((gt.RBF(), gt.WhiteNoise())),
                 gt.Product((gt.RBF(), gt.Sum((gt.RBF(), gt.WhiteNoise())))),
                 gt.ActiveDims(gt.WhiteNoise(), [0])):
        with pytest.raises(ValueError, match="noise-free"):
            dt._check_noise_free(kern)


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_problem(n=256, d=3, seed=9):
    """chip_smoke.py's problem: x ~ U(0, 2)³, values and gradients of
    sin(2Σx) at the same 256 points with noise 0.01, f32."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, (n, d))
    y, g = f_and_grad(x)
    y = y + 0.01 * rng.normal(size=n)
    g = g + 0.01 * rng.normal(size=g.shape)
    return [a.astype(np.float32) for a in (x, y, g)]


def _jax_run(dtype):
    from tests._jax_gaps import setup_jax

    dt_ = setup_jax(dtype)
    x, y, g = (jnp.asarray(a.astype(dt_)) for a in smoke_problem())
    kern, p0 = gj.RBF(), jnp.ones(4, dt_)
    K = jax.jit(lambda p: dj.joint_gram(kern, p, x, x))(p0)
    v, gr = jax.jit(jax.value_and_grad(lambda p: dj.nlml(kern, p, x, y, x, g)))(p0)
    # the joint gram's every 97th entry (11 000 of its 1 048 576)
    return {"joint_gram": np.asarray(K, np.float64).ravel()[::97].tolist(), "value": float(v),
            "grad": np.asarray(gr, np.float64).tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
