"""Port parity: deep kernel learning against the JAX package.

The same seeded NumPy data go through both packages in f64: the
deep kernel's Glorot init (bit for bit: the same NumPy draw), its
features, gram, cross block and diagonal, ``matrix_and_grad`` (jacfwd in
both), the fast NLML's value and gradient through the MLP (the port's one
autograd VJP through the gram), the Adam fit's trace and parameters, and
predictions from the JAX package's fitted parameters carried across.  The
JAX side runs once, under one ``jax.jit``, in a module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of the fast NLML (value and gradient) at the start of
``chip_smoke.py``'s DKL fit (x of ``make_data(4096, 3)``, a step target,
``DeepKernel(Sum(RBF, WhiteNoise), (32, 32, 2))``, noise 0.1):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_dkl.py [n]
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import exact_gp as et
from pygpr_torch.models.likelihood import nlml_fast
from pygpr_tpu.models import dkl as dj
from pygpr_tpu.models import exact_gp as ej
from pygpr_tpu.models import likelihood as lj

#: closed forms (relative), fits (absolute, as tests/test_torch_slice.py)
RTOL, FIT_TOL = 1e-10, 1e-8
WIDTHS, SEED, STEPS = (8, 2), 3, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def step_target(t):
    """tests/test_dkl.py's non-stationary target: sin(2t) left of 0, a
    square wave sign(sin 4t) right of it."""
    return np.where(t < 0, np.sin(2 * t), np.sign(np.sin(4 * t)))


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-2, 2, n))[:, None]
    y = step_target(x[:, 0]) + 0.05 * rng.normal(size=n)
    return x, y, np.linspace(-1.9, 1.9, 11)[:, None]


@pytest.fixture(scope="module")
def parity():
    x, y, xq = _data()
    kern = dj.DeepKernel(gj.Sum((gj.RBF(), gj.WhiteNoise())), WIDTHS, seed=SEED)
    p0 = np.array(kern.init_params(jnp.asarray(x)))
    p0[-1] = 0.1

    def run(x, y, xq, p0):
        out = {"feat": kern.features(p0, x), "K": kern.matrix(p0, x), "Kx": kern.matrix(p0, x, xq),
               "diag": kern.diag(p0, xq)}
        out["K_mg"], out["dK"] = kern.matrix_and_grad(p0, x)
        out["nlml"], out["grad"] = jax.value_and_grad(lambda q: lj.nlml_fast(kern, q, x, y))(p0)
        fit = dj.fit_dkl(kern, x, y, params0=p0, n_steps=STEPS)
        out["fit"] = fit._asdict()
        st = ej.factorize(kern, fit.params, x, y)
        out["pred"] = ej.predict(kern, st, xq, "diag")
        return out

    want = jax.jit(run)(*map(jnp.asarray, (x, y, xq, p0)))
    return (x, y, xq, p0), jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


KERN = gt.DeepKernel(gt.Sum((gt.RBF(), gt.WhiteNoise())), WIDTHS, seed=SEED)


def test_init_params_bit_equal_and_identity(parity):
    (x, _, _, p0), _ = parity
    p = KERN.init_params(T(x))
    p[-1] = 0.1
    assert np.array_equal(p.numpy(), p0)
    assert KERN.init_params(T(np.stack([x, x]))).shape == (2, KERN.n_params(1))
    assert KERN == gt.DeepKernel(gt.Sum((gt.RBF(), gt.WhiteNoise())), WIDTHS, seed=SEED)
    assert hash(KERN) == hash(gt.DeepKernel(gt.Sum((gt.RBF(), gt.WhiteNoise())), WIDTHS, seed=SEED))
    assert KERN != gt.DeepKernel(gt.Sum((gt.RBF(), gt.WhiteNoise())), WIDTHS, seed=SEED + 1)
    with pytest.raises(ValueError):
        gt.DeepKernel(KERN, (2,))


def test_features_gram_and_jacobian_match_jax(parity):
    (x, _, xq, p0), want = parity
    p, xt, xqt = T(p0), T(x), T(xq)
    np.testing.assert_allclose(KERN.features(p, xt).numpy(), want["feat"], rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(KERN.matrix(p, xt).numpy(), want["K"], rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(KERN.matrix(p, xt, xqt).numpy(), want["Kx"], rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(KERN.diag(p, xqt).numpy(), want["diag"], rtol=RTOL)
    K, dK = KERN.matrix_and_grad(p, xt)
    np.testing.assert_allclose(K.numpy(), want["K_mg"], rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(dK.numpy(), want["dK"], rtol=1e-9, atol=1e-12)


def test_fast_nlml_gradient_through_the_mlp_matches_jax(parity):
    (x, y, _, p0), want = parity
    p = T(p0).requires_grad_(True)
    v = nlml_fast(KERN, p, T(x), T(y))
    (g,) = torch.autograd.grad(v, p)
    np.testing.assert_allclose(v.item(), want["nlml"], rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), want["grad"], rtol=1e-8, atol=1e-10)


def test_fit_dkl_matches_jax_and_carries_across(parity):
    (x, y, xq, p0), want = parity
    fit = gt.fit_dkl(KERN, T(x), T(y), params0=T(p0), n_steps=STEPS)
    w = want["fit"]
    np.testing.assert_allclose(fit.nlml.numpy(), w["nlml"], atol=FIT_TOL)
    # the last layer's biases shift every feature alike, and the base RBF
    # is translation-invariant: their gradient is round-off (|g| < 1e-12),
    # which Adam's g/√v turns into steps of ±lr in either package alike.
    # Every other parameter is held; the predictions do not see these two
    nm = KERN.n_mlp_params(1)
    bias = np.arange(nm - WIDTHS[-1], nm)
    keep = np.setdiff1d(np.arange(fit.params.shape[0]), bias)
    np.testing.assert_allclose(fit.params.numpy()[keep], w["params"][keep], atol=FIT_TOL)
    p = T(w["params"]).requires_grad_(True)
    (g,) = torch.autograd.grad(nlml_fast(KERN, p, T(x), T(y)), p)
    assert g[bias].abs().max() < 1e-12
    assert bool(fit.converged) == bool(w["converged"])
    carried = convert.dkl_fit_from_numpy(w, "cpu")
    kern = convert.kernel_from_spec(convert.kernel_spec(dj.DeepKernel(gj.Sum((gj.RBF(), gj.WhiteNoise())), WIDTHS,
                                                                      seed=SEED)))
    st = et.factorize(kern, carried.params, T(x), T(y))
    mean, var = et.predict(kern, st, T(xq), "diag")
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], rtol=1e-8, atol=1e-12)


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_data(n=4096, dim=3, seed=42):
    """chip_smoke.py's DKL problem: make_data's x, the step target of
    t = (Σx − 3)/1.5 ∈ [−2, 2] with noise 0.05 (seed 6), f32."""
    x = np.random.default_rng(seed).uniform(0.0, 2.0, size=(n, dim)).astype(np.float32)
    t = (x.sum(-1) - 3.0) / 1.5
    y = step_target(t) + 0.05 * np.random.default_rng(6).normal(size=n)
    return x, y.astype(np.float32)


SMOKE_WIDTHS = (32, 32, 2)


def _jax_run(dtype, n="4096"):
    from tests._jax_gaps import setup_jax

    dt = setup_jax(dtype)
    x, y = (jnp.asarray(a.astype(dt)) for a in smoke_data(int(n)))
    kern = dj.DeepKernel(gj.Sum((gj.RBF(), gj.WhiteNoise())), SMOKE_WIDTHS, seed=0)
    p0 = kern.init_params(x).at[-1].set(0.1)
    v, g = jax.jit(jax.value_and_grad(lambda q: lj.nlml_fast(kern, q, x, y)))(p0)
    return {"value": float(v), "grad": np.asarray(g, np.float64).tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
