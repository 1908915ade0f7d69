"""Port parity: multi-fidelity co-kriging against the JAX package.

The same seeded NumPy data (the JAX test's AR(1) problem, small) go
through both packages in f64: the stage-2 NLML and its gradient in (θ_δ,
ρ), the two-stage fit, the composed prediction on a JAX state carried
across by ``convert``, and the wrapper.  The JAX side runs once, under one
``jax.jit``, in a module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of ``nlml_stage2`` (value and gradient) on
``chip_smoke.py``'s problem (d = 3, 4096 low-fidelity and 512
high-fidelity points; both levels at θ = [1, 1, 1, 1, 0.1], ρ = 1):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_multifidelity.py
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
from pygpr_torch.models import multifidelity as mt
from pygpr_tpu.models import exact_gp as ej
from pygpr_tpu.models import multifidelity as mj

RTOL, FIT_TOL = 1e-10, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mf_problem(n_lo=48, n_hi=10, d=1, rho=1.8, seed=0, lo=0.0, hi=4.0, noise=0.05):
    """tests/test_multifidelity.py's AR(1) problem: f_hi = sin(2Σx),
    f_lo = (f_hi − 0.4 cos(5x₀))/ρ, noise 0.05 on both levels."""
    rng = np.random.default_rng(seed)
    x_lo = rng.uniform(lo, hi, (n_lo, d))
    x_hi = rng.uniform(lo, hi, (n_hi, d))
    f_hi = lambda x: np.sin(2 * x.sum(-1))
    f_lo = lambda x: (f_hi(x) - 0.4 * np.cos(5 * x[:, 0])) / rho
    y_lo = f_lo(x_lo) + noise * rng.normal(size=n_lo)
    y_hi = f_hi(x_hi) + noise * rng.normal(size=n_hi)
    return x_lo, y_lo, x_hi, y_hi, f_hi


@pytest.fixture(scope="module")
def parity():
    x_lo, y_lo, x_hi, y_hi, _ = mf_problem()
    xq = np.linspace(0.2, 3.8, 13)[:, None]
    p = np.array([1.0, 1.0, 0.1])
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def run(x_lo, y_lo, x_hi, y_hi, xq, p):
        out = {}
        st_lo = ej.factorize(cov, p, x_lo, y_lo)
        out["st_lo"] = st_lo._asdict()
        out["s2"], (out["g_d"], out["g_rho"]) = jax.value_and_grad(
            lambda q, r: mj.nlml_stage2(cov, q, r, cov, st_lo, x_hi, y_hi), argnums=(0, 1))(p * 1.1, 1.3)
        st = mj.fit_mf(cov, cov, x_lo, y_lo, x_hi, y_hi, params_lo0=p, params_d0=p, max_iter=40)
        out["fit"] = st._asdict() | {"state_lo": st.state_lo._asdict(), "state_d": st.state_d._asdict()}
        out["pred"] = mj.predict_mf(cov, cov, st, xq)
        return out

    want = jax.jit(run)(*map(jnp.asarray, (x_lo, y_lo, x_hi, y_hi, xq, p)))
    return (x_lo, y_lo, x_hi, y_hi, xq, p), jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


COV = gt.Sum((gt.RBF(), gt.WhiteNoise()))


def test_stage2_nlml_and_gradient_match_jax(parity):
    (x_lo, y_lo, x_hi, y_hi, _, p), want = parity
    st_lo = convert.state_from_numpy(want["st_lo"], "cpu")
    q = T(p * 1.1).requires_grad_(True)
    r = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    v = mt.nlml_stage2(COV, q, r, COV, st_lo, T(x_hi), T(y_hi))
    gq, gr = torch.autograd.grad(v, (q, r))
    np.testing.assert_allclose(v.item(), want["s2"], rtol=RTOL)
    np.testing.assert_allclose(gq.numpy(), want["g_d"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gr.item(), want["g_rho"], rtol=1e-9)


def test_fit_mf_matches_jax(parity):
    (x_lo, y_lo, x_hi, y_hi, xq, p), want = parity
    st = mt.fit_mf(COV, COV, T(x_lo), T(y_lo), T(x_hi), T(y_hi), params_lo0=T(p), params_d0=T(p), max_iter=40)
    w = want["fit"]
    for f in ("params_lo", "params_d", "rho", "nlml_lo", "nlml_d"):
        np.testing.assert_allclose(getattr(st, f).numpy(), w[f], atol=FIT_TOL, err_msg=f)
    mean, var = mt.predict_mf(COV, COV, st, T(xq))
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], atol=1e-7)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], atol=1e-7)


def test_predict_mf_on_jax_state_matches_jax(parity):
    (*_, xq, _), want = parity
    st = convert.mf_state_from_numpy(want["fit"], "cpu")
    mean, var = mt.predict_mf(COV, COV, st, T(xq))
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], rtol=1e-9)


def test_wrapper_and_rho_zero_reduction(parity):
    """ρ fixed at 0 by a zero low level makes stage 2 the hi-only GP's
    NLML (the JAX test's reduction); the wrapper trains as fit_mf."""
    (x_lo, y_lo, x_hi, y_hi, xq, p), want = parity
    st_lo = et.factorize(COV, T(p), T(x_lo), T(y_lo) * 0.0)
    v = mt.nlml_stage2(COV, T(p), torch.tensor(0.7, dtype=torch.float64), COV, st_lo, T(x_hi), T(y_hi))
    np.testing.assert_allclose(v.item(), gt.nlml(COV, T(p), T(x_hi), T(y_hi)).item(), rtol=RTOL)
    model = gt.MultiFidelityGP(x_lo, y_lo, x_hi, y_hi, COV, device="cpu")
    model.train(max_iter=40, params_lo0=p, params_d0=p)
    mean, var = model.predict(xq)
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], atol=1e-7)
    assert (var > 0).all()


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_problem():
    """chip_smoke.py's problem: d = 3 on [0, 2]³, 4096 low-fidelity and 512
    high-fidelity points of the AR(1) generator, f32."""
    x_lo, y_lo, x_hi, y_hi, _ = mf_problem(4096, 512, 3, hi=2.0)
    return [a.astype(np.float32) for a in (x_lo, y_lo, x_hi, y_hi)]


def _jax_run(dtype):
    from tests._jax_gaps import setup_jax

    dt = setup_jax(dtype)
    x_lo, y_lo, x_hi, y_hi = (jnp.asarray(a.astype(dt)) for a in smoke_problem())
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    p0 = jnp.asarray([1.0, 1.0, 1.0, 1.0, 0.1], dt)

    def f(q, r):
        st_lo = ej.factorize(cov, p0, x_lo, y_lo)
        return mj.nlml_stage2(cov, q, r, cov, st_lo, x_hi, y_hi)

    v, (gq, gr) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(p0, jnp.asarray(1.0, dt))
    return {"value": float(v), "grad": np.r_[np.asarray(gq, np.float64), float(gr)].tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
