"""Port parity: the most-likely heteroscedastic GP against the JAX package.

The same seeded NumPy data (the JAX test's two-regime noise field at
n = 64) go through both packages in f64: the fixed point ``fit_hgp``, the
composed prediction and the learned noise on a JAX state carried across
by ``convert``, and the wrapper.  The JAX package's loop runs on the host;
the fixture runs each of its fits as one ``jax.jit`` of ``fit_mle`` a
kernel, and its ``factorize`` and ``predict`` likewise.  Below about n = 64 the round-0 homoscedastic fit collapses to the
interpolating mode (at n = 40: ℓ ≈ 1.9e3, σₙ ≈ 1e-3), where L-BFGS stops
on a flat ridge at a point that round-off sets, and the two packages part
there by up to 1e-5.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of the FixedNoise mean GP's NLML (value and gradient) on
``chip_smoke.py``'s problem (n = 4096, x ~ U(0, 4), y = sin(2x) + (0.05 +
0.1x)ε, the true noise variance in the noise column, θ = [1, 1]):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_heteroscedastic.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import heteroscedastic as ht
from pygpr_tpu.models import heteroscedastic as hj

#: fits (absolute, as tests/test_torch_slice.py), predictions on one state
FIT_TOL, RTOL = 1e-8, 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hgp_problem(n=64, seed=0):
    """The JAX test's two-regime field: noise std 0.05 left of x = 2, 0.4
    right of it, on sin(2x)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 4, n))[:, None]
    sd = np.where(x[:, 0] < 2.0, 0.05, 0.4)
    y = np.sin(2 * x[:, 0]) + sd * rng.normal(size=n)
    return x, y, np.linspace(0.2, 3.8, 9)[:, None]


KW = dict(n_rounds=2, max_iter=30)


def _jitted(fn, *static):
    """``fn`` compiled once for each value of its leading arguments
    ``static`` (the kernel, predict's variance mode, …)."""
    compiled = {}

    def call(*args, **kw):
        key = args[: len(static)] + tuple(sorted(kw.items()))
        if key not in compiled:
            compiled[key] = jax.jit(lambda *rest: fn(*args[: len(static)], *rest, **kw))
        return compiled[key](*args[len(static):])

    return call


@pytest.fixture(scope="module")
def parity():
    import types

    import pygpr_tpu.optimize.lbfgs as lj
    from pygpr_tpu.models import exact_gp as ej

    x, y, xq = hgp_problem()
    plain_fit, plain_exact = lj.fit_mle, hj.exact_gp
    lj.fit_mle = _jitted(plain_fit, "kern")
    fac = _jitted(lambda kern, config, p, xx, yy: ej.factorize(kern, p, xx, yy, config), "kern", "config")
    pred = _jitted(lambda kern, var, config, st, xp: ej.predict(kern, st, xp, var, config), "kern", "var", "config")
    hj.exact_gp = types.SimpleNamespace(factorize=lambda kern, p, xx, yy, config: fac(kern, config, p, xx, yy),
                                        predict=lambda kern, st, xp, var, config: pred(kern, var, config, st, xp))
    cm, cn = gj.RBF(), gj.Sum((gj.RBF(), gj.WhiteNoise()))
    try:
        st = hj.fit_hgp(x, jnp.asarray(y), **KW)
        obs = hj.predict_hgp(st, cm, cn, xq)
        lat = hj.predict_hgp(st, cm, cn, xq, observation=False)
    finally:
        lj.fit_mle, hj.exact_gp = plain_fit, plain_exact
    arrays = {f: getattr(st, f) for f in st._fields} | {"state_mean": st.state_mean._asdict(),
                                                         "state_noise": st.state_noise._asdict()}
    return (x, y, xq), jax.tree.map(np.asarray, arrays), jax.tree.map(np.asarray, (obs, lat))


def T(a):
    return torch.tensor(np.asarray(a))


def test_fit_hgp_matches_jax(parity):
    (x, y, _), want, _ = parity
    st = ht.fit_hgp(x, T(y), **KW)
    for f in ("noise_train", "params_mean", "params_noise"):
        np.testing.assert_allclose(getattr(st, f).numpy(), want[f], atol=FIT_TOL, err_msg=f)
    np.testing.assert_allclose(st.z_mean, float(want["z_mean"]), atol=FIT_TOL)


def test_predict_hgp_on_jax_state_matches_jax(parity):
    (_, _, xq), want, (obs, lat) = parity
    st = convert.hgp_state_from_numpy(want, "cpu")
    cm, cn = gt.RBF(), gt.Sum((gt.RBF(), gt.WhiteNoise()))
    for (m, v), (wm, wv) in ((ht.predict_hgp(st, cm, cn, xq), obs),
                             (ht.predict_hgp(st, cm, cn, xq, observation=False), lat)):
        np.testing.assert_allclose(m.numpy(), wm, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(v.numpy(), wv, rtol=1e-9)


def test_wrapper_trains_and_predicts_as_the_functions(parity):
    (x, y, xq), want, (obs, lat) = parity
    model = gt.HeteroscedasticGP(x, y, device="cpu")
    model.train(**KW)
    mean, var = model.predict(xq)
    np.testing.assert_allclose(mean.numpy(), obs[0], atol=1e-7)
    # the learned noise is the observation variance less the latent one
    np.testing.assert_allclose(model.noise_at(xq).numpy(), obs[1] - lat[1], atol=1e-7)


def test_fits_start_at_the_kernels_default_init_whatever_the_config(monkeypatch):
    """Each fit starts at its kernel's ``init_params(x)``, as the JAX
    package's fit_hgp does: ``config.noise_init`` does not reach the starts
    (the round-0 and noise-GP white noise start at the JAX default)."""
    import pygpr_torch.optimize.lbfgs as lt

    starts, plain = [], lt.fit_mle

    def record(kern, p0, x, y, **kw):
        starts.append((type(kern).__name__, p0.tolist()))
        return plain(kern, p0, x, y, **kw)

    monkeypatch.setattr(lt, "fit_mle", record)
    x, y, _ = hgp_problem(24)
    ht.fit_hgp(x, T(y), n_rounds=1, max_iter=2, config=gt.Config(noise_init=0.3))
    assert [k for k, _ in starts] == ["Sum", "Sum", "FixedNoise"]
    want = np.asarray(gj.Sum((gj.RBF(), gj.WhiteNoise())).init_params(jnp.asarray(x)))
    np.testing.assert_allclose(starts[0][1], want, rtol=1e-12)
    assert starts[0][1][-1] == starts[1][1][-1] == float(want[-1]) != 0.3


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_problem(n=4096, seed=3):
    """chip_smoke.py's problem: x ~ U(0, 4) in 1-D, y = sin(2x) + (0.05 +
    0.1x)ε, f32; also the true noise variance."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 4.0, (n, 1)).astype(np.float32)
    sd = 0.05 + 0.1 * x[:, 0]
    y = (np.sin(2.0 * x[:, 0]) + sd * rng.normal(size=n)).astype(np.float32)
    return x, y, (sd**2).astype(np.float32)


def _jax_run(dtype):
    from tests._jax_gaps import setup_jax
    from pygpr_tpu.models.likelihood import nlml
    from pygpr_tpu.ops.fixed_noise import FixedNoise, with_noise

    dt = setup_jax(dtype)
    x, y, nv = smoke_problem()
    xa, yj = jnp.asarray(with_noise(x, nv).astype(dt)), jnp.asarray(y.astype(dt))
    kern = FixedNoise(gj.RBF())
    v, g = jax.jit(jax.value_and_grad(lambda q: nlml(kern, q, xa, yj)))(jnp.ones(2, dt))
    return {"value": float(v), "grad": np.asarray(g, np.float64).tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
