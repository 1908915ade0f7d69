"""Port parity: the GPLVM against the JAX package.

The same seeded NumPy data go through both packages in f64: the PCA init
(bit for bit), the shared-gram NLML and its gradient in the kernel
parameters and the latents (also at a coincident pair of latents, where
RBF's squared distance has its straight-through clamp), the MAP fit, the
reconstruction from the JAX package's fit carried across by ``convert``,
and the wrapper.  The JAX side runs once, under one ``jax.jit``, in a
module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of the MAP objective (value and gradient in the latents
and log parameters) at the PCA latents of ``chip_smoke.py``'s GPLVM
problem (n = 1024, p = 12, q = 2, ``Sum(RBF, WhiteNoise)``) with θ = [1,
1, 1, 0.1] (the fit's all-ones start has σₙ = 1, a gram too well
conditioned for its f32 gap to be more than the sums' round-off):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gplvm.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import gplvm as vt
from pygpr_tpu.models import gplvm as vj

RTOL, FIT_TOL = 1e-10, 1e-8
FIT_ITERS = 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def latent_problem(n=32, p=5, q=2, seed=0, noise=0.05):
    """A q-dimensional latent through a fixed random tanh map into p
    outputs, plus noise (NumPy, f64)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, q))
    w, b = rng.normal(size=(q, p)), 0.3 * rng.normal(size=p)
    return np.tanh(z @ w + b) + noise * rng.normal(size=(n, p))


@pytest.fixture(scope="module")
def parity():
    y = latent_problem()
    x0 = vj.pca_init(y, 2)
    xc = x0.copy()
    xc[1] = xc[0]                                         # a coincident pair
    p = np.array([1.1, 0.8, 1.2, 0.15])
    kern = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def run(y, x0, xc, p):
        out = {}
        out["nlml"], (out["g_p"], out["g_x"]) = jax.value_and_grad(
            lambda q, x: vj.nlml_multi(kern, q, x, y), argnums=(0, 1))(p, x0)
        out["nlml_c"], out["g_xc"] = jax.value_and_grad(lambda x: vj.nlml_multi(kern, p, x, y))(xc)
        res = vj.fit(kern, y, 2, x0=x0, max_iter=FIT_ITERS)
        out["fit"] = res._asdict()
        out["rec"] = vj.reconstruct(kern, res.params, res.latents, y)
        out["rec_q"] = vj.reconstruct(kern, res.params, res.latents, y, res.latents[:5] + 0.1)
        return out

    want = jax.jit(run)(*map(jnp.asarray, (y, x0, xc, p)))
    return (y, x0, xc, p), jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


KERN = gt.Sum((gt.RBF(), gt.WhiteNoise()))


def test_pca_init_bit_equal(parity):
    (y, x0, _, _), _ = parity
    assert np.array_equal(vt.pca_init(y, 2), x0)
    assert np.array_equal(vt.pca_init(T(y), 3), vj.pca_init(y, 3))


def test_nlml_multi_value_and_gradients_match_jax(parity):
    (y, x0, _, p), want = parity
    q, x = T(p).requires_grad_(True), T(x0).requires_grad_(True)
    v = vt.nlml_multi(KERN, q, x, T(y))
    gq, gx = torch.autograd.grad(v, (q, x))
    np.testing.assert_allclose(v.item(), want["nlml"], rtol=RTOL)
    np.testing.assert_allclose(gq.numpy(), want["g_p"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gx.numpy(), want["g_x"], rtol=1e-9, atol=1e-11)


def test_latent_gradient_at_a_coincident_pair_matches_jax(parity):
    (y, _, xc, p), want = parity
    x = T(xc).requires_grad_(True)
    v = vt.nlml_multi(KERN, T(p), x, T(y))
    (gx,) = torch.autograd.grad(v, x)
    np.testing.assert_allclose(v.item(), want["nlml_c"], rtol=RTOL)
    np.testing.assert_allclose(gx.numpy(), want["g_xc"], rtol=1e-9, atol=1e-11)


def test_fit_matches_jax_and_reconstructs_from_the_jax_fit(parity):
    (y, x0, _, _), want = parity
    res = vt.fit(KERN, T(y), 2, x0=T(x0), max_iter=FIT_ITERS)
    w = want["fit"]
    np.testing.assert_allclose(res.latents.numpy(), w["latents"], atol=FIT_TOL)
    np.testing.assert_allclose(res.params.numpy(), w["params"], atol=FIT_TOL)
    np.testing.assert_allclose(res.value.item(), w["value"], atol=FIT_TOL)
    carried = convert.gplvm_result_from_numpy(w, "cpu")
    mean, var = vt.reconstruct(KERN, carried.params, carried.latents, T(y))
    np.testing.assert_allclose(mean.numpy(), want["rec"][0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var.numpy(), want["rec"][1], rtol=1e-9)
    mean, var = vt.reconstruct(KERN, carried.params, carried.latents, T(y), carried.latents[:5] + 0.1)
    np.testing.assert_allclose(mean.numpy(), want["rec_q"][0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var.numpy(), want["rec_q"][1], rtol=1e-9)


def test_wrapper_trains_from_pca(parity):
    (y, _, _, _), want = parity
    model = gt.GPLVM(y, q=2, device="cpu").train(max_iter=FIT_ITERS)
    np.testing.assert_allclose(model.latents.numpy(), want["fit"]["latents"], atol=FIT_TOL)
    mean, var = model.reconstruct()
    assert mean.shape == y.shape and (var > 0).all()


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_problem():
    """chip_smoke.py's GPLVM problem: n = 1024, p = 12, q = 2, f32 (the
    size of the oil-flow set, 1000 × 12, rounded to 1024)."""
    return latent_problem(1024, 12, 2, seed=8).astype(np.float32)


def _jax_run(dtype):
    from tests._jax_gaps import setup_jax

    dt = setup_jax(dtype)
    y = smoke_problem()
    x0 = vj.pca_init(y.astype(np.float64), 2).astype(dt)
    yj = jnp.asarray(y.astype(dt))
    kern = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def objective(u):
        x, th = u[: 1024 * 2].reshape(1024, 2), jnp.exp(u[1024 * 2:])
        return vj.nlml_multi(kern, th, x, yj) + 0.5 * jnp.sum(jnp.square(x))

    u0 = jnp.concatenate([jnp.asarray(x0).reshape(-1), jnp.log(jnp.asarray([1.0, 1.0, 1.0, 0.1], dt))])
    v, g = jax.jit(jax.value_and_grad(objective))(u0)
    return {"value": float(v), "grad": np.asarray(g, np.float64).tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
