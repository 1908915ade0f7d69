"""Port parity: the Student-t process against the JAX package.

The same seeded NumPy data go through both packages in f64: the TP NLML
and its gradient in the kernel parameters and ν, the predictive moments
and NLPD on a JAX state carried across by ``convert``, the joint L-BFGS
fit and the wrapper.  The JAX side runs once, under one ``jax.jit``, in a
module fixture.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU of ``nlml_tp`` (value and gradient) at the start of
``chip_smoke.py``'s TP fit (``make_data(4096, 3)``, ν₀ = 5), the
yardstick of the card's limits:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tprocess.py [n]
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import tprocess as tt
from pygpr_tpu.models import exact_gp as ej
from pygpr_tpu.models import tprocess as tj

#: closed forms against the JAX package (relative), fits (absolute on
#: parameters, as tests/test_torch_slice.py)
RTOL, FIT_TOL = 1e-10, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=40, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2, (n, d))
    y = np.sin(2 * x.sum(-1)) + 0.1 * rng.standard_t(3, size=n)
    xq = rng.uniform(0, 2, (9, d))
    yq = np.sin(2 * xq.sum(-1))
    return x, y, xq, yq, np.array([1.1, 0.9, 1.2, 0.2])


@pytest.fixture(scope="module")
def parity():
    x, y, xq, yq, p = _data()
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def run(x, y, xq, yq, p):
        out = {}
        out["nlml"], (out["g_p"], out["g_nu"]) = jax.value_and_grad(
            lambda q, nu: tj.nlml_tp(cov, q, nu, x, y), argnums=(0, 1))(p, 4.5)
        out["nlml_big_nu"] = tj.nlml_tp(cov, p, 1e7, x, y)
        st = ej.factorize(cov, p, x, y)
        out["state"] = st._asdict()
        out["mean"], out["cov_diag"], out["dof"] = tj.predict_tp(cov, st, 4.5, xq, "diag")
        _, out["cov_full"], _ = tj.predict_tp(cov, st, 4.5, xq, "full")
        out["nlpd"] = tj.nlpd_tp(out["mean"], out["cov_diag"], out["dof"], yq)
        res = tj.fit_tp(cov, x, y, p, 5.0, max_iter=40)
        out["fit"] = res._asdict() | {"state": res.state._asdict()}
        return out

    want = jax.jit(run)(*map(jnp.asarray, (x, y, xq, yq, p)))
    return (x, y, xq, yq, p), jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


COV = gt.Sum((gt.RBF(), gt.WhiteNoise()))


def test_nlml_tp_value_and_gradient_match_jax(parity):
    (x, y, _, _, p), want = parity
    q, nu = T(p).requires_grad_(True), torch.tensor(4.5, dtype=torch.float64, requires_grad=True)
    v = tt.nlml_tp(COV, q, nu, T(x), T(y))
    gq, gnu = torch.autograd.grad(v, (q, nu))
    np.testing.assert_allclose(v.item(), want["nlml"], rtol=RTOL)
    np.testing.assert_allclose(gq.numpy(), want["g_p"], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(gnu.item(), want["g_nu"], rtol=1e-9)


def test_nlml_tp_tends_to_the_gaussian_nlml(parity):
    """ν → ∞: the TP NLML is the exact GP's (the JAX test's limit)."""
    (x, y, _, _, p), want = parity
    v = tt.nlml_tp(COV, T(p), 1e7, T(x), T(y)).item()
    # the two gammaln terms are near 8e7 and cancel: their round-off is
    # ε·8e7 ≈ 2e-8 absolute
    np.testing.assert_allclose(v, want["nlml_big_nu"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(v, gt.nlml(COV, T(p), T(x), T(y)).item(), rtol=1e-5)


def test_predict_and_nlpd_on_jax_state_match_jax(parity):
    (_, _, xq, yq, _), want = parity
    st = convert.state_from_numpy(want["state"], "cpu")
    mean, cd, dof = tt.predict_tp(COV, st, 4.5, T(xq), "diag")
    _, cf, _ = tt.predict_tp(COV, st, 4.5, T(xq), "full")
    np.testing.assert_allclose(mean.numpy(), want["mean"], rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(cd.numpy(), want["cov_diag"], rtol=1e-9)
    np.testing.assert_allclose(cf.numpy(), want["cov_full"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dof.item(), want["dof"], rtol=RTOL)
    np.testing.assert_allclose(tt.nlpd_tp(mean, cd, dof, T(yq)).item(), want["nlpd"], rtol=1e-9)


def test_fit_tp_matches_jax_and_carries_across(parity):
    (x, y, xq, _, p), want = parity
    res = tt.fit_tp(COV, T(x), T(y), T(p), 5.0, max_iter=40)
    w = want["fit"]
    np.testing.assert_allclose(res.params.numpy(), w["params"], atol=FIT_TOL)
    np.testing.assert_allclose(res.nu.item(), w["nu"], atol=FIT_TOL)
    np.testing.assert_allclose(res.nlml.item(), w["nlml"], atol=FIT_TOL)
    carried = convert.tp_result_from_numpy(w, "cpu")
    m1, c1, _ = tt.predict_tp(COV, carried.state, carried.nu, T(xq))
    m2, c2, _ = tt.predict_tp(COV, res.state, res.nu, T(xq))
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=1e-7)
    np.testing.assert_allclose(c1.numpy(), c2.numpy(), atol=1e-7)


def test_wrapper_trains_and_predicts_as_the_functions(parity):
    (x, y, xq, _, p), want = parity
    tp = gt.TProcess(x, y, COV, nu=5.0, params=p, device="cpu")
    tp.train(max_iter=40)
    np.testing.assert_allclose(tp.params.numpy(), want["fit"]["params"], atol=FIT_TOL)
    mean, cov, dof = tp.predict(xq)
    assert mean.shape == (9,) and cov.shape == (9,) and (cov > 0).all()
    assert dof.item() == pytest.approx(tp.nu + 40)


def test_f32_plain_path_and_device_policy():
    x, y, _, _, p = _data()
    v32 = tt.nlml_tp(COV, T(p).float(), 5.0, T(x).float(), T(y).float())
    v64 = tt.nlml_tp(COV, T(p), 5.0, T(x), T(y))
    assert v32.dtype == torch.float32
    assert abs(v32.item() - v64.item()) / abs(v64.item()) < 1e-4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gt.TProcess(x, y, COV)


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def smoke_data(n=4096, dim=3, seed=42):
    """chip_smoke.py's make_data (bench.py::make_data): f32 x and y."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _jax_run(dtype, n="4096"):
    from tests._jax_gaps import setup_jax

    dt = setup_jax(dtype)
    x, y = (jnp.asarray(a.astype(dt)) for a in smoke_data(int(n)))
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    p0 = jnp.asarray([1.0, 1.0, 1.0, 1.0, 0.1], dt)
    v, (gp_, gnu) = jax.jit(jax.value_and_grad(lambda q, nu: tj.nlml_tp(cov, q, nu, x, y), argnums=(0, 1)))(
        p0, jnp.asarray(5.0, dt))
    return {"value": float(v), "grad": np.r_[np.asarray(gp_, np.float64), float(gnu)].tolist()}


if __name__ == "__main__":
    from tests._jax_gaps import main

    main(__file__, _jax_run)
