"""Carrying the JAX package's state into the port (``pygpr_torch.convert``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tinv", [False, True])
def test_jax_state_predicts_the_same_in_the_port(tinv, rng):
    """A JAX-factorized GPState, carried over field by field as NumPy,
    predicts what the JAX package predicts."""
    cj = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    x = rng.uniform(0, 2, size=(50, 2))
    y = np.sin(2 * x.sum(-1)) + 0.1 * rng.normal(size=50)
    xs = rng.uniform(0, 2, size=(12, 2))
    p = np.array([1.3, 0.8, 1.2, 0.1])

    def run(p, x, y, xs):
        s = gj.factorize(cj, p, x, y)
        if tinv:
            s = gj.precompute_tinv(s)
        return s, gj.predict(cj, s, xs, "full"), gj.predict(cj, s, xs, "diag")

    sj, full, diag = jax.jit(run)(*(jnp.asarray(a) for a in (p, x, y, xs)))
    st = convert.state_from_numpy({k: None if v is None else np.asarray(v) for k, v in sj._asdict().items()}, "cpu")
    assert (st.tinv is not None) == tinv
    ct = convert.kernel_from_names(*(type(k).__name__ for k in cj.kernels))
    assert ct == gt.Sum((gt.RBF(), gt.WhiteNoise()))
    for var, (mj, vj) in (("full", full), ("diag", diag)):
        mt, vt = gt.predict(ct, st, xs, var)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8, atol=1e-8)


def test_params_from_numpy():
    p = np.array([1.0, 0.5, 0.1], np.float32)
    t = convert.params_from_numpy(p, "cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert convert.params_from_numpy(p, "cpu", torch.float64).dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), p)


def test_kernel_from_names():
    assert convert.kernel_from_names("RBF") == gt.RBF()
    assert convert.kernel_from_names("RBF", "WhiteNoise") == gt.Sum((gt.RBF(), gt.WhiteNoise()))
    with pytest.raises(ValueError):
        convert.kernel_from_names("Matern")
    with pytest.raises(ValueError):
        convert.kernel_from_names()


def test_state_from_numpy_requires_every_field():
    with pytest.raises(ValueError, match="missing"):
        convert.state_from_numpy({"x": np.zeros((2, 1))}, "cpu")


def test_jax_committee_state_and_fit_info_come_across(rng):
    """A JAX committee's batched GPState and grBCM FitInfo, as NumPy,
    serve the same committee prediction in the port."""
    from pygpr_torch.models import grbcm as gbt
    from pygpr_tpu.models import grbcm as gbj

    cj = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    xl, xg, xs = rng.uniform(0, 2, size=(3, 15, 2)), rng.uniform(0, 2, size=(8, 2)), rng.uniform(0, 2, size=(6, 2))
    yl, yg = np.sin(2 * xl.sum(-1)), np.sin(2 * xg.sum(-1))
    info = gbj.FitInfo(
        params_g=np.array([1.1, 0.9, 1.2, 0.1]), params_l=np.tile([1.0, 1.1, 0.8, 0.2], (3, 1)),
        nlml_g=np.array(1.0), nlml_l=np.ones(3), ok_l=np.array([True, True, False]),
    )

    def run(xl, yl, xg, yg, xs):
        x_aug, y_aug = gbj.augment(xl, yl, xg, yg)
        sg = gj.factorize(cj, info.params_g, xg, yg)
        sl = gj.factorize(cj, info.params_l, x_aug, y_aug)
        return sg, sl, gbj.predict(cj, info.params_g, info.params_l, sg, sl, xs, "diag", mask=info.ok_l)

    sg, sl, want = jax.jit(run)(*(jnp.asarray(a) for a in (xl, yl, xg, yg, xs)))
    ft = convert.fit_info_from_numpy(info._asdict(), "cpu")
    sg_t, sl_t = (convert.state_from_numpy({k: None if v is None else np.asarray(v) for k, v in s._asdict().items()}, "cpu")
                  for s in (sg, sl))
    assert sl_t.chol.shape == (3, 23, 23)
    ct = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    got = gbt.predict(ct, ft.params_g, ft.params_l, sg_t, sl_t, torch.tensor(xs), "diag", mask=ft.ok_l)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8, atol=1e-8)
    with pytest.raises(ValueError):
        convert.fit_info_from_numpy({"params_g": info.params_g}, "cpu")
