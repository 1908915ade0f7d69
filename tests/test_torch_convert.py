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
