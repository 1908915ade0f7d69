"""Port parity: the stage probe's block kernels (B7, B8) and ``probe``.

The port's plain versions of ``_micro_cholesky``, ``_micro_cholesky_masked``
and ``_tri_inverse`` (``pygpr_torch/bench/mfu_probe.py``) against the JAX
helpers on the same f32 blocks, made with NumPy from a seed (P = 2 blocks).
The JAX side runs once, under one ``jax.jit``, in a module fixture: the
value form's 16 unrolled mini-panels take about 6 s of XLA compile on a
CPU.  The kernels themselves run on the card only
(``tests/test_torch_cuda.py``).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygpr_torch.bench import mfu_probe as mp
from pygpr_tpu.ops.pallas_cholesky import _micro_cholesky, _micro_cholesky_masked, _tri_inverse

#: port against JAX, both f32 on the CPU: the same operations in the same
#: order, only the products' summation order (MKL against XLA) differs.
#: The factor's largest entry is 2.31 (an ulp 2.4e-7, measured gap 2.4e-7);
#: 1e-6 is about four of its ulps, where the f32 factor's own error against
#: f64 is 4.5e-7 (value form) and 1.0e-6 (masked form)
CHOL_ATOL = 1e-6
#: the inverse of tril(K) + 2I has largest entry 0.15 (an ulp 1.5e-8) and is
#: 1.1e-8 from f64; two of its ulps
TINV_ATOL = 3e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blocks():
    """Two SPD blocks K (as the probe's diagonal strip), two lower
    triangles tril(K) + 2I (its triangular strip), and the JAX results."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((2, 128, 128)).astype(np.float32)
    K = (A @ A.transpose(0, 2, 1) / 128 + 4.0 * np.eye(128, dtype=np.float32)).astype(np.float32)
    Lt = (np.tril(K) + 2.0 * np.eye(128, dtype=np.float32)).astype(np.float32)
    run = jax.jit(lambda k, lt: (jax.vmap(_micro_cholesky)(k), jax.vmap(_micro_cholesky_masked)(k),
                                 jax.vmap(_tri_inverse)(lt)))
    chol, chol_masked, tinv = (np.asarray(v) for v in run(jnp.asarray(K), jnp.asarray(Lt)))
    return dict(K=K, Lt=Lt, chol=chol, chol_masked=chol_masked, tinv=tinv)


def test_micro_cholesky_matches_jax(blocks):
    got = mp.micro_cholesky(torch.tensor(blocks["K"])).numpy()
    assert np.abs(got - blocks["chol"]).max() <= CHOL_ATOL
    assert (np.triu(got, 1) == 0).all()


def test_micro_cholesky_masked_matches_jax(blocks):
    got = mp.micro_cholesky_masked(torch.tensor(blocks["K"])).numpy()
    assert np.abs(got - blocks["chol_masked"]).max() <= CHOL_ATOL
    assert (np.triu(got, 1) == 0).all()


def test_tri_inverse_block_matches_jax(blocks):
    got = mp.tri_inverse_block(torch.tensor(blocks["Lt"])).numpy()
    assert np.abs(got - blocks["tinv"]).max() <= TINV_ATOL


def test_block_inverse_matches_jax_and_f64(blocks):
    """K6's blocking (32×32 diagonal tiles by triangular solves, two
    halving levels) against the JAX ``_tri_inverse`` in f32 within
    ``TINV_ATOL`` (measured 1.5e-8, one ulp of the largest entry), and
    against the port's copy of it, ``tri_inverse_block``, in f64 to 1e-12:
    the same inverse by another blocking.  Only the lower triangle is read."""
    Lt = blocks["Lt"]
    got = mp.block_inverse(torch.tensor(Lt)).numpy()
    assert np.abs(got - blocks["tinv"]).max() <= TINV_ATOL
    assert (np.triu(got, 1) == 0).all()
    Lt64 = torch.tensor(Lt, dtype=torch.float64)
    np.testing.assert_allclose(mp.block_inverse(Lt64).numpy(), mp.tri_inverse_block(Lt64).numpy(), rtol=0, atol=1e-12)
    upper_nan = Lt + np.triu(np.full((128, 128), np.nan, np.float32), 1)
    assert np.array_equal(mp.block_inverse(torch.tensor(upper_nan)).numpy(), got)


@pytest.mark.parametrize("which", ["pivots", "tinv"])
def test_strip_wrappers_take_the_plain_versions_on_the_cpu(blocks, which):
    if which == "pivots":
        strip, fn, plain, src = blocks["K"], mp.pivots_strip, mp.micro_cholesky, blocks["K"]
    else:
        strip, fn, plain, src = blocks["Lt"], mp.tinv_strip, mp.tri_inverse_block, blocks["Lt"]
    before = fn.launches
    got = fn(torch.tensor(strip.reshape(256, 128)))
    assert fn.launches == before  # no kernel on the CPU
    assert got.shape == (256, 128)
    assert torch.equal(got.reshape(2, 128, 128), plain(torch.tensor(src)))


def test_indefinite_block_gives_nan_in_that_block_only(blocks):
    strip = blocks["K"].copy()
    strip[1] = -strip[1]
    L = mp.pivots_strip(torch.tensor(strip.reshape(256, 128))).reshape(2, 128, 128).numpy()
    lower = np.tril(np.ones((128, 128), bool))
    assert np.isfinite(L[0]).all()
    assert np.isnan(L[1][lower]).all()


@pytest.mark.parametrize("fn", [mp.pivots_strip, mp.tinv_strip])
@pytest.mark.parametrize("shape", [(200, 128), (256, 64), (0, 128), (2, 128, 128)])
def test_strip_wrappers_raise_on_other_shapes(fn, shape):
    with pytest.raises(ValueError):
        fn(torch.zeros(shape))


def test_library_route_computes_the_nlml_and_its_gradient():
    """The probe's library route (``full_fast_vg_library``) against
    ``nlml_value_and_grad`` in f64 at n = 256, the probe's data: the same
    function, by another order of operations (a block-doubling inverse
    and TᵀT instead of the ladder's solves)."""
    import pygpr_torch as gp

    cov, p, x, y = (a if i == 0 else a.double() for i, a in enumerate(mp.probe_data(256, "cpu")))
    v, g = mp._library_value_and_grad(cov, p, x, y)
    v_ref, g_ref = gp.nlml_value_and_grad(cov, p, x, y)
    assert abs(v.item() - v_ref.item()) <= 1e-10 * abs(v_ref.item())
    assert torch.linalg.norm(g - g_ref).item() <= 1e-10 * torch.linalg.norm(g_ref).item()


def test_library_route_gives_nan_where_cholesky_fails():
    class Indefinite:
        """A covariance whose gram is −I."""

        def matrix(self, params, x):
            return -torch.eye(x.shape[0], dtype=x.dtype)

        def gram_adjoint(self, params, x, Abar):
            return torch.zeros_like(params)

    x = torch.zeros((256, 1), dtype=torch.float64)
    v, _ = mp._library_value_and_grad(Indefinite(), torch.ones(2, dtype=torch.float64), x, x[:, 0])
    assert torch.isnan(v)


def test_probe_emits_the_nine_stages(capsys):
    recs = mp.probe(256, reps=1, device="cpu")
    names = ["full_fast_vg_cuda", "full_fast_vg_library", "fused_chol_inverse_cuda", "cholesky_library",
             "pivot_chain_only", "block_tri_inverse_only", "syrk_from_tril", "gram_build", "attribution"]
    assert [r["probe"] for r in recs] == names
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == recs
    for r in recs[:-1]:
        assert math.isfinite(r["ms"]) and r["ms"] > 0
    assert recs[4]["panels"] == recs[5]["panels"] == 2
