"""Port parity: the plain version of kernel K3 (batched Cholesky) against
the JAX package's two Pallas Cholesky kernels, and the jitter ladder's
routing to it.

Inputs are made with NumPy from a seed.  ``cholesky_pallas`` runs in
interpret mode through the same patch of ``pl.pallas_call`` that
``tests/test_torch_kernels.py`` uses, once and at its smallest padded
size: its fully unrolled body takes seconds to compile on the CPU.  ``cholesky_pallas_batched`` takes
``interpret=True`` itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pygpr_torch as gt
from pygpr_torch.ops import chol_batched, linalg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, shape):
    n = shape[-1]
    A = rng.standard_normal(shape)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_plain_matches_cholesky_pallas(rng, monkeypatch):
    """A ragged matrix ([100, 100], which the Pallas kernel pads to 128
    with an identity tail) in f32: within test_pallas.py's 2e-4·n of the
    Pallas kernel and of f64."""
    import pygpr_tpu.ops.pallas_cholesky as pc

    orig = pl.pallas_call
    monkeypatch.setattr(pc.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    K = _spd(rng, (100, 100)).astype(np.float32)
    L = chol_batched.cholesky_batched(torch.tensor(K)).numpy()
    Lj = np.asarray(pc.cholesky_pallas(jnp.asarray(K)))
    tol = 2e-4 * 100
    np.testing.assert_allclose(L, Lj, atol=tol)
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), atol=tol)
    assert np.all(np.triu(L, 1) == 0.0)


def test_plain_matches_cholesky_pallas_batched(rng):
    from pygpr_tpu.ops.pallas_cholesky import cholesky_pallas_batched

    K = _spd(rng, (2, 256, 256)).astype(np.float32)
    L = chol_batched.cholesky_batched(torch.tensor(K)).numpy()
    Lj = np.asarray(cholesky_pallas_batched(jnp.asarray(K), interpret=True))
    np.testing.assert_allclose(L, Lj, atol=2e-4 * 256)
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), atol=2e-4 * 256)


@pytest.mark.parametrize(
    "shape",
    [(200, 200), (3, 256, 256), (1, 1), (2, 64, 64),
     # B5's domain at 3 and 5 outer panels of 128, and a stack beside it
     # (320 % 128 != 0) that keeps the 64-wide sweep
     (3, 384, 384), (2, 640, 640), (2, 320, 320)],
)
def test_plain_f64_is_exact(shape, rng):
    K = _spd(rng, shape)
    Kt = torch.tensor(K)
    L = chol_batched.cholesky_batched(Kt)
    assert L.shape == Kt.shape
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), rtol=1e-12, atol=1e-12)
    assert torch.equal(Kt, torch.tensor(K))  # the caller's K is not written


def test_plain_nan_stays_in_its_matrix(rng):
    K = torch.tensor(_spd(rng, (4, 70, 70)), dtype=torch.float32)
    K[2] = -torch.eye(70)
    L = chol_batched.cholesky_batched(K)
    lower = torch.ones(70, 70, dtype=torch.bool).tril()
    assert torch.isnan(L[2][lower]).all()
    for i in (0, 1, 3):
        torch.testing.assert_close(L[i], chol_batched.cholesky_batched(K[i]), rtol=1e-6, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        chol_batched.cholesky_batched_cuda(torch.eye(64))


@pytest.mark.parametrize(
    "shape,dtype,routed",
    [
        ((1024, 1024), torch.float32, True),      # cholesky_pallas
        ((1, 1), torch.float32, True),
        ((1152, 1152), torch.float32, False),     # one matrix above 1024
        ((2, 1152, 1152), torch.float32, True),   # cholesky_pallas_batched
        ((2, 1100, 1100), torch.float32, False),  # large and unaligned
        ((1, 1152, 1152), torch.float32, False),  # no batch to amortize over
        ((3, 100, 100), torch.float32, True),     # cholesky_pallas under vmap
        ((2, 3, 100, 100), torch.float32, True),
        ((64, 64), torch.float64, False),         # f64 stays on cholesky_ex
    ],
)
def test_ladder_routing_rule(shape, dtype, routed):
    K = torch.empty(shape, dtype=dtype)
    assert linalg.batched_kernel_takes(K) == routed


@pytest.mark.parametrize("shape,dtype", [((2, 3, 40, 40), torch.float32), ((40, 40), torch.float64)])
def test_ladder_goes_through_the_kernel_by_the_rule(shape, dtype, rng, monkeypatch):
    """f32 goes through K3's plain version on the CPU (leading axes
    flattened into one batch), f64 through cholesky_ex; both factor."""
    calls = []
    plain = chol_batched.cholesky_batched_plain
    monkeypatch.setattr(chol_batched, "cholesky_batched_plain", lambda K: calls.append(K.shape) or plain(K))
    K = torch.tensor(_spd(rng, shape), dtype=dtype)
    res = gt.safe_cholesky(K)
    assert calls == ([(6, 40, 40)] if dtype == torch.float32 else [])
    assert res.chol.shape == K.shape and bool(res.ok.all())
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(res.chol @ res.chol.mT, linalg.add_diag(K, res.jitter), rtol=tol, atol=tol * 40)


def test_f32_ladder_escalates_each_matrix_on_its_own(rng):
    """A stack where one gram is exactly singular (duplicated points, bare
    RBF) and shifted to a least eigenvalue of −5e-4: through the plain
    kernel each matrix keeps its own rung, that one 1e-3 as in
    ``tests/test_torch_linalg.py``'s JAX case, and its factor is the f64
    factor of the jittered matrix."""
    x = rng.uniform(0, 2, size=(3, 30, 2))
    x[1, 15:] = x[1, :15]
    K = gt.RBF().matrix(torch.ones(3, dtype=torch.float64), torch.tensor(x[1]))
    eye = torch.eye(30, dtype=torch.float64)
    K = torch.stack([K + 0.1 * eye, K - 5e-4 * eye, K + 0.2 * eye])
    got = gt.safe_cholesky(K.float())
    np.testing.assert_allclose(got.jitter.numpy(), [1e-7, 1e-3, 1e-7], rtol=1e-6)
    np.testing.assert_array_equal(got.ok.numpy(), [1.0, 1.0, 1.0])
    want = np.linalg.cholesky(linalg.add_diag(K, got.jitter.double()).numpy())
    np.testing.assert_allclose(got.chol.numpy(), want, atol=2e-4 * 30)


def test_plain_diag_block_in_two_tiles(rng):
    """The plain version's 64-wide diagonal block, factored as 2×2 tiles of
    32 (D00, D10 = A10 D00⁻ᵀ by substitution, A11 − D10 D10ᵀ, D11), in
    f64: the Cholesky factor to round-off, and ``B D⁻ᵀ`` by the
    substitution it uses for D10."""
    A = _spd(rng, (2, 64, 64))
    B = rng.standard_normal((2, 96, 32))
    D = chol_batched._factor_diag(torch.tensor(A))
    np.testing.assert_allclose(D.numpy(), np.linalg.cholesky(A), rtol=1e-12, atol=1e-12)
    D00 = D[:, :32, :32]
    X = chol_batched._solve_rows(torch.tensor(B), D00).numpy()
    want = np.linalg.solve(D00.numpy(), np.swapaxes(B, -1, -2)).swapaxes(-1, -2)
    np.testing.assert_allclose(X, want, rtol=1e-10, atol=1e-12)
