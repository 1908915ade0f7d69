"""Port parity: laddered Cholesky, solves and triangular inverses against
the JAX package on the CPU (f64 unless said otherwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch.ops import linalg as tl
from pygpr_tpu.ops import linalg as jl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, n, batch=()):
    A = rng.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def test_ladder_per_matrix_matches_jax(rng):
    """A batch where one gram is exactly singular (duplicated points,
    bare RBF) and shifted to a least eigenvalue of −5e-4: each matrix
    escalates on its own rung (that one to 1e-3), as in JAX."""
    x = rng.uniform(0, 2, size=(3, 30, 2))
    x[1, 15:] = x[1, :15]
    p = np.array([1.0, 1.0, 1.0])
    K = np.array(gj.kernel_matrix(gj.RBF(), jnp.asarray(p), jnp.asarray(x)))
    K[1] -= 5e-4 * np.eye(30)
    want = jax.jit(jl.safe_cholesky)(jnp.asarray(K))
    got = tl.safe_cholesky(torch.tensor(K))
    np.testing.assert_allclose(got.jitter.numpy(), np.asarray(want.jitter), rtol=1e-12)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert got.jitter[1] > got.jitter[0] == got.jitter[2]
    np.testing.assert_allclose(got.chol.numpy(), np.asarray(want.chol), rtol=1e-9, atol=1e-9)


def test_ladder_failure_gives_nan():
    got = tl.safe_cholesky(-torch.eye(4, dtype=torch.float64))
    assert got.ok.item() == 0.0
    assert torch.isnan(got.chol).all()


def test_safe_cholesky_backward_matches_jax(rng):
    """The Murray backward against JAX's custom JVP, through a gram."""
    x = rng.uniform(0, 2, size=(25, 2))
    p = np.array([1.1, 0.8, 1.3, 0.2])
    w = rng.standard_normal((25, 25))
    cj = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    ct = gt.Sum((gt.RBF(), gt.WhiteNoise()))

    def fj(q):
        return jnp.sum(jnp.asarray(w) * jl.safe_cholesky(cj.matrix(q, jnp.asarray(x))).chol)

    want = jax.jit(jax.grad(fj))(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    val = torch.sum(torch.tensor(w) * tl.safe_cholesky(ct.matrix(pt, torch.tensor(x))).chol)
    (got,) = torch.autograd.grad(val, pt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fn", ["cholesky_solve", "solve_lower", "solve_lower_t"])
@pytest.mark.parametrize("rhs", ["vec", "mat"])
def test_solves_match_jax(fn, rhs, rng):
    K = _spd(rng, 20)
    L = np.linalg.cholesky(K)
    b = rng.standard_normal(20 if rhs == "vec" else (20, 3))
    want = jax.jit(getattr(jl, fn))(jnp.asarray(L), jnp.asarray(b))
    got = getattr(tl, fn)(torch.tensor(L), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def test_logdets_inverse_and_spd_solve_match_jax(rng):
    K = _spd(rng, 20, (2,))
    L = np.linalg.cholesky(K)
    b = rng.standard_normal((2, 20))
    Lt, Lj = torch.tensor(L), jnp.asarray(L)
    want = jax.jit(lambda L, K, b: (
        jl.logdet_from_chol(L), jl.half_logdet_from_chol(L), jl.inv_from_chol(L),
        jl.spd_solve(K, b), jl.add_diag(K, 0.5),
    ))(Lj, jnp.asarray(K), jnp.asarray(b))
    got = (
        tl.logdet_from_chol(Lt), tl.half_logdet_from_chol(Lt), tl.inv_from_chol(Lt),
        tl.spd_solve(torch.tensor(K), torch.tensor(b)), tl.add_diag(torch.tensor(K), 0.5),
    )
    for got, want in zip(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [100, 256, 300])
def test_tri_inverse_doubling_matches_jax(n, rng):
    L = np.linalg.cholesky(_spd(rng, n))
    got = tl.tri_inverse_doubling(torch.tensor(L))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(jl.tri_inverse_doubling)(jnp.asarray(L))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.numpy() @ L, np.eye(n), atol=1e-12)


@pytest.mark.parametrize("n", [64, 200])
def test_syrk_from_tril_matches_jax(n, rng):
    T = np.tril(rng.standard_normal((n, n)))
    got = tl.syrk_from_tril(torch.tensor(T), base=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.syrk_from_tril(jnp.asarray(T), base=48)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), T.T @ T, rtol=1e-12, atol=1e-12)


def test_chol_and_tri_inverse_f64_matches_jax(rng):
    K = _spd(rng, 96)
    Lj, Tj = jax.jit(jl.chol_and_tri_inverse)(jnp.asarray(K))
    Lt, Tt = tl.chol_and_tri_inverse(torch.tensor(K))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=1e-10, atol=1e-12)


def test_chol_and_tri_inverse_f32_ladder_through_fused_plain(rng):
    """An f32 [256, 256] takes the fused kernel's path (its plain version
    on the CPU).  An exactly singular gram (duplicated points, bare RBF)
    fails rung 0 and comes out finite on a later rung, with T·L = I."""
    x = rng.uniform(0, 2, size=(256, 2))
    x[128:] = x[:128]
    K = gt.RBF().matrix(torch.tensor([1.0, 1.0, 1.0]), torch.tensor(x)).float()
    L, T = tl.chol_and_tri_inverse(K)
    assert torch.isfinite(L).all() and torch.isfinite(T).all()
    jitter = (L @ L.T - K).diagonal().mean().item()
    assert 1e-5 < jitter < 1e-1
    eye = np.eye(256)
    np.testing.assert_allclose((T.double() @ L.double()).numpy(), eye, atol=5e-3)


@pytest.mark.parametrize(
    "shape,dtype,routed",
    [
        ((1152, 1152), torch.float32, True),      # one f32 gram above 1024: K2
        ((4096, 4096), torch.float32, True),
        ((1024, 1024), torch.float32, False),     # K3's (the first rule)
        ((1100, 1100), torch.float32, False),     # unaligned: the library
        ((2, 1152, 1152), torch.float32, False),  # a stack: K3's
        ((1, 1152, 1152), torch.float32, False),  # a leading axis: the library
        ((1152, 1152), torch.float64, False),
    ],
)
def test_ladder_second_routing_rule(shape, dtype, routed):
    assert tl.fused_kernel_takes(torch.empty(shape, dtype=dtype)) == routed


def test_safe_cholesky_f32_above_1024_goes_through_fused_plain(rng, monkeypatch):
    """A single f32 [1152, 1152] gram, exactly singular (duplicated points,
    bare RBF) and shifted to a least eigenvalue of −5e-4, takes K2's path
    (its plain version on the CPU) at every rung it tries, escalates to the
    JAX package's rung for the same f32 gram (1e-3), and its factor is that
    of the jittered matrix."""
    from pygpr_torch.ops import chol_inverse

    calls = []
    plain = chol_inverse.cholesky_inverse_plain
    monkeypatch.setattr(chol_inverse, "cholesky_inverse_plain", lambda K: calls.append(K.shape) or plain(K))
    x = rng.uniform(0, 2, size=(1152, 2))
    x[576:] = x[:576]
    p = np.array([1.0, 1.0, 1.0])
    K = np.asarray(gj.kernel_matrix(gj.RBF(), jnp.asarray(p), jnp.asarray(x)) - 5e-4 * np.eye(1152), np.float32)
    want = jax.jit(jl.safe_cholesky)(jnp.asarray(K))
    got = tl.safe_cholesky(torch.tensor(K))
    assert got.ok.item() == 1.0 and len(calls) > 1 and set(calls) == {(1152, 1152)}
    np.testing.assert_allclose(got.jitter.item(), float(want.jitter), rtol=1e-6)
    L = got.chol.double()
    A = torch.tensor(K, dtype=torch.float64) + got.jitter.item() * torch.eye(1152, dtype=torch.float64)
    assert torch.linalg.matrix_norm(L @ L.T - A) / torch.linalg.matrix_norm(A) < 1e-6
