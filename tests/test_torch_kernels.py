"""Port parity: covariance kernels and the plain versions of the two
hand-written CUDA kernels against the JAX package on the CPU.

Inputs are made with NumPy from a seed and fed to both packages.  The
Pallas kernels run in interpret mode through the same patch of
``pl.pallas_call`` that ``tests/test_pallas.py`` uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import pygpr_torch as gt
import pygpr_tpu as gj
import pygpr_tpu.ops.pallas_kernels as pk
from pygpr_torch.ops import chol_inverse, gram


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pk.pl, "pallas_call", interp_call)


KERNELS = {
    "rbf": (gj.RBF, gt.RBF, lambda d: np.r_[1.3, np.linspace(0.7, 1.2, d)]),
    "noise": (gj.WhiteNoise, gt.WhiteNoise, lambda d: np.array([0.3])),
    "sum": (
        lambda: gj.Sum((gj.RBF(), gj.WhiteNoise())),
        lambda: gt.Sum((gt.RBF(), gt.WhiteNoise())),
        lambda d: np.r_[1.3, np.linspace(0.7, 1.2, d), 0.3],
    ),
}


def _data(rng, n=40, d=3):
    return rng.uniform(0.0, 2.0, size=(n, d))


@pytest.fixture(scope="module")
def parity():
    """Inputs, and the JAX package's kernel matrices, gradients and gram
    adjoints for every kernel, from one compiled program (one XLA
    compile instead of one per test)."""
    rng = np.random.default_rng(0)
    inputs = dict(x=_data(rng), xp=_data(rng, n=17), x2=_data(rng), abar=rng.standard_normal((40, 40)))

    def run(x, xp, x2, abar):
        out = {"sq_distance": gj.sq_distance(x, xp)}
        for name, (mk_j, _, mk_p) in KERNELS.items():
            k, p = mk_j(), jnp.asarray(mk_p(3))
            out[name] = {
                "train": gj.kernel_matrix(k, p, x),
                "cross": gj.kernel_matrix(k, p, x, xp),
                "batched": gj.kernel_matrix(k, jnp.stack([p, p * 1.1]), jnp.stack([x, x2])),
                "diag": gj.kernel_diag(k, p, x),
                "and_grad": gj.kernel_and_grad(k, p, x),
                "gram_adjoint": k.gram_adjoint(p, x, abar),
            }
        return out

    want = jax.jit(run)(**{k: jnp.asarray(v) for k, v in inputs.items()})
    return inputs, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("name", sorted(KERNELS))
@pytest.mark.parametrize("form", ["train", "cross", "batched", "diag"])
def test_kernel_matrix_matches_jax(name, form, parity):
    (inp, want), (_, mk_t, mk_p) = parity, KERNELS[name]
    xt, xpt, pt = torch.tensor(inp["x"]), torch.tensor(inp["xp"]), torch.tensor(mk_p(3))
    if form == "cross":
        got = gt.kernel_matrix(mk_t(), pt, xt, xpt)
    elif form == "diag":
        got = gt.kernel_diag(mk_t(), pt, xt)
    elif form == "batched":
        got = gt.kernel_matrix(mk_t(), torch.stack([pt, pt * 1.1]), torch.stack([xt, torch.tensor(inp["x2"])]))
    else:
        got = gt.kernel_matrix(mk_t(), pt, xt)
    np.testing.assert_allclose(got.numpy(), want[name][form], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_kernel_and_grad_matches_jax(name, parity):
    (inp, want), (_, mk_t, mk_p) = parity, KERNELS[name]
    Kt, dKt = gt.kernel_and_grad(mk_t(), torch.tensor(mk_p(3)), torch.tensor(inp["x"]))
    Kj, dKj = want[name]["and_grad"]
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(dKt.numpy(), dKj, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_adjoint_matches_autograd_vjp(name, rng):
    """⟨Abar, ∂K/∂θ⟩ in closed form equals autograd's VJP through the
    gram build (the JAX suite holds the same identity to 1e-9)."""
    _, mk_t, mk_p = KERNELS[name]
    kern = mk_t()
    x = torch.tensor(_data(rng))
    abar = torch.tensor(rng.standard_normal((40, 40)))
    p = torch.tensor(mk_p(3), requires_grad=True)
    (vjp,) = torch.autograd.grad(kern.matrix(p, x), p, abar)
    ga = kern.gram_adjoint(p.detach(), x, abar)
    np.testing.assert_allclose(ga.numpy(), vjp.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_gram_adjoint_matches_jax(name, parity):
    (inp, want), (_, mk_t, mk_p) = parity, KERNELS[name]
    got = mk_t().gram_adjoint(torch.tensor(mk_p(3)), torch.tensor(inp["x"]), torch.tensor(inp["abar"]))
    np.testing.assert_allclose(got.numpy(), want[name]["gram_adjoint"], rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_init_params_match_jax(name, rng):
    mk_j, mk_t, _ = KERNELS[name]
    x = rng.uniform(size=(2, 5, 3))
    np.testing.assert_array_equal(
        mk_t().init_params(torch.tensor(x)).numpy(), np.asarray(mk_j().init_params(jnp.asarray(x)))
    )


def test_sq_distance_matches_jax(parity):
    inp, want = parity
    np.testing.assert_allclose(
        gt.sq_distance(torch.tensor(inp["x"]), torch.tensor(inp["xp"])).numpy(),
        want["sq_distance"], rtol=1e-12, atol=1e-12,
    )


def test_sum_operator_and_equality():
    k = gt.RBF() + gt.WhiteNoise()
    assert k == gt.Sum((gt.RBF(), gt.WhiteNoise()))
    assert hash(k) == hash(gt.Sum((gt.RBF(), gt.WhiteNoise())))
    assert (k + gt.RBF()).kernels == (gt.RBF(), gt.WhiteNoise(), gt.RBF())


def test_matcher():
    assert gram.matches_rbf_noise(gt.Sum((gt.RBF(), gt.WhiteNoise())))
    assert not gram.matches_rbf_noise(gt.RBF())
    assert not gram.matches_rbf_noise(gt.Sum((gt.RBF(), gt.RBF())))
    assert not gram.matches_rbf_noise(gt.Sum((gt.WhiteNoise(), gt.RBF())))


def _gram_setup(rng, n):
    x = rng.uniform(0, 2, size=(n, 3)).astype(np.float32)
    p = np.array([1.2, 0.8, 1.1, 0.9, 0.1], np.float32)
    return x, p


@pytest.mark.parametrize("n", (256, 300))
def test_plain_gram_matches_pallas(n, rng, interpret):
    """The plain gram (f32, direct differences) against the Pallas kernel
    in interpret mode (f32, matmul trick).  The Pallas kernel's own
    cancellation error is about 3e-6 at these inputs, over
    test_pallas.py's 1e-6, so both are held to the f64 gram: the port
    to 1e-6, and the two apart by no more than the Pallas error + 1e-6."""
    x, p = _gram_setup(rng, n)
    Kj = np.asarray(pk.rbf_noise_gram(jnp.asarray(p), jnp.asarray(x)))
    Kt = gram.rbf_noise_gram_plain(torch.tensor(p), torch.tensor(x)).numpy()
    K64 = gram.rbf_noise_gram_plain(torch.tensor(p, dtype=torch.float64), torch.tensor(x, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(Kt, K64, atol=1e-6)
    np.testing.assert_allclose(Kt, Kj, atol=np.abs(Kj - K64).max() + 1e-6)
    # the f64 plain gram is the JAX package's f64 gram
    np.testing.assert_allclose(
        K64,
        np.asarray(gj.kernel_matrix(gj.Sum((gj.RBF(), gj.WhiteNoise())), jnp.asarray(p, jnp.float64), jnp.asarray(x, jnp.float64))),
        rtol=1e-12, atol=1e-12,
    )


def test_gram_backward_matches_pallas_vjp(rng, interpret):
    """Autograd through rbf_noise_gram (its backward is the Pallas VJP
    as torch ops) against JAX's custom VJP, test_pallas.py tolerances."""
    x, p = _gram_setup(rng, 300)
    jp, jx = jnp.asarray(p), jnp.asarray(x)
    gp_j = jax.grad(lambda q: jnp.sum(jnp.sin(pk.rbf_noise_gram(q, jx))))(jp)
    gx_j = jax.grad(lambda z: jnp.sum(jnp.cos(pk.rbf_noise_gram(jp, z))))(jx)
    tp = torch.tensor(p, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    (gp_t,) = torch.autograd.grad(torch.sum(torch.sin(gram.rbf_noise_gram(tp, tx.detach()))), tp)
    (gx_t,) = torch.autograd.grad(torch.sum(torch.cos(gram.rbf_noise_gram(tp.detach(), tx))), tx)
    np.testing.assert_allclose(gp_t.numpy(), np.asarray(gp_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), rtol=1e-3, atol=1e-3)


def test_gram_backward_matches_autograd_f64(rng):
    """The hand-written backward equals autograd through the plain f64
    formula (params and x cotangents)."""
    x = torch.tensor(rng.uniform(0, 2, size=(30, 3)), requires_grad=True)
    p = torch.tensor([1.2, 0.8, 1.1, 0.9, 0.1], dtype=torch.float64, requires_grad=True)
    kbar = torch.tensor(rng.standard_normal((30, 30)))
    want = torch.autograd.grad(gram.rbf_noise_gram_plain(p, x), (p, x), kbar)
    got = torch.autograd.grad(gram.rbf_noise_gram(p, x), (p, x), kbar)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_gram_dispatch(dtype, rng):
    """f32 RBF+noise takes the fused gram (its plain version on the CPU,
    bit for bit); f64 and other kernels take ``kern.matrix``."""
    x = torch.tensor(rng.uniform(0, 2, size=(50, 3)), dtype=dtype)
    p = torch.tensor([1.2, 0.8, 1.1, 0.9, 0.1], dtype=dtype)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    K = gt.train_gram(cov, p, x)
    if dtype == torch.float32:
        assert torch.equal(K, gram.rbf_noise_gram_plain(p, x))
    else:
        assert torch.equal(K, cov.matrix(p, x))
    assert torch.equal(gt.train_gram(gt.RBF(), p[:4], x), gt.RBF().matrix(p[:4], x))


def test_cholesky_inverse_plain_matches_pallas(rng, interpret):
    """Plain fused (L, T) against the Pallas kernel in interpret mode and
    NumPy f64, with test_pallas.py's tolerances."""
    from pygpr_tpu.ops.pallas_cholesky import cholesky_inverse_pallas

    n = 256
    A = rng.standard_normal((n, n)).astype(np.float32)
    K = (A @ A.T + n * np.eye(n)).astype(np.float32)
    L, T = chol_inverse.cholesky_inverse(torch.tensor(K))
    L, T = L.numpy(), T.numpy()
    Lj, Tj = (np.asarray(a) for a in cholesky_inverse_pallas(jnp.asarray(K), interpret=True))
    Lr = np.linalg.cholesky(K.astype(np.float64))
    np.testing.assert_allclose(L, Lr, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(T @ Lr, np.eye(n), atol=5e-3)
    np.testing.assert_allclose(L, Lj, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(T, Tj, rtol=2e-4, atol=2e-3)
    assert np.all(np.triu(L, 1) == 0.0)
    assert np.all(np.triu(T, 1) == 0.0)


def test_cholesky_inverse_plain_f64_exact(rng):
    n = 384
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    Kt = torch.tensor(K)
    L, T = chol_inverse.cholesky_inverse(Kt)
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.numpy() @ L.numpy(), np.eye(n), atol=1e-12)
    assert torch.equal(Kt, torch.tensor(K))  # the caller's K is not written


def test_cholesky_inverse_plain_f64_ragged(rng):
    """Five 128-wide panels: the plain version's panels, tiles and band in
    f64 against NumPy."""
    n = 640
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    L, T = chol_inverse.cholesky_inverse(torch.tensor(K))
    np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(K), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.numpy() @ L.numpy(), np.eye(n), atol=1e-12)
    assert np.all(np.triu(L.numpy(), 1) == 0.0) and np.all(np.triu(T.numpy(), 1) == 0.0)


@pytest.mark.parametrize("p", [20, 300])
def test_cholesky_inverse_plain_nan_from_first_negative_pivot(rng, p):
    """L is finite left of the first non-positive pivot's column and NaN on
    and below the diagonal from it on (the kernel's contract)."""
    n = 512
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)
    K[p, p] = -1.0
    L, _ = chol_inverse.cholesky_inverse(torch.tensor(K))
    L = L.numpy()
    assert np.isfinite(L[:, :p]).all()
    assert np.isnan(L[p:, p:][np.tril_indices(n - p)]).all()


def test_compare_k2_exits_without_a_card(tmp_path, capsys):
    """The card-only comparison of K2 with an earlier source fails, and
    builds nothing, where there is no CUDA device."""
    from pygpr_torch.bench import compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would build and time")
    assert compare.main(["--kernel", "k2", "--old", str(tmp_path), "2048"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())


def test_cholesky_inverse_indefinite_nan():
    L, _ = chol_inverse.cholesky_inverse(-torch.eye(256))
    assert not torch.isfinite(L).all()


@pytest.mark.parametrize("shape", [(384, 384), (200, 200), (128, 128), (2, 256, 256), (256, 384)])
def test_cholesky_inverse_shape_rule(shape):
    """The kernel's domain: one square [n, n], n % 128 == 0, n ≥ 256."""
    K = torch.eye(shape[-1]).expand(shape).contiguous() if len(shape) == 3 else torch.zeros(shape)
    taken = len(shape) == 2 and shape[0] == shape[1] and shape[0] % 128 == 0 and shape[0] >= 256
    assert chol_inverse.takes(K) == taken
    if not taken:
        with pytest.raises(ValueError):
            chol_inverse.cholesky_inverse(K)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(8, 3)
    p = torch.ones(5)
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p, x)
    with pytest.raises(ValueError):
        chol_inverse.cholesky_inverse_cuda(torch.eye(256))
