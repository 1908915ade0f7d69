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


#: a stack of three grams at n = 40, d = 2, as ``jax.vmap`` of the Pallas
#: gram takes it: θ an expert with one x shared (the MCMC chains), and x an
#: expert with one θ shared (a committee under shared parameters)
STACK_C, STACK_N = 3, 40


@pytest.fixture(scope="module")
def stack():
    """Seeded inputs of both stack forms, and from one jitted JAX program:
    the vmapped Pallas gram in interpret mode over both forms' six grams at
    once (one call), its VJP at a cotangent, and the JAX package's NLML (f64)
    of chains over one data set and of a committee."""
    rng = np.random.default_rng(11)
    c, n = STACK_C, STACK_N
    inp = dict(
        x=rng.uniform(0.0, 2.0, (n, 2)).astype(np.float32),
        P=(np.array([1.2, 0.8, 1.1, 0.1]) * rng.uniform(0.85, 1.15, (c, 4))).astype(np.float32),
        X=rng.uniform(0.0, 2.0, (c, n, 2)).astype(np.float32),
        p=np.array([1.2, 0.8, 1.1, 0.1], np.float32),
        kbar=rng.standard_normal((2 * c, n, n)).astype(np.float32),
        y=np.sin(2.0 * rng.uniform(0.0, 2.0, (c, n))),
    )
    cj = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def run(x, P, X, p, kbar, y):
        # the two forms materialized into one batch: the shared inputs'
        # cotangents are the sums of their members'
        p_all = jnp.concatenate([P, jnp.broadcast_to(p, (c, 4))])
        x_all = jnp.concatenate([jnp.broadcast_to(x, (c, n, 2)), X])
        K, vjp = jax.vjp(jax.vmap(pk.rbf_noise_gram), p_all, x_all)
        p_bar, x_bar = vjp(kbar)
        x64, X64, P64, p64 = (a.astype(jnp.float64) for a in (x, X, P, p))
        chains = jax.vmap(lambda q: gj.nlml(cj, q, x64, y[0]))(P64)
        return dict(K=K, p_bar=p_bar, x_bar=x_bar, chains=chains, committee=gj.nlml(cj, p64, X64, y),
                    committee_own=gj.nlml(cj, P64, X64, y))

    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(pk.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        want = jax.jit(run)(**{k: jnp.asarray(v) for k, v in inp.items()})
    return inp, jax.tree_util.tree_map(np.asarray, want)


def _stack_forms(inp, dtype=torch.float32):
    """(params, x) of each form: θ an expert over a shared x, and a shared
    θ over x an expert."""
    t = {k: torch.tensor(v, dtype=dtype) for k, v in inp.items()}
    return {"chains": (t["P"], t["x"]), "committee": (t["p"], t["X"])}


@pytest.mark.parametrize("form", ["chains", "committee"])
def test_plain_gram_stack_matches_vmapped_pallas(form, stack):
    """The batched plain gram against ``jax.vmap`` of the Pallas kernel in
    interpret mode, held as test_plain_gram_matches_pallas holds one gram:
    the port to 1e-6 of its f64 gram, and the two apart by no more than the
    Pallas kernel's own f64 gap + 1e-6."""
    inp, want = stack
    params, x = _stack_forms(inp)[form]
    Kj = want["K"][:STACK_C] if form == "chains" else want["K"][STACK_C:]
    Kt = gram.rbf_noise_gram_plain(params, x).numpy()
    K64 = gram.rbf_noise_gram_plain(params.double(), x.double()).numpy()
    assert Kt.shape == (STACK_C, STACK_N, STACK_N)
    np.testing.assert_allclose(Kt, K64, atol=1e-6)
    np.testing.assert_allclose(Kt, Kj, atol=np.abs(Kj - K64).max() + 1e-6)
    # each matrix of the stack bit-equal to the plain gram of it alone
    for i in range(STACK_C):
        alone = gram.rbf_noise_gram_plain(params[i] if params.ndim == 2 else params, x[i] if x.ndim == 3 else x)
        assert torch.equal(torch.from_numpy(Kt[i]), alone)


@pytest.mark.parametrize("form", ["chains", "committee"])
def test_gram_stack_backward_matches_vmapped_pallas_vjp(form, stack):
    """Autograd through the batched rbf_noise_gram (the Pallas VJP as
    batched torch ops, reduced over the stack for the shared input) against
    ``jax.vjp`` of the vmapped Pallas gram, test_pallas.py's tolerances."""
    inp, want = stack
    params, x = (t.clone().requires_grad_(True) for t in _stack_forms(inp)[form])
    half = slice(0, STACK_C) if form == "chains" else slice(STACK_C, None)
    kbar = torch.tensor(inp["kbar"][half])
    gp_t, gx_t = torch.autograd.grad(gram.rbf_noise_gram(params, x), (params, x), kbar)
    gp_j, gx_j = want["p_bar"][half], want["x_bar"][half]
    if form == "chains":
        gx_j = gx_j.sum(0)
    else:
        gp_j = gp_j.sum(0)
    assert gp_t.shape == params.shape and gx_t.shape == x.shape
    np.testing.assert_allclose(gp_t.numpy(), gp_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(gx_t.numpy(), gx_j, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", ["rbf_noise", "matern"])
def test_train_gram_stack_equals_stacked_train_gram(family, dtype, stack):
    """``train_gram`` of a stack (one call) bit-equal to a stack of its
    calls on one matrix each, in both forms: one fused-gram call for the
    canonical kernel in f32, a loop over ``kern.matrix`` otherwise."""
    inp, _ = stack
    kern = gt.Sum((gt.RBF(), gt.WhiteNoise())) if family == "rbf_noise" else gt.Sum((gt.Matern(2.5), gt.WhiteNoise()))
    for params, x in _stack_forms(inp, dtype).values():
        got = gt.train_gram(kern, params, x)
        want = torch.stack([gt.train_gram(kern, params[i] if params.ndim == 2 else params,
                                          x[i] if x.ndim == 3 else x) for i in range(STACK_C)])
        assert got.dtype == dtype and torch.equal(got, want)


def test_stacked_nlml_matches_jax(stack):
    """The NLML of 4 chains (θ ``[C, nhp]`` over one shared x) and of a
    3-expert committee (θ shared and θ an expert) against the JAX
    package's on the same inputs: f64 at the committee tests' rtol 1e-8,
    and in f32 (the grams by the plain fused gram, one call a stack) to the
    flagship's f32-against-f64 limit, 1e-4 of the JAX f64 values (these
    read up to 1.1e-5: f32 round-off through grams of noise 0.01)."""
    inp, want = stack
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    for dtype, rtol in ((torch.float64, 1e-8), (torch.float32, 1e-4)):
        forms = _stack_forms(inp, dtype)
        P, x = forms["chains"]
        p, X = forms["committee"]
        y = torch.tensor(inp["y"], dtype=dtype)
        np.testing.assert_allclose(gt.nlml(cov, P, x, y[0]).numpy(), want["chains"], rtol=rtol)
        np.testing.assert_allclose(gt.nlml(cov, p, X, y).numpy(), want["committee"], rtol=rtol)
        np.testing.assert_allclose(gt.nlml(cov, P, X, y).numpy(), want["committee_own"], rtol=rtol)


def test_stacks_built_in_one_gram_call(stack, monkeypatch):
    """The committee NLML, the chains' NLML and ``exact_gp.factorize`` of a
    committee build their f32 stack of canonical grams with one call of the
    fused gram (on the card, one K1 launch), the chains' x never expanded."""
    from pygpr_torch.models import exact_gp, likelihood

    calls = []
    plain = gram.rbf_noise_gram_plain

    def counted(params, x):
        calls.append((tuple(params.shape), tuple(x.shape)))
        return plain(params, x)

    monkeypatch.setattr(gram, "rbf_noise_gram_plain", counted)
    inp, _ = stack
    forms = _stack_forms(inp)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    y = torch.tensor(inp["y"], dtype=torch.float32)
    P, x = forms["chains"]
    p, X = forms["committee"]
    c, n = STACK_C, STACK_N
    for run, shapes in (
        (lambda: likelihood.nlml(cov, P, x, y[0]), ((c, 4), (n, 2))),
        (lambda: likelihood._nlml_batched_vals(cov, p, X, y, gt.DEFAULT), ((4,), (c, n, 2))),
        (lambda: exact_gp.factorize(cov, P, X, y), ((c, 4), (c, n, 2))),
    ):
        calls.clear()
        run()
        assert calls == [shapes]


@pytest.mark.parametrize("case", ["unbatched", "stack", "expanded", "one_row", "strided", "expanded_strided"])
def test_gram_batch_stride_rule(case):
    """The batch stride the card's wrapper passes for each input form
    (strides only, so it runs on CPU tensors): 0 for an unbatched or an
    expanded input, the row size of a contiguous stack; a view it cannot
    pass is refused."""
    x = torch.zeros(5, 3)
    t, want = {
        "unbatched": (x, 0),
        "stack": (torch.zeros(4, 5, 3), 15),
        "expanded": (x.expand(4, 5, 3), 0),
        "one_row": (x[None], 15),
        "strided": (torch.zeros(4, 5, 6)[..., :3], None),
        "expanded_strided": (torch.zeros(5, 6)[:, :3].expand(4, 5, 3), None),
    }[case]
    if want is None:
        with pytest.raises(ValueError, match="contiguous"):
            gram._batch_stride(t, 2, "x")
    else:
        assert gram._batch_stride(t, 2, "x") == want


def test_gram_stack_bytes_count_shared_inputs_once():
    """A shared x or θ is read once, not once a matrix."""
    nb, n, d = 4, 1024, 1
    assert gram.stack_bytes(nb, n, d, 1, nb) == 4.0 * (nb * n * n + n * d + nb * (d + 2))
    assert gram.stack_bytes(nb, n, d, nb, nb) - gram.stack_bytes(nb, n, d, 1, 1) == 4.0 * (nb - 1) * (n * d + d + 2)


def test_train_gram_takes_a_column_slice_of_theta(stack):
    """A stack of θ that is a column slice of a wider one (``split_params``
    of a mean's parameters) is made contiguous before the fused gram,
    whose card wrapper refuses a strided stack."""
    inp, _ = stack
    P, x = _stack_forms(inp)["chains"]
    wide = torch.cat([P, torch.ones(STACK_C, 2)], dim=1)[:, : P.shape[1]]
    assert not wide.is_contiguous()
    calls = []
    plain = gram.rbf_noise_gram_plain

    def counted(params, xx):
        calls.append(params.is_contiguous())
        return plain(params, xx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gram, "rbf_noise_gram_plain", counted)
        got = gt.train_gram(gt.Sum((gt.RBF(), gt.WhiteNoise())), wide, x)
    assert calls == [True] and torch.equal(got, plain(P, x))
