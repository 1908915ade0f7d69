"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import pygpr_torch as gp
from pygpr_torch.bench import mfu_probe
from pygpr_torch.models import iterative
from pygpr_torch.ops import chol_batched, chol_inverse, gram, matvec

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(n, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, d)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)).astype(np.float32)
    p = np.ones(d + 2, np.float32)
    p[-1] = 0.1
    return x, y, p


@pytest.mark.parametrize("n,d", [(1, 1), (63, 2), (1000, 3), (2048, 8)])
def test_gram_kernel_matches_plain(n, d, dev):
    x, _, p = _data(n, d)
    xt, pt = torch.tensor(x, device=dev), torch.tensor(p, device=dev)
    K = gram.rbf_noise_gram_cuda(pt, xt)
    torch.cuda.synchronize()
    assert (K - gram.rbf_noise_gram_plain(pt, xt)).abs().max().item() <= 1e-5


def _gram_stack(nb, n, d, x_shared, p_shared, dev, seed=0):
    """(params, x) of a stack on the card: one x ``[n, d]`` expanded along
    the stack (batch stride 0) or ``[nb, n, d]``; one params expanded or
    ``[nb, d + 2]``, each row its own."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(0.0, 2.0, (1 if x_shared else nb, n, d)), dtype=torch.float32, device=dev)
    p = rng.uniform(0.8, 1.2, (1 if p_shared else nb, d + 2))
    p[:, -1] = 0.1
    return torch.tensor(p, dtype=torch.float32, device=dev).expand(nb, d + 2), x.expand(nb, n, d)


#: (nb, n, d, x shared, params shared): the MCMC chains, the 16 × 512 + 256
#: committee, a ragged n (the one-float store path), the flagship's d and
#: the widest d
STACKS = [(4, 1024, 1, True, False), (16, 768, 2, False, False), (5, 63, 2, False, True),
          (3, 300, 3, True, True), (3, 130, 64, False, False)]


@pytest.mark.parametrize("nb,n,d,x_shared,p_shared", STACKS)
def test_gram_stack_equals_single_launches_and_is_symmetric(nb, n, d, x_shared, p_shared, dev):
    """One launch over a stack: each matrix bit-equal to a launch on it
    alone, every matrix bit-symmetric, within 1e-5 of the plain version
    (same formula and summation order; expf against torch.exp and fma
    contraction differ), and a stride-0 input read as it is."""
    p, x = _gram_stack(nb, n, d, x_shared, p_shared, dev)
    K = gram.rbf_noise_gram_cuda(p, x)
    torch.cuda.synchronize()
    assert K.shape == (nb, n, n)
    assert all(torch.equal(K[i], gram.rbf_noise_gram_cuda(p[i].contiguous(), x[i].contiguous())) for i in range(nb))
    assert torch.equal(K, K.mT)
    assert (K - gram.rbf_noise_gram_plain(p, x)).abs().max().item() <= 1e-5
    # a shared input given unbatched, or copied out, gives the same bits
    assert torch.equal(K, gram.rbf_noise_gram_cuda(p[0] if p_shared else p, x[0] if x_shared else x).expand_as(K))
    assert torch.equal(K, gram.rbf_noise_gram_cuda(p.contiguous(), x.contiguous()))


def test_gram_counts_launches_matrices_and_shapes(dev):
    """``shapes`` is keyed (nb, n, d, distinct x, distinct θ)."""
    p, x = _gram_stack(4, 256, 1, True, False, dev)
    k1 = gram.rbf_noise_gram_cuda
    keys = [(4, 256, 1, 1, 4), (1, 256, 1, 1, 1), (4, 256, 1, 4, 1)]
    before = (k1.launches, k1.matrices, *(k1.shapes[k] for k in keys))
    gram.rbf_noise_gram_cuda(p, x)
    gram.rbf_noise_gram_cuda(p[0], x[0])
    gram.rbf_noise_gram_cuda(p[0], x.contiguous())
    assert (k1.launches, k1.matrices, *(k1.shapes[k] for k in keys)) == (
        before[0] + 3, before[1] + 9, before[2] + 1, before[3] + 1, before[4] + 1)


def test_train_gram_on_a_column_slice_of_theta(dev):
    """A stack of θ sliced out of a wider one is copied to a contiguous
    stack by ``train_gram`` (the wrapper itself refuses it), one launch."""
    p, x = _gram_stack(4, 256, 2, True, False, dev)
    wide = torch.cat([p, torch.ones(4, 3, device=dev)], dim=1)[:, :4]
    k1 = gram.rbf_noise_gram_cuda
    with pytest.raises(ValueError):
        k1(wide, x)
    before = k1.launches
    K = gp.train_gram(gp.Sum((gp.RBF(), gp.WhiteNoise())), wide, x)
    assert k1.launches == before + 1 and torch.equal(K, k1(p.contiguous(), x))


def test_gram_stack_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    p, x = _gram_stack(3, 64, 2, False, False, dev)
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(torch.ones(4, 4, device=dev), x)  # 4 params rows, 3 matrices
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p[:, :3].contiguous(), x)  # params not [nb, d + 2]
    with pytest.raises(TypeError):
        gram.rbf_noise_gram_cuda(p.double(), x.double())
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p, x.mT.contiguous().mT)  # each matrix's x not contiguous
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p, torch.zeros(3, 128, 2, device=dev)[:, :64])  # batch stride 256, not 128
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p, torch.zeros(3, 64, 2, 1, device=dev))


@pytest.mark.parametrize("n", [256, 384, 640, 1024])
def test_chol_inverse_kernel_matches_plain_and_f64(n, dev):
    x, _, p = _data(n)
    K = gram.rbf_noise_gram_plain(torch.tensor(p, device=dev), torch.tensor(x, device=dev))
    K0 = K.clone()
    L, T = chol_inverse.cholesky_inverse_cuda(K)
    torch.cuda.synchronize()
    assert torch.equal(K, K0)  # the caller's K is not written
    Lp, Tp = chol_inverse.cholesky_inverse_plain(K)
    assert (L - Lp).abs().max() <= 1e-3 * Lp.abs().max()
    assert (T - Tp).abs().max() <= 1e-3 * Tp.abs().max()
    L64 = torch.linalg.cholesky(K.double())
    assert torch.linalg.norm(L.double() - L64) <= 1e-3 * torch.linalg.norm(L64)
    assert (T.double() @ L.double() - torch.eye(n, device=dev, dtype=torch.float64)).abs().max() <= 1e-3
    assert (torch.triu(L, 1) == 0).all() and (torch.triu(T, 1) == 0).all()


def test_chol_inverse_kernel_indefinite_gives_nan(dev):
    L, _ = chol_inverse.cholesky_inverse_cuda(-torch.eye(256, device=dev))
    assert not torch.isfinite(L).all()


@pytest.mark.parametrize("p", [20, 300])
def test_chol_inverse_kernel_nan_from_first_negative_pivot(p, dev):
    """The first non-positive pivot p, in the first 32 pivots or in a later
    panel: L is finite left of column p and NaN on and below the diagonal
    from p on; the caller's K is not written."""
    n = 512
    x, _, prm = _data(n)
    K = gram.rbf_noise_gram_plain(torch.tensor(prm, device=dev), torch.tensor(x, device=dev))
    K[p, p] = -1.0
    K0 = K.clone()
    L, _ = chol_inverse.cholesky_inverse_cuda(K)
    torch.cuda.synchronize()
    assert torch.equal(K, K0)
    assert torch.isfinite(L[:, :p]).all()
    rows, cols = torch.tril_indices(n - p, n - p, device=dev)
    assert torch.isnan(L[p:, p:][rows, cols]).all()


def test_chol_inverse_kernel_repeats_bit_equal(dev):
    """No atomics: two calls on the same K give the same bits."""
    x, _, p = _data(2048)
    K = gram.rbf_noise_gram_plain(torch.tensor(p, device=dev), torch.tensor(x, device=dev))
    L1, T1 = chol_inverse.cholesky_inverse_cuda(K)
    L2, T2 = chol_inverse.cholesky_inverse_cuda(K)
    assert torch.equal(L1, L2) and torch.equal(T1, T2)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(8, 3, device=dev)
    p = torch.ones(5, device=dev)
    with pytest.raises(TypeError):
        gram.rbf_noise_gram_cuda(p.double(), x.double())
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p[:4], x)
    with pytest.raises(ValueError):
        gram.rbf_noise_gram_cuda(p, torch.zeros(3, 8, device=dev).T)
    with pytest.raises(TypeError):
        chol_inverse.cholesky_inverse_cuda(torch.eye(256, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        chol_inverse.cholesky_inverse_cuda(torch.eye(320, device=dev))
    with pytest.raises(ValueError):
        chol_inverse.cholesky_inverse_cuda(torch.eye(256, device=dev).T)


def _spd_stack(nb, n, dev, seed=0):
    x = np.random.default_rng(seed).uniform(0.0, 2.0, size=(nb, n, 2)).astype(np.float32)
    p = torch.tensor([1.0, 1.2, 0.8, 0.1], device=dev)
    return torch.stack([gram.rbf_noise_gram_plain(p, torch.tensor(xi, device=dev)) for xi in x])


@pytest.mark.parametrize("shape", [(300, 300), (4, 512, 512), (1024, 1024), (1000, 1000)])
def test_chol_batched_kernel_matches_plain_and_f64(shape, dev):
    """K3 against its plain version (1e-3 of max|L|: the same algorithm,
    another summation order) and f64 (‖L−L64‖F ≤ 1e-3 ‖L64‖F)."""
    K = _spd_stack(1 if len(shape) == 2 else shape[0], shape[-1], dev)
    K = K[0] if len(shape) == 2 else K
    K0 = K.clone()
    L = chol_batched.cholesky_batched_cuda(K)
    torch.cuda.synchronize()
    assert torch.equal(K, K0)  # the caller's K is not written
    assert L.shape == K.shape
    Lp = chol_batched.cholesky_batched_plain(K)
    assert (L - Lp).abs().max() <= 1e-3 * Lp.abs().max()
    L64 = torch.linalg.cholesky(K.double())
    assert torch.linalg.norm(L.double() - L64) <= 1e-3 * torch.linalg.norm(L64)
    assert (torch.triu(L, 1) == 0).all()


def test_chol_batched_kernel_nan_stays_in_its_matrix(dev):
    K = _spd_stack(4, 320, dev)
    K[2] = -torch.eye(320, device=dev)
    L = chol_batched.cholesky_batched_cuda(K)
    torch.cuda.synchronize()
    lower = torch.ones(320, 320, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[2][lower]).all()
    for i in (0, 1, 3):
        assert torch.equal(L[i], chol_batched.cholesky_batched_cuda(K[i].contiguous()))


@pytest.mark.parametrize("nb,n", [(16, 768), (4, 1536), (3, 2560), (16, 2048), (3, 4096)])
def test_chol_batched_stack_members_equal_their_factors_alone(nb, n, dev):
    """Each member of a stack in cholesky_pallas_batched's domain bit-equal
    to the same matrix factored alone (cholesky_pallas's 64-wide sweep): a
    matrix's arithmetic depends neither on nb nor on the launch sequence.
    On an H100 the last two stacks take the outer panels of 128 (16 and 32
    of them, the look-ahead across them, an odd nb), the first three the
    64-wide sweep."""
    K = _spd_stack(nb, n, dev, seed=1)
    L = chol_batched.cholesky_batched_cuda(K)
    torch.cuda.synchronize()
    assert torch.isfinite(L).all()
    for i in range(nb):
        assert torch.equal(L[i], chol_batched.cholesky_batched_cuda(K[i].contiguous()))


def test_chol_batched_stack_nan_from_a_pivot_inside_an_outer_panel(dev):
    """A negative diagonal entry at 586 of the middle matrix of a
    [3, 4096, 4096] stack (outer panels of 128 on an H100), inside the
    second 64-wide panel of the outer panel at 512: that matrix's columns
    before it stay finite and every entry of its lower triangle from column
    586 on is NaN; the other two are bit-equal to their factors alone."""
    n = 4096
    K = _spd_stack(3, n, dev, seed=4)
    p = 512 + 64 + 10
    K[1, p, p] = -1.0
    L = chol_batched.cholesky_batched_cuda(K)
    torch.cuda.synchronize()
    assert torch.isfinite(L[1][:, :p]).all()
    lower = torch.ones(n - p, n - p, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[1][p:, p:][lower]).all()
    for i in (0, 2):
        assert torch.equal(L[i], chol_batched.cholesky_batched_cuda(K[i].contiguous()))


def test_chol_batched_kernel_single_indefinite_gives_nan(dev):
    """One [1024, 1024] with a negative diagonal entry at 500 (inside a
    panel's second 32-wide tile): columns before it stay finite and equal
    the f64 factor of the leading block, and every entry of the lower
    triangle from column 500 on is NaN."""
    K = _spd_stack(1, 1024, dev, seed=2)[0]
    K[500, 500] = -1.0
    L = chol_batched.cholesky_batched_cuda(K)
    torch.cuda.synchronize()
    assert torch.isfinite(L[:, :500]).all()
    lower = torch.ones(524, 524, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[500:, 500:][lower]).all()
    L64 = torch.linalg.cholesky(K[:500, :500].double())
    assert torch.linalg.norm(L[:500, :500].double() - L64) <= 1e-3 * torch.linalg.norm(L64)


def test_chol_batched_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    with pytest.raises(TypeError):
        chol_batched.cholesky_batched_cuda(torch.eye(64, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        chol_batched.cholesky_batched_cuda(torch.ones(4, 64, device=dev).T)
    with pytest.raises(ValueError):
        chol_batched.cholesky_batched_cuda(torch.eye(64))


def test_main_path_launches_both_kernels_and_matches_f64(dev):
    x, y, p = _data(512)
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    counters = (gram.rbf_noise_gram_cuda, chol_inverse.cholesky_inverse_cuda)
    before = [c.launches for c in counters]
    v, g = gp.nlml_value_and_grad(cov, *(torch.tensor(a, device=dev) for a in (p, x, y)))
    assert all(c.launches > b for c, b in zip(counters, before))
    v64, g64 = gp.nlml_value_and_grad(cov, *(torch.tensor(a, device=dev, dtype=torch.float64) for a in (p, x, y)))
    assert abs(v.item() - v64.item()) <= 1e-4 * abs(v64.item())
    assert torch.linalg.norm(g.double() - g64) <= 1e-2 * torch.linalg.norm(g64)



@pytest.mark.parametrize("family", ["matern52", "fixed_noise"])
def test_kernel_family_nlml_launches_k2_and_matches_f64(family, dev):
    """The fast NLML of Sum(Matern(2.5), WhiteNoise) and of
    FixedNoise(Matern(2.5)) (the variance 0.01 known per point) in f32 on
    the card against f64, within chip_smoke.py's kernel_families limits,
    with K2 launched and K1 not (only the canonical RBF + noise takes K1)."""
    n = 1024
    x, y, _ = _data(n)
    if family == "matern52":
        kern, p = gp.Sum((gp.Matern(2.5), gp.WhiteNoise())), np.r_[np.ones(4), 0.1].astype(np.float32)
    else:
        x = gp.with_noise(x, 0.01)
        kern, p = gp.FixedNoise(gp.Matern(2.5)), np.ones(4, np.float32)
    counters = (gram.rbf_noise_gram_cuda, chol_inverse.cholesky_inverse_cuda)
    before = [c.launches for c in counters]
    v, g = gp.nlml_value_and_grad(kern, *(torch.tensor(a, device=dev) for a in (p, x, y)))
    assert counters[0].launches == before[0] and counters[1].launches > before[1]
    v64, g64 = gp.nlml_value_and_grad(kern, *(torch.tensor(a, device=dev, dtype=torch.float64) for a in (p, x, y)))
    assert abs(v.item() - v64.item()) <= 1e-4 * abs(v64.item())
    assert torch.linalg.norm(g.double() - g64) <= 1e-2 * torch.linalg.norm(g64)

#: shapes whose plan on an H100 (132 SMs) needs no split of the column sweep
UNSPLIT = ((6000, 2, 280), (70000, 2, 5))


@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (63, 2, 9), (1030, 3, 7), (300, 64, 20), (2048, 2, 56)]
                         + [(2048, 2, k) for k in (1, 5, 8, 9, 40, 256)] + [(2048, 2, 17), (1031, 2, 40)]
                         + list(UNSPLIT))
def test_matvec_kernel_matches_f64_and_repeats_bit_equal(n, d, k, dev):
    """K4 against its plain version in f64 on the same f32 inputs, to
    1e-4 + 1e-3 of each column's largest entry (chip_smoke.py states why
    the column's scale), and two launches give the same bits.  The cases
    at n = 2048 are the iterative path's widths, both regimes, and the
    plan splits their column sweep (the splits' sums added in a fixed
    order); k = 17 is the first wide width; n = 1031 at k = 40 fills
    neither regime's row tile.  The cases of ``UNSPLIT`` fill the card
    with rows alone, so each block scales its own sums by σ²: the wide
    BN = 48 template over 6 column tiles with ragged n and k, and the
    narrow k = 5."""
    rng = np.random.default_rng(n + d + k)
    x = torch.tensor(rng.uniform(0.0, 4.0, (n, d)), dtype=torch.float32, device=dev)
    v = torch.tensor(rng.standard_normal((n, k)), dtype=torch.float32, device=dev)
    th = torch.tensor(np.r_[1.2, np.linspace(0.8, 1.1, d)], dtype=torch.float32, device=dev)
    out = matvec.rbf_gram_matvec_cuda(th, x, v)
    torch.cuda.synchronize()
    assert torch.equal(out, matvec.rbf_gram_matvec_cuda(th, x, v))
    if n == 2048:
        assert matvec.plan(n, k, matvec._sms(x.device))["splits"] > 1
    if (n, d, k) in UNSPLIT:
        assert matvec.plan(n, k, matvec._sms(x.device))["splits"] == 1
    p64 = matvec.rbf_gram_matvec_plain(th.double(), x.double(), v.double())
    assert ((out.double() - p64).abs() <= 1e-4 + 1e-3 * p64.abs().amax(dim=0)).all()


def test_matvec_backward_matches_f64_autograd(dev):
    """θ̄, x̄ and V̄ from K4's backward (K4 again on the batched columns)
    against autograd through the f64 plain version, 1e-3 relative."""
    rng = np.random.default_rng(7)
    x, v, w = (torch.tensor(a, dtype=torch.float32, device=dev)
               for a in (rng.uniform(0.0, 4.0, (512, 2)), *rng.standard_normal((2, 512, 4))))
    th = torch.tensor([1.0, 0.9, 1.1], device=dev)
    leaves = [t.clone().requires_grad_(True) for t in (th, x, v)]
    before = matvec.rbf_gram_matvec_cuda.launches
    grads = torch.autograd.grad(torch.sum(w * matvec.rbf_gram_matvec(*leaves)), leaves)
    assert matvec.rbf_gram_matvec_cuda.launches == before + 2
    leaves64 = [t.double().requires_grad_(True) for t in (th, x, v)]
    grads64 = torch.autograd.grad(torch.sum(w.double() * matvec.rbf_gram_matvec_plain(*leaves64)), leaves64)
    for a, b in zip(grads, grads64):
        assert torch.linalg.norm(a.double() - b) <= 1e-3 * torch.linalg.norm(b)


def test_matvec_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    x, v, th = torch.zeros(8, 2, device=dev), torch.zeros(8, 3, device=dev), torch.ones(3, device=dev)
    with pytest.raises(TypeError):
        matvec.rbf_gram_matvec_cuda(th.double(), x.double(), v.double())
    with pytest.raises(ValueError):
        matvec.rbf_gram_matvec_cuda(th[:2], x, v)
    with pytest.raises(ValueError):
        matvec.rbf_gram_matvec_cuda(th, x, torch.zeros(3, 8, device=dev).T)
    with pytest.raises(ValueError):
        matvec.rbf_gram_matvec_cuda(th, x, torch.zeros(8, 0, device=dev))
    with pytest.raises(TypeError):  # the f32 RBF path launches K4 or raises, never falls back
        matvec.rbf_gram_matvec(th, x, v.double())


def test_iterative_path_launches_k4_and_matches_f64(dev):
    """The iterative NLML on an f32 RBF launches K4 in every piece (CG,
    Lanczos, the surrogate's forward and backward) and agrees with the
    same estimator in f64 (the blocked path)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 4.0, (2048, 2))
    y = np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=2048)
    z = iterative.make_probes(2048, 8, 0)
    p = np.array([1.0, 1.0, 1.0, 0.1])
    kw = dict(rank=64, num_lanczos=16, cg_tol=1e-6, max_cg=400, block=1024)
    args = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (p, x, y, z)]
    matvec.rbf_gram_matvec_cuda.launches = 0
    v, g = iterative.nlml_value_and_grad(gp.RBF(), *args, **kw)
    assert matvec.rbf_gram_matvec_cuda.launches >= 16 + 4
    v64, g64 = iterative.nlml_value_and_grad(gp.RBF(), *(a.double() for a in args), **kw)
    assert abs(v.item() - v64.item()) <= 1e-3 * abs(v64.item())
    assert torch.linalg.norm(g.double() - g64) <= 5e-2 * torch.linalg.norm(g64)


def _block_strips(P, dev, seed=0):
    """The probe's strips: the P diagonal 128-blocks of K = AAᵀ/n + 4I
    (n = 128P) and tril of each + 2I, f32 on the card."""
    n = 128 * P
    A = torch.tensor(np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32), device=dev)
    K = A @ A.T / n + 4.0 * torch.eye(n, device=dev)
    blocks = torch.stack([K[i * 128:(i + 1) * 128, i * 128:(i + 1) * 128] for i in range(P)])
    return blocks, torch.tril(blocks) + 2.0 * torch.eye(128, device=dev)


@pytest.mark.parametrize("P", [2, 16, 64])
def test_block_probe_kernels_match_plain_and_f64(P, dev):
    """B7 and B8 against their plain versions and f64 on the card, within
    1e-5 of the largest entry (about 40 ulps: f32 sums of up to 128 terms
    in another order), exact zeros above the diagonal, and two launches
    bit-equal (no atomics)."""
    blocks, trils = _block_strips(P, dev)
    S, St = blocks.reshape(-1, 128), trils.reshape(-1, 128)
    L = mfu_probe.pivots_strip(S).reshape(P, 128, 128)
    T = mfu_probe.tinv_strip(St).reshape(P, 128, 128)
    torch.cuda.synchronize()
    L64 = torch.linalg.cholesky(blocks.double())
    T64 = torch.linalg.solve_triangular(trils.double(), torch.eye(128, device=dev, dtype=torch.float64), upper=False)
    assert (L.double() - L64).abs().max() <= 1e-5 * L64.abs().max()
    assert (L - mfu_probe.micro_cholesky(blocks)).abs().max() <= 1e-5 * L.abs().max()
    assert (T.double() - T64).abs().max() <= 1e-5 * T64.abs().max()
    assert (T - mfu_probe.tri_inverse_block(trils)).abs().max() <= 1e-5 * T.abs().max()
    assert (torch.triu(L, 1) == 0).all() and (torch.triu(T, 1) == 0).all()
    assert torch.equal(mfu_probe.pivots_strip(S), L.reshape(-1, 128))
    assert torch.equal(mfu_probe.tinv_strip(St), T.reshape(-1, 128))


def test_pivots_kernel_nan_stays_in_its_block(dev):
    blocks, _ = _block_strips(4, dev)
    blocks[2] = -blocks[2]
    L = mfu_probe.pivots_strip(blocks.reshape(-1, 128)).reshape(4, 128, 128)
    torch.cuda.synchronize()
    lower = torch.ones(128, 128, dtype=torch.bool, device=dev).tril()
    assert torch.isnan(L[2][lower]).all()
    assert torch.isfinite(L[[0, 1, 3]]).all()


def test_tinv_kernel_zero_pivot_stays_in_its_block(dev):
    """A zero pivot in block 2 of a strip of 4: that block's inverse is
    not finite (no guard), and the other three match f64 within 1e-5 of
    the largest entry, as in test_block_probe_kernels_match_plain_and_f64."""
    _, trils = _block_strips(4, dev)
    trils[2, 37, 37] = 0.0
    T = mfu_probe.tinv_strip(trils.reshape(-1, 128)).reshape(4, 128, 128)
    torch.cuda.synchronize()
    assert not torch.isfinite(T[2]).all()
    keep = [0, 1, 3]
    T64 = torch.linalg.solve_triangular(trils[keep].double(), torch.eye(128, device=dev, dtype=torch.float64),
                                        upper=False)
    assert (T[keep].double() - T64).abs().max() <= 1e-5 * T64.abs().max()


def test_block_probe_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    for fn in (mfu_probe.pivots_strip, mfu_probe.tinv_strip):
        with pytest.raises(TypeError):
            fn(torch.eye(128, device=dev, dtype=torch.float64))
        with pytest.raises(ValueError):
            fn(torch.ones(256, 256, device=dev)[:, :128])
        with pytest.raises(ValueError):
            fn(torch.ones(192, 128, device=dev))


def _chain_problem(n=1024, seed=0):
    """The MCMC phase's problem (``chip_smoke.py``): y = sin(2x) + 0.1ε,
    x ~ U(0, 3) in 1-D, and 4 chain states u = log θ near its posterior
    mode (θ ≈ (1.8, 0.64, 0.102))."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 3.0, (n, 1))
    y = np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=n)
    u = np.log([1.8, 0.64, 0.102]) + 0.1 * np.random.default_rng(8).standard_normal((4, 3))
    return x, y, u


def test_chain_log_posterior_and_grad_f32_vs_f64(dev):
    """The chains' log posterior and its autograd gradient at 4 chain
    states ``[4, nhp]`` in f32 (one K1 launch for the chains' grams, K3 on the
    ``[4, 1024, 1024]`` stack) against f64 on the card, within
    ``chip_smoke.py``'s limits: about 2× the card's reading at its 8 chain
    states (1.40e-4 in value, 2.46e-2 in gradient, where the JAX package's
    own f32 path on the CPU reads 1.27e-4 and 3.02e-2: this 1-D gram is
    ill-conditioned for f32)."""
    from pygpr_torch.sample import mcmc

    n = 1024
    x, y, u = _chain_problem(n)
    kern = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    out = {}
    for dt in (torch.float32, torch.float64):
        lp = mcmc.log_posterior_fn(kern, torch.tensor(x, dtype=dt, device=dev), torch.tensor(y, dtype=dt, device=dev))
        k1, k3 = gram.rbf_noise_gram_cuda, chol_batched.cholesky_batched_cuda
        before = (k1.launches, k1.matrices, k3.launches, k3.shapes[(4, n)])
        out[dt] = mcmc._value_and_grad(lp, torch.tensor(u, dtype=dt, device=dev))
        torch.cuda.synchronize()
        launched = (k1.launches - before[0], k1.matrices - before[1], k3.launches - before[2],
                    k3.shapes[(4, n)] - before[3])
        if dt == torch.float32:
            # the 4 chains' grams in one launch, x shared
            assert launched[:2] == (1, 4) and launched[2] >= 1 and launched[2] == launched[3]
        else:
            assert launched == (0, 0, 0, 0)
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert torch.isfinite(v32).all() and torch.isfinite(g32).all()
    assert ((v32.double() - v64).abs() / v64.abs()).max() <= 3e-4
    assert ((g32.double() - g64).norm(dim=-1) / g64.norm(dim=-1)).max() <= 5e-2


def test_latent_and_inducing_factorizations_launch_k3(dev):
    """ESS's K, SVGP's K_uu and RFF's m×m system go through K3 in f32
    (ESS's K once a rung of the jitter ladder)."""
    from pygpr_torch.models import rff, svgp

    rng = np.random.default_rng(1)
    x = torch.tensor(rng.uniform(0.0, 3.0, (512, 2)), dtype=torch.float32, device=dev)
    y = (torch.sin(2.0 * x.sum(-1)) > 0).float()
    k3 = chol_batched.cholesky_batched_cuda
    before, before_512 = k3.launches, k3.shapes[(1, 512)]
    res = gp.sample_latent(gp.RBF(), torch.ones(3, device=dev), gp.BernoulliLogit(), torch.zeros(0, device=dev), x,
                           y, torch.Generator(device=dev).manual_seed(0), n_samples=5, n_warmup=5)
    assert torch.isfinite(res.samples).all() and k3.launches > before
    assert k3.shapes[(1, 512)] - before_512 == k3.launches - before
    vp = svgp.init_variational(gp.RBF(), gp.BernoulliLogit(), x, x[:64])
    v = svgp.neg_elbo(gp.RBF(), gp.BernoulliLogit(), vp, x, y)
    assert torch.isfinite(v) and k3.shapes[(1, 64)] >= 1
    basis = rff.make_basis(128, 2, seed=0, device=dev)
    st = rff.factorize_rff(basis, torch.tensor([1.0, 1.0, 1.0, 0.3], device=dev), x, y)
    assert bool(st.ok) and k3.shapes[(1, 128)] >= 1


def test_ski_direct_path_factors_its_grid_grams_with_k3(dev):
    """SKI's direct path at g = 512 (bench.py::bench_ski_direct's grid,
    n = 10⁵): K3 factors the grid gram and Z = WᵀW at [512, 512] inside
    the NLML, at the ladder's rung each factor's L Lᵀ within n·ε_f32 of
    max|A| of the plain version's (the f32 grid gram takes jitter 1e-4,
    where the factors themselves part by up to cond(A)·ε), and the
    analytic value and gradient finite."""
    from pygpr_torch.models import ski
    from pygpr_torch.ops import linalg

    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 8.0, (100_000, 1)).astype(np.float32), axis=0)
    y = (np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=100_000)).astype(np.float32)
    grid = ski.make_grid(x, 512)
    stats = ski.compute_stats_streamed((x, y), grid, device=dev)
    k3 = chol_batched.cholesky_batched_cuda
    k3.shapes.clear()
    p = torch.tensor([1.0, 1.0, 0.1], device=dev, requires_grad=True)
    v = ski.nlml_direct(gp.RBF(), p, stats, grid)
    (g,) = torch.autograd.grad(v, p)
    assert k3.shapes[(1, 512)] >= 2
    assert torch.isfinite(v) and torch.isfinite(g).all()
    tgram = ski.grid_gram_factors(torch.ones(2, device=dev), grid, torch.float32)[0]
    for K in (tgram, stats.z):
        A = linalg.add_diag(K, linalg.safe_cholesky(K).jitter).contiguous()
        L, Lp = chol_batched.cholesky_batched_cuda(A), chol_batched.cholesky_batched_plain(A)
        assert torch.isfinite(L).all()
        assert ((L @ L.T - Lp @ Lp.T).abs().max() / A.abs().max()).item() <= 512 * torch.finfo(torch.float32).eps


def test_statespace_scan_f32_at_a_million_points(dev):
    """The f32 parallel scan at n = 10⁶ on the bench's data (duplicate
    times from the f32 rounding included): the value, the adjoint gradient
    and the posterior finite, and the value and gradient within 10× the
    JAX package's own f32 gaps (1.02e-6, 5.33e-4) of f64 on the same times."""
    from pygpr_torch import bench
    from pygpr_torch.models import statespace

    t, y = bench.statespace_large_data()
    assert (np.diff(t) == 0).any()
    out = {}
    for dt in (torch.float32, torch.float64):
        tt, yt = (torch.tensor(a, dtype=dt, device=dev) for a in (t, y))
        p = torch.tensor([1.0, 1.0, 0.1], dtype=dt, device=dev)
        with torch.no_grad():
            out[dt] = statespace.nlml_ss_adjoint_value_and_grad(1.5, p, tt, yt)
            m, v = statespace.posterior_ss(1.5, p, tt, yt, np.linspace(0.0, 2000.0, 64))
        assert torch.isfinite(m).all() and (v > 0).all()
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert torch.isfinite(v32) and torch.isfinite(g32).all()
    assert abs(v32.item() - v64.item()) / abs(v64.item()) <= 1.02e-5
    assert (torch.linalg.norm(g32.double() - g64) / torch.linalg.norm(g64)).item() <= 5.33e-3


def test_derivative_joint_gram_f32_against_f64_launches_k3(dev):
    """The derivative GP's [1024, 1024] joint gram (256 points with values
    and gradients, d = 3) built by torch.func on the card in f32, within
    10× the JAX package's own f32 gap (4.08e-7, relative in norm) of f64;
    its factorization launches K3 at [1024, 1024]."""
    from pygpr_torch.models import derivative

    x = torch.tensor(np.random.default_rng(9).uniform(0.0, 2.0, (256, 3)), dtype=torch.float32, device=dev)
    p = torch.ones(4, device=dev)
    K32 = derivative.joint_gram(gp.RBF(), p, x, x)
    K64 = derivative.joint_gram(gp.RBF(), p.double(), x.double(), x.double())
    assert K32.shape == (1024, 1024)
    assert (torch.linalg.norm(K32.double() - K64) / torch.linalg.norm(K64)).item() <= 4.08e-6
    k3 = chol_batched.cholesky_batched_cuda
    before = k3.shapes[(1, 1024)]
    g = torch.cos(2.0 * x.sum(-1))[:, None].expand(256, 3)
    st = derivative.factorize(gp.RBF(), p, x, torch.sin(2.0 * x.sum(-1)), x, g)
    assert k3.shapes[(1, 1024)] > before and bool(st.ok) and torch.isfinite(st.weights).all()


def test_gplvm_nlml_multi_at_1024_launches_k3(dev):
    """The GPLVM's shared-gram NLML at [1024, 1024] (p = 12) in f32 on the
    card against f64 on the same inputs, value and gradient; one K3 launch
    at [1024, 1024] a rung."""
    from pygpr_torch.models import gplvm

    rng = np.random.default_rng(8)
    y = torch.tensor(np.tanh(rng.normal(size=(1024, 2)) @ rng.normal(size=(2, 12))), dtype=torch.float32,
                     device=dev)
    x0 = torch.tensor(gplvm.pca_init(y.cpu().double().numpy(), 2), dtype=torch.float32, device=dev)
    p = torch.tensor([1.0, 1.0, 1.0, 0.1], device=dev)
    k3 = chol_batched.cholesky_batched_cuda
    before = k3.shapes[(1, 1024)]
    out = {}
    for dt in (torch.float32, torch.float64):
        x = x0.to(dt).requires_grad_(True)
        v = gplvm.nlml_multi(gp.Sum((gp.RBF(), gp.WhiteNoise())), p.to(dt), x, y.to(dt))
        (g,) = torch.autograd.grad(v, x)
        out[dt] = (v.item(), g.double())
    assert k3.shapes[(1, 1024)] > before
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert abs(v32 - v64) / abs(v64) <= 1e-4
    assert (torch.linalg.norm(g32 - g64) / torch.linalg.norm(g64)).item() <= 1e-2


def test_checkpoint_round_trip_of_cuda_tensors(dev, tmp_path):
    """CUDA tensors saved to the npz layout come back on the card, in their
    dtype, bit for bit."""
    from pygpr_torch.utils import load_checkpoint, save_checkpoint

    tree = {"params": torch.randn(5, device=dev), "state": (torch.randn(3, 3, device=dev, dtype=torch.float64), None)}
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, tree, meta={"iters": 7})
    like = {"params": torch.zeros(5, device=dev), "state": (torch.zeros(3, 3, device=dev, dtype=torch.float64), None)}
    got, meta = load_checkpoint(path, like)
    assert meta == {"iters": 7} and got["state"][1] is None
    for a, b in ((got["params"], tree["params"]), (got["state"][0], tree["state"][0])):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)


def test_safe_cholesky_sends_a_single_f32_gram_above_1024_to_k2(dev):
    """The ladder's second rule: a single f32 [4096, 4096] flagship gram
    goes to K2, one launch at rung 0, and its factor's backward error
    ‖LLᵀ − K‖/‖K‖ is that of K2's own factor (8.8e-8 on an H100 for this
    gram); a [1100, 1100] one (unaligned) stays on the library."""
    x, _, p = _data(4096)
    K = gram.rbf_noise_gram_cuda(torch.tensor(p, device=dev), torch.tensor(x, device=dev))
    chol_inverse.cholesky_inverse_cuda.launches = 0
    res = gp.safe_cholesky(K)
    torch.cuda.synchronize()
    assert chol_inverse.cholesky_inverse_cuda.launches == 1 and res.ok.item() == 1.0
    L, K64 = res.chol.double(), K.double()
    err = (torch.linalg.matrix_norm(L @ L.T - K64) / torch.linalg.matrix_norm(K64)).item()
    assert err < 5e-7, err
    chol_inverse.cholesky_inverse_cuda.launches = 0
    res = gp.safe_cholesky(K[:1100, :1100].contiguous())
    assert chol_inverse.cholesky_inverse_cuda.launches == 0 and res.ok.item() == 1.0
