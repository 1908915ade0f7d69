"""Port parity: the plain version of the fused gram-matvec kernel (K4) and
its backward against the JAX package's Pallas kernel on the CPU.

Inputs are made with NumPy from a seed and fed to both packages.  The
Pallas kernel runs in interpret mode through the same patch of
``pl.pallas_call`` that ``tests/test_pallas_matvec.py`` uses, under one
``jax.jit`` per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu.ops.pallas_matvec as pm
from pygpr_torch.models import iterative as it
from pygpr_torch.ops import matvec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(rng, n, dim=2, k=3):
    """tests/test_pallas_matvec.py's inputs."""
    x = rng.uniform(0, 2, size=(n, dim)).astype(np.float32)
    v = rng.normal(size=(n, k)).astype(np.float32)
    theta = np.array([1.2, 0.8, 1.1], np.float32)[: dim + 1]
    return theta, x, v


@pytest.fixture(scope="module")
def parity():
    """The Pallas kernel's output at n = 300 (ragged against its 512-row
    tile) and its custom VJP at n = 260, from one interpret-mode program."""
    rng = np.random.default_rng(0)
    fwd = _setup(rng, 300)
    vjp = _setup(rng, 260)
    w = np.random.default_rng(1).normal(size=vjp[2].shape).astype(np.float32)

    def run(fwd, vjp, w):
        loss = lambda t, z, u: jnp.sum(w * pm.rbf_gram_matvec(t, z, u))
        return pm.rbf_gram_matvec(*fwd), jax.grad(loss, argnums=(0, 1, 2))(*vjp)

    orig = pm.pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm.pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        out, grads = jax.jit(run)(fwd, vjp, w)
    return fwd, vjp, w, np.asarray(out), [np.asarray(g) for g in grads]


def T(a):
    return torch.as_tensor(np.asarray(a))


def test_plain_matches_pallas(parity):
    """f32, ragged n = 300, k = 3, at test_pallas_matvec.py's tolerance."""
    (theta, x, v), _, _, want, _ = parity
    got = matvec.rbf_gram_matvec_plain(T(theta), T(x), T(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def test_vjp_matches_pallas_custom_vjp(parity):
    """θ̄, x̄ and V̄ of the port's backward (one more matvec on the batched
    columns) against the JAX custom VJP, f32, at test_pallas_matvec.py's
    tolerance for its VJP."""
    _, (theta, x, v), w, _, want = parity
    leaves = [T(a).requires_grad_(True) for a in (theta, x, v)]
    got = torch.autograd.grad(torch.sum(T(w) * matvec.rbf_gram_matvec(*leaves)), leaves)
    for g, ref, name in zip(got, want, ("theta", "x", "v")):
        np.testing.assert_allclose(g.numpy(), ref, rtol=2e-4, atol=2e-4, err_msg=f"cotangent mismatch: {name}")


def test_vjp_without_x_drops_its_columns(parity, monkeypatch):
    """When x needs no gradient the backward's matvec has 1 + 2d columns a
    column of V, not 1 + 3d, and θ̄ and V̄ are unchanged."""
    _, (theta, x, v), w, _, want = parity
    widths = []
    plain = matvec.rbf_gram_matvec_plain

    def spy(t, z, u):
        widths.append(u.shape[1])
        return plain(t, z, u)

    monkeypatch.setattr(matvec, "rbf_gram_matvec_plain", spy)
    th, vv = T(theta).requires_grad_(True), T(v).requires_grad_(True)
    got = torch.autograd.grad(torch.sum(T(w) * matvec.rbf_gram_matvec(th, T(x), vv)), (th, vv))
    k, d = v.shape[1], x.shape[1]
    assert widths == [k, k + 2 * d * k]
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), want[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("tile_elems", [1 << 25, 7 * 150])
def test_plain_f64_matches_dense_product(tile_elems, monkeypatch):
    """f64, against K(x, x) @ V from the port's kernel matrix, with one
    tile and with ragged tiles of 7 rows."""
    monkeypatch.setattr(matvec, "PLAIN_TILE_ELEMS", tile_elems)
    rng = np.random.default_rng(3)
    x, v = T(rng.uniform(0, 2, (150, 3))), T(rng.normal(size=(150, 4)))
    theta = T(np.array([1.3, 0.7, 1.1, 0.9]))
    want = gt.RBF().matrix(theta, x) @ v
    np.testing.assert_allclose(matvec.rbf_gram_matvec_plain(theta, x, v).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_gram_matvec_f32_takes_the_plain_kernel_and_matches_blocked():
    """A bare f32 RBF on the CPU goes through K4's plain version, and it
    equals the blocked path, noise term included (the JAX test's bound)."""
    rng = np.random.default_rng(4)
    x = T(rng.uniform(0, 2, (300, 2)).astype(np.float32))
    v = T(rng.normal(size=300).astype(np.float32))
    params = T(np.array([1.1, 0.9, 1.2, 0.3], np.float32))
    got = it.gram_matvec(gt.RBF(), params, x, v, block=64)
    ref = it._blocked_rows(gt.RBF(), params[:-1], x, x, v[:, None], 64, gt.DEFAULT)[:, 0] + (0.09 + 1e-7) * v
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_supported_matcher():
    assert matvec.supported(gt.RBF(), torch.zeros((4, 2)))
    assert not matvec.supported(gt.Sum((gt.RBF(), gt.WhiteNoise())), torch.zeros((4, 2)))
    assert not matvec.supported(gt.RBF(), torch.zeros((4, 2), dtype=torch.float64))
    assert not matvec.supported(gt.RBF(), torch.zeros((4, matvec.MAX_DIM + 1)))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises; a CPU tensor is never
    sent to the plain version from there."""
    x, v, theta = torch.zeros((4, 2)), torch.zeros((4, 1)), torch.ones(3)
    with pytest.raises(ValueError):
        matvec.rbf_gram_matvec_cuda(theta, x, v)


#: every width the iterative GP launches K4 at, at n = 32768 (and the CG
#: width at n = 131072): the forward and CG for the mean, the surrogate's
#: backward at k = 1, Lanczos and the probes, CG on [y, probes], the
#: backward at k = 8, a variance chunk
PATH_WIDTHS = (1, 5, 8, 9, 40, 256)


@pytest.mark.parametrize("n,k", [(32768, k) for k in PATH_WIDTHS] + [(131072, 9)])
def test_plan_fills_the_card_without_padding_the_path_widths(n, k):
    """At the iterative path's widths: a narrow template of exactly k
    columns (no padded FMA), a wide one padded by at most 25 %, and a grid
    of at least 2 blocks for each SM of an H100 (132 SMs).  These are
    blocks of the grid, not blocks resident at once: the count is
    BLOCKS_PER_SM, chosen by a trial on the card."""
    p = matvec.plan(n, k)
    if k <= 16:
        assert (p["regime"], p["width"]) == ("narrow", k)
    else:
        assert p["regime"] == "wide"
        assert p["col_tiles"] * p["width"] - k <= 0.25 * p["col_tiles"] * p["width"]
    assert p["blocks"] >= 2 * matvec.H100_SMS
    assert p["blocks"] == -(-n // p["rows"]) * p["col_tiles"] * p["splits"]
    # each split holds at least two steps of the column sweep
    assert p["splits"] == 1 or n // p["splits"] >= 2 * matvec.STEP[p["regime"]]


def test_every_width_maps_to_a_launch_the_kernel_takes():
    """Every k in 1..MAX_COLS gets a template the kernel instantiates
    (csrc's launch_width): a narrow width ≥ k for k ≤ 16, else a wide block
    width; and a grid the card takes (column tiles and splits ≤ 65535)."""
    narrow, wide = set(matvec.NARROW_WIDTHS), set(matvec.WIDE_ROWS)
    for k in range(1, matvec.MAX_COLS + 1):
        w = matvec.template_width(k)
        assert (k <= w and w in narrow) if k <= 16 else w in wide, (k, w)
    for k in (1, 16, 17, 48, 49, 64, 65, 129, matvec.MAX_COLS):
        for n in (1, 300, 8192, 131072):
            p = matvec.plan(n, k)
            assert p["col_tiles"] <= 65535 and 1 <= p["splits"] <= 65535
            assert p["col_tiles"] * p["width"] >= k


def test_compare_reads_the_old_sources_entry():
    """The comparison tool reads an earlier source's C entry by its
    parameters' types, and the current K4 source, whose entry takes the
    plan's width and splits, is not the one its K4 mode calls."""
    from pathlib import Path

    from pygpr_torch.bench import compare

    old = ("extern \"C\" int rbf_gram_matvec_f32(const void* x, const void* theta, const void* v, void* out,\n"
           "                                   int n, int d, int k, void* stream) {")
    name, want = compare.OLD_ENTRIES["k4"]
    assert compare.entry_types(old, name) == want
    assert compare.entry_types(old, "chol_inverse_f32") == ()
    src = (Path(matvec.__file__).parent.parent / "csrc" / "rbf_gram_matvec.cu").read_text()
    now = compare.entry_types(src, name)
    assert now[:4] == want[:4] and now != want and len(now) == 11


def test_compare_k4_exits_without_a_card(tmp_path, capsys):
    """The card-only comparison of K4 with an earlier source fails, and
    builds nothing, where there is no CUDA device."""
    from pygpr_torch.bench import compare

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would build and time")
    assert compare.main(["--kernel", "k4", "--old", str(tmp_path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
