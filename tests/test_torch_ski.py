"""Port parity: SKI (KISS-GP) against the JAX package.

The same seeded NumPy data go through both packages in f64: the grid and
its stencils, the interpolation and Kronecker matvecs, the SKI operator,
the direct path's statistics (in memory, and streamed through the port's
NumPy ``bincount`` accumulator), its NLML (the analytic gradient and plain
autograd through the ladder's Cholesky and the QR), fit and predict, and
the Krylov path's estimator, Adam fit and predict with the same probes.
The JAX side runs once, under one ``jax.jit``, in a module fixture, at
n ≤ 300 and grids of at most 64 nodes a side.  The wrapper runs both
paths on the CPU.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU for ``chip_smoke.py``'s direct problem
(``bench.py::bench_ski_direct``: n = 10⁶ in 1-D, g = 512, the port's f64
statistics fed to both precisions; in f64 also the analytic gradient
against autodiff through the ladder's Cholesky and the QR), the
yardstick of the card's limits:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ski.py [n]
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import iterative as it
from pygpr_torch.models import ski as kt
from pygpr_tpu.models import ski as kj

#: same algorithm on the same inputs, only summation order differs
RTOL = 1e-9
#: the Krylov solver settings of the parity runs: tight CG
KW = dict(rank=32, num_lanczos=12, cg_tol=1e-9, max_cg=400)
#: the direct NLML cases of the JAX test of the analytic gradient
#: (tests/test_ski.py::test_direct_analytic_grad_matches_ad)
CASES = {"1d_rbf": (1, 64, None), "2d_rbf": (2, 16, None), "1d_matern52": (1, 64, "matern52")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, dim, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim))
    return x, np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)


def _inputs():
    inp = {}
    for name, (dim, g, _) in CASES.items():
        x, y = _data(200, dim, 10 + dim)
        inp[name] = dict(x=x, y=y, g=g, params=np.array([1.2] + [0.9] * dim + [0.3]))
    x, y = _data(300, 1, 3)
    inp["krylov"] = dict(x=x, y=y, g=64, params=np.array([1.1, 1.4, 0.3]),
                         probes=it.make_probes(300, 8, seed=1).astype(np.float64),
                         xs=np.linspace(0.1, 1.9, 20)[:, None], v=np.random.default_rng(4).normal(size=(300, 2)))
    return inp


def _jax_kern(prof):
    return gj.RBF() if prof is None else gj.Separable(prof)


def _port_kern(prof):
    return gt.RBF() if prof is None else gt.Separable(prof)


@pytest.fixture(scope="module")
def parity():
    """The inputs, and every JAX result the tests compare with, from one
    compiled program (the data enter as constants: SKI's stencils are host
    NumPy in both packages)."""
    inp = _inputs()
    grids = {k: kj.make_grid(v["x"], v["g"]) for k, v in inp.items()}

    def run(theta):
        out = {}
        for name, (dim, g, prof) in CASES.items():
            d, grid, kern = inp[name], grids[name], _jax_kern(prof)
            stats = kj.compute_stats(d["x"], jnp.asarray(d["y"]), grid)
            p = jnp.asarray(d["params"])
            out[f"stats_{name}"] = (stats.z, stats.wty, stats.yty)
            out[f"vg_{name}"] = jax.value_and_grad(lambda q: kj.nlml_direct(kern, q, stats, grid))(p)
            out[f"vg_ad_{name}"] = jax.value_and_grad(
                lambda q: kj.nlml_direct(kern, q, stats, grid, analytic_grad=False))(p)
            out[f"mv_{name}"] = kj.ski_gram_matvec(kern, p, d["x"], grid, jnp.asarray(d["x"][:, :1] * 0 + 1.0))
        d, grid = inp["1d_rbf"], grids["1d_rbf"]
        stats = kj.compute_stats(d["x"], jnp.asarray(d["y"]), grid)
        xs = np.linspace(0.1, 1.9, 15)[:, None]
        out["pred_direct"] = kj.predict_direct(gj.RBF(), jnp.asarray(d["params"]), d["x"], d["y"], xs, grid,
                                               stats=stats)
        res = kj.fit_direct(gj.RBF(), jnp.ones(3), d["x"], jnp.asarray(d["y"]), grid, stats=stats, max_iter=20)
        out["fit_direct"] = (res.params, res.value)
        k, grid = inp["krylov"], grids["krylov"]
        p = jnp.asarray(k["params"])
        out["mv_krylov"] = kj.ski_gram_matvec(gj.RBF(), p, k["x"], grid, jnp.asarray(k["v"]))
        out["krylov_vg"] = kj.nlml_value_and_grad(gj.RBF(), p, k["x"], jnp.asarray(k["y"]),
                                                  jnp.asarray(k["probes"]), grid, **KW)
        out["krylov_pred"] = kj.predict(gj.RBF(), p, k["x"], jnp.asarray(k["y"]), k["xs"], grid, rank=32,
                                        cg_tol=1e-10, query_chunk=8)
        out["krylov_fit"] = kj.fit(gj.RBF(), jnp.ones(3), k["x"], jnp.asarray(k["y"]), jnp.asarray(k["probes"]),
                                   grid, iters=5, learning_rate=0.08, rank=32)
        return out

    want = jax.jit(run)(jnp.zeros(()))
    return inp, grids, jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


def _port_grid(jax_grid):
    return convert.grid_from_numpy(*jax_grid)


def test_grid_and_stencils_match_jax(parity):
    inp, grids, _ = parity
    for name, d in inp.items():
        g = kt.make_grid(d["x"], d["g"])
        np.testing.assert_array_equal(g.lo, grids[name].lo)
        np.testing.assert_array_equal(g.h, grids[name].h)
        assert g.sizes == grids[name].sizes and g.total == grids[name].total
        idx, wts = kt.interp_weights(d["x"], g)
        idx_j, wts_j = kj.interp_weights(d["x"], grids[name])
        np.testing.assert_array_equal(idx, idx_j)
        np.testing.assert_array_equal(wts, wts_j)
    i0, w = kt._cubic_taps(np.linspace(-1.5, 3.5, 11))
    i0_j, w_j = kj._cubic_taps(np.linspace(-1.5, 3.5, 11))
    np.testing.assert_array_equal(i0, i0_j)
    np.testing.assert_array_equal(w, w_j)
    with pytest.raises(ValueError):
        kt.make_grid(np.zeros((4, 2)), (16,))


def test_interp_and_kron_matvecs_match_jax(parity):
    """``W u``, ``Wᵀ v`` (``index_add``) and the per-axis Kronecker GEMMs."""
    inp, grids, _ = parity
    d, grid = inp["2d_rbf"], grids["2d_rbf"]
    idx, wts = kj.interp_weights(d["x"], grid)
    rng = np.random.default_rng(5)
    u, v = rng.normal(size=(grid.total, 3)), rng.normal(size=(200, 3))
    np.testing.assert_allclose(kt.interp_matvec(T(idx), T(wts), grid.sizes, T(u)).numpy(),
                               np.asarray(kj.interp_matvec(jnp.asarray(idx), jnp.asarray(wts), grid.sizes,
                                                           jnp.asarray(u))), rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(kt.interp_t_matvec(T(idx), T(wts), grid.sizes, T(v), grid.total).numpy(),
                               np.asarray(kj.interp_t_matvec(jnp.asarray(idx), jnp.asarray(wts), grid.sizes,
                                                             jnp.asarray(v), grid.total)), rtol=1e-12, atol=1e-13)
    t1, t2 = rng.normal(size=(5, 5)), rng.normal(size=(7, 7))
    u = rng.normal(size=(35, 3))
    np.testing.assert_allclose(kt.kron_matvec((T(t1), T(t2)), (5, 7), T(u)).numpy(), np.kron(t1, t2) @ u,
                               rtol=1e-12, atol=1e-12)
    theta = T(d["params"][:-1])
    fac = kt.grid_gram_factors(theta, _port_grid(grid), torch.float64)
    fac_j = kj.grid_gram_factors(jnp.asarray(d["params"][:-1]), grid, jnp.float64)
    for a, b in zip(fac, fac_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)


@pytest.mark.parametrize("name", ["1d_rbf", "2d_rbf", "1d_matern52", "krylov"])
def test_ski_gram_matvec_matches_jax(parity, name):
    inp, grids, want = parity
    d = inp[name]
    prof = CASES.get(name, (0, 0, None))[2]
    v = d["v"] if name == "krylov" else d["x"][:, :1] * 0 + 1.0
    got = kt.ski_gram_matvec(_port_kern(prof), T(d["params"]), T(d["x"]), _port_grid(grids[name]), T(v))
    np.testing.assert_allclose(got.numpy(), want[f"mv_{name}"], rtol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_statistics_match_jax_in_memory_and_streamed(parity, name):
    """``compute_stats`` (``index_add`` on the device) and
    ``compute_stats_streamed`` (f64 NumPy ``bincount``, in chunks smaller
    than n) against the JAX package's ``compute_stats``."""
    inp, grids, want = parity
    d, grid = inp[name], _port_grid(grids[name])
    z_j, wty_j, yty_j = want[f"stats_{name}"]
    s = kt.compute_stats(T(d["x"]), T(d["y"]), grid)
    streamed = kt.compute_stats_streamed((d["x"], d["y"]), grid, chunk=64, device="cpu")
    for st in (s, streamed):
        np.testing.assert_allclose(st.z.numpy(), z_j, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(st.wty.numpy(), wty_j, rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(st.yty.item(), yty_j, rtol=1e-12)
        assert st.n == 200 and st.z.dtype == torch.float64
    # the JAX package's own streamed statistics, carried across
    sj = kj.compute_stats_streamed((d["x"], d["y"]), grids[name], chunk=64)
    carried = convert.ski_stats_from_numpy({k: np.asarray(v) for k, v in sj._asdict().items()}, "cpu")
    np.testing.assert_allclose(carried.z.numpy(), streamed.z.numpy(), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name", list(CASES))
def test_nlml_direct_matches_jax(parity, name):
    """Value and gradient by both routes against the JAX package's; the
    analytic gradient against autograd to the JAX test's 5e-4 (the ladder's
    jitter is a constant in one and weakly differentiated in the other)."""
    inp, grids, want = parity
    d, grid = inp[name], _port_grid(grids[name])
    kern = _port_kern(CASES[name][2])
    stats = kt.compute_stats(T(d["x"]), T(d["y"]), grid)
    grads = {}
    for analytic in (True, False):
        p = T(d["params"]).requires_grad_(True)
        v = kt.nlml_direct(kern, p, stats, grid, analytic_grad=analytic)
        (g,) = torch.autograd.grad(v, p)
        wv, wg = want[f"vg_{name}" if analytic else f"vg_ad_{name}"]
        np.testing.assert_allclose(v.item(), wv, rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), wg, rtol=1e-7)
        grads[analytic] = g.numpy()
    np.testing.assert_allclose(grads[True], grads[False], rtol=5e-4, atol=1e-5)


def test_nlml_direct_on_the_jax_statistics(parity):
    inp, grids, want = parity
    z, wty, yty = want["stats_1d_rbf"]
    stats = convert.ski_stats_from_numpy(dict(z=z, wty=wty, yty=yty, n=200), "cpu")
    v = kt.nlml_direct(gt.RBF(), T(inp["1d_rbf"]["params"]), stats, _port_grid(grids["1d_rbf"]))
    np.testing.assert_allclose(v.item(), want["vg_1d_rbf"][0], rtol=RTOL)


def test_direct_fit_and_predict_match_jax(parity):
    inp, grids, want = parity
    d, grid = inp["1d_rbf"], _port_grid(grids["1d_rbf"])
    stats = kt.compute_stats(T(d["x"]), T(d["y"]), grid)
    xs = np.linspace(0.1, 1.9, 15)[:, None]
    mean, var = kt.predict_direct(gt.RBF(), T(d["params"]), T(d["x"]), T(d["y"]), T(xs), grid, stats=stats)
    np.testing.assert_allclose(mean.numpy(), want["pred_direct"][0], atol=1e-9)
    np.testing.assert_allclose(var.numpy(), want["pred_direct"][1], atol=1e-9)
    assert kt.predict_direct(gt.RBF(), T(d["params"]), T(d["x"]), T(d["y"]), T(xs), grid, stats=stats,
                             var="none")[1] is None
    with pytest.raises(ValueError):
        kt.predict_direct(gt.RBF(), T(d["params"]), T(d["x"]), T(d["y"]), T(xs), grid, stats=stats, var="full")
    res = kt.fit_direct(gt.RBF(), torch.ones(3, dtype=torch.float64), T(d["x"]), T(d["y"]), grid, stats=stats,
                        max_iter=20)
    np.testing.assert_allclose(res.params.numpy(), want["fit_direct"][0], rtol=1e-6)
    np.testing.assert_allclose(res.value.item(), want["fit_direct"][1], rtol=1e-9)


def test_krylov_estimator_predict_and_fit_match_jax(parity):
    """The Krylov path with the same probes: the estimated NLML and its
    gradient, the CG predictions (chunks padded with the first query), and
    five Adam steps."""
    inp, grids, want = parity
    k, grid = inp["krylov"], _port_grid(grids["krylov"])
    p, x, y = T(k["params"]), T(k["x"]), T(k["y"])
    v, g = kt.nlml_value_and_grad(gt.RBF(), p, x, y, T(k["probes"]), grid, **KW)
    np.testing.assert_allclose(v.item(), want["krylov_vg"][0], rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), want["krylov_vg"][1], rtol=1e-8)
    mean, var = kt.predict(gt.RBF(), p, x, y, T(k["xs"]), grid, rank=32, cg_tol=1e-10, query_chunk=8)
    np.testing.assert_allclose(mean.numpy(), want["krylov_pred"][0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(var.numpy(), want["krylov_pred"][1], rtol=1e-8)
    with pytest.raises(ValueError):
        kt.predict(gt.RBF(), p, x, y, T(k["xs"]), grid, var="full")
    params, trace = kt.fit(gt.RBF(), torch.ones(3, dtype=torch.float64), x, y, T(k["probes"]), grid, iters=5,
                           learning_rate=0.08, rank=32)
    np.testing.assert_allclose(trace.numpy(), want["krylov_fit"][1], rtol=1e-8)
    np.testing.assert_allclose(params.numpy(), want["krylov_fit"][0], rtol=1e-8)


def test_skigp_direct_and_krylov_paths():
    """The wrapper on the CPU, both paths (the JAX tests' checks at a
    smaller grid): the direct path under L-BFGS, and the Krylov path above
    ``direct_max``."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 2.0, size=(256, 2))
    y = np.sin(2.0 * x[:, 0]) * np.cos(x[:, 1]) + 0.1 * rng.normal(size=256)
    model = gt.SKIGP(x, y, grid_size=20, num_probes=8, rank=32, seed=3, device="cpu")
    assert model.direct
    trace = model.train(iters=20, learning_rate=0.1)
    assert trace.shape == (1,) and np.isfinite(trace.item())
    xs = rng.uniform(0.2, 1.8, size=(50, 2))
    mean, var = model.predict(xs)
    assert np.sqrt(np.mean((mean.numpy() - np.sin(2.0 * xs[:, 0]) * np.cos(xs[:, 1])) ** 2)) < 0.15
    assert torch.isfinite(var).all()

    x = np.sort(rng.uniform(0.0, 4.0, size=(256, 1)), axis=0)
    y = np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=256)
    model = gt.SKIGP(x, y, grid_size=64, num_probes=8, rank=24, seed=0, direct_max=32, device="cpu")
    assert not model.direct
    trace = model.train(iters=20, learning_rate=0.1, max_cg=80)
    assert trace[-1] < trace[0]
    mean, var = model.predict(x[:50])
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()


def test_ski_rejects_a_kernel_that_does_not_factorize():
    with pytest.raises(ValueError):
        kt.make_ski_matvec(gt.Matern(1.5), np.zeros((10, 1)), kt.make_grid(np.random.rand(10, 1), 32),
                           device="cpu")


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def bench_ski_direct_data(n=1_000_000, seed=7):
    """``bench.py::bench_ski_direct``'s problem: x ~ U(0, 8) sorted, 1-D,
    y = sin(2x) + 0.1ε, both f32."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 8.0, (n, 1)).astype(np.float32), axis=0)
    y = (np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _jax_run(n: int, dtype: str, path: str) -> dict:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "f64")
    x, _ = bench_ski_direct_data(n)
    grid = kj.make_grid(x, 512)
    f = np.load(path)
    dt = np.float64 if dtype == "f64" else np.float32
    stats = kj.SKIStats(z=jnp.asarray(f["z"].astype(dt)), wty=jnp.asarray(f["wty"].astype(dt)),
                        yty=jnp.asarray(f["yty"].astype(dt)), n=n)
    p0 = jnp.asarray([1.0, 1.0, 0.1], dt)
    v, g = jax.jit(jax.value_and_grad(lambda p: kj.nlml_direct(gj.RBF(), p, stats, grid)))(p0)
    g_ad = jax.jit(jax.grad(lambda p: kj.nlml_direct(gj.RBF(), p, stats, grid, analytic_grad=False)))(p0)
    return {"value": float(v), "grad": np.asarray(g, np.float64).tolist(),
            "grad_autodiff": np.asarray(g_ad, np.float64).tolist()}


def _gaps(n: int) -> dict:
    import tempfile

    x, y = bench_ski_direct_data(n)
    stats = kt.compute_stats_streamed((x, y), kt.make_grid(x, 512), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/stats.npz"
        np.savez(path, z=stats.z.numpy(), wty=stats.wty.numpy(), yty=stats.yty.numpy())
        runs = {}
        for dtype in ("f64", "f32"):
            out = subprocess.run([sys.executable, __file__, "run", str(n), dtype, path], capture_output=True,
                                 text=True, check=True)
            runs[dtype] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = runs["f32"], runs["f64"]
    g32, g64 = np.asarray(a["grad"]), np.asarray(b["grad"])
    ad64 = np.asarray(b["grad_autodiff"])
    return {"n": n, "rel_value": abs(a["value"] - b["value"]) / abs(b["value"]),
            "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)),
            "rel_grad_each": (np.abs(g32 - g64) / np.abs(g64)).tolist(),
            "analytic_vs_autodiff_f64": float(np.linalg.norm(g64 - ad64) / np.linalg.norm(ad64)),
            "analytic_vs_autodiff_f64_each": (np.abs(g64 - ad64) / np.abs(ad64)).tolist(), "f64": b, "f32": a}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "run":
        print(json.dumps(_jax_run(int(sys.argv[2]), sys.argv[3], sys.argv[4])), flush=True)
    else:
        print(json.dumps({"jax_ski_direct_f32_gaps": _gaps(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)}),
              flush=True)
