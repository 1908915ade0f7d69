"""Port parity: the matrix-free iterative GP against the JAX package.

Inputs are made with NumPy from a seed and fed to both packages, with the
same probes (``make_probes`` is the same NumPy generator in both).  The
JAX side runs under one ``jax.jit`` per module, in a fixture: called
eagerly, its ``while_loop``s compile anew on every call.  In f64 the port
takes the blocked torch path, the counterpart of the JAX package's XLA
path, so the two agree to round-off.

Run as a script, the file measures the JAX package's own f32-against-f64
gaps on the CPU (XLA path), the yardsticks of the card's checks in
``chip_smoke.py``, and beside them the port's own gaps on the CPU at the
same n, data, probes and settings (its f32 path there is K4's plain
version, the card's comparison):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_iterative.py
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import iterative as it
from pygpr_tpu.models import iterative as ij

N = 200
#: solver settings of the parity runs: tight CG so that the tolerance
#: tests the port's arithmetic, not the truncation; rank below n so that
#: the SLQ term is not zero
KW = dict(rank=32, num_lanczos=12, cg_tol=1e-9, max_cg=400, block=64)
PRED_KW = dict(rank=32, cg_tol=1e-9, max_cg=400, block=64, query_chunk=16)
#: the whole slice through the two packages' IterativeGP, default solvers;
#: its training is the JAX ``fit`` that test_fit_trace_and_params holds
SLICE = dict(num_probes=8, rank=24, block=64, seed=3)
SLICE_ITERS = 5
#: f64 parity bound (relative): every piece is the same algorithm on the
#: same inputs, so only summation order differs; CG and Lanczos amplify
#: that by the conditioning of K + σₙ²I (σₙ = 0.3 here), far inside 1e-8
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 3.0, (N, 2))
    return dict(
        x=x,
        y=np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=N),
        xq=rng.uniform(0.0, 3.0, (37, 2)),
        v=rng.normal(size=(N, 3)),
        u=rng.normal(size=(N, 4)),
        params=np.array([1.1, 0.9, 1.2, 0.3]),
        probes=ij.make_probes(N, 8, seed=1).astype(np.float64),
        xs=rng.uniform(0.0, 3.0, (21, 2)),
    )


@pytest.fixture(scope="module")
def parity():
    """The inputs, and every JAX result the tests compare with, from one
    compiled program."""
    inp = _inputs()
    rbf = gj.RBF()

    def run(x, y, xq, v, u, params, probes, xs):
        theta, sn = params[:-1], params[-1]
        sn2 = sn * sn + 1e-7
        mv = lambda w: ij.gram_matvec(rbf, params, x, w, block=KW["block"])
        L, piv = ij.pivoted_cholesky(rbf, theta, x, KW["rank"], return_pivots=True)
        pre = ij.make_preconditioner(L, sn2, N)
        B = jnp.concatenate([y[:, None], probes], axis=1)
        out = {
            "gram_matvec": mv(v),
            "gram_matvec_vec": mv(v[:, 0]),
            "cross_matvec": ij.cross_matvec(rbf, params, xq, x, v, block=32),
            "L": L, "pivots": piv,
            "apply_inv": pre.apply_inv(u), "apply_inv_sqrt": pre.apply_inv_sqrt(u),
            "half_logdet": pre.half_logdet,
            "slq": ij.slq_logdet(mv, probes, num_lanczos=KW["num_lanczos"]),
        }
        out["cg"], out["cg_iters"] = ij.cg_solve(mv, B, precond_inv=pre.apply_inv, tol=KW["cg_tol"],
                                                 max_iter=KW["max_cg"])
        out["value"], out["grad"] = ij.nlml_value_and_grad(rbf, params, x, y, probes, **KW)
        out["mean"], out["var"] = ij.predict(rbf, params, x, y, xq, **PRED_KW)
        # the whole slice: IterativeGP.train then .predict, then its state
        # carried across (convert) and its nlml()
        model = ij.IterativeGP(x, y, rbf, **SLICE)
        out["slice_trace"] = model.train(iters=SLICE_ITERS)
        out["slice_params"] = model.params
        out["slice_mean"], out["slice_var"] = model.predict(xs)
        out["slice_probes"] = model.probes
        out["slice_nlml"] = model.nlml()
        return out

    want = jax.jit(run)(**{k: jnp.asarray(a) for k, a in inp.items()})
    return inp, jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol)


def test_gram_and_cross_matvec(parity):
    inp, want = parity
    rbf = gt.RBF()
    p, x, v = T(inp["params"]), T(inp["x"]), T(inp["v"])
    close(it.gram_matvec(rbf, p, x, v, block=KW["block"]), want["gram_matvec"])
    close(it.gram_matvec(rbf, p, x, v[:, 0], block=KW["block"]), want["gram_matvec_vec"])
    close(it.cross_matvec(rbf, p, T(inp["xq"]), x, v, block=32), want["cross_matvec"])


def test_blocked_matvec_is_differentiable_in_params_only(parity):
    """The blocked path's backward recomputes each tile for θ̄ alone (what
    the Hutchinson surrogate needs) and refuses a gradient in x."""
    inp, want = parity
    x = T(inp["x"]).requires_grad_(True)
    out = it.gram_matvec(gt.RBF(), T(inp["params"]), x, T(inp["v"]), block=KW["block"])
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(out.sum(), x)


def test_pivoted_cholesky_and_preconditioner(parity):
    inp, want = parity
    theta, sn = T(inp["params"][:-1]), inp["params"][-1]
    L, piv = it.pivoted_cholesky(gt.RBF(), theta, T(inp["x"]), KW["rank"], return_pivots=True)
    np.testing.assert_array_equal(piv.numpy(), want["pivots"])
    # L's entries near 0 carry the round-off of the largest: atol at its scale
    close(L, want["L"], atol=RTOL * np.abs(want["L"]).max())
    pre = it.make_preconditioner(L, sn * sn + 1e-7, N)
    u = T(inp["u"])
    close(pre.apply_inv(u), want["apply_inv"])
    close(pre.apply_inv_sqrt(u), want["apply_inv_sqrt"])
    close(pre.half_logdet, want["half_logdet"])


def test_cg_solve_and_slq(parity):
    inp, want = parity
    rbf, p, x = gt.RBF(), T(inp["params"]), T(inp["x"])
    mv = lambda w: it.gram_matvec(rbf, p, x, w, block=KW["block"])
    L = it.pivoted_cholesky(rbf, p[:-1], x, KW["rank"])
    pre = it.make_preconditioner(L, p[-1] ** 2 + 1e-7, N)
    B = torch.cat([T(inp["y"])[:, None], T(inp["probes"])], dim=1)
    X, iters = it.cg_solve(mv, B, precond_inv=pre.apply_inv, tol=KW["cg_tol"], max_iter=KW["max_cg"])
    assert iters == int(want["cg_iters"])
    close(X, want["cg"], atol=RTOL * np.abs(want["cg"]).max())
    close(it.slq_logdet(mv, T(inp["probes"]), num_lanczos=KW["num_lanczos"]), want["slq"])


def test_nlml_value_and_grad(parity):
    inp, want = parity
    v, g = it.nlml_value_and_grad(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["probes"]), **KW)
    close(v, want["value"])
    close(g, want["grad"])


def test_fit_trace_and_params(parity):
    """5 Adam steps from the reference init (the JAX IterativeGP's train
    with the same probes): the whole NLML trace and the end point."""
    inp, want = parity
    x = T(inp["x"])
    params, trace = it.fit(gt.RBF(), it.init_params(gt.RBF(), x), x, T(inp["y"]), T(want["slice_probes"]),
                           rank=SLICE["rank"], block=SLICE["block"], iters=SLICE_ITERS)
    close(trace, want["slice_trace"])
    close(params, want["slice_params"])


def test_predict_mean_and_var(parity):
    inp, want = parity
    mean, var = it.predict(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["xq"]), **PRED_KW)
    close(mean, want["mean"])
    close(var, want["var"])
    assert it.predict(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["xq"]), var="none",
                      **PRED_KW)[1] is None
    with pytest.raises(ValueError):
        it.predict(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["xq"]), var="full")


def test_iterative_gp_slice(parity):
    """IterativeGP.train then .predict on the CPU, against the JAX model
    with the same data, seed and defaults."""
    inp, want = parity
    model = gt.IterativeGP(inp["x"], inp["y"], gt.RBF(), device="cpu", **SLICE)
    np.testing.assert_array_equal(model.probes.numpy(), want["slice_probes"])
    trace = model.train(iters=SLICE_ITERS)
    close(trace, want["slice_trace"])
    close(model.params, want["slice_params"])
    mean, var = model.predict(inp["xs"])
    close(mean, want["slice_mean"])
    close(var, want["slice_var"])


def test_convert_iterative_gp(parity):
    """A JAX IterativeGP's arrays carried across give the same nlml() and
    the same prediction."""
    inp, want = parity
    arrays = {"x": inp["x"], "y": inp["y"], "params": want["slice_params"], "probes": want["slice_probes"]}
    model = convert.iterative_gp_from_numpy(arrays, gt.RBF(), "cpu", rank=SLICE["rank"], block=SLICE["block"])
    close(model.nlml(), want["slice_nlml"])
    mean, var = model.predict(inp["xs"])
    close(mean, want["slice_mean"])
    close(var, want["slice_var"])


def test_check_noise_free_refuses_whitenoise():
    from pygpr_torch.models.sgpr import _check_noise_free

    with pytest.raises(ValueError):
        _check_noise_free(gt.Sum((gt.RBF(), gt.WhiteNoise())))
    _check_noise_free(gt.RBF())
    x = np.zeros((4, 2))
    with pytest.raises(ValueError):
        gt.IterativeGP(x, np.zeros(4), gt.Sum((gt.RBF(), gt.WhiteNoise())), device="cpu")
    with pytest.raises(ValueError):
        it.nlml_value_and_grad(gt.Sum((gt.RBF(), gt.WhiteNoise())), torch.ones(5), T(x), torch.zeros(4),
                               torch.ones(4, 2))


def test_init_params_and_probes_match_jax():
    x = np.random.default_rng(2).uniform(size=(9, 3))
    np.testing.assert_array_equal(it.init_params(gt.RBF(), T(x)).numpy(),
                                  np.asarray(ij.init_params(gj.RBF(), jnp.asarray(x))))
    np.testing.assert_array_equal(it.make_probes(33, 5, 4), ij.make_probes(33, 5, 4))


# -- the JAX package's own f32-against-f64 gaps (run as a script) ----------

def _iterative_gap(n):
    """Relative gaps of the iterative NLML estimator, f32 against f64,
    on the JAX package's XLA path at the settings of its bench
    (``bench_iterative_large_n``: its data, 8 probes, rank 64, 16 Lanczos
    steps, cg_tol 1e-4, max_cg 64, block 4096) at size n."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, (n, 2))
    y = np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)
    probes = ij.make_probes(n, 8, 0)
    params = np.array([1.0, 1.0, 1.0, 0.1])
    f = jax.jit(lambda p, xx, yy, zz: ij.nlml_value_and_grad(
        gj.RBF(), p, xx, yy, zz, rank=64, num_lanczos=16, cg_tol=1e-4, max_cg=64, block=4096))
    out = {}
    for dt in (jnp.float32, jnp.float64):
        v, g = f(*(jnp.asarray(a, dt) for a in (params, x, y, probes)))
        out[dt] = (float(v), np.asarray(g, np.float64))
    (v32, g32), (v64, g64) = out[jnp.float32], out[jnp.float64]
    port = {}
    for dt in (torch.float32, torch.float64):
        v, g = it.nlml_value_and_grad(gt.RBF(), *(torch.as_tensor(a, dtype=dt) for a in (params, x, y, probes)),
                                      rank=64, num_lanczos=16, cg_tol=1e-4, max_cg=64, block=4096)
        port[dt] = (float(v), g.detach().double().numpy())
    (pv32, pg32), (pv64, pg64) = port[torch.float32], port[torch.float64]
    return {"n": n, "value_f32": v32, "value_f64": v64, "rel_value": abs(v32 - v64) / abs(v64),
            "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)),
            "port_value_f32": pv32, "port_value_f64": pv64, "port_rel_value": abs(pv32 - pv64) / abs(pv64),
            "port_rel_grad": float(np.linalg.norm(pg32 - pg64) / np.linalg.norm(pg64)),
            "port_f64_vs_jax_f64_value": abs(pv64 - v64) / abs(v64)}


def _exact_gap(n):
    """Relative gaps of the exact NLML value and fast gradient, f32
    against f64, on the JAX package's XLA path with ``bench.py``'s data."""
    import bench
    from pygpr_tpu.config import Config
    from pygpr_tpu.models import likelihood

    x, y, params = (np.asarray(a, np.float64) for a in bench.make_data(n)[:3])
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    f = jax.jit(lambda p, xx, yy: likelihood.nlml_value_and_grad(cov, p, xx, yy, Config(grad_mode="fast")))
    out = {}
    for dt in (jnp.float32, jnp.float64):
        v, g = f(*(jnp.asarray(a, dt) for a in (params, x, y)))
        out[dt] = (float(v), np.asarray(g, np.float64))
    (v32, g32), (v64, g64) = out[jnp.float32], out[jnp.float64]
    return {"n": n, "rel_value": abs(v32 - v64) / abs(v64),
            "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))}


def _variance_inputs(n, n_query=512):
    """The variance readings' data: the iterative bench's generator at n
    (f64), ``n_query`` queries and its parameters."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, (n, 2))
    y = np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)
    xq = rng.uniform(0, 4, (n_query, 2))
    return np.array([1.0, 1.0, 1.0, 0.1]), x, y, xq


def _latent_variances(inputs):
    """The diagonal predictive variance's latent part (var − σₙ² − jitter)
    at the bench's solver settings, in f32 and f64, by the JAX package's
    XLA path and by the port: ``{("jax" | "port", "f32" | "f64"): array}``."""
    from pygpr_tpu.config import Config

    kw = dict(var="diag", rank=64, cg_tol=1e-4, max_cg=64, block=4096)
    f = jax.jit(lambda p, xx, yy, qq: ij.predict(gj.RBF(), p, xx, yy, qq, **kw)[1])
    sn2 = inputs[0][-1] ** 2
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32), ("f64", jnp.float64, torch.float64)):
        out["jax", name] = np.asarray(f(*(jnp.asarray(a, jdt) for a in inputs)), np.float64) - sn2 - Config().jitter
        with torch.no_grad():
            var = it.predict(gt.RBF(), *(torch.as_tensor(a, dtype=tdt) for a in inputs), **kw)[1]
        out["port", name] = var.double().numpy() - sn2 - gt.DEFAULT.jitter
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _variance_gap(n, n_query=512):
    """Relative gaps of the diagonal predictive variance's latent part, in
    norm over ``n_query`` queries, at the bench's settings, in both
    packages: f32 against f64, and f64 against the exact GP (a dense f64
    solve in NumPy)."""
    inputs = _variance_inputs(n, n_query)
    params, x, _, xq = inputs
    lat = _latent_variances(inputs)

    def gram(a, b):
        return np.exp(-np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1))

    chol = np.linalg.cholesky(gram(x, x) + params[-1] ** 2 * np.eye(n))
    half = np.linalg.solve(chol, gram(x, xq))
    exact = 1.0 - np.sum(half * half, axis=0)
    return {"n": n, "latent_exact_median": float(np.median(exact)),
            "f32_vs_f64": _rel(lat["jax", "f32"], lat["jax", "f64"]), "f64_vs_exact": _rel(lat["jax", "f64"], exact),
            "port_f32_vs_f64": _rel(lat["port", "f32"], lat["port", "f64"]),
            "port_f64_vs_exact": _rel(lat["port", "f64"], exact),
            "port_f64_vs_jax_f64": _rel(lat["port", "f64"], lat["jax", "f64"])}


def _variance_gap_spread(n, n_query=512):
    """The f32-against-f64 gap of the latent variance in both packages on
    the f32-rounded data of :func:`_variance_gap` and on the same data
    with every input coordinate moved one f32 ulp up, and down: how far
    f32 round-off alone moves each package's gap."""
    params, x, y, xq = _variance_inputs(n, n_query)
    x32 = x.astype(np.float32)
    out = {"n": n, "jax": {}, "port": {}}
    for name, xs in (("data", x32), ("up", np.nextafter(x32, np.float32(np.inf))),
                     ("down", np.nextafter(x32, np.float32(-np.inf)))):
        lat = _latent_variances((params, xs.astype(np.float64), y, xq))
        for package in ("jax", "port"):
            out[package][name] = _rel(lat[package, "f32"], lat[package, "f64"])
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    for n in (4096, 8192):
        print(json.dumps({"iterative": _iterative_gap(n)}), flush=True)
    for n in (2048, 8192):
        print(json.dumps({"exact": _exact_gap(n)}), flush=True)
    for n in (4096, 8192):
        print(json.dumps({"variance": _variance_gap(n)}), flush=True)
    for n in (4096, 8192):
        print(json.dumps({"variance_spread": _variance_gap_spread(n)}), flush=True)
