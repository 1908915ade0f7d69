"""Port parity: the Kronecker grid GP against the JAX package.

The same seeded NumPy grids go through both packages in f64: the NLML on
2-D and 3-D grids (against the JAX package and the dense pipeline of
``Sum((Separable, WhiteNoise))``), its gradient through ``eigh``, the
factorized state and the predictions, the fit and the wrapper.  Only
quantities invariant to eigenvector signs are compared (the NLML, its
gradient, α, the denominators and the predictions); a JAX state carried
across by ``convert.kron_state_from_numpy`` keeps the JAX eigenvectors and
predicts as the JAX package does.  The JAX side runs once, under one
``jax.jit``, in a module fixture.  The large f32 case compares the port
with its own f64.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU for ``chip_smoke.py``'s Kronecker problem
(``bench.py::bench_kron``: g = 512 per axis), the yardstick of the card's
limits:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_kronecker.py [g]
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
from pygpr_torch.models import kronecker as kt
from pygpr_tpu.models import kronecker as kj

#: the JAX tests' tolerances: NLML against dense 1e-9, predictions 1e-9
RTOL_NLML, ATOL_PRED = 1e-9, 1e-9
#: the dense pipeline's fixed 1e-7 jitter folded into the grid noise
SN_ADJ = float(np.sqrt(0.04 + 1e-7))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(axes, f, seed, noise):
    G = np.meshgrid(*axes, indexing="ij")
    x_full = np.stack([g.ravel() for g in G], -1)
    return x_full, f(*G) + noise * np.random.default_rng(seed).normal(size=G[0].shape)


def _inputs():
    rng = np.random.default_rng(0)
    ax1, ax2 = np.sort(rng.uniform(0, 3, 8)), np.sort(rng.uniform(0, 2, 7))
    x2, y2 = _grid([ax1, ax2], lambda a, b: np.sin(2 * a) * np.cos(3 * b), 1, 0.1)
    rng3 = np.random.default_rng(1)
    axes3 = [np.sort(rng3.uniform(0, 1, 5)) for _ in range(3)]
    x3, y3 = _grid(axes3, lambda a, b, c: np.sin(a + b) * c, 2, 0.05)
    fa1, fa2 = np.linspace(0, 3, 12), np.linspace(0, 3, 10)
    _, yf = _grid([fa1, fa2], lambda a, b: np.sin(2 * a) * np.cos(2 * b), 5, 0.1)
    return dict(ax1=ax1, ax2=ax2, x2=x2, y2=y2, a31=axes3[0], a32=axes3[1], a33=axes3[2], x3=x3, y3=y3,
                xq=np.random.default_rng(2).uniform(0, 2, (11, 2)), fa1=fa1, fa2=fa2, yf=yf,
                xqf=np.random.default_rng(3).uniform(0.2, 2.8, (16, 2)),
                p2=np.array([1.0, 1.2, 0.9, SN_ADJ]), p3=np.array([1.0, 1.0, 1.0, 1.0, SN_ADJ]))


@pytest.fixture(scope="module")
def parity():
    """The inputs, and every JAX result the tests compare with, from one
    compiled program."""
    inp = _inputs()

    def run(ax1, ax2, x2, y2, a31, a32, a33, x3, y3, xq, fa1, fa2, yf, xqf, p2, p3):
        out = {}
        rbf = gj.Separable("rbf")
        axes2 = [ax1, ax2]
        out["nlml2"] = kj.nlml_kron(rbf, p2, axes2, y2)
        out["grad2"] = jax.grad(lambda u: kj.nlml_kron(rbf, jnp.exp(u), axes2, y2))(jnp.log(p2))
        for prof in ("rbf", "matern32"):
            out[f"nlml3_{prof}"] = kj.nlml_kron(gj.Separable(prof), p3, [a31, a32, a33], y3)
            out[f"grad3_{prof}"] = jax.grad(lambda q: kj.nlml_kron(gj.Separable(prof), q, [a31, a32, a33], y3))(p3)
        st = kj.factorize_kron(rbf, p2, axes2, y2)
        out["state"] = st._asdict()
        out["pred"] = kj.predict_kron(rbf, st, xq)
        res = kj.fit_kron(rbf, [fa1, fa2], yf, max_iter=30)
        out["fit_params"], out["fit_nlml"] = res.params, res.nlml
        out["fit_pred"] = kj.predict_kron(rbf, res.state, xqf)
        return out

    want = jax.jit(run)(**{k: jnp.asarray(a) for k, a in inp.items()})
    return inp, jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


def test_nlml_kron_2d_matches_jax_and_dense(parity):
    inp, want = parity
    axes = [T(inp["ax1"]), T(inp["ax2"])]
    v = kt.nlml_kron(gt.Separable("rbf"), T(inp["p2"]), axes, T(inp["y2"])).item()
    np.testing.assert_allclose(v, want["nlml2"], rtol=RTOL_NLML)
    cov = gt.Sum((gt.Separable("rbf"), gt.WhiteNoise()))
    dense = gt.nlml(cov, T([1.0, 1.2, 0.9, 0.2]), T(inp["x2"]), T(inp["y2"]).reshape(-1)).item()
    np.testing.assert_allclose(v, dense, rtol=RTOL_NLML)


@pytest.mark.parametrize("profile", ["rbf", "matern32"])
def test_nlml_kron_3d_and_gradient_match_jax(parity, profile):
    inp, want = parity
    axes = [T(inp["a31"]), T(inp["a32"]), T(inp["a33"])]
    p = T(inp["p3"]).requires_grad_(True)
    v = kt.nlml_kron(gt.Separable(profile), p, axes, T(inp["y3"]))
    (g,) = torch.autograd.grad(v, p)
    np.testing.assert_allclose(v.item(), want[f"nlml3_{profile}"], rtol=RTOL_NLML)
    np.testing.assert_allclose(g.numpy(), want[f"grad3_{profile}"], rtol=1e-8)
    cov = gt.Sum((gt.Separable(profile), gt.WhiteNoise()))
    dense = gt.nlml(cov, T([1.0, 1.0, 1.0, 1.0, 0.2]), T(inp["x3"]), T(inp["y3"]).reshape(-1)).item()
    np.testing.assert_allclose(v.item(), dense, rtol=RTOL_NLML)


def test_gradient_through_eigh_matches_jax(parity):
    """The log-parameter gradient (autograd through ``torch.linalg.eigh``
    and the clamp at zero) against ``jax.grad`` through ``jnp.linalg.eigh``."""
    inp, want = parity
    u = torch.log(T(inp["p2"])).requires_grad_(True)
    v = kt.nlml_kron(gt.Separable("rbf"), torch.exp(u), [T(inp["ax1"]), T(inp["ax2"])], T(inp["y2"]))
    (g,) = torch.autograd.grad(v, u)
    np.testing.assert_allclose(g.numpy(), want["grad2"], rtol=1e-8)


def test_factorize_and_predict_match_jax(parity):
    inp, want = parity
    kern = gt.Separable("rbf")
    st = kt.factorize_kron(kern, T(inp["p2"]), [T(inp["ax1"]), T(inp["ax2"])], T(inp["y2"]))
    ws = want["state"]
    assert bool(st.ok)
    np.testing.assert_allclose(st.nlml.item(), ws["nlml"], rtol=RTOL_NLML)
    np.testing.assert_allclose(st.alpha.numpy(), ws["alpha"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(st.denom.numpy(), ws["denom"], rtol=1e-9, atol=1e-12)
    mean, var = kt.predict_kron(kern, st, T(inp["xq"]))
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], atol=ATOL_PRED)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], atol=ATOL_PRED)
    m_none, v_none = kt.predict_kron(kern, st, T(inp["xq"]), "none")
    assert v_none is None
    np.testing.assert_allclose(m_none.numpy(), mean.numpy())
    # the dense exact GP's posterior (its diagonal carries σₙ² = 0.04)
    cov = gt.Sum((gt.Separable("rbf"), gt.WhiteNoise()))
    se = gt.factorize(cov, T([1.0, 1.2, 0.9, 0.2]), T(inp["x2"]), T(inp["y2"]).reshape(-1))
    m_e, v_e = gt.predict(cov, se, T(inp["xq"]), "diag")
    np.testing.assert_allclose(mean.numpy(), m_e.numpy(), atol=ATOL_PRED)
    np.testing.assert_allclose(var.numpy(), v_e.numpy() - 0.04, atol=ATOL_PRED)


def test_kron_state_from_numpy_predicts_as_jax(parity):
    inp, want = parity
    st = convert.kron_state_from_numpy(want["state"], "cpu")
    mean, var = kt.predict_kron(gt.Separable("rbf"), st, T(inp["xq"]))
    np.testing.assert_allclose(mean.numpy(), want["pred"][0], atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want["pred"][1], atol=1e-12)


def test_fit_kron_and_wrapper_match_jax(parity):
    """30 L-BFGS iterations in both packages (the port's L-BFGS is optax's
    step for step), the state at the fit, and the wrapper's train and
    predict; the JAX test's quality bounds on the fit."""
    inp, want = parity
    kern = gt.Separable("rbf")
    axes = [T(inp["fa1"]), T(inp["fa2"])]
    res = kt.fit_kron(kern, axes, T(inp["yf"]), max_iter=30)
    np.testing.assert_allclose(res.params.numpy(), want["fit_params"], rtol=1e-6)
    np.testing.assert_allclose(res.nlml.item(), want["fit_nlml"], rtol=1e-9)
    mean, var = kt.predict_kron(kern, res.state, T(inp["xqf"]))
    np.testing.assert_allclose(mean.numpy(), want["fit_pred"][0], atol=1e-6)
    np.testing.assert_allclose(var.numpy(), want["fit_pred"][1], atol=1e-6)
    model = gt.KroneckerGP([inp["fa1"], inp["fa2"]], inp["yf"], profile="rbf", device="cpu")
    res_w = model.train(max_iter=30)
    np.testing.assert_allclose(res_w.params.numpy(), res.params.numpy(), rtol=1e-12)
    assert 0.05 < res_w.params[-1].item() < 0.2
    m_w, v_w = model.predict(inp["xqf"])
    np.testing.assert_allclose(m_w.numpy(), mean.numpy(), rtol=1e-12)
    assert (v_w > 0).all()
    truth = np.sin(2 * inp["xqf"][:, 0]) * np.cos(2 * inp["xqf"][:, 1])
    assert np.sqrt(np.mean((m_w.numpy() - truth) ** 2)) < 0.05


def test_large_grid_f32_against_f64():
    """N = 96 × 96: the f32 NLML and gradient against the port's own f64 on
    the same f32-rounded grid and targets (the JAX test's large grid)."""
    rng = np.random.default_rng(4)
    ax = np.linspace(0, 4, 96).astype(np.float32)
    X1, X2 = np.meshgrid(ax, ax, indexing="ij")
    y = (np.sin(2 * X1) * np.cos(X2) + 0.05 * rng.normal(size=X1.shape)).astype(np.float32)
    out = {}
    for dt in (torch.float32, torch.float64):
        p = torch.tensor([1.0, 1.0, 1.0, 0.2], dtype=dt).requires_grad_(True)
        axt = torch.tensor(ax, dtype=dt)
        v = kt.nlml_kron(gt.Separable("rbf"), p, [axt, axt], torch.tensor(y, dtype=dt))
        out[dt] = (v.item(), torch.autograd.grad(v, p)[0].double().numpy())
    (v32, g32), (v64, g64) = out[torch.float32], out[torch.float64]
    assert np.isfinite(v32) and np.isfinite(g32).all()
    assert abs(v32 - v64) / abs(v64) < 1e-4
    assert np.linalg.norm(g32 - g64) / np.linalg.norm(g64) < 1e-2


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def bench_kron_data(g=512, seed=11):
    """``bench.py::bench_kron``'s problem: ``ax = linspace(0, 8, g)`` f32,
    ``y = sin(2x₁)cos(x₂) + 0.05ε`` f32 on the g × g grid."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(0.0, 8.0, g, dtype=np.float32)
    x1, x2 = np.meshgrid(ax, ax, indexing="ij")
    y = (np.sin(2.0 * x1) * np.cos(x2) + 0.05 * rng.normal(size=x1.shape)).astype(np.float32)
    return ax, y


def _jax_run(g: int, dtype: str) -> dict:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "f64")
    ax, y = bench_kron_data(g)
    dt = np.float64 if dtype == "f64" else np.float32
    axj, yj = jnp.asarray(ax.astype(dt)), jnp.asarray(y.astype(dt))
    kern = gj.Separable("rbf")
    v, gr = jax.jit(jax.value_and_grad(lambda p: kj.nlml_kron(kern, p, [axj, axj], yj)))(
        jnp.asarray([1.0, 1.0, 1.0, 0.2], dt))
    return {"value": float(v), "grad": np.asarray(gr, np.float64).tolist()}


def _gaps(g: int) -> dict:
    runs = {}
    for dtype in ("f64", "f32"):
        out = subprocess.run([sys.executable, __file__, "run", str(g), dtype], capture_output=True, text=True,
                             check=True)
        runs[dtype] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = runs["f32"], runs["f64"]
    g32, g64 = np.asarray(a["grad"]), np.asarray(b["grad"])
    return {"g": g, "rel_value": abs(a["value"] - b["value"]) / abs(b["value"]),
            "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)),
            "rel_grad_each": (np.abs(g32 - g64) / np.abs(g64)).tolist(), "f64": b, "f32": a}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "run":
        print(json.dumps(_jax_run(int(sys.argv[2]), sys.argv[3])), flush=True)
    else:
        print(json.dumps({"jax_kronecker_f32_gaps": _gaps(int(sys.argv[1]) if len(sys.argv) > 1 else 512)}),
              flush=True)
