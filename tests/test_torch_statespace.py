"""Port parity: the state-space (Kalman) GP against the JAX package.

The same seeded NumPy series go through both packages in f64: the
sequential and parallel NLML, the smoothed posterior, the three gradient
routes (forward mode inside an autograd function, forward mode through the
scan of (element, tangent) pairs, the adjoint scan) against the JAX
package's reverse-mode gradient, the fits and the wrapper.  The JAX side
runs once, under one ``jax.jit``, in a module fixture, at n ≤ 500.  The
scan helper is held against a sequential fold at n = 61 and 120 in both
directions, and the closed-form inverse at d = 1, 2, 3.  The large-n f32
case compares the port with its own f64.

Run as a script, the file prints the JAX package's own f32-against-f64
gaps on the CPU for ``chip_smoke.py``'s state-space problem (the JAX
bench's data at n = 125 000: the value, the adjoint gradient and the
posterior, f32 on the same f32-rounded times as f64), the yardstick of the
card's limits:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_statespace.py [n]
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
from pygpr_torch.models import statespace as st
from pygpr_tpu.models import statespace as sj

NUS = (0.5, 1.5, 2.5)
#: fold the dense pipeline's fixed 1e-7 jitter into the SSM noise so the
#: parity with the dense NLML is exact (the JAX test's parameters)
P_SS = np.array([1.1, 0.8, float(np.sqrt(0.25**2 + 1e-7))])
P_DENSE = np.array([1.1, 0.8, 0.25])
#: the JAX tests' tolerances: NLML against dense 1e-10, posterior 1e-9,
#: gradient routes against reverse mode 1e-9, the SciPy fit 2e-3 in the
#: parameters
RTOL_NLML, ATOL_POST, RTOL_GRAD, RTOL_FIT = 1e-10, 1e-9, 1e-9, 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _series(n, seed, noise, hi=6.0, freq=2.0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, hi, n))
    return t, np.sin(freq * t) + noise * rng.normal(size=n)


def _inputs():
    t, y = _series(120, 0, 0.2)
    tq = np.sort(np.random.default_rng(3).uniform(0.2, 5.8, 17))
    rng = np.random.default_rng(7)
    t_base = np.sort(rng.uniform(0, 50, 150))
    t_dup = np.sort(np.concatenate([t_base, t_base[::11]]))  # duplicate stamps
    y_dup = np.sin(0.6 * t_dup) + 0.1 * rng.normal(size=t_dup.size)
    t_fit, y_fit = _series(300, 6, 0.15)
    return dict(t=t, y=y, tq=tq, t_dup=t_dup, y_dup=y_dup, p_grad=np.array([1.2, 0.8, 0.25]), t_fit=t_fit,
                y_fit=y_fit, tq_fit=np.linspace(0.2, 5.8, 64))


@pytest.fixture(scope="module")
def parity():
    """The inputs, and every JAX result the tests compare with, from one
    compiled program."""
    inp = _inputs()

    def run(t, y, tq, t_dup, y_dup, p_grad, t_fit, y_fit, tq_fit):
        p_ss, p_dense = jnp.asarray(P_SS), jnp.asarray(P_DENSE)
        out = {}
        for nu in NUS:
            out[f"nlml_{nu}"] = sj.nlml_ss(nu, p_ss, t, y, parallel=False)
            cov = gj.Sum((gj.Matern(nu), gj.WhiteNoise()))
            out[f"dense_{nu}"] = gj.nlml(cov, p_dense, t[:, None], y)
            # reverse mode through the sequential filter: the same
            # derivative as through the scan, at a tenth of its XLA compile
            out[f"vg_{nu}"] = jax.value_and_grad(lambda q: sj.nlml_ss(nu, q, t_dup, y_dup, parallel=False))(p_grad)
        out["nlml_1.5_scan"] = sj.nlml_ss(1.5, p_ss, t, y, parallel=True)
        out["post"] = sj.posterior_ss(1.5, p_ss, t, y, tq, parallel=False)
        return out

    want = jax.jit(run)(**{k: jnp.asarray(a) for k, a in inp.items()})
    return inp, jax.tree.map(np.asarray, want)


def T(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("parallel", [False, True])
@pytest.mark.parametrize("nu", NUS)
def test_nlml_ss_matches_jax_and_dense(parity, nu, parallel):
    inp, want = parity
    v = st.nlml_ss(nu, T(P_SS), T(inp["t"]), T(inp["y"]), parallel=parallel).item()
    np.testing.assert_allclose(v, want[f"nlml_{nu}"], rtol=RTOL_NLML)
    if nu == 1.5:
        np.testing.assert_allclose(v, want["nlml_1.5_scan"], rtol=RTOL_NLML)
    np.testing.assert_allclose(v, want[f"dense_{nu}"], rtol=RTOL_NLML)
    # the port's own dense NLML too
    cov = gt.Sum((gt.Matern(nu), gt.WhiteNoise()))
    np.testing.assert_allclose(v, gt.nlml(cov, T(P_DENSE), T(inp["t"])[:, None], T(inp["y"])).item(),
                               rtol=RTOL_NLML)


@pytest.mark.parametrize("parallel", [False, True])
def test_posterior_ss_matches_jax(parity, parallel):
    inp, want = parity
    m, v = st.posterior_ss(1.5, T(P_SS), T(inp["t"]), T(inp["y"]), T(inp["tq"]), parallel=parallel)
    wm, wv = want["post"]
    np.testing.assert_allclose(m.numpy(), wm, atol=ATOL_POST)
    np.testing.assert_allclose(v.numpy(), wv, atol=ATOL_POST)


def _route(name, nu, p, t, y):
    if name == "ad":
        q = p.clone().requires_grad_(True)
        v = st.nlml_ss(nu, q, t, y)
        return v, torch.autograd.grad(v, q)[0]
    if name == "fwdgrad":
        q = p.clone().requires_grad_(True)
        v = st.nlml_ss_fwdgrad(nu, q, t, y)
        return v, torch.autograd.grad(v, q)[0]
    if name == "forward":
        return st.nlml_ss_value_and_grad(nu, p, t, y)
    return st.nlml_ss_adjoint_value_and_grad(nu, p, t, y)


@pytest.mark.parametrize("route", ["ad", "fwdgrad", "forward", "adjoint"])
@pytest.mark.parametrize("nu", NUS)
def test_gradient_routes_match_jax_reverse_mode(parity, nu, route):
    """Every gradient route of the port, on a chain with duplicate stamps
    (Δt = 0: A = I, Q = 0, no special case), against the JAX package's
    reverse-mode autodiff through its sequential filter."""
    inp, want = parity
    v, g = _route(route, nu, T(inp["p_grad"]), T(inp["t_dup"]), T(inp["y_dup"]))
    wv, wg = want[f"vg_{nu}"]
    np.testing.assert_allclose(v.item(), wv, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), wg, rtol=RTOL_GRAD)


def _mat_fold(elems, reverse):
    """Sequential inclusive fold of 2×2 lane matrices, the scan's oracle."""
    n = elems[0].shape[-1]
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc, out = None, [None] * n
    for i in order:
        e = (elems[0][..., i:i + 1],)
        acc = e if acc is None else _matmul_combine(acc, e)
        out[i] = acc[0]
    return torch.cat(out, dim=-1)


def _matmul_combine(a, b):
    """A non-commutative associative operation: b·a per lane."""
    return (st._bmm(b[0], a[0]),)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [61, 120])
def test_associative_scan_matches_sequential_fold_and_jax(n, reverse):
    rng = np.random.default_rng(n)
    m = rng.normal(size=(2, 2, n)) * 0.5 + np.eye(2)[:, :, None]
    (got,) = st.associative_scan(_matmul_combine, (T(m),), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), _mat_fold((T(m),), reverse).numpy(), rtol=1e-12, atol=1e-12)
    jax_combine = lambda a, b: (sj._bmm(b[0], a[0]),)
    (want,) = jax.lax.associative_scan(jax_combine, (jnp.asarray(m),), reverse=reverse, axis=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_closed_form_inverse(d):
    rng = np.random.default_rng(d)
    m = rng.normal(size=(d, d, 9)) + 2.0 * np.eye(d)[:, :, None]
    got = st._inv(T(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(sj._inv(jnp.asarray(m))), rtol=1e-13)
    want = np.linalg.inv(np.moveaxis(m, -1, 0))
    np.testing.assert_allclose(np.moveaxis(got, -1, 0), want, rtol=1e-12)


def test_filter_and_smoother_states_match_the_sequential_oracle(parity):
    inp, _ = parity
    t, y = T(inp["t_dup"]), T(inp["y_dup"])
    a_s, q_s, p_inf, r_var = st._prep(1.5, T(inp["p_grad"]), t, y, None)
    mask = torch.ones_like(y)
    ms, ps, _ = st._filter_seq(a_s, q_s, p_inf, y, r_var, mask)
    ma, pa = st._filter_assoc(a_s, q_s, p_inf, y, r_var, mask)
    np.testing.assert_allclose(ma.numpy(), ms.numpy(), atol=1e-10)
    np.testing.assert_allclose(pa.numpy(), ps.numpy(), atol=1e-10)
    sm, sp = st._smooth_seq(a_s, q_s, ms, ps)
    am, ap = st._smooth_assoc(a_s, q_s, ms, ps)
    np.testing.assert_allclose(am.numpy(), sm.numpy(), atol=1e-10)
    np.testing.assert_allclose(ap.numpy(), sp.numpy(), atol=1e-10)


def test_fit_ss_reaches_the_optimum_of_the_jax_nlml(parity):
    """The L-BFGS fit (the port's optax-equivalent L-BFGS) ends where the
    JAX package's NLML, evaluated at the port's fitted parameters, agrees
    with the port's value; the fit recovers the generating noise."""
    inp, _ = parity
    res = st.fit_ss(1.5, T(inp["t_fit"]), T(inp["y_fit"]), max_iter=150)
    assert res.nlml.item() < st.nlml_ss(1.5, torch.tensor([1.0, 1.0, 0.3], dtype=torch.float64),
                                        T(inp["t_fit"]), T(inp["y_fit"])).item()
    v_jax = sj.nlml_ss(1.5, jnp.asarray(res.params.numpy()), jnp.asarray(inp["t_fit"]), jnp.asarray(inp["y_fit"]),
                       parallel=False)
    np.testing.assert_allclose(res.nlml.item(), float(v_jax), rtol=1e-9)
    assert 0.08 < res.params[-1].item() < 0.3


@pytest.mark.parametrize("grad_method", ["ad", "adjoint"])
def test_fit_ss_large_lands_on_fit_ss(grad_method):
    """The SciPy-driven fit lands on the same optimum as the L-BFGS fit
    (the JAX tests' bounds), by either gradient."""
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(0, 60, 400))
    y = np.sin(0.5 * t) + 0.1 * rng.normal(size=400)
    r1 = st.fit_ss(1.5, T(t), T(y), max_iter=150)
    r2 = st.fit_ss_large(1.5, T(t), T(y), max_iter=100, grad_method=grad_method)
    assert bool(r2.converged)
    np.testing.assert_allclose(r2.params.numpy(), r1.params.numpy(), rtol=RTOL_FIT)
    np.testing.assert_allclose(r2.nlml.item(), r1.nlml.item(), rtol=1e-6, atol=1e-4)


def test_state_space_gp_wrapper(parity):
    """The wrapper on the CPU (the JAX test's checks): train, predict, the
    observation variance, nlml; its predictions are posterior_ss at the
    fitted parameters."""
    inp, _ = parity
    model = gt.StateSpaceGP(inp["t_fit"], inp["y_fit"], nu=1.5, device="cpu")
    res = model.train(max_iter=120)
    assert np.isfinite(res.nlml.item())
    assert 0.08 < res.params[-1].item() < 0.3
    mean, var = model.predict(inp["tq_fit"])
    m, _ = st.posterior_ss(1.5, res.params, T(inp["t_fit"]), T(inp["y_fit"]), T(inp["tq_fit"]))
    np.testing.assert_allclose(mean.numpy(), m.numpy(), rtol=1e-12)
    truth = np.sin(2 * inp["tq_fit"])
    assert np.sqrt(np.mean((mean.numpy() - truth) ** 2)) < 0.1
    assert (var > 0).all()
    _, var_obs = model.predict(inp["tq_fit"], observation=True)
    np.testing.assert_allclose((var_obs - var).numpy(), res.params[-1].item() ** 2, rtol=1e-6)
    np.testing.assert_allclose(model.nlml(), res.nlml.item(), rtol=1e-9)


def test_adjoint_gradient_f32_against_f64_at_20000():
    """The JAX test's f32 accuracy of the adjoint gradient on a dense chain
    (mean λ·Δt ≈ 3e-3), the port against its own f64 autodiff, with
    duplicate stamps from the f32 rounding and a few made on purpose."""
    rng = np.random.default_rng(8)
    n = 20_000
    t64 = np.sort(np.concatenate([rng.uniform(0, 40.0, n - 50), np.repeat(rng.uniform(0, 40.0, 25), 2)]))
    y64 = np.sin(0.7 * t64) + 0.1 * rng.normal(size=n)
    t32 = t64.astype(np.float32)
    p = np.array([1.1, 0.9, 0.2])
    q = T(p).requires_grad_(True)
    (g_ref,) = torch.autograd.grad(st.nlml_ss(1.5, q, T(t32.astype(np.float64)), T(y64)), q)
    v32, g32 = st.nlml_ss_adjoint_value_and_grad(1.5, T(p).float(), T(t32), T(y64.astype(np.float32)))
    assert np.isfinite(v32.item())
    g_ref = g_ref.numpy()
    rel = np.abs(g32.double().numpy() - g_ref) / (np.abs(g_ref) + 1e-3 * np.abs(g_ref).max())
    assert rel.max() < 1e-3, (g32, g_ref)


# ----------------------------------------------------------------------
# script mode: the JAX package's own f32-against-f64 gaps
# ----------------------------------------------------------------------


def bench_data(n=1_000_000, seed=3):
    """The JAX bench's data (bench_statespace_large): t ~ U(0, 2000)
    sorted, y = sin(0.3t) + 0.1ε, both f32."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 2000.0, n)).astype(np.float32)
    y = (np.sin(0.3 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return t, y


def _jax_run(n: int, dtype: str) -> dict:
    """One package run: value, adjoint gradient and posterior of the bench
    problem cut to its first n points, in ``dtype`` on the f32 times."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "f64")
    t, y = bench_data()
    t, y = t[:n], y[:n]
    dt = np.float64 if dtype == "f64" else np.float32
    tj, yj = jnp.asarray(t.astype(dt)), jnp.asarray(y.astype(dt))
    p = jnp.asarray([1.0, 1.0, 0.1], dt)
    v, g = sj.nlml_ss_adjoint_value_and_grad(1.5, p, tj, yj)
    tq = np.linspace(0.0, float(t[-1]), 512).astype(np.float32)
    m, var = sj.posterior_ss(1.5, p, tj, yj, jnp.asarray(tq.astype(dt)))
    return {"value": float(v), "grad": np.asarray(g, np.float64).tolist(),
            "mean": np.asarray(m, np.float64).tolist(), "var": np.asarray(var, np.float64).tolist()}


def _gaps(n: int) -> dict:
    runs = {}
    for dtype in ("f64", "f32"):
        out = subprocess.run([sys.executable, __file__, "run", str(n), dtype], capture_output=True, text=True,
                             check=True)
        runs[dtype] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = runs["f32"], runs["f64"]
    g32, g64 = np.asarray(a["grad"]), np.asarray(b["grad"])
    m32, m64 = np.asarray(a["mean"]), np.asarray(b["mean"])
    v32, v64 = np.asarray(a["var"]), np.asarray(b["var"])
    return {"n": n, "rel_value": abs(a["value"] - b["value"]) / abs(b["value"]),
            "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64)),
            "mean_abs": float(np.abs(m32 - m64).max()), "var_rel": float(np.max(np.abs(v32 - v64) / v64)),
            "value_f64": b["value"], "grad_f64": b["grad"]}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "run":
        print(json.dumps(_jax_run(int(sys.argv[2]), sys.argv[3])), flush=True)
    else:
        print(json.dumps({"jax_statespace_f32_gaps": _gaps(int(sys.argv[1]) if len(sys.argv) > 1 else 125_000)}),
              flush=True)
