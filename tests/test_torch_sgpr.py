"""Port parity: SGPR (``pygpr_torch/models/sgpr.py``) against the JAX package.

Inputs are made with NumPy from a seed and fed to both packages in f64.
The JAX side runs once, under one ``jax.jit``, in a module fixture: its
L-BFGS fit is a ``while_loop`` that would compile anew on every eager call.
Every piece is the same algorithm on the same inputs (the JAX package's
Cholesky and block-doubling inverse against the port's ``cholesky_ex`` and
its own block doubling), so they agree to round-off, far inside 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import sgpr as st
from pygpr_tpu.models import sgpr as sj

N, M, D = 60, 12, 2
FIT_ITERS = 5
#: f64 parity bound (relative)
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 3.0, (N, D))
    return dict(
        x=x,
        y=np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=N),
        z=x[rng.permutation(N)[:M]] + 0.05 * rng.normal(size=(M, D)),
        xq=rng.uniform(0.0, 3.0, (7, D)),
        params=np.array([1.1, 0.9, 1.2, 0.3]),
    )


@pytest.fixture(scope="module")
def parity():
    """The inputs, and every JAX result the tests compare with, from one
    compiled program (and the pivoted selection, which returns NumPy)."""
    inp = _inputs()
    rbf = gj.RBF()

    def run(x, y, z, xq, params):
        out = {}
        out["value"], (out["grad_params"], out["grad_z"]) = jax.value_and_grad(
            lambda p, zz: sj.neg_elbo(rbf, p, x, y, zz), argnums=(0, 1))(params, z)
        state = sj.factorize(rbf, params, x, y, z)
        out["state"] = state._asdict()
        for var in ("diag", "full", "none"):
            out[f"mean_{var}"], cov = sj.predict(rbf, state, xq, var)
            if cov is not None:
                out[f"cov_{var}"] = cov
        res, z_opt = sj.fit(rbf, params, x, y, z, opt_inducing=True, max_iter=FIT_ITERS)
        out["fit_z"], out["fit_z_params"], out["fit_z_value"], out["fit_z_iters"] = z_opt, res.params, res.value, res.iters
        res, _ = sj.fit(rbf, params, x, y, z, max_iter=FIT_ITERS)
        out["fit_params"], out["fit_value"], out["fit_iters"] = res.params, res.value, res.iters
        return out

    want = jax.tree.map(np.asarray, jax.jit(run)(**{k: jnp.asarray(a) for k, a in inp.items()}))
    want["pivoted"] = sj.init_inducing_pivoted(rbf, jnp.asarray(inp["x"]), M)
    return inp, want


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_neg_elbo_value_and_grad(parity):
    inp, want = parity
    p, z = T(inp["params"]).requires_grad_(True), T(inp["z"]).requires_grad_(True)
    v = st.neg_elbo(gt.RBF(), p, T(inp["x"]), T(inp["y"]), z)
    gp_, gz = torch.autograd.grad(v, (p, z))
    close(v, want["value"])
    close(gp_, want["grad_params"])
    close(gz, want["grad_z"])


def test_factorize(parity):
    inp, want = parity
    s = st.factorize(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["z"]))
    for f in ("tinv_kuu", "tinv_b", "c", "ok"):
        close(getattr(s, f), want["state"][f], atol=1e-12)


@pytest.mark.parametrize("var", ["diag", "full", "none"])
def test_predict(parity, var):
    inp, want = parity
    s = st.factorize(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["z"]))
    mean, cov = st.predict(gt.RBF(), s, T(inp["xq"]), var)
    close(mean, want[f"mean_{var}"])
    if var == "none":
        assert cov is None
    else:
        close(cov, want[f"cov_{var}"])


@pytest.mark.parametrize("opt_inducing", [False, True])
def test_fit(parity, opt_inducing):
    inp, want = parity
    res, z = st.fit(gt.RBF(), T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["z"]),
                    opt_inducing=opt_inducing, max_iter=FIT_ITERS)
    key = "fit_z" if opt_inducing else "fit"
    assert int(res.iters) == int(want[f"{key}_iters"])
    close(res.params, want[f"{key}_params"])
    close(res.value, want[f"{key}_value"])
    if opt_inducing:
        close(z, want["fit_z"])
    else:
        assert torch.equal(z, T(inp["z"]))


def test_init_inducing_bit_equal():
    x = _inputs()["x"]
    for m, seed in ((M, 0), (30, 5)):
        assert np.array_equal(st.init_inducing(x, m, seed), sj.init_inducing(x, m, seed))
        assert np.array_equal(st.init_inducing(T(x), m, seed), sj.init_inducing(x, m, seed))
    with pytest.raises(ValueError):
        st.init_inducing(x, N + 1)


def test_init_inducing_pivoted(parity):
    inp, want = parity
    got = st.init_inducing_pivoted(gt.RBF(), inp["x"], M, device="cpu")
    np.testing.assert_allclose(got, want["pivoted"], rtol=RTOL)


def test_sample_predictive_moments_match_predict(parity):
    """20000 joint draws: the sample mean within 4 standard errors of the
    predictive mean, the sample covariance within 0.05 of the predictive
    covariance (its largest entry is about 0.2; the standard error of a
    covariance entry from 20000 draws is under 0.003)."""
    inp, _ = parity
    rbf = gt.RBF()
    s = st.factorize(rbf, T(inp["params"]), T(inp["x"]), T(inp["y"]), T(inp["z"]))
    mean, cov = st.predict(rbf, s, T(inp["xq"]), "full")
    draws = st.sample_predictive(rbf, s, T(inp["xq"]), torch.Generator().manual_seed(0), n_samples=20000)
    assert draws.shape == (20000, 7)
    se = torch.sqrt(torch.diagonal(cov) / 20000)
    assert ((draws.mean(0) - mean).abs() <= 4 * se).all()
    assert (torch.cov(draws.T) - cov).abs().max() <= 0.05


def test_convert_sgpr_state(parity):
    inp, want = parity
    s = convert.sgpr_state_from_numpy(want["state"], "cpu")
    mean, var = st.predict(gt.RBF(), s, T(inp["xq"]), "diag")
    close(mean, want["mean_diag"])
    close(var, want["cov_diag"])
    with pytest.raises(ValueError):
        convert.sgpr_state_from_numpy({"z": want["state"]["z"]}, "cpu")


def test_sgpr_wrapper_and_noise_free_check(parity):
    inp, want = parity
    with pytest.raises(ValueError):
        gt.SGPR(inp["x"], inp["y"], gt.Sum((gt.RBF(), gt.WhiteNoise())), m=M, device="cpu")
    model = gt.SGPR(inp["x"], inp["y"], gt.RBF(), z=inp["z"], device="cpu")
    model.set_params(inp["params"])
    mean, var = model.predict(inp["xq"], var="full")
    close(mean, want["mean_full"])
    close(var, want["cov_full"])
    close(model.neg_elbo(), want["value"])


def _f32_fit_readings(package, names=("bench", "up", "down")):
    """The SGPR bench's f32 fit (``bench_sgpr_large_n``: N = 98304, m = 1024,
    60 L-BFGS iterations, the bench's data, inducing points and start) in
    one package on the CPU, from the bench's start and from the starts one
    f32 ulp above and below it in every parameter (``np.nextafter``).  Prints
    one JSON line a start: the final negative ELBO, the iterations taken,
    the parameters and the RMSE of the predictive mean against the
    noise-free targets.  From forty minutes to hours a start on a CPU."""
    import json
    import time

    from pygpr_torch import bench as tb

    x, y, xs, ys_true, _ = tb.sgpr_large_n_data()
    z = st.init_inducing(x, 1024, seed=0)
    base = np.asarray(sj.init_params(gj.RBF(), jnp.asarray(x)), np.float32)
    starts = {"bench": base, "up": np.nextafter(base, np.float32(np.inf)),
              "down": np.nextafter(base, np.float32(-np.inf))}
    if package == "jax":
        jax.config.update("jax_enable_x64", False)
        xj, yj, zj, xsj = (jnp.asarray(a, jnp.float32) for a in (x, y, z, xs))
        fitf = jax.jit(lambda p: sj.fit(gj.RBF(), p, xj, yj, zj, max_iter=60)[0])
        post = jax.jit(lambda p: sj.predict(gj.RBF(), sj.factorize(gj.RBF(), p, xj, yj, zj), xsj, "diag")[0])
    else:
        xt, yt, zt, xst = (torch.as_tensor(a, dtype=torch.float32) for a in (x, y, z, xs))
    for name in names:
        p0 = starts[name]
        t0 = time.perf_counter()
        if package == "jax":
            res = fitf(jnp.asarray(p0))
            value, iters, params = float(res.value), int(res.iters), np.asarray(res.params)
            mean = np.asarray(post(res.params))
        else:
            res, _ = st.fit(gt.RBF(), torch.as_tensor(p0), xt, yt, zt, max_iter=60)
            value, iters, params = float(res.value), int(res.iters), res.params.numpy()
            with torch.no_grad():
                mean = st.predict(gt.RBF(), st.factorize(gt.RBF(), res.params, xt, yt, zt), xst, "diag")[0].numpy()
        rmse = float(np.sqrt(np.mean((mean.astype(np.float64) - ys_true) ** 2)))
        print(json.dumps({"package": package, "dtype": "float32", "start": name, "params0": p0.tolist(),
                          "neg_elbo": value, "iters": iters, "params": params.tolist(), "rmse_vs_true": rmse,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sgpr.py [jax|torch] [bench|up|down ...]
    import sys

    packages = [a for a in sys.argv[1:] if a in ("jax", "torch")] or ["jax", "torch"]
    names = [a for a in sys.argv[1:] if a in ("bench", "up", "down")] or ["bench", "up", "down"]
    for package in packages:
        _f32_fit_readings(package, names)
