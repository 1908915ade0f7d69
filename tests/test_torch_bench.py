"""The port's benchmark entry points (``pygpr_torch/bench``) at tiny sizes
on the CPU.

The serving bench's chunked β-precision aggregation is held against the
port's ``grbcm.predict`` and against the JAX bench's own posterior at the
same arguments; every other entry returns a record with exactly the keys
of the JAX function's record, read from the JAX source (its ``return``
dict), so that the two benches' lines stay comparable.
"""

import ast
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_torch.bench as tb
from pygpr_torch.models import exact_gp, grbcm

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the JAX test's tiny committee (tests/test_bench_units.py)
TINY_1M = dict(nc=8, nls=16, ng=8, nq=64, dim=2, chunk=4, reps=1, rounds=1)
#: the JAX test's bound for the aggregation against grbcm.predict, f32
TOL_1M = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores: one
    thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record_keys(func: str) -> set:
    """Keys of the record that ``pygpr_tpu/bench/__init__.py::func``
    builds: the first dict literal in its body with a "metric" key."""
    tree = ast.parse((REPO / "pygpr_tpu" / "bench" / "__init__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                return keys
    raise AssertionError(f"no record in {func}")


def test_grbcm_million_serving_matches_predict_and_the_jax_bench():
    from pygpr_tpu.bench import bench_grbcm_million_serving as jax_bench

    rec, mean, var = tb.bench_grbcm_million_serving(**TINY_1M, return_posterior=True, device="cpu")
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    json.dumps(rec)
    assert set(rec) == _jax_record_keys("bench_grbcm_million_serving")

    # the same data through grbcm.predict
    nc, nls, ng, nq, dim = (TINY_1M[k] for k in ("nc", "nls", "ng", "nq", "dim"))
    xl, yl, xg, yg, xs, _ = tb.million_serving_data(nc, nls, ng, nq, dim)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    p = torch.tensor(np.r_[np.ones(dim + 1), 0.3].astype(np.float32))
    xl, yl, xg, yg, xs = (torch.tensor(a) for a in (xl, yl, xg, yg, xs))
    x_aug, y_aug = grbcm.augment(xl, yl, xg, yg)
    sg = exact_gp.precompute_tinv(exact_gp.factorize(cov, p, xg, yg))
    sl = exact_gp.precompute_tinv(exact_gp.factorize(cov, p, x_aug, y_aug))
    res = grbcm.predict(cov, p, p, sg, sl, xs, "diag")
    np.testing.assert_allclose(mean, res.mean.numpy(), rtol=TOL_1M, atol=TOL_1M)
    np.testing.assert_allclose(var, res.covar.numpy(), rtol=TOL_1M, atol=TOL_1M)

    # and the JAX bench's own posterior at the same arguments
    _, mean_j, var_j = jax_bench(**TINY_1M, return_posterior=True)
    np.testing.assert_allclose(mean, mean_j, rtol=TOL_1M, atol=TOL_1M)
    np.testing.assert_allclose(var, var_j, rtol=TOL_1M, atol=TOL_1M)


@pytest.mark.parametrize("name,kw", [
    ("bench_large_n", dict(nc=2, nls=48, ng=16, n_query=64, fit_iters=2)),
    ("bench_iterative_large_n", dict(n=256, num_probes=4, rank=8, block=64, max_cg=20, n_query=32)),
    ("bench_sgpr_large_n", dict(n=256, m=16, n_query=32, fit_iters=3)),
])
def test_bench_records_have_the_jax_keys(name, kw):
    rec = getattr(tb, name)(device="cpu", **kw)
    assert set(rec) == _jax_record_keys(name)
    json.dumps(rec)
    assert all(math.isfinite(v) for v in rec.values() if isinstance(v, float))
    assert rec["rmse_vs_true"] > 0


def test_headline_rates_are_finite():
    assert math.isfinite(tb.bench_lml_grad(n=256, reps=2, device="cpu"))
    assert tb.bench_predictions(nc=2, nls=32, ng=16, n_query=64, reps=2, device="cpu") > 0


@pytest.mark.parametrize("flag", ["--million"])
def test_unported_flags_exit_non_zero(flag):
    out = subprocess.run([sys.executable, "-m", "pygpr_torch.bench", flag], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "ROADMAP item" in out.stderr
    assert out.stdout == ""


def test_statespace_bench_record_has_the_jax_keys():
    """``bench_statespace_large`` at a tiny n on the CPU: the JAX bench's
    record keys (its adjoint record and the posterior stage's additions),
    plus the two peak-memory keys of the port (``None`` off the card)."""
    rec = tb.bench_statespace_large(n=512, nq=16, reps=1, device="cpu")
    added = {"nlml_value_seconds_per_eval", "ad_grad_n", "ad_grad_seconds_per_eval", "posterior_nq",
             "posterior_seconds", "posterior_rmse_vs_true"}
    assert set(rec) == _jax_record_keys("bench_statespace_large") | added | {"adjoint_grad_peak_bytes",
                                                                              "ad_grad_peak_bytes"}
    json.dumps(rec)
    assert all(math.isfinite(v) for v in rec.values() if isinstance(v, float))
    assert rec["ad_grad_n"] == 64 and rec["adjoint_grad_peak_bytes"] is None
    slim = tb.bench_statespace_large(n=256, reps=1, include_posterior=False, device="cpu")
    assert set(slim) == _jax_record_keys("bench_statespace_large") | {"adjoint_grad_peak_bytes"}


def _million_serving_f64(nc: int, nq: int, chunk_q: int = 256):
    """Script mode: the serving bench's committee (its data, θ = 1,
    σₙ = 0.3, ``nc`` experts of 500 points + 128 global) through
    ``grbcm.predict`` in f64 on the CPU, queries taken ``chunk_q`` at a
    time; returns the mean, the variance and the noise-free targets."""
    xl, yl, xg, yg, xs, ys_true = tb.million_serving_data(nc=nc, nq=nq)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    p = torch.tensor([1.0, 1.0, 1.0, 0.3], dtype=torch.float64)
    xl, yl, xg, yg, xs = (torch.tensor(a, dtype=torch.float64) for a in (xl, yl, xg, yg, xs))
    x_aug, y_aug = grbcm.augment(xl, yl, xg, yg)
    with torch.no_grad():
        sg = exact_gp.factorize(cov, p, xg, yg)
        sl = exact_gp.factorize(cov, p, x_aug, y_aug)
        parts = [grbcm.predict(cov, p, p, sg, sl, q, "diag") for q in torch.split(xs, chunk_q)]
    return torch.cat([r.mean for r in parts]).numpy(), torch.cat([r.covar for r in parts]).numpy(), ys_true


def _million_serving_readings():
    """grBCM's RMSE at the serving bench's fixed parameters against the
    number of experts (f64, 1024 queries), and the bench's f32 posterior
    against that f64 one at 400 experts: the readings behind the serving
    line's check in ``chip_smoke.py``."""
    nq = 1024
    for nc in (20, 100, 200):
        mean, _, ys_true = _million_serving_f64(nc, nq)
        print(json.dumps({"experts": nc, "queries": nq, "rmse_vs_true_f64": float(np.sqrt(np.mean((mean - ys_true) ** 2)))}),
              flush=True)
    nc = 400
    mean64, var64, ys_true = _million_serving_f64(nc, nq)
    rec, mean, var = tb.bench_grbcm_million_serving(nc=nc, nq=nq, chunk=50, reps=1, rounds=1, return_posterior=True,
                                                     device="cpu")
    print(json.dumps({"experts": nc, "queries": nq, "rmse_vs_true_f64": float(np.sqrt(np.mean((mean64 - ys_true) ** 2))),
                      "rmse_vs_true_f32_bench": rec["rmse_vs_true"],
                      "max_abs_mean_gap_f32_vs_f64": float(np.abs(mean - mean64).max()),
                      "max_rel_var_gap_f32_vs_f64": float((np.abs(var - var64) / var64).max())}), flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bench.py
    _million_serving_readings()
