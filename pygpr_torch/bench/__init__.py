"""Benchmark entry points of the port.

Counterpart of ``pygpr_tpu/bench/__init__.py``, on one CUDA device:

  * :func:`bench_lml_grad` — NLML value + gradient evaluations/s (the
    optimizer's inner loop).
  * :func:`bench_predictions` — grBCM predictions/s (committee factorize,
    predict and β-aggregation).
  * :func:`bench_large_n` — grBCM at N = 98304 (16 experts) on one card.
  * :func:`bench_grbcm_million_serving` — grBCM serving at N = 10⁶.
  * :func:`bench_iterative_large_n` — the matrix-free exact GP at
    n = 32768.
  * :func:`bench_sgpr_large_n` — SGPR at N = 98304, m = 1024.
  * :func:`bench_statespace_large` — the exact 1-D Matérn-3/2 GP at
    n = 10⁶ through the state-space parallel scans.

Each takes the JAX function's defaults, data generators and seeds and
returns a record with its keys, numbers unrounded; each takes ``device``
("cuda" unless given; the tests pass "cpu" at tiny sizes).  Times are host
clock around work that ends in a device synchronize.  The JAX package's
``weak_scaling`` and ``million_point_mesh_run`` wait for the port's
``parallel/`` layer (ROADMAP item 16).

``python -m pygpr_torch.bench [flag]`` prints them as JSON lines; the
stage probe of the flagship is ``python -m pygpr_torch.bench.mfu_probe``.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(f, *args, reps: int = 20, device="cuda") -> float:
    """Steady-state seconds a call: one warm call, then ``reps`` calls
    back to back and one device synchronize at the end."""
    f(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        f(*args)
    _sync(device)
    return (time.perf_counter() - t0) / reps


def _timed(f, device):
    """``(f(), seconds)``, the work ended by a device synchronize."""
    _sync(device)
    t0 = time.perf_counter()
    out = f()
    _sync(device)
    return out, time.perf_counter() - t0


def _synth(n: int, dim: int, dtype, seed: int = 42, device="cuda"):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim)).astype(dtype)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)).astype(dtype)
    return torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)


def bench_lml_grad(n: int = 2048, dim: int = 3, reps: int = 30, dtype=np.float32, device="cuda") -> float:
    """NLML value + fast-gradient evaluations/s."""
    import pygpr_torch as gp

    x, y = _synth(n, dim, dtype, device=device)
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    p = torch.as_tensor(np.concatenate([np.ones(dim + 1), [0.1]]).astype(dtype), device=device)
    return 1.0 / _timeit(lambda q: gp.nlml_value_and_grad(cov, q, x, y), p, reps=reps, device=device)


def bench_predictions(nc: int = 16, nls: int = 512, ng: int = 256, n_query: int = 4096, dim: int = 2,
                      reps: int = 10, dtype=np.float32, device="cuda") -> float:
    """grBCM predictions/s (diag), factorize included, through the
    batch-visible committee path."""
    import pygpr_torch as gp
    from pygpr_torch.models import exact_gp, grbcm

    rng = np.random.default_rng(0)
    xl = rng.uniform(0, 4, (nc, nls, dim)).astype(dtype)
    yl = np.sin(xl.sum(-1)).astype(dtype)
    xg = rng.uniform(0, 4, (ng, dim)).astype(dtype)
    yg = np.sin(xg.sum(-1)).astype(dtype)
    xs = rng.uniform(0, 4, (n_query, dim)).astype(dtype)
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    xl, yl, xg, yg, xs = (torch.as_tensor(a, device=device) for a in (xl, yl, xg, yg, xs))
    x_aug, y_aug = grbcm.augment(xl, yl, xg, yg)
    pg = cov.init_params(xg)
    pl_ = cov.init_params(x_aug)

    def run(q):
        sg = exact_gp.factorize(cov, pg, xg, yg)
        sl = exact_gp.factorize(cov, pl_, x_aug, y_aug)
        return grbcm.predict(cov, pg, pl_, sg, sl, q, "diag").mean

    with torch.no_grad():
        return n_query / _timeit(run, xs, reps=reps, device=device)


def main(device="cuda"):
    """Print the headline lines: NLML evaluations/s at n = 2048 and grBCM
    predictions/s at 16 × 512.  The JAX package's third line, weak-scaling
    efficiency over a device mesh, waits for the port's ``parallel/``
    layer (ROADMAP item 16) and is not printed."""
    import json

    print(json.dumps({"metric": "lml_grad_evals_per_s_n2048", "value": bench_lml_grad(device=device),
                      "unit": "evals/s"}), flush=True)
    print(json.dumps({"metric": "grbcm_predictions_per_s_16x512", "value": bench_predictions(device=device),
                      "unit": "predictions/s"}), flush=True)


def _large_n_target(x):
    return np.sin(2.0 * x.sum(-1)) + 0.5 * np.cos(5.0 * x[..., 0])


def bench_large_n(nc: int = 16, nls: int = 6144, ng: int = 256, n_query: int = 8192, dim: int = 2,
                  fit_iters: int = 15, seed: int = 0, device="cuda") -> dict:
    """BASELINE config 4: grBCM at N ≈ 100k (16 experts) on one card.

    The shared fit sums the experts' fast-gradient NLMLs one at a time
    (peak memory one expert's gram) in L-BFGS segments of 3 iterations, as
    the JAX bench does; factorize, predict and the serving state
    T = L⁻¹ then take the whole ``[16, 6400, 6400]`` stack at once.
    Returns fit and factorize seconds, predictions/s with and without T,
    and the RMSE and NLPD against held-out targets."""
    import pygpr_torch as gp
    from pygpr_torch.models import exact_gp, grbcm

    rng = np.random.default_rng(seed)
    xl = rng.uniform(0, 4, (nc, nls, dim)).astype(np.float32)
    yl = (_large_n_target(xl) + 0.1 * rng.normal(size=(nc, nls))).astype(np.float32)
    xg = rng.uniform(0, 4, (ng, dim)).astype(np.float32)
    yg = (_large_n_target(xg) + 0.1 * rng.normal(size=ng)).astype(np.float32)
    xs = rng.uniform(0, 4, (n_query, dim)).astype(np.float32)
    ys_true = _large_n_target(xs)
    ys_noisy = (ys_true + 0.1 * rng.normal(size=n_query)).astype(np.float32)
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    xl, yl, xg, yg, xs_t = (torch.as_tensor(a, device=device) for a in (xl, yl, xg, yg, xs))

    (info, x_aug, y_aug), fit_s = _timed(lambda: grbcm.fit(
        cov, xl, yl, xg, yg, max_iter=fit_iters, shared=True, stream=True, segment_iters=3), device)
    pg, pl = info.params_g, info.params_l

    def factorize_all():
        return exact_gp.factorize(cov, pg, xg, yg), exact_gp.factorize(cov, pl, x_aug, y_aug)

    with torch.no_grad():
        factorize_all()
        (sg, sl), factorize_s = _timed(factorize_all, device)

        def predict_q(sg_, sl_):
            res = grbcm.predict(cov, pg, pl, sg_, sl_, xs_t, "diag")
            return res.mean, res.covar

        predict_q(sg, sl)
        (mean, var), predict_s = _timed(lambda: predict_q(sg, sl), device)

        sg_t = exact_gp.precompute_tinv(sg)
        sl_t, precompute_s = _timed(lambda: exact_gp.precompute_tinv(sl), device)
        predict_q(sg_t, sl_t)
        _, serve_predict_s = _timed(lambda: predict_q(sg_t, sl_t), device)
    del sg, sl, sg_t, sl_t

    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    err = mean - ys_noisy
    n_aug = nls + ng
    params_l = pl[0].cpu().numpy()
    return {
        "metric": "grbcm_large_n_single_chip",
        "n_total": nc * nls,
        "experts": nc,
        "n_aug": n_aug,
        "fit_s": fit_s,
        "fit_iters": fit_iters,
        "factorize_s": factorize_s,
        "predict_s": predict_s,
        "predictions_per_s": n_query / predict_s,
        "serving_precompute_s": precompute_s,
        "serving_predict_s": serve_predict_s,
        "serving_predictions_per_s": n_query / serve_predict_s,
        # per query and expert one kernel row and the amortized share of the
        # n_aug²·n_query solve pair
        "flops_per_query": 2.0 * (nc * n_aug**2 + ng**2),
        "rmse_vs_true": float(np.sqrt(np.mean((mean - ys_true) ** 2))),
        "nlpd": float(np.mean(0.5 * np.log(2 * np.pi * var) + err**2 / (2 * var))),
        "params_shared": [float(v) for v in params_l],
    }


def million_serving_data(nc: int = 2000, nls: int = 500, ng: int = 128, nq: int = 4096, dim: int = 2,
                         seed: int = 0):
    """The data of :func:`bench_grbcm_million_serving` (NumPy, f32): expert
    shards ``xl [nc, nls, dim]``, ``yl``, the global set ``xg [ng, dim]``,
    ``yg``, queries ``xs [nq, dim]`` and the noise-free targets there, for
    f = sin(2Σx) on [0, 4]^dim with noise 0.1."""
    rng = np.random.default_rng(seed)

    def f(x):
        return np.sin(2.0 * x.sum(-1))

    xl = rng.uniform(0, 4, (nc, nls, dim)).astype(np.float32)
    yl = (f(xl) + 0.1 * rng.normal(size=(nc, nls))).astype(np.float32)
    xg = rng.uniform(0, 4, (ng, dim)).astype(np.float32)
    yg = (f(xg) + 0.1 * rng.normal(size=ng)).astype(np.float32)
    xs = rng.uniform(0, 4, (nq, dim)).astype(np.float32)
    return xl, yl, xg, yg, xs, f(xs)


def bench_grbcm_million_serving(nc: int = 2000, nls: int = 500, ng: int = 128, nq: int = 4096, dim: int = 2,
                                chunk: int = 100, reps: int = 3, rounds: int = 4, seed: int = 0,
                                return_posterior: bool = False, device="cuda"):
    """BASELINE config 5, one-card half: grBCM serving throughput at
    N = nc·nls = 10⁶ training points.

    The committee has ``nc`` augmented experts of ``n_aug = ng + nls``.
    Every expert's ``T = L⁻¹`` and ``w = K⁻¹y`` are computed once, in
    chunks of ``chunk`` experts (one K1 launch for a chunk's grams, the
    K3 Cholesky of its stack, block-doubling inverses), into one resident
    ``[nc, n_aug, n_aug]`` stack (3.2 GB at the defaults).  A query batch
    is then products only: the global expert's predict, then per chunk of
    experts one cross gram and one ``T·K*ᵀ`` product, with the β-precision
    aggregation (pinned communication expert β₁ = 1) summed chunk by chunk
    in ``[nq]`` accumulators.  The hyperparameters are fixed (θ = 1,
    σₙ = 0.3), not fitted, so ``rmse_vs_true`` is that of grBCM at those
    parameters: it grows with the number of experts.
    ``return_posterior=True`` also returns the aggregated mean and variance
    (NumPy) for the parity checks."""
    import pygpr_torch as gp
    from pygpr_torch.models import exact_gp
    from pygpr_torch.ops import linalg
    from pygpr_torch.ops.kernels import train_gram

    assert nc % chunk == 0
    n_aug = ng + nls
    nch = nc // chunk
    xl, yl, xg, yg, xs, ys_true = million_serving_data(nc, nls, ng, nq, dim, seed)
    # augmentation on the host (data preparation stays NumPy)
    x_aug = np.concatenate([np.broadcast_to(xg, (nc, ng, dim)), xl], axis=1)
    y_aug = np.concatenate([np.broadcast_to(yg, (nc, ng)), yl], axis=1)

    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    nhp = cov.n_params(dim)
    params = np.ones((nhp,), np.float32)
    params[-1] = 0.3
    p_j = torch.as_tensor(params, device=device)

    def as_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    # ---- one-time factorization sweep, chunked ----------------------------
    def factorize_chunk(xc, yc):
        grams = train_gram(cov, p_j, xc)
        chol = linalg.safe_cholesky(grams).chol
        del grams
        return linalg.tri_inverse_doubling(chol), linalg.cholesky_solve(chol, yc)

    def setup():
        t_all = torch.zeros((nc, n_aug, n_aug), dtype=torch.float32, device=device)
        w_parts = []
        for i in range(nch):
            s = slice(i * chunk, (i + 1) * chunk)
            t_all[s], wc = factorize_chunk(as_dev(x_aug[s]), as_dev(y_aug[s]))
            w_parts.append(wc)
        sg = exact_gp.precompute_tinv(exact_gp.factorize(cov, p_j, as_dev(xg), as_dev(yg)))
        return t_all, torch.cat(w_parts, dim=0), as_dev(x_aug), sg

    with torch.no_grad():
        (t_all, w_all, x_all, sg), setup_s = _timed(setup, device)
        floor = 1e-7
        ones = torch.ones((chunk,), dtype=torch.bool, device=device)
        zeros = torch.zeros((chunk,), dtype=torch.float32, device=device)

        def step(q):
            mu_g, var_g = exact_gp.predict(cov, sg, q, "diag")
            prec_g = 1.0 / var_g
            lg = torch.log(prec_g)
            s1, s2, sb = (torch.zeros((nq,), dtype=torch.float32, device=device) for _ in range(3))
            for i in range(nch):
                s = slice(i * chunk, (i + 1) * chunk)
                st = exact_gp.GPState(x=x_all[s], y=w_all[s], params=p_j.expand(chunk, nhp), chol=t_all[s],
                                      weights=w_all[s], jitter=zeros, ok=ones, tinv=t_all[s])
                mu, var = exact_gp.predict(cov, st, q, "diag")
                prec = 1.0 / torch.clamp_min(var, floor)
                beta = 0.5 * (torch.log(prec) - lg[None])
                if i == 0:
                    beta[0] = 1.0
                s1 += torch.sum(beta * prec, dim=0)
                s2 += torch.sum(beta * prec * mu, dim=0)
                sb += torch.sum(beta, dim=0)
            beta0 = 1.0 - sb
            covar = 1.0 / (beta0 * prec_g + s1)
            mean = covar * (beta0 * prec_g * mu_g + s2)
            return q + 0.0 * (mean + covar)[:, None], mean, covar

        q = as_dev(xs)
        _, mean, covar = step(q)
        mean_h, var_h = mean.cpu().numpy(), covar.cpu().numpy()
        assert np.isfinite(mean_h).all() and (var_h > 0).all()
        rmse = float(np.sqrt(np.mean((mean_h - ys_true) ** 2)))

        best = float("inf")
        for _ in range(rounds):
            _sync(device)
            t0 = time.perf_counter()
            s = q
            for _ in range(reps):
                s, mean, covar = step(s)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / reps)

    rec = {
        "metric": "grbcm_1m_predictions_per_s_single_chip",
        "value": nq / best,
        "unit": "predictions/s",
        "n_total": nc * nls,
        "experts": nc,
        "n_aug": n_aug,
        "queries_per_batch": nq,
        "batch_seconds": best,
        "setup_seconds": setup_s,
        "rmse_vs_true": rmse,
        "path": ("serving: per-expert T=L^-1 + weights precomputed once (3.2 GB resident at the defaults), "
                 "query batches products only, experts taken in chunks with the beta-precision aggregation "
                 "summed chunk by chunk (pinned communication expert)"),
        "vs_baseline": None,
        "baseline": ("reference dense pipeline cannot run at N=1e6 (8 TB gram); BASELINE config 5's "
                     "single-chip half"),
    }
    if return_posterior:
        return rec, mean_h, var_h
    return rec


def bench_iterative_large_n(n: int = 32768, dim: int = 2, num_probes: int = 8, rank: int = 64, block: int = 4096,
                            max_cg: int = 64, n_query: int = 2048, seed: int = 0, device="cuda") -> dict:
    """Matrix-free exact-GP NLML value + gradient at n = 32768 on one
    card: about (CG + Lanczos + 2) gram-matvecs of 2n²·cols flops each
    (kernel K4 for the bare f32 RBF) and no n×n array; then the posterior
    mean of ``n_query`` points by CG."""
    import pygpr_torch as gp
    from pygpr_torch.models import iterative

    rng = np.random.default_rng(seed)

    def f(x):
        return np.sin(2.0 * x.sum(-1))

    x = rng.uniform(0, 4, (n, dim)).astype(np.float32)
    y = (f(x) + 0.1 * rng.normal(size=n)).astype(np.float32)
    xs = rng.uniform(0, 4, (n_query, dim)).astype(np.float32)
    probes = torch.as_tensor(iterative.make_probes(n, num_probes, seed), device=device)
    cov = gp.RBF()
    params = torch.as_tensor(np.r_[np.ones(dim + 1), 0.1].astype(np.float32), device=device)
    x_j, y_j, xs_j = (torch.as_tensor(a, device=device) for a in (x, y, xs))

    num_lanczos = 16

    def vg():
        return iterative.nlml_value_and_grad(cov, params, x_j, y_j, probes, rank=rank, num_lanczos=num_lanczos,
                                             cg_tol=1e-4, max_cg=max_cg, block=block)

    v, g = vg()
    v0 = float(v)
    (v, g), eval_s = _timed(vg, device)
    # matvec passes: CG (max_cg steps of one [n, 1 + p] matvec), Lanczos
    # (num_lanczos × p columns), the surrogate's forward and backward
    # (4 × (1 + p)); a column pass is about 2n²(d + 1) flops, and the
    # columns of one [n, k] matvec share its distances (÷ (1 + p))
    cols_cg = max_cg * (1 + num_probes)
    cols_slq = num_lanczos * num_probes
    cols_grad = 4 * (1 + num_probes)
    flops = 2.0 * n * n * (dim + 1) * (cols_cg + cols_slq + cols_grad) / (1 + num_probes)

    def mean_f():
        return iterative.predict(cov, params, x_j, y_j, xs_j, var="none", rank=rank, cg_tol=1e-4, max_cg=max_cg,
                                 block=block)[0]

    with torch.no_grad():
        mean_f()
        mean, predict_s = _timed(mean_f, device)
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - f(xs)) ** 2)))
    return {
        "metric": "iterative_exact_gp_n32768_single_chip",
        "n_total": n,
        "eval_s": eval_s,
        "evals_per_s": 1.0 / eval_s,
        "nlml": v0,
        "grad_finite": bool(torch.isfinite(g).all()),
        "approx_tflops": flops / eval_s / 1e12,
        "mean_predict_s": predict_s,
        "rmse_vs_true": rmse,
        "note": f"no n×n array exists; dense gram would be {4.0 * n * n / 2**30} GiB",
    }


def sgpr_large_n_data(n: int = 98304, n_query: int = 8192, dim: int = 2, seed: int = 0):
    """The data of :func:`bench_sgpr_large_n` (NumPy): ``x [n, dim]``,
    ``y``, queries ``xs [n_query, dim]`` (f32), the noise-free targets
    there (f64) and noisy ones (f32), for :func:`bench_large_n`'s function
    on [0, 4]^dim with noise 0.1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 4, (n, dim)).astype(np.float32)
    y = (_large_n_target(x) + 0.1 * rng.normal(size=n)).astype(np.float32)
    xs = rng.uniform(0, 4, (n_query, dim)).astype(np.float32)
    ys_true = _large_n_target(xs)
    ys_noisy = (ys_true + 0.1 * rng.normal(size=n_query)).astype(np.float32)
    return x, y, xs, ys_true, ys_noisy


def bench_sgpr_large_n(n: int = 98304, m: int = 1024, n_query: int = 8192, dim: int = 2, fit_iters: int = 60,
                       seed: int = 0, return_posterior: bool = False, device="cuda"):
    """SGPR at N ≈ 100k on one card, the low-rank counterpart of
    :func:`bench_large_n` (same generative function, N and query set).
    An ELBO evaluation is two tall [m, n] products and the m×m
    factorizations; the serving state is m-sized.
    ``return_posterior=True`` also returns the predictive mean and
    variance (NumPy) for the parity checks."""
    import pygpr_torch as gp
    from pygpr_torch.models import sgpr

    x, y, xs, ys_true, ys_noisy = sgpr_large_n_data(n, n_query, dim, seed)

    cov = gp.RBF()
    z = torch.as_tensor(sgpr.init_inducing(x, m, seed=seed), device=device)
    x_j, y_j, xs_j = (torch.as_tensor(a, device=device) for a in (x, y, xs))
    p0 = sgpr.init_params(cov, x_j)

    (res, _), fit_s = _timed(lambda: sgpr.fit(cov, p0, x_j, y_j, z, max_iter=fit_iters), device)
    params = res.params

    def fac():
        return sgpr.factorize(cov, params, x_j, y_j, z)

    fac()
    st, factorize_s = _timed(fac, device)
    with torch.no_grad():
        sgpr.predict(cov, st, xs_j, "diag")
        (mean, var), predict_s = _timed(lambda: sgpr.predict(cov, st, xs_j, "diag"), device)
    mean, var = mean.cpu().numpy(), var.cpu().numpy()
    err = mean - ys_noisy
    rec = {
        "metric": "sgpr_large_n_single_chip",
        "n_total": n,
        "inducing": m,
        "fit_s": fit_s,
        "fit_iters_taken": int(res.iters),
        "neg_elbo": float(res.value),
        "factorize_s": factorize_s,
        "predict_s": predict_s,
        "predictions_per_s": n_query / predict_s,
        "rmse_vs_true": float(np.sqrt(np.mean((mean - ys_true) ** 2))),
        "nlpd": float(np.mean(0.5 * np.log(2 * np.pi * var) + err**2 / (2 * var))),
        "params": [float(v) for v in params.cpu().numpy()],
    }
    if return_posterior:
        return rec, mean, var
    return rec


def statespace_large_data(n: int = 1_000_000, seed: int = 3):
    """The data of :func:`bench_statespace_large` (NumPy, f32): t ~ U(0,
    2000) sorted, y = sin(0.3t) + 0.1·N(0, 1)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 2000.0, n)).astype(np.float32)
    y = (np.sin(0.3 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return t, y


def _peak_bytes(device, fn):
    """``(fn(), peak device bytes allocated during it)`` on a CUDA device;
    ``None`` for the peak elsewhere."""
    if torch.device(device).type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device)


def bench_statespace_large(n: int = 1_000_000, nu: float = 1.5, nq: int = 4096, reps: int = 3, seed: int = 3,
                           include_posterior: bool = True, device="cuda") -> dict:
    """Exact 1-D Matérn-3/2 GP at n = 10⁶ on one card through the
    state-space parallel scans (``models/statespace``).

      * NLML value + gradient seconds an evaluation at the full n by the
        adjoint scan (``nlml_ss_adjoint_value_and_grad``); the dense
        pipeline at n = 10⁶ would need an 8 TB gram.
      * the NLML value alone at the full n, and value + gradient by
        autograd through the scan at n/8 (as the JAX bench).
      * the smoothed posterior at ``nq`` query times, the host merge of
        the queries included.

    A failure of the adjoint gradient fails the run.  Beside the JAX
    bench's keys, the record holds the peak device bytes of the adjoint
    and the autograd evaluations (``None`` off the card).
    """
    from pygpr_torch.models import statespace

    t, y = statespace_large_data(n, seed)
    t_j, y_j = (torch.as_tensor(a, device=device) for a in (t, y))
    p0 = torch.tensor([1.0, 1.0, 0.1], dtype=torch.float32, device=device)

    def adjoint():
        return statespace.nlml_ss_adjoint_value_and_grad(nu, p0, t_j, y_j)

    (va, ga), adj_peak = _peak_bytes(device, adjoint)
    v0 = float(va)
    if not (np.isfinite(v0) and bool(torch.isfinite(ga).all())):
        raise FloatingPointError(f"non-finite state-space adjoint value or gradient: {v0}, {ga.tolist()}")
    _, s = _timed(lambda: [adjoint() for _ in range(reps)], device)
    grad_eval_s = s / reps
    rec = {
        "metric": "statespace_exact_nlml_grad_n1e6_single_chip",
        "value": 1.0 / grad_eval_s,
        "unit": "evals/s",
        "n_total": n,
        "nu": nu,
        "nlml_at_init": v0,
        "adjoint_grad_seconds_per_eval": grad_eval_s,
        "adjoint_grad_n": n,
        "grad_note": "exact value+gradient at the full n by the adjoint scan (models/statespace.py): the filter, "
                     "one backward affine scan and an elementwise linear functional; no scan is differentiated",
        "vs_baseline": None,
        "baseline": "reference dense pipeline cannot run at n=1e6 (8 TB gram); this is the exact Matern NLML via "
                    "the O(n) associative-scan state-space form",
        "adjoint_grad_peak_bytes": adj_peak,
    }
    if not include_posterior:
        return rec

    with torch.no_grad():
        value = lambda: statespace.nlml_ss(nu, p0, t_j, y_j)
        v = value()
        _, s = _timed(lambda: [value() for _ in range(reps)], device)
    if not np.isfinite(float(v)):
        raise FloatingPointError("non-finite state-space NLML")
    rec["nlml_value_seconds_per_eval"] = s / reps

    n_grad = n // 8
    tg, yg = t_j[:n_grad], y_j[:n_grad]

    def ad():
        q = p0.clone().requires_grad_(True)
        with torch.enable_grad():
            val = statespace.nlml_ss(nu, q, tg, yg)
            (g,) = torch.autograd.grad(val, q)
        return val.detach(), g

    (vd, gd), ad_peak = _peak_bytes(device, ad)
    if not (np.isfinite(float(vd)) and bool(torch.isfinite(gd).all())):
        raise FloatingPointError("non-finite state-space NLML gradient by autograd")
    _, s = _timed(lambda: [ad() for _ in range(reps)], device)
    rec["ad_grad_n"] = n_grad
    rec["ad_grad_seconds_per_eval"] = s / reps
    rec["ad_grad_peak_bytes"] = ad_peak

    # smoothed posterior, timed end to end (the host merge of the queries
    # into the chain is part of the path)
    tq = np.linspace(0.0, 2000.0, nq).astype(np.float32)
    with torch.no_grad():
        statespace.posterior_ss(nu, p0, t_j, y_j, tq)
        (mq, vq), post_s = _timed(lambda: statespace.posterior_ss(nu, p0, t_j, y_j, tq), device)
    mq_h, vq_h = mq.cpu().numpy(), vq.cpu().numpy()
    if not (np.isfinite(mq_h).all() and (vq_h > 0).all()):
        raise FloatingPointError("state-space posterior not finite and positive")
    rec.update(posterior_nq=nq, posterior_seconds=post_s,
               posterior_rmse_vs_true=float(np.sqrt(np.mean((mq_h - np.sin(0.3 * tq)) ** 2))))
    return rec
