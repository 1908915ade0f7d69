#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pygpr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pygpr_torch/csrc`` with nvcc
(K1 gram, K2 fused Cholesky + inverse, K3 batched Cholesky), holds each
against its plain PyTorch version on the card, drives the port's exact-GP
path (NLML value + fast gradient at n = 2048..16384, then an L-BFGS fit,
factorize and predict at n = 4096) and its grBCM committee path (train,
factorize and serve at 16 experts of 512 points, then fit, factorize and
predict at 16 experts of 6144 points, held against f64 on the card), and
prints one JSON object per phase.  The last line is
``{"ok": true, "device": {"platform": "gpu", ...}}``; any failed check
exits non-zero without it.  Without a CUDA device it exits 1 at once.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
#: FP32 FFMA flop/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

#: L-BFGS iterations of the shared committee fit at N = 98304, the JAX
#: package's own (bench_large_n)
LARGE_FIT_ITERS = 15
#: f32 against f64 on the card at N = 98304, same parameters: largest
#: absolute gap of the aggregated mean and largest relative gap of the
#: aggregated variance, about 9x the gaps measured on an H100 at this
#: input after the 15-iteration fit (5.57e-3 and 1.26e-2): f32 round-off
#: times the conditioning of 6400-point grams with noise variance 0.01
LARGE_MEAN_GAP = 5e-2
LARGE_VAR_GAP = 0.12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_data(n, dim=3, seed=42):
    """The JAX package's flagship benchmark data (bench.py::make_data)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(n, dim)).astype(np.float32)
    y = (np.sin(2.0 * x.sum(-1)) + 0.1 * rng.normal(size=n)).astype(np.float32)
    params = np.ones(dim + 2, np.float32)
    params[-1] = 0.1
    return x, y, params


def eval_flops(n, dim=3):
    """FLOPs of one fast value+grad evaluation (bench.py::eval_flops):
    Cholesky n³/3 + inverse n³/3 + K⁻¹ = TᵀT ⅔n³ + gram terms."""
    return (4.0 / 3.0) * n**3 + 4.0 * n**2 * dim + 20.0 * n**2


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    import numpy as np

    import pygpr_torch as gp
    from pygpr_torch.models import exact_gp, grbcm, metrics
    from pygpr_torch.ops import _build, chol_batched, chol_inverse, gram

    dev = torch.device("cuda")
    failures = []

    def check(phase, name, ok):
        if not ok:
            failures.append(f"{phase}: {name}")
        return bool(ok)

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def to_dev(*arrays, dtype=torch.float32):
        return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]

    def device_ms(fn):
        """Device time (ms) of one call of ``fn`` by group of kernels, from
        torch.profiler: K1, K2's one-block diagonal factorizations (its
        pivot chain), K2's products, K3's diagonal blocks (its pivot
        chain), K3's products, and every other kernel ("torch")."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = {"k1": 0.0, "k2_pivot_chain": 0.0, "k2_products": 0.0, "k3_pivot_chain": 0.0,
                  "k3_products": 0.0, "torch": 0.0}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            us = getattr(e, "cuda_time_total", 0.0) if us is None else us
            if "rbf_noise_gram_kernel" in e.key:
                groups["k1"] += us
            elif "chol_batched_diag_kernel" in e.key:
                groups["k3_pivot_chain"] += us
            elif "chol_batched_" in e.key:
                groups["k3_products"] += us
            elif "diag_block_kernel" in e.key:
                groups["k2_pivot_chain"] += us
            elif any(k in e.key for k in ("gemm_kernel", "splitk_reduce_kernel", "zero_upper_kernel")):
                groups["k2_products"] += us
            else:
                groups["torch"] += us
        out = {k: v / 1e3 for k, v in groups.items()}
        out["all"] = sum(out.values())
        return out

    # -- 1. environment and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tf32_off = (
        torch.backends.cuda.matmul.allow_tf32 is False
        and torch.get_float32_matmul_precision() == "highest"
    )
    check("env", "f32 matmuls in IEEE f32, not TF32", tf32_off)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for name, log in _build.build_logs.items()
    }
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    emit({
        "phase": "env", "card": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "tf32_off": tf32_off, "build_s": build_s, "ptxas": ptxas,
    })
    record = {}

    # -- 2. K1: fused RBF+noise gram against its plain version --------------
    # tolerance 1e-5 absolute: same formula and summation order, so only
    # expf against torch.exp and fma contraction differ (K ≤ σ² + σₙ² ≈ 1)
    for n in (1000, 2048, 8192):
        xn, _, pn = make_data(n)
        x, p = to_dev(xn, pn)
        K = gram.rbf_noise_gram_cuda(p, x)
        err = (K - gram.rbf_noise_gram_plain(p, x)).abs().max().item()
        ms = cuda_ms(lambda: gram.rbf_noise_gram_cuda(p, x), 20)
        plain_ms = cuda_ms(lambda: gram.rbf_noise_gram_plain(p, x), 5)
        b_ms, b_by = bound_ms(4.0 * (n * n + n * 3 + 5), n * n * (3.0 * 3 + 3))
        ok = check("k1", f"n={n} max_abs_err {err} > 1e-5", err <= 1e-5)
        emit({"phase": "k1_rbf_noise_gram", "n": n, "d": 3, "max_abs_err": err, "ok": ok,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        record["k1"] = dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # -- 3. K2: fused Cholesky + inverse against plain and f64 --------------
    # tolerances: against f64, ‖L−L64‖F/‖L64‖F ≤ 1e-3 and max|T·L−I| ≤ 1e-3
    # (f32 round-off times cond(K), measured ≤ 1.4e-4 and ≤ 2e-5 at these
    # inputs); against the plain version, max-abs difference ≤ 1e-3 of
    # max|L| and of max|T| (same algorithm, other summation order)
    for n in (256, 2048, 8192):
        xn, _, pn = make_data(n)
        x, p = to_dev(xn, pn)
        K = gram.rbf_noise_gram_plain(p, x)
        L, T = chol_inverse.cholesky_inverse_cuda(K)
        L64 = torch.linalg.cholesky(K.double())
        rel_l = (torch.linalg.norm(L.double() - L64) / torch.linalg.norm(L64)).item()
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        tl = (T.double() @ L.double() - eye).abs().max().item()
        del L64, eye
        zeros = bool((torch.triu(L, 1) == 0).all() and (torch.triu(T, 1) == 0).all())
        t0 = time.perf_counter()
        Lp, Tp = chol_inverse.cholesky_inverse_plain(K)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err_l = (L - Lp).abs().max().item()
        err_t = (T - Tp).abs().max().item()
        rel_pl = err_l / L.abs().max().item()
        rel_pt = err_t / T.abs().max().item()
        del Lp, Tp
        ms = cuda_ms(lambda: chol_inverse.cholesky_inverse_cuda(K), 3 if n >= 8192 else 10)
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(K), 5)
        parts = device_ms(lambda: chol_inverse.cholesky_inverse_cuda(K))
        panels = n // chol_inverse.PANEL
        b_ms, b_by = bound_ms(12.0 * n * n, (2.0 / 3.0) * n**3)
        ok = all([
            check("k2", f"n={n} rel L err {rel_l}", rel_l <= 1e-3),
            check("k2", f"n={n} |TL-I| {tl}", tl <= 1e-3),
            check("k2", f"n={n} upper triangles not zero", zeros),
            check("k2", f"n={n} vs plain L {rel_pl}", rel_pl <= 1e-3),
            check("k2", f"n={n} vs plain T {rel_pt}", rel_pt <= 1e-3),
        ])
        emit({"phase": "k2_cholesky_inverse", "n": n, "rel_err_L_vs_f64": rel_l,
              "max_abs_TL_minus_I": tl, "upper_zero": zeros, "max_abs_err_L_vs_plain": err_l,
              "max_abs_err_T_vs_plain": err_t, "ok": ok, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": b_ms, "bound_by": b_by, "library_ms_cholesky_ex": lib_ms,
              "panels": panels, "pivot_chain_ms": parts["k2_pivot_chain"],
              "pivot_block_us": 1e3 * parts["k2_pivot_chain"] / panels,
              "products_ms": parts["k2_products"]})
        record["k2"] = dict(n=n, max_abs_err=err_l, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
        del K, L, T
    L, _ = chol_inverse.cholesky_inverse_cuda(-torch.eye(256, device=dev))
    indef_nan = not bool(torch.isfinite(L).all())
    emit({"phase": "k2_indefinite", "n": 256, "nonfinite_L": indef_nan,
          "ok": check("k2", "indefinite input gave a finite L", indef_nan)})

    # -- 4. K3: batched Cholesky against plain and f64 ------------------------
    # tolerances as K2's: against f64, ‖L−L64‖F/‖L64‖F ≤ 1e-3 (f32
    # round-off times cond(K)); against the plain version, max-abs
    # difference ≤ 1e-3 of max|L| (the same right-looking algorithm, with
    # cuBLAS's summation order in the plain version's products)
    def committee_grams(nb, n, seed=3):
        """RBF + noise grams of the committee's inputs: d = 2 on [0, 4]²,
        σ = ℓ = 1, σₙ = 0.1."""
        x = np.random.default_rng(seed).uniform(0.0, 4.0, size=(nb, n, 2)).astype(np.float32)
        (p,) = to_dev(np.array([1.0, 1.0, 1.0, 0.1], np.float32))
        return torch.stack([gram.rbf_noise_gram_plain(p, xi) for xi in to_dev(*x)])

    record["k3"] = {}
    for nb, n in ((1, 256), (1, 1000), (16, 768), (16, 6400)):
        K = committee_grams(nb, n)
        K = K[0] if nb == 1 else K  # [n, n] as cholesky_pallas takes it
        L = chol_batched.cholesky_batched_cuda(K)
        L64 = torch.linalg.cholesky(K.double())
        rel_l = (torch.linalg.norm(L.double() - L64) / torch.linalg.norm(L64)).item()
        del L64
        zeros = bool((torch.triu(L, 1) == 0).all())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Lp = chol_batched.cholesky_batched_plain(K)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = (L - Lp).abs().max().item()
        rel_p = err / L.abs().max().item()
        del Lp
        reps = 3 if n >= 4096 else 10
        ms = cuda_ms(lambda: chol_batched.cholesky_batched_cuda(K), reps)
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps)
        parts = device_ms(lambda: chol_batched.cholesky_batched_cuda(K))
        b_ms, b_by = bound_ms(8.0 * nb * n * n, nb * n**3 / 3.0)
        shape = list(K.shape)
        ok = all([
            check("k3", f"{shape} rel L err {rel_l}", rel_l <= 1e-3),
            check("k3", f"{shape} upper triangle not zero", zeros),
            check("k3", f"{shape} vs plain {rel_p}", rel_p <= 1e-3),
        ])
        emit({"phase": "k3_chol_batched", "shape": shape, "rel_err_L_vs_f64": rel_l, "upper_zero": zeros,
              "max_abs_err_vs_plain": err, "ok": ok, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
              "bound_by": b_by, "library_ms_cholesky_ex": lib_ms, "ms_over_bound": ms / b_ms,
              "ms_over_library": ms / lib_ms, "panels": -(-n // chol_batched.PANEL),
              "pivot_chain_ms": parts["k3_pivot_chain"], "products_ms": parts["k3_products"]})
        record["k3"][(nb, n)] = dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
        del K, L
    # one indefinite matrix in a stack of 16: NaN in its factor only, and the
    # other 15 bit-equal to their factors computed alone (no launch mixes
    # matrices, and the kernel has no atomics)
    K = committee_grams(16, 768)
    K[5] = -torch.eye(768, device=dev)
    L = chol_batched.cholesky_batched_cuda(K)
    lower = torch.ones(768, 768, dtype=torch.bool, device=dev).tril()
    own_nan = bool(torch.isnan(L[5][lower]).all())
    alone = all(torch.equal(L[i], chol_batched.cholesky_batched_cuda(K[i].contiguous())) for i in range(16) if i != 5)
    emit({"phase": "k3_indefinite", "shape": [16, 768, 768], "indefinite": 5, "nan_in_its_factor": own_nan,
          "others_equal_alone": alone,
          "ok": all([check("k3", "indefinite matrix's factor not all NaN", own_nan),
                     check("k3", "a finite factor differs from its factor alone", alone)])})
    del K, L

    # -- 5. main path: NLML value + fast gradient ---------------------------
    # bounds against the same call in f64 on the card (plain torch path):
    # value 1e-4 and gradient 1e-2 relative, about 15x and 10x the
    # f32-vs-f64 gaps of the JAX package at n = 2048
    k1, k2, k3 = gram.rbf_noise_gram_cuda, chol_inverse.cholesky_inverse_cuda, chol_batched.cholesky_batched_cuda
    totals = {"k1": 0, "k2": 0, "k3": 0, "k3_batched": 0}

    def zero_counts():
        k1.launches = k2.launches = k3.launches = k3.batched_launches = 0

    def read_counts():
        """Launches since zero_counts, by kernel, added to the totals of the
        main path's runs; k3_batched are K3's launches on a stack in
        cholesky_pallas_batched's domain."""
        got = {"k1": k1.launches, "k2": k2.launches, "k3": k3.launches, "k3_batched": k3.batched_launches}
        for k, v in got.items():
            totals[k] += v
        return got

    for n in (2048, 4096, 8192, 16384):
        xn, yn, pn = make_data(n)
        x, y, p = to_dev(xn, yn, pn)
        zero_counts()
        v, g = gp.nlml_value_and_grad(cov, p, x, y)
        out = {"phase": "nlml_value_and_grad", "n": n, "d": 3, "grad_mode": "fast"}
        ok = check("nlml", f"n={n} non-finite", bool(torch.isfinite(v) and torch.isfinite(g).all()))
        if n <= 8192:
            x64, y64, p64 = to_dev(xn, yn, pn, dtype=torch.float64)
            v64, g64 = gp.nlml_value_and_grad(cov, p64, x64, y64)
            rel_v = abs(v.item() - v64.item()) / abs(v64.item())
            rel_g = (torch.linalg.norm(g.double() - g64) / torch.linalg.norm(g64)).item()
            ok = all([ok, check("nlml", f"n={n} value rel {rel_v}", rel_v <= 1e-4),
                      check("nlml", f"n={n} grad rel {rel_g}", rel_g <= 1e-2)])
            out.update(value=v.item(), value_f64=v64.item(), rel_err_value=rel_v, rel_err_grad=rel_g)
            reps = 10 if n <= 4096 else 5
        else:
            out.update(value=v.item())
            reps = 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            v, g = gp.nlml_value_and_grad(cov, p, x, y)
        torch.cuda.synchronize()
        s = (time.perf_counter() - t0) / reps
        c = read_counts()
        ok = all([ok, check("nlml", f"n={n} kernels not launched {c}", min(c["k1"], c["k2"]) > 0)])
        parts = device_ms(lambda: gp.nlml_value_and_grad(cov, p, x, y))
        out.update(ok=ok, ms_per_eval=1e3 * s, evals_per_s=1.0 / s,
                   tflops=eval_flops(n) / s / 1e12, launches_k1=c["k1"], launches_k2=c["k2"],
                   device_ms=parts, idle_share=1.0 - parts["all"] / (1e3 * s))
        emit(out)
        del x, y

    # -- 6. fit and serve ----------------------------------------------------
    n = 4096
    xn, yn, pn = make_data(n)
    x, y, p = to_dev(xn, yn, pn)
    zero_counts()
    v0 = gp.nlml(cov, p, x, y).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gp.fit_mle(cov, p, x, y, max_iter=30)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = gp.factorize(cov, res.params, x, y)
    torch.cuda.synchronize()
    factorize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = gp.precompute_tinv(state)
    torch.cuda.synchronize()
    tinv_s = time.perf_counter() - t0
    xq = np.random.default_rng(7).uniform(0.0, 2.0, size=(4096, 3)).astype(np.float32)
    (xq_t,) = to_dev(xq)
    t0 = time.perf_counter()
    mean, var = gp.predict(cov, state, xq_t, var="diag")
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    truth = torch.sin(2.0 * xq_t.sum(-1))
    rmse = torch.sqrt(torch.mean((mean - truth) ** 2)).item()
    c = read_counts()
    ok = all([
        check("fit", f"NLML did not fall: {v0} -> {res.value.item()}", res.value.item() < v0),
        check("fit", "non-finite params", bool(torch.isfinite(res.params).all())),
        check("serve", f"rmse {rmse} >= 0.1", rmse < 0.1),
        check("serve", "variance not finite and > 0", bool(torch.isfinite(var).all() and (var > 0).all())),
        check("fit", f"kernels not launched {c}", min(c["k1"], c["k2"]) > 0),
    ])
    emit({"phase": "fit_and_serve", "n": n, "queries": 4096, "nlml_start": v0,
          "nlml_fit": res.value.item(), "iters": int(res.iters), "grad_norm": res.grad_norm.item(),
          "params": res.params.tolist(), "fit_s": fit_s, "factorize_s": factorize_s,
          "precompute_tinv_s": tinv_s, "predict_s": predict_s,
          "predictions_per_s": 4096 / predict_s, "rmse": rmse, "ok": ok,
          "launches_k1": c["k1"], "launches_k2": c["k2"]})
    del x, y, state, mean, var

    # -- 7. grBCM committees ---------------------------------------------------
    def committee_data(nc, nls, ng, nq, seed=0):
        """The JAX package's BASELINE config-4 data (bench_large_n): d = 2 on
        [0, 4]², f = sin(2Σx) + 0.5 cos(5x₀), noise 0.1 on the training
        targets and on the held-out targets of the NLPD."""
        rng = np.random.default_rng(seed)

        def f(x):
            return np.sin(2.0 * x.sum(-1)) + 0.5 * np.cos(5.0 * x[..., 0])

        xl = rng.uniform(0, 4, (nc, nls, 2)).astype(np.float32)
        yl = (f(xl) + 0.1 * rng.normal(size=(nc, nls))).astype(np.float32)
        xg = rng.uniform(0, 4, (ng, 2)).astype(np.float32)
        yg = (f(xg) + 0.1 * rng.normal(size=ng)).astype(np.float32)
        xs = rng.uniform(0, 4, (nq, 2)).astype(np.float32)
        ys_true = f(xs)
        ys_noisy = (ys_true + 0.1 * rng.normal(size=nq)).astype(np.float32)
        return xl, yl, xg, yg, xs, ys_true, ys_noisy

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def warm(fn, reps=5):
        """Seconds of ``reps`` further calls of ``fn``, one at a time, and
        their median."""
        secs = [timed(fn)[1] for _ in range(reps)]
        return float(np.median(secs)), secs

    def objective_profile(params, x_aug, y_aug):
        """Wall seconds, device ms by kernel group, and the device's idle
        share of one value and gradient of the shared fit's objective, the
        summed committee NLML in log parameters, at ``params``."""
        u = torch.log(params).requires_grad_(True)

        def objective():
            with torch.enable_grad():
                torch.autograd.grad(gp.nlml(cov, torch.exp(u), x_aug, y_aug).sum(), u)

        objective()
        wall_s = timed(objective)[1]
        parts = device_ms(objective)
        return wall_s, parts, 1.0 - parts["all"] / (1e3 * wall_s)

    def serve_checks(phase, mean, var, ys_true, ys_noisy):
        truth, noisy = to_dev(ys_true, ys_noisy)
        rmse = metrics.rmse(truth, mean).item()
        nlpd = metrics.nlpd(noisy, mean, var).item()
        ok = all([check(phase, f"rmse {rmse} >= 0.1", rmse < 0.1),
                  check(phase, "variance not finite and > 0", bool(torch.isfinite(var).all() and (var > 0).all()))])
        return rmse, nlpd, ok

    # 7a. serving at the JAX package's committee shape (bench.py::bench_predictions):
    # nc = 16, nls = 512, ng = 256 (n_aug = 768), 4096 queries
    xl, yl, xg, yg, xs, ys_true, ys_noisy = committee_data(16, 512, 256, 4096)
    model = gp.GRBCM(xl, yl, xg, yg, cov)
    zero_counts()
    info, fit_s = timed(lambda: model.train(max_iter=30, shared=True))
    c_fit = read_counts()
    eval_s, eval_parts, eval_idle = objective_profile(info.params_l[0], model.gpl.x, model.gpl.y)
    zero_counts()
    _, factorize_first_s = timed(lambda: (model.gpg.update(), model.gpl.update()))
    c_fac = read_counts()
    factorize_s, factorize_reps = warm(lambda: (gp.factorize(cov, model.gpg.params, model.xg, model.yg),
                                                gp.factorize(cov, model.gpl.params, model.gpl.x, model.gpl.y)))
    _, tinv_s = timed(model.prepare_serving)
    (xq,) = to_dev(xs)
    zero_counts()
    mean, var = model.predict(xq, "diag")
    read_counts()
    predict_s, predict_reps = warm(lambda: model.predict(xq, "diag"))
    rmse, nlpd, ok = serve_checks("grbcm_serving", mean, var, ys_true, ys_noisy)
    ok = all([ok,
              check("grbcm_serving", f"fit launches {c_fit}", min(c_fit["k1"], c_fit["k2"], c_fit["k3"]) > 0),
              check("grbcm_serving", f"factorize launches {c_fac}", min(c_fac["k1"], c_fac["k3"]) > 0)])
    emit({"phase": "grbcm_serving_16x512", "nc": 16, "nls": 512, "ng": 256, "n_aug": 768, "queries": 4096,
          "fit_max_iter": 30, "fit_s": fit_s,
          "nlml_l": info.nlml_l.tolist(), "params": info.params_l[0].tolist(), "params_g": info.params_g.tolist(),
          "objective_eval_s": eval_s, "objective_eval_device_ms": eval_parts, "objective_eval_idle_share": eval_idle,
          "factorize_first_s": factorize_first_s, "factorize_s": factorize_s, "factorize_s_warm": factorize_reps,
          "precompute_tinv_s": tinv_s, "predict_s": predict_s, "predict_s_warm": predict_reps,
          "predictions_per_s": 4096 / predict_s, "rmse": rmse, "nlpd": nlpd, "ok": ok,
          "launches_fit": c_fit, "launches_factorize": c_fac})
    del model, mean, var

    # 7b. BASELINE config 4 (pygpr_tpu/bench/__init__.py::bench_large_n):
    # nc = 16, nls = 6144, ng = 256, so n_aug = 6400 and N = 98304; 8192
    # queries.  The committee stays batch-visible throughout: its NLML in
    # the shared fit, factorize and T = L⁻¹ each take the whole
    # [16, 6400, 6400] stack
    xl, yl, xg, yg, xs, ys_true, ys_noisy = committee_data(16, 6144, 256, 8192)
    xl, yl, xg, yg, xq = to_dev(xl, yl, xg, yg, xs)
    zero_counts()
    (info, x_aug, y_aug), fit_s = timed(lambda: grbcm.fit(
        cov, xl, yl, xg, yg, max_iter=LARGE_FIT_ITERS, shared=True, stream=False))
    c_fit = read_counts()
    eval_s, eval_parts, eval_idle = objective_profile(info.params_l[0], x_aug, y_aug)
    def factorize_both():
        return gp.factorize(cov, info.params_g, xg, yg), gp.factorize(cov, info.params_l, x_aug, y_aug)

    zero_counts()
    (sg, sl), factorize_first_s = timed(factorize_both)
    c_fac = read_counts()
    factorize_s, factorize_reps = warm(factorize_both)
    fac_parts = device_ms(lambda: gp.factorize(cov, info.params_l, x_aug, y_aug))
    (sg, sl), tinv_s = timed(lambda: (gp.precompute_tinv(sg), gp.precompute_tinv(sl)))

    def predict_large():
        return grbcm.predict(cov, info.params_g, info.params_l, sg, sl, xq, "diag", mask=info.ok_l)

    zero_counts()
    res = predict_large()
    read_counts()
    predict_s, predict_reps = warm(predict_large)
    mean, var = res.mean, res.covar
    rmse, nlpd, ok = serve_checks("grbcm_large_n", mean, var, ys_true, ys_noisy)
    del sg, sl, res
    torch.cuda.empty_cache()
    # the same committee and parameters in f64 on the card (cholesky_ex and
    # cholesky_solve, no T): its 5.2 GB stack is above
    # exact_gp.BATCHED_STACK_BYTES, so factorize and predict take it one
    # expert at a time
    d64 = [a.double() for a in (info.params_g, info.params_l, xg, yg, x_aug, y_aug, xq)]
    per_expert = exact_gp._per_expert(d64[4])
    sg64 = gp.factorize(cov, d64[0], d64[2], d64[3])
    sl64 = gp.factorize(cov, d64[1], d64[4], d64[5])
    res64 = grbcm.predict(cov, d64[0], d64[1], sg64, sl64, d64[6], "diag", mask=info.ok_l)
    gap_mean = (mean.double() - res64.mean).abs().max().item()
    gap_var = ((var.double() - res64.covar).abs() / res64.covar).max().item()
    del sg64, sl64, res64, d64
    torch.cuda.empty_cache()
    ok = all([ok,
              check("grbcm_large_n", "the f64 reference was not per expert", per_expert),
              check("grbcm_large_n", f"f32 mean {gap_mean} from f64 > {LARGE_MEAN_GAP}", gap_mean <= LARGE_MEAN_GAP),
              check("grbcm_large_n", f"f32 variance {gap_var} from f64 > {LARGE_VAR_GAP}", gap_var <= LARGE_VAR_GAP),
              check("grbcm_large_n", f"fit launches {c_fit}", min(c_fit["k1"], c_fit["k2"], c_fit["k3"]) > 0),
              check("grbcm_large_n", f"factorize launches {c_fac}", min(c_fac["k1"], c_fac["k3"]) > 0)])
    emit({"phase": "grbcm_large_n", "nc": 16, "nls": 6144, "ng": 256, "n_aug": 6400, "n_total": 16 * 6144,
          "queries": 8192, "fit_iters_cap": LARGE_FIT_ITERS, "fit_s": fit_s, "nlml_l": info.nlml_l.tolist(),
          "params": info.params_l[0].tolist(), "params_g": info.params_g.tolist(),
          "objective_eval_s": eval_s, "objective_eval_device_ms": eval_parts, "objective_eval_idle_share": eval_idle,
          "factorize_first_s": factorize_first_s, "factorize_s": factorize_s, "factorize_s_warm": factorize_reps,
          "factorize_device_ms": fac_parts, "precompute_tinv_s": tinv_s, "predict_s": predict_s,
          "predict_s_warm": predict_reps, "predictions_per_s": 8192 / predict_s, "rmse": rmse, "nlpd": nlpd,
          "max_abs_mean_gap_vs_f64": gap_mean, "max_rel_var_gap_vs_f64": gap_var, "ok": ok,
          "launches_fit": c_fit, "launches_factorize": c_fac})
    del x_aug, y_aug, mean, var

    # -- 8. kernels ----------------------------------------------------------
    r1, r2 = record["k1"], record["k2"]
    r3a, r3b = record["k3"][(1, 256)], record["k3"][(16, 6400)]
    # a kernel's check passed when none of its comparison phases failed
    k1_ok, k2_ok, k3_ok = (not any(f.startswith(p) for f in failures) for p in ("k1", "k2", "k3"))

    def k3_line(name, replaces, launches, r):
        return {"name": name, "kernel": "cholesky_batched", "route": "cuda",
                "source": "pygpr_torch/csrc/chol_batched.cu", "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": r["shape"], "ok": k3_ok}

    emit({"kernels": [
        {"name": "rbf_noise_gram", "route": "cuda", "source": "pygpr_torch/csrc/rbf_noise_gram.cu",
         "replaces": "pygpr_tpu/ops/pallas_kernels.py:136",
         "launches": totals["k1"], "max_abs_err": r1["max_abs_err"], "ms": r1["ms"],
         "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"], "bound_by": r1["bound_by"],
         "library_ms": None, "n": r1["n"], "ok": k1_ok},
        {"name": "cholesky_inverse", "route": "cuda", "source": "pygpr_torch/csrc/chol_inverse.cu",
         "replaces": "pygpr_tpu/ops/pallas_cholesky.py:1071",
         "launches": totals["k2"], "max_abs_err": r2["max_abs_err"], "ms": r2["ms"],
         "plain_ms": r2["plain_ms"], "bound_ms": r2["bound_ms"], "bound_by": r2["bound_by"],
         "library_ms": r2["library_ms"], "n": r2["n"], "ok": k2_ok},
        k3_line("cholesky_pallas", "pygpr_tpu/ops/pallas_cholesky.py:529", totals["k3"] - totals["k3_batched"], r3a),
        k3_line("cholesky_pallas_batched", "pygpr_tpu/ops/pallas_cholesky.py:485", totals["k3_batched"], r3b),
    ]})
    if failures:
        print("chip_smoke failed:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
