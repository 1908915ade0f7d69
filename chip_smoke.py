#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pygpr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``pygpr_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, drives the
port's exact-GP path (NLML value + fast gradient at n = 2048..16384, then
an L-BFGS fit, factorize and predict at n = 4096), and prints one JSON
object per phase.  The last line is
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
    from pygpr_torch.ops import _build, chol_inverse, gram

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
        pivot chain), K2's products, and every other kernel ("torch")."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        groups = {"k1": 0.0, "k2_pivot_chain": 0.0, "k2_products": 0.0, "torch": 0.0}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            us = getattr(e, "cuda_time_total", 0.0) if us is None else us
            if "rbf_noise_gram_kernel" in e.key:
                groups["k1"] += us
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

    # -- 4. main path: NLML value + fast gradient ---------------------------
    # bounds against the same call in f64 on the card (plain torch path):
    # value 1e-4 and gradient 1e-2 relative, about 15x and 10x the
    # f32-vs-f64 gaps of the JAX package at n = 2048
    counters = (gram.rbf_noise_gram_cuda, chol_inverse.cholesky_inverse_cuda)
    for c in counters:
        c.launches = 0
    for n in (2048, 4096, 8192, 16384):
        xn, yn, pn = make_data(n)
        x, y, p = to_dev(xn, yn, pn)
        before = [c.launches for c in counters]
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
        delta = [c.launches - b for c, b in zip(counters, before)]
        ok = all([ok, check("nlml", f"n={n} kernels not launched {delta}", min(delta) > 0)])
        parts = device_ms(lambda: gp.nlml_value_and_grad(cov, p, x, y))
        out.update(ok=ok, ms_per_eval=1e3 * s, evals_per_s=1.0 / s,
                   tflops=eval_flops(n) / s / 1e12, launches_k1=delta[0], launches_k2=delta[1],
                   device_ms=parts, idle_share=1.0 - parts["all"] / (1e3 * s))
        emit(out)
        del x, y

    # -- 5. fit and serve ----------------------------------------------------
    n = 4096
    xn, yn, pn = make_data(n)
    x, y, p = to_dev(xn, yn, pn)
    before = [c.launches for c in counters]
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
    delta = [c.launches - b for c, b in zip(counters, before)]
    ok = all([
        check("fit", f"NLML did not fall: {v0} -> {res.value.item()}", res.value.item() < v0),
        check("fit", "non-finite params", bool(torch.isfinite(res.params).all())),
        check("serve", f"rmse {rmse} >= 0.1", rmse < 0.1),
        check("serve", "variance not finite and > 0", bool(torch.isfinite(var).all() and (var > 0).all())),
        check("fit", f"kernels not launched {delta}", min(delta) > 0),
    ])
    emit({"phase": "fit_and_serve", "n": n, "queries": 4096, "nlml_start": v0,
          "nlml_fit": res.value.item(), "iters": int(res.iters), "grad_norm": res.grad_norm.item(),
          "params": res.params.tolist(), "fit_s": fit_s, "factorize_s": factorize_s,
          "precompute_tinv_s": tinv_s, "predict_s": predict_s,
          "predictions_per_s": 4096 / predict_s, "rmse": rmse, "ok": ok,
          "launches_k1": delta[0], "launches_k2": delta[1]})

    # -- 6. kernels ----------------------------------------------------------
    k1, k2 = record["k1"], record["k2"]
    # a kernel's check passed when none of its comparison phases failed
    k1_ok, k2_ok = (not any(f.startswith(p) for f in failures) for p in ("k1", "k2"))
    emit({"kernels": [
        {"name": "rbf_noise_gram", "route": "cuda", "source": "pygpr_torch/csrc/rbf_noise_gram.cu",
         "replaces": "pygpr_tpu/ops/pallas_kernels.py:136",
         "launches": counters[0].launches, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "n": k1["n"], "ok": k1_ok},
        {"name": "cholesky_inverse", "route": "cuda", "source": "pygpr_torch/csrc/chol_inverse.cu",
         "replaces": "pygpr_tpu/ops/pallas_cholesky.py:1071",
         "launches": counters[1].launches, "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "n": k2["n"], "ok": k2_ok},
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
