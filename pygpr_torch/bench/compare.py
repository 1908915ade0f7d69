"""A kernel against an earlier version of its source, on one card in one
process.

    python -m pygpr_torch.bench.compare --kernel {k1,k2,k3,k4,k6} --old DIR [n ...]

``DIR`` holds the earlier source and the headers it includes, unpacked
from git into a directory that ``.gitignore`` lists, for example::

    mkdir -p _archive/k3_old
    for f in chol_batched.cu small_chol.cuh; do
      git show <commit>:pygpr_torch/csrc/$f > _archive/k3_old/$f; done

It is built there with the package's ``nvcc`` flags.  Each mode calls
one earlier C entry, named below, through ``ctypes``; a source that does
not declare exactly that entry (``OLD_ENTRIES``) is refused before it is
built.  Both kernels are timed in turns (old, new, new, old).  The card's
name and power limit come first.

``--kernel k1``: K1 (``csrc/rbf_noise_gram.cu``) against the one-matrix
version with C entry ``rbf_noise_gram_f32(x, params, out, n, d, stream)``,
which builds a stack in one launch a matrix (each into its slice of the
output, so no copy is timed).  For each shape (default: every shape the
main path of ``chip_smoke.py`` gives K1; given as groups of five ``nb n d
nx nparams``, the numbers of distinct x and θ, 1 for one shared along the
stack) one JSON line: both versions' device ms for the stack (queued
behind a spin kernel) and host ms a stack back to back (CUDA events, no
spin: what a caller that waits on nothing pays), the byte bound (a shared
input read once), whether the two stacks are bit-equal and the new one
bit-symmetric, on ``x ~ U(0, 2)``.  Exits 1 if a stack is not bit-equal.

``--kernel k2``: K2 (``csrc/chol_inverse.cu``, with ``block_inverse.cuh``
and ``small_chol.cuh``) against a version with C entry
``chol_inverse_f32(K, L, T, P, n, stream)``.  For each n (default: every
n the main path gives K2) one JSON line: both kernels' device ms (CUDA
events over a few calls each), whether their factors are bit-equal and
the larger gap between them (relative to max|L| and max|T|), each one's
relative L error and max|TL − I| against f64 at n ≤ 8192, and at
n = 2048, 4096 and 8192 the f32 NLML gradient's relative error against
f64 with each kernel in the fast path (the flagship's data,
``bench.py::make_data``, as ``chip_smoke.py`` draws it).

``--kernel k3``: K3 (``csrc/chol_batched.cu``, with ``small_chol.cuh``)
against a version with the same C entry ``chol_batched_f32(K, L, Diag,
nb, n, n_pad, stream)`` and a scratch ``Diag`` of
``chol_batched_scratch_floats(nb, n, n_pad)`` floats where the version
declares that entry, else ``[nb, 64, 64]``.  For each
shape (default: every shape the main path gives K3, B4's and B5's, and
the card tests' stacks; given as pairs ``nb n``) one JSON line: both
kernels' device ms (queued behind a spin kernel, as ``chip_smoke.py``
times K3), each one's device ms of its panel launches and of its
trailing updates (torch.profiler, ``chip_smoke.py``'s groups), and the
largest gap between their factors, on ``chip_smoke.py``'s committee
grams.  K3's factors are bit-equal to those
of the version at commit 6647aab on every shape (``csrc/chol_batched.cu``
says why), so the mode exits 1 if any gap is not exactly 0.

``--kernel k4``: K4 (``csrc/rbf_gram_matvec.cu``) against the version with
C entry ``rbf_gram_matvec_f32(x, theta, v, out, n, d, k, stream)``.  For
each n (default 32768 and 131072) and each width k the main path launches
there (1, 5, 8, 9, 40 and 256 at 32768; all but 256 at 131072) one JSON line: both
kernels' device ms and TFLOP/s (2n²(d + k)), the largest gap between their
outputs and each one's largest error against the f64 plain version, as a
share of ``chip_smoke.py``'s bound (1e-4 + 1e-3 of the column's largest
entry), on the main path's data (``chip_smoke.py::iterative_data``).

``--kernel k6``: K6 (``tri_inverse_blocks_f32`` of ``csrc/block_probe.cu``)
against a version with the same C entry ``tri_inverse_blocks_f32(in, out,
P, stream)``.  For each P (default 16 and 64, the stage probe's strips at
n = 2048 and 8192) one JSON line: both kernels' device ms (queued behind
a spin kernel), the gap between their inverses and each one's error
against f64, relative to the largest entry, on the probe's strips
(``chip_smoke.py``'s K6 inputs).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

#: every n the main path of ``chip_smoke.py`` gives K2
K2_MAIN_PATH_N = (256, 2048, 4096, 6400, 8192, 16384)
#: every shape (nb, n) the main path of ``chip_smoke.py`` gives K3 (B4's
#: matrices, the 10⁶-point serving chunk, B5's stacks), and the card
#: tests' stacks on either side of the choice between K3's launch sequences
K3_SHAPES = ((1, 256), (1, 1000), (1, 1024), (16, 768), (100, 628), (16, 6400), (4, 1536), (3, 2560), (16, 2048),
             (3, 4096))
#: every (nb, n, d, distinct x, distinct θ) the main path of
#: ``chip_smoke.py`` gives K1 (its ``main_path_by_shape`` line), and the
#: one-matrix kernel's chain gram (1, 1024, 1): one grams of the committees' global and
#: local experts, the fits and the flagship; the MCMC chains' stack (x
#: shared); the 16 × 512 + 256 and 16 × 6144 + 256 committees under their
#: shared θ (the fit) and with a θ row an expert (factorize); a 10⁶-point
#: serving chunk (θ shared)
K1_SHAPES = ((1, 128, 2, 1, 1), (1, 256, 2, 1, 1), (1, 1024, 1, 1, 1), (1, 1024, 3, 1, 1), (1, 2048, 3, 1, 1),
             (1, 4096, 3, 1, 1), (1, 6400, 2, 1, 1), (1, 8192, 3, 1, 1), (1, 16384, 3, 1, 1), (4, 1024, 1, 1, 4),
             (16, 768, 2, 16, 1), (16, 768, 2, 16, 16), (16, 6400, 2, 16, 1), (16, 6400, 2, 16, 16),
             (100, 628, 2, 100, 1))
#: the stage probe's strips, P blocks of 128 (n = 2048 and 8192)
K6_PANELS = (16, 64)
#: the widths the main path of ``chip_smoke.py`` launches K4 at, by n
K4_MAIN_PATH = {32768: (1, 5, 8, 9, 40, 256), 131072: (1, 5, 8, 9, 40)}
#: the C source each kernel is built from
SOURCES = {"k1": "rbf_noise_gram", "k2": "chol_inverse", "k3": "chol_batched", "k4": "rbf_gram_matvec", "k6": "block_probe"}
#: the one earlier C entry each mode calls, by its parameters' types: an
#: old source that does not declare exactly this entry is refused
OLD_ENTRIES = {
    "k1": ("rbf_noise_gram_f32", ("const void*", "const void*", "void*", "int", "int", "void*")),
    "k2": ("chol_inverse_f32", ("const void*", "void*", "void*", "void*", "int", "void*")),
    "k3": ("chol_batched_f32", ("const void*", "void*", "void*", "int", "int", "int", "void*")),
    "k4": ("rbf_gram_matvec_f32", ("const void*", "const void*", "const void*", "void*", "int", "int", "int", "void*")),
    "k6": ("tri_inverse_blocks_f32", ("const void*", "void*", "int", "void*")),
}


def entry_types(source: str, name: str) -> tuple:
    """The parameters' types of ``extern "C" int name(...)`` in the C
    source text, without the parameters' names; () if it is not there."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(name) + r"\s*\(([^)]*)\)", source)
    if m is None:
        return ()
    types = (re.sub(r"\s*\b\w+$", "", p.strip()) for p in m.group(1).split(","))
    return tuple(re.sub(r"\s*\*", "*", " ".join(t.split())) for t in types)


def build_old(src_dir: Path, name: str) -> ctypes.CDLL:
    """Compile ``src_dir/<name>.cu`` with the package's flags into
    ``src_dir`` and load it."""
    from pygpr_torch.ops import _build

    out = src_dir / f"lib{name}_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(out), str(src_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the old source:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def old_k2(lib: ctypes.CDLL):
    """The earlier library's ``(L, T)`` of a CUDA f32 ``K``."""
    fn = lib.chol_inverse_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]

    def call(K):
        n = K.shape[0]
        opts = dict(dtype=torch.float32, device=K.device)
        L, T, P = torch.empty((n, n), **opts), torch.empty((n, n), **opts), torch.empty((128, n), **opts)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), T.data_ptr(), P.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"old chol_inverse launch failed: CUDA error {err}")
        return L, T

    return call


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def queued_ms(fn, reps: int) -> float:
    """Device ms a call, the calls queued behind a spin kernel twice as
    long as the host takes to issue them (at 1.98 GHz), so that the events
    time them back to back even where a call's launches are shorter than
    its host work (``chip_smoke.py``'s ``shape_ms``)."""
    import time

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(20_000_000, int(2.0 * 1.98e9 * reps * host_s)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def old_k1(lib: ctypes.CDLL):
    """The earlier library's stack ``[nb, n, n]`` of CUDA f32 ``params [nb,
    d + 2]`` and ``x [nb, n, d]`` (each matrix's row contiguous; a shared
    input expanded): one launch a matrix."""
    fn = lib.rbf_noise_gram_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def call(p, x):
        nb, n, d = x.shape
        out = torch.empty((nb, n, n), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i in range(nb):
            err = fn(x[i].data_ptr(), p[i].data_ptr(), out[i].data_ptr(), n, d, stream)
            if err != 0:
                raise RuntimeError(f"old rbf_noise_gram launch failed: CUDA error {err}")
        return out

    return call


def compare_k1(old, shapes, device="cuda") -> list:
    """Both kernels in turns on each (nb, n, d, nx, nparams): nx distinct
    x and nparams distinct θ, a shared one expanded along the stack (the
    new kernel reads it at batch stride 0)."""
    from pygpr_torch.ops import gram

    new = gram.rbf_noise_gram_cuda
    rows = []
    for nb, n, d, nx, nparams in shapes:
        rng = np.random.default_rng(0)
        p = np.ones((nparams, d + 2), np.float32) + 0.01 * np.arange(nparams, dtype=np.float32)[:, None]
        p[:, -1] = 0.1
        x, p = (torch.tensor(a, dtype=torch.float32, device=device)
                for a in (rng.uniform(0.0, 2.0, (nx, n, d)), p))
        x, p = x.expand(nb, n, d), p.expand(nb, d + 2)
        reps = 10 if nb * n * n > 10**8 else 50
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(queued_ms(lambda: (old if who == "old" else new)(p, x), reps))
        Ko, Kn = old(p, x), new(p, x)
        row = {"shape": [nb, n, d, nx, nparams], "old_ms": turns["old"], "new_ms": turns["new"],
               "old_over_new": float(np.mean(turns["old"]) / np.mean(turns["new"])),
               "old_host_ms": events_ms(lambda: old(p, x), 4 * reps),
               "new_host_ms": events_ms(lambda: new(p, x), 4 * reps),
               "bound_ms": 1e3 * gram.stack_bytes(nb, n, d, nx, nparams) / 3.35e12,
               "bit_equal": bool(torch.equal(Kn, Ko)), "max_abs_gap": (Kn - Ko).abs().max().item(),
               "new_symmetric": bool(torch.equal(Kn, Kn.mT))}
        del Ko, Kn
        torch.cuda.empty_cache()
        print(json.dumps({"compare_k1": row}), flush=True)
        rows.append(row)
    return rows


def compare_k2(old, ns, device="cuda") -> list:
    import pygpr_torch as gp
    from pygpr_torch.bench import _synth
    from pygpr_torch.ops import chol_inverse, gram

    new = chol_inverse.cholesky_inverse_cuda
    dev = torch.device(device)
    cov = gp.Sum((gp.RBF(), gp.WhiteNoise()))
    rows = []
    for n in ns:
        x, y = _synth(n, 3, np.float32, device=dev)
        p = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.1], device=dev)
        K = gram.rbf_noise_gram_plain(p, x)
        reps = 2 if n >= 16384 else 3 if n >= 6400 else 10
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(events_ms(lambda: (old if who == "old" else new)(K), reps))
        Lo, To = old(K)
        Ln, Tn = new(K)
        row = {"n": n, "old_ms": turns["old"], "new_ms": turns["new"],
               "old_over_new": float(np.mean(turns["old"]) / np.mean(turns["new"])),
               "bit_equal": bool(torch.equal(Ln, Lo) and torch.equal(Tn, To)),
               "L_gap_over_max": ((Ln - Lo).abs().max() / Lo.abs().max()).item(),
               "T_gap_over_max": ((Tn - To).abs().max() / To.abs().max()).item()}
        if n <= 8192:
            L64 = torch.linalg.cholesky(K.double())
            eye = torch.eye(n, dtype=torch.float64, device=dev)
            for who, (L, T) in (("old", (Lo, To)), ("new", (Ln, Tn))):
                row[f"{who}_rel_err_L_vs_f64"] = (torch.linalg.norm(L.double() - L64) / torch.linalg.norm(L64)).item()
                row[f"{who}_max_abs_TL_minus_I"] = (T.double() @ L.double() - eye).abs().max().item()
            del L64, eye
        del Lo, To, Ln, Tn
        if n in (2048, 4096, 8192):
            v64, g64 = gp.nlml_value_and_grad(cov, *(a.double() for a in (p, x, y)))
            for who, kern in (("old", old), ("new", new)):
                saved = chol_inverse.cholesky_inverse_cuda
                chol_inverse.cholesky_inverse_cuda = kern
                try:
                    v, g = gp.nlml_value_and_grad(cov, p, x, y)
                finally:
                    chol_inverse.cholesky_inverse_cuda = saved
                row[f"{who}_nlml_rel_err_value"] = abs(v.item() - v64.item()) / abs(v64.item())
                row[f"{who}_nlml_rel_err_grad"] = (torch.linalg.norm(g.double() - g64) / torch.linalg.norm(g64)).item()
        del K
        torch.cuda.empty_cache()
        print(json.dumps({"compare_k2": row}), flush=True)
        rows.append(row)
    return rows


def old_k4(lib: ctypes.CDLL):
    """The earlier library's ``K(x, x) @ v`` for CUDA f32 ``theta, x, v``."""
    fn = lib.rbf_gram_matvec_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def call(theta, x, v):
        (n, d), k = x.shape, v.shape[1]
        out = torch.empty((n, k), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), theta.data_ptr(), v.data_ptr(), out.data_ptr(), n, d, k, stream)
        if err != 0:
            raise RuntimeError(f"old rbf_gram_matvec launch failed: CUDA error {err}")
        return out

    return call


def compare_k4(old, ns, device="cuda") -> list:
    from pygpr_torch.ops import matvec

    new = matvec.rbf_gram_matvec_cuda
    dev = torch.device(device)
    rng = np.random.default_rng(11)
    rows = []
    for n in ns:
        xs = np.random.default_rng(0).uniform(0, 4, (n, 2)).astype(np.float32)  # chip_smoke.py::iterative_data
        x = torch.tensor(xs, device=dev)
        th = torch.ones(3, device=dev)
        for k in K4_MAIN_PATH.get(n, (9,)):
            v = torch.tensor(rng.standard_normal((n, k)).astype(np.float32), device=dev)
            flops = 2.0 * n * n * (2 + k)
            reps = max(2, min(20, int(2e11 / flops)))
            turns = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                turns[who].append(events_ms(lambda: (old if who == "old" else new)(th, x, v), reps))
            out_old, out_new = old(th, x, v), new(th, x, v)
            p64 = matvec.rbf_gram_matvec_plain(th.double(), x.double(), v.double())
            tol = 1e-4 + 1e-3 * p64.abs().amax(dim=0)
            row = {"n": n, "k": k, "plan": matvec.plan(n, k, matvec._sms(dev)),
                   "old_ms": turns["old"], "new_ms": turns["new"],
                   "old_over_new": float(np.mean(turns["old"]) / np.mean(turns["new"])),
                   "old_tflops": flops / np.mean(turns["old"]) / 1e9,
                   "new_tflops": flops / np.mean(turns["new"]) / 1e9,
                   "gap_over_bound": ((out_new.double() - out_old.double()).abs() / tol).max().item(),
                   "old_err_over_bound_f64": ((out_old.double() - p64).abs() / tol).max().item(),
                   "new_err_over_bound_f64": ((out_new.double() - p64).abs() / tol).max().item(),
                   "old_max_abs_err": (out_old.double() - p64).abs().max().item(),
                   "new_max_abs_err": (out_new.double() - p64).abs().max().item()}
            del out_old, out_new, p64, v
            torch.cuda.empty_cache()
            print(json.dumps({"compare_k4": row}), flush=True)
            rows.append(row)
    return rows


def old_k3(lib: ctypes.CDLL):
    """The earlier library's factor of a CUDA f32 ``K``, ``[n, n]`` or
    ``[nb, n, n]``."""
    fn = lib.chol_batched_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    try:  # a version that sizes its own scratch
        size = lib.chol_batched_scratch_floats
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
    except AttributeError:  # [nb, 64, 64]
        size = lambda nb, n, n_pad: nb * 64 * 64

    def call(K):
        n = K.shape[-1]
        nb = K.shape[0] if K.ndim == 3 else 1
        n_pad = -(-n // 64) * 64
        opts = dict(dtype=torch.float32, device=K.device)
        L, D = torch.empty((nb, n_pad, n_pad), **opts), torch.empty((size(nb, n, n_pad),), **opts)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), D.data_ptr(), nb, n, n_pad, stream)
        if err != 0:
            raise RuntimeError(f"old chol_batched launch failed: CUDA error {err}")
        L = L[:, :n, :n].contiguous()
        return L if K.ndim == 3 else L[0]

    return call


def committee_grams(nb, n, device, seed=3):
    """``chip_smoke.py``'s K3 inputs: RBF + noise grams, d = 2 on [0, 4]²,
    σ = ℓ = 1, σₙ = 0.1; ``[n, n]`` for nb = 1."""
    from pygpr_torch.ops import gram

    x = np.random.default_rng(seed).uniform(0.0, 4.0, size=(nb, n, 2)).astype(np.float32)
    p = torch.tensor([1.0, 1.0, 1.0, 0.1], device=device)
    K = gram.rbf_noise_gram_plain(p, torch.tensor(x, device=device))
    return K[0] if nb == 1 else K


def k3_parts(fn) -> dict:
    """Device ms of one call of a K3 version by group of kernels, from
    torch.profiler, as ``chip_smoke.py`` groups them: ``panel_ms`` (the
    panel launches and the first diagonal block) and ``update_ms`` (the
    trailing updates and the load); and by kernel, launches and ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = {"panel_ms": 0.0, "update_ms": 0.0, "launches": {}}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = getattr(e, "cuda_time_total", 0.0) if us is None else us
        if "chol_batched_" not in e.key:
            continue
        parts["panel_ms" if "chol_batched_panel" in e.key or "chol_batched_diag128" in e.key else "update_ms"] += us / 1e3
        name = re.search(r"chol_batched_\w+", e.key).group(0)
        parts["launches"][name] = [e.count, us / 1e3]  # launches, device ms in all
    return parts


def compare_k3(old, shapes, device="cuda") -> list:
    from pygpr_torch.ops import chol_batched

    new = chol_batched.cholesky_batched_cuda
    rows = []
    for nb, n in shapes:
        K = committee_grams(nb, n, torch.device(device))
        reps = 3 if n >= 4096 else 10
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(queued_ms(lambda: (old if who == "old" else new)(K), reps))
        Lo, Ln = old(K), new(K)
        row = {"shape": list(K.shape), "batched_domain": chol_batched.batched_domain(nb, n),
               "old_ms": turns["old"], "new_ms": turns["new"],
               "old_over_new": float(np.mean(turns["old"]) / np.mean(turns["new"])),
               "max_abs_gap": (Ln - Lo).abs().max().item(), "bit_equal": bool(torch.equal(Ln, Lo)),
               "finite": bool(torch.isfinite(Ln).all())}
        for who, fn in (("old", old), ("new", new)):
            row.update({f"{who}_{k}": v for k, v in k3_parts(lambda: fn(K)).items()})
        del K, Lo, Ln
        torch.cuda.empty_cache()
        print(json.dumps({"compare_k3": row}), flush=True)
        rows.append(row)
    return rows


def old_k6(lib: ctypes.CDLL):
    """The earlier library's inverses of a CUDA f32 strip ``[P·128, 128]``."""
    fn = lib.tri_inverse_blocks_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

    def call(S):
        out = torch.empty_like(S)
        err = fn(S.data_ptr(), out.data_ptr(), S.shape[0] // 128, torch.cuda.current_stream(S.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"old tri_inverse_blocks launch failed: CUDA error {err}")
        return out

    return call


def compare_k6(old, panels, device="cuda") -> list:
    from pygpr_torch.bench import mfu_probe

    new = mfu_probe.tinv_strip
    dev = torch.device(device)
    eye = torch.eye(128, device=dev)
    rows = []
    for P in panels:
        n = 128 * P
        A = torch.tensor(np.random.default_rng(0).standard_normal((n, n)).astype(np.float32), device=dev)
        Kp = A @ A.T / n + 4.0 * torch.eye(n, device=dev)
        trils = torch.stack([torch.tril(Kp[i * 128:(i + 1) * 128, i * 128:(i + 1) * 128]) for i in range(P)]) + 2.0 * eye
        S = trils.reshape(-1, 128)
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(queued_ms(lambda: (old if who == "old" else new)(S), 50))
        To, Tn = (f(S).reshape(P, 128, 128) for f in (old, new))
        T64 = torch.linalg.solve_triangular(trils.double(), eye.double(), upper=False)
        top = T64.abs().max()
        row = {"panels": P, "old_ms": turns["old"], "new_ms": turns["new"],
               "old_over_new": float(np.mean(turns["old"]) / np.mean(turns["new"])),
               "gap_over_max": ((Tn - To).abs().max() / To.abs().max()).item(),
               "old_err_over_max_f64": ((To.double() - T64).abs().max() / top).item(),
               "new_err_over_max_f64": ((Tn.double() - T64).abs().max() / top).item(),
               "new_upper_zero": bool((torch.triu(Tn, 1) == 0).all()),
               "new_repeats_bit_equal": bool(torch.equal(new(S), Tn.reshape(-1, 128)))}
        del A, Kp, trils, S, To, Tn, T64
        print(json.dumps({"compare_k6": row}), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="k2")
    ap.add_argument("--old", required=True, type=Path, help="directory holding the earlier source")
    ap.add_argument("n", nargs="*", type=int)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"compare: no CUDA device ({args.kernel})", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    src = args.old.resolve() / f"{SOURCES[args.kernel]}.cu"
    name, want = OLD_ENTRIES[args.kernel]
    got = entry_types(src.read_text(), name) if src.exists() else ()
    if got != want:
        print(f"compare: {src} does not declare the entry this mode calls, {name}({', '.join(want)}), "
              f"but ({', '.join(got) or 'none'})", file=sys.stderr)
        return 1
    lib = build_old(args.old.resolve(), SOURCES[args.kernel])
    if args.kernel == "k1":
        rows = compare_k1(old_k1(lib), list(zip(*(args.n[i::5] for i in range(5)))) if args.n else list(K1_SHAPES))
        if not all(r["bit_equal"] for r in rows):
            print("compare: K1's grams differ from the earlier version's", file=sys.stderr)
            return 1
    elif args.kernel == "k2":
        compare_k2(old_k2(lib), args.n or list(K2_MAIN_PATH_N))
    elif args.kernel == "k3":
        shapes = list(zip(args.n[::2], args.n[1::2])) if args.n else list(K3_SHAPES)
        rows = compare_k3(old_k3(lib), shapes)
        if not all(r["bit_equal"] for r in rows):
            print("compare: K3's factors differ from the earlier version's", file=sys.stderr)
            return 1
    elif args.kernel == "k4":
        compare_k4(old_k4(lib), args.n or list(K4_MAIN_PATH))
    else:
        compare_k6(old_k6(lib), args.n or list(K6_PANELS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
