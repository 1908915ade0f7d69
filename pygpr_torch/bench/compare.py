"""A kernel against an earlier version of its source, on one card in one
process.

    python -m pygpr_torch.bench.compare --kernel {k2,k4} --old DIR [n ...]

``DIR`` holds the earlier source, unpacked from git into a directory that
``.gitignore`` lists::

    mkdir -p _archive/k2_old && git show <commit>:pygpr_torch/csrc/chol_inverse.cu > _archive/k2_old/chol_inverse.cu
    mkdir -p _archive/k4_old && git show <commit>:pygpr_torch/csrc/rbf_gram_matvec.cu > _archive/k4_old/rbf_gram_matvec.cu

It is built there with the package's ``nvcc`` flags.  Each mode calls
one earlier C entry, named below, through ``ctypes``; a source that does
not declare exactly that entry (``OLD_ENTRIES``) is refused before it is
built.  Both kernels are timed in turns (old, new, new, old; CUDA events
over a few calls each).  The card's name and power limit come first.

``--kernel k2``: K2 (``csrc/chol_inverse.cu``) against the left-looking
split-k version (C entry ``chol_inverse_f32(K, L, T, W, X, P, partial_cap,
n, stream)``, 64-wide panels).  For each n (default: every n the main path
gives K2) one JSON line: both kernels' device ms, the larger gap between
their factors (relative to max|L| and max|T|), each one's relative L error
and max|TL − I| against f64 at n ≤ 8192, and at n = 2048, 4096 and 8192
the f32 NLML gradient's relative error against f64 with each kernel in the
fast path (the flagship's data, ``bench.py::make_data``, as
``chip_smoke.py`` draws it).

``--kernel k4``: K4 (``csrc/rbf_gram_matvec.cu``) against the version with
C entry ``rbf_gram_matvec_f32(x, theta, v, out, n, d, k, stream)``.  For
each n (default 32768 and 131072) and each width k the main path launches
there (1, 5, 8, 9, 40 and 256 at 32768; all but 256 at 131072) one JSON line: both
kernels' device ms and TFLOP/s (2n²(d + k)), the largest gap between their
outputs and each one's largest error against the f64 plain version, as a
share of ``chip_smoke.py``'s bound (1e-4 + 1e-3 of the column's largest
entry), on the main path's data (``chip_smoke.py::iterative_data``).
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
#: the widths the main path of ``chip_smoke.py`` launches K4 at, by n
K4_MAIN_PATH = {32768: (1, 5, 8, 9, 40, 256), 131072: (1, 5, 8, 9, 40)}
#: the C source each kernel is built from
SOURCES = {"k2": "chol_inverse", "k4": "rbf_gram_matvec"}
#: the one earlier C entry each mode calls, by its parameters' types: an
#: old source that does not declare exactly this entry is refused
OLD_ENTRIES = {
    "k2": ("chol_inverse_f32",
           ("const void*", "void*", "void*", "void*", "void*", "void*", "long long", "int", "void*")),
    "k4": ("rbf_gram_matvec_f32", ("const void*", "const void*", "const void*", "void*", "int", "int", "int", "void*")),
}
#: most k-splits of the split-k version's left-looking products (its
#: wrapper's MAX_SPLITS; sizes its scratch)
SPLITK_MAX_SPLITS = 16


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
    """The split-k library's ``(L, T)`` of a CUDA f32 ``K``."""
    fn = lib.chol_inverse_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

    def call(K):
        n = K.shape[0]
        opts = dict(dtype=torch.float32, device=K.device)
        L, T = torch.empty((n, n), **opts), torch.empty((n, n), **opts)
        W, X = torch.empty((n, 64), **opts), torch.empty((64, n), **opts)
        P = torch.empty((SPLITK_MAX_SPLITS * n * 64,), **opts)
        stream = torch.cuda.current_stream(K.device).cuda_stream
        err = fn(K.data_ptr(), L.data_ptr(), T.data_ptr(), W.data_ptr(), X.data_ptr(), P.data_ptr(), P.numel(), n,
                 stream)
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
    if args.kernel == "k2":
        compare_k2(old_k2(lib), args.n or list(K2_MAIN_PATH_N))
    else:
        compare_k4(old_k4(lib), args.n or list(K4_MAIN_PATH))
    return 0


if __name__ == "__main__":
    sys.exit(main())
