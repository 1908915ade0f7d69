"""K2 (``csrc/chol_inverse.cu``) against an earlier version of its source,
on one card in one process.

    python -m pygpr_torch.bench.compare_k2 --old DIR [n ...]

``DIR`` holds the earlier, left-looking split-k ``chol_inverse.cu`` (C
entry ``chol_inverse_f32(K, L, T, W, X, P, partial_cap, n, stream)``, 64-wide
panels), unpacked from git into a directory that ``.gitignore`` lists::

    mkdir -p _archive/k2_pr5 && git show <commit>:pygpr_torch/csrc/chol_inverse.cu > _archive/k2_pr5/chol_inverse.cu

It is built there with the package's ``nvcc`` flags.  For each n (default: every n the main path gives K2) it prints one JSON
line: both kernels' device ms, timed in turns (old, new, new, old; CUDA
events over a few calls each), the larger gap between their factors
(relative to max|L| and max|T|), each one's relative L error and
max|TL − I| against f64 at n ≤ 8192, and at n = 2048, 4096 and 8192 the
f32 NLML gradient's relative error against f64 with each kernel in the
fast path (the flagship's data, ``bench.py::make_data``, as
``chip_smoke.py`` draws it).  The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

#: every n the main path of ``chip_smoke.py`` gives K2
MAIN_PATH_N = (256, 2048, 4096, 6400, 8192, 16384)
#: most k-splits of the split-k version's left-looking products (its
#: wrapper's MAX_SPLITS; sizes its scratch)
SPLITK_MAX_SPLITS = 16


def build_old(src_dir: Path) -> ctypes.CDLL:
    """Compile ``src_dir/chol_inverse.cu`` with the package's flags into
    ``src_dir`` and load it."""
    from pygpr_torch.ops import _build

    out = src_dir / "libchol_inverse_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(out), str(src_dir / "chol_inverse.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the old source:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def old_kernel(lib: ctypes.CDLL):
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


def compare(old, ns, device="cuda") -> list:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path, help="directory holding the earlier chol_inverse.cu")
    ap.add_argument("n", nargs="*", type=int, default=list(MAIN_PATH_N))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_k2: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    compare(old_kernel(build_old(args.old.resolve())), args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
