"""``python -m pygpr_torch.bench [flag]`` — the port's benchmark lines, on
the CUDA device.

  (no flag)     NLML evaluations/s at n = 2048 and grBCM predictions/s at
                16 × 512, one JSON line each
  --large-n     BASELINE config 4: grBCM at N = 98304, 16 experts: fit,
                factorize, predictions/s, RMSE and NLPD, one JSON line
  --iterative   the matrix-free exact GP at n = 32768: Krylov NLML value +
                gradient with no n×n array, and the CG posterior mean
  --sgpr        SGPR at N = 98304, m = 1024 inducing points, comparable to
                the --large-n line (same function, N and queries)
  --grbcm-1m    BASELINE config 5, one-card half: grBCM serving throughput
                at N = 10⁶ (2000 experts, T = L⁻¹ resident)
  --statespace  the exact 1-D Matérn-3/2 GP at n = 10⁶ through the
                state-space parallel scans: adjoint value + gradient, the
                value alone, autograd at n/8 and the smoothed posterior

``--million`` (the committee sharded over a device mesh) is not ported
yet and exits with status 2.
"""

import json
import sys

#: flags of the JAX bench whose paths the port does not have yet
_WAITING = {
    "--million": "grbcm over a device mesh needs the port's parallel/ layer (ROADMAP item 16)",
}


def _main() -> int:
    args = sys.argv[1:]
    for flag, why in _WAITING.items():
        if flag in args:
            print(f"pygpr_torch.bench {flag}: not ported yet: {why}", file=sys.stderr)
            return 2
    import pygpr_torch.bench as bench

    entries = {
        "--large-n": bench.bench_large_n,
        "--sgpr": bench.bench_sgpr_large_n,
        "--iterative": bench.bench_iterative_large_n,
        "--grbcm-1m": bench.bench_grbcm_million_serving,
        "--statespace": bench.bench_statespace_large,
    }
    for flag, fn in entries.items():
        if flag in args:
            print(json.dumps(fn()), flush=True)
            return 0
    bench.main()
    return 0


sys.exit(_main())
