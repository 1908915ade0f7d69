"""The JAX package's own f32-against-f64 gaps on the CPU, for the script
modes of the port's test files.

A test file run as ``python tests/test_torch_<model>.py`` calls
:func:`gaps`, which runs the file again as ``… run f64 [args]`` and ``… run
f32 [args]`` in two processes (x64 on for f64 and off for f32, as the JAX
package's users run each) and compares the JSON objects they print, name
by name: the relative gap of each number or, for a list, in norm.
"""

import json
import subprocess
import sys

import numpy as np


def setup_jax(dtype: str):
    """JAX on the CPU with x64 on for ``"f64"`` and off for ``"f32"``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "f64")
    return np.float64 if dtype == "f64" else np.float32


def gaps(script: str, *args: str) -> dict:
    runs = {}
    for dtype in ("f64", "f32"):
        out = subprocess.run([sys.executable, script, "run", dtype, *args], capture_output=True, text=True,
                             check=True)
        runs[dtype] = json.loads(out.stdout.strip().splitlines()[-1])
    a, b = runs["f32"], runs["f64"]
    rel = {}
    for k in b:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        rel[k] = float(np.linalg.norm(x - y) / np.linalg.norm(y))
    return {"rel": rel, "f64": b, "f32": a}


def main(script: str, run):
    """Script mode: ``run(dtype, *args) -> dict`` in a child, else the gaps."""
    if len(sys.argv) > 1 and sys.argv[1] == "run":
        print(json.dumps(run(sys.argv[2], *sys.argv[3:])), flush=True)
    else:
        print(json.dumps(gaps(script, *sys.argv[1:])), flush=True)
