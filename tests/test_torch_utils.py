"""Port parity: the utilities and the resumable fit against the JAX package.

Checkpoints written by either package load in the other (the npz layout
``leaf_i``, ``__treedef__``, ``__meta__``); ``BinaryDataset`` files written
by either open in the other, and ``minibatches(seed=…)`` yields the same
bits (the JAX package's native gather against the port's NumPy one);
``svgp.fit_streamed`` runs from a ``BinaryDataset`` as from the same
batches in memory; ``fit_mle_resumable`` resumes from a checkpoint the JAX
package wrote and ends where the JAX package's own resume ends; the state
diagnostics agree on a committee state carried across; ``checkify_nlml``
raises on a NaN parameter; and ``trace`` writes a Chrome trace that names
the ``annotate`` range.
"""

import json
import os
import shutil
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert
from pygpr_torch.models import svgp as vt
from pygpr_torch.optimize.resumable import fit_mle_resumable as resume_t
from pygpr_torch.utils import checkpoint as ct
from pygpr_torch.utils import diagnostics as gd
from pygpr_torch.utils.dataset import BinaryDataset as DatasetT
from pygpr_torch.utils.profiling import annotate, trace
from pygpr_tpu.optimize.resumable import fit_mle_resumable as resume_j
from pygpr_tpu.utils import checkpoint as cj
from pygpr_tpu.utils import diagnostics as jd
from pygpr_tpu.utils.dataset import BinaryDataset as DatasetJ

FIT_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair(NamedTuple):
    a: object
    b: object


def _tree(rng):
    return {"w": rng.normal(size=(3, 2)), "steps": np.int64(7),
            "opt": (rng.normal(size=4), [rng.normal(size=2), None]), "pair": Pair(rng.normal(size=()), np.arange(3))}


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    tree = _tree(np.random.default_rng(0))
    like = jax.tree.map(jnp.asarray, tree)
    tensors = {"w": torch.tensor(tree["w"]), "steps": tree["steps"],
               "opt": (torch.tensor(tree["opt"][0]), [torch.tensor(tree["opt"][1][0]), None]),
               "pair": Pair(torch.tensor(tree["pair"].a), torch.tensor(tree["pair"].b))}
    path = str(tmp_path / "ck.npz")
    ct.save_checkpoint(path, tensors, meta={"iters": 20})
    got, meta = cj.load_checkpoint(path, like)
    assert meta == {"iters": 20}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert np.array_equal(np.asarray(a), b)
    with np.load(path) as z:
        assert bytes(z["__treedef__"]).decode() == str(jax.tree.structure(like))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = str(tmp_path / "ck.npz")
    cj.save_checkpoint(path, jax.tree.map(jnp.asarray, tree), meta={"iters": 3, "tag": "x"})
    like = {"w": torch.zeros(3, 2, dtype=torch.float64), "steps": 0,
            "opt": (torch.zeros(4, dtype=torch.float32), [torch.zeros(2, dtype=torch.float64), None]),
            "pair": Pair(torch.zeros((), dtype=torch.float64), np.zeros(3))}
    got, meta = ct.load_checkpoint(path, like)
    assert meta == {"iters": 3, "tag": "x"}
    assert isinstance(got["w"], torch.Tensor) and torch.equal(got["w"], torch.tensor(tree["w"]))
    assert got["opt"][0].dtype == torch.float32 and got["opt"][1][1] is None
    assert isinstance(got["pair"], Pair) and np.array_equal(got["pair"].b, tree["pair"].b)
    assert int(got["steps"]) == 7


def _xy(n=1000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 4, (n, d)).astype(np.float32)
    return x, (np.sin(x.sum(-1)) + 0.1 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_binary_dataset_files_and_batches_cross_packages(tmp_path, writer):
    x, y = _xy()
    path = str(tmp_path / "d.bin")
    (DatasetT if writer == "port" else DatasetJ).write(path, x, y)
    dt, dj = DatasetT(path, 3), DatasetJ(path, 3)
    assert dt.n == dj.n == 1000 and np.array_equal(dt.x, x) and np.array_equal(dt.y, y)
    for (a, b), (c, d) in zip(dt.iter_chunks(300), dj.iter_chunks(300)):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    bt = list(dt.minibatches(128, seed=5, epochs=2))
    bj = list(dj.minibatches(128, seed=5, epochs=2))
    assert len(bt) == len(bj) == 14
    for (a, b), (c, d) in zip(bt, bj):
        assert a.dtype == np.float32 and np.array_equal(a, c) and np.array_equal(b, d)
    with pytest.raises(ValueError):
        DatasetT(path, 6)                      # 16000 bytes are no whole number of 28-byte rows


def test_fit_streamed_from_a_binary_dataset(tmp_path):
    """The same fit as from the same batches in memory, to the bit."""
    x, y = _xy(512, 2)

    class InMemory:
        n = 512

        def __init__(self):
            self.x = x

        def minibatches(self, batch_size, *, seed=0, epochs=1):
            rng = np.random.default_rng(seed)
            for _ in range(epochs):
                perm = rng.permutation(self.n)
                for s in range(0, self.n - self.n % batch_size, batch_size):
                    yield x[perm[s: s + batch_size]], y[perm[s: s + batch_size]]

    ds = DatasetT.write(str(tmp_path / "s.bin"), x, y)
    z = x[:16].astype(np.float64)
    kw = dict(batch_size=64, epochs=2, seed=3, device="cpu")
    a = vt.fit_streamed(gt.RBF(), gt.GaussianLik(), ds, z, **kw)
    b = vt.fit_streamed(gt.RBF(), gt.GaussianLik(), InMemory(), z, **kw)
    assert a.losses.shape == (16,) and torch.equal(a.losses, b.losses)
    assert a.losses[-4:].mean() < a.losses[:4].mean()


def test_fit_mle_resumable_resumes_from_a_jax_checkpoint(tmp_path, monkeypatch):
    import pygpr_tpu.optimize.resumable as rj

    # each segment of the JAX package's resumable fit as one compiled program
    plain, compiled = rj.fit_mle, {}

    def fit_mle(kern, params, x, y, **kw):
        key = tuple(sorted(kw.items()))
        if key not in compiled:
            compiled[key] = jax.jit(lambda p, xx, yy: plain(kern, p, xx, yy, **kw))
        return compiled[key](params, x, y)

    monkeypatch.setattr(rj, "fit_mle", fit_mle)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 2, (48, 2))
    y = np.sin(2 * x.sum(-1)) + 0.1 * rng.normal(size=48)
    p0 = np.array([1.0, 1.0, 1.0, 0.3])
    cj_, ct_ = gj.Sum((gj.RBF(), gj.WhiteNoise())), gt.Sum((gt.RBF(), gt.WhiteNoise()))
    path_j, path_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    first = resume_j(cj_, jnp.asarray(p0), jnp.asarray(x), jnp.asarray(y), path_j, max_iter=5, segment_iters=5)
    assert int(first.iters) == 5
    shutil.copy(path_j, path_t)
    want = resume_j(cj_, jnp.asarray(p0), jnp.asarray(x), jnp.asarray(y), path_j, max_iter=10, segment_iters=5)
    got = resume_t(ct_, p0, x, y, path_t, max_iter=10, segment_iters=5, device="cpu")
    assert int(got.iters) == int(want.iters) == 10
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), atol=FIT_TOL)
    np.testing.assert_allclose(got.value.item(), float(want.value), atol=FIT_TOL)
    with np.load(path_t) as z:
        assert json.loads(bytes(z["__meta__"]).decode()) == {"iters": 10}
        np.testing.assert_allclose(z["leaf_0"], np.asarray(want.params), atol=FIT_TOL)


def test_state_diagnostics_match_jax():
    """A committee of four: one healthy, one on a higher rung of the ladder,
    one failed, one with a non-finite weight."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 2, (4, 20, 1))
    y = np.sin(2 * x[..., 0])
    p = np.array([[1.0, 1.0, 0.1]] * 4)
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))
    st = jax.jit(lambda p, x, y: gj.factorize(cov, p, x, y))(*map(jnp.asarray, (p, x, y)))
    w = np.array(st.weights)
    w[3, 5] = np.nan
    st_j = st._replace(weights=jnp.asarray(w), jitter=jnp.asarray([1e-7, 1e-5, 1e-1, 1e-7]),
                       ok=jnp.asarray([1.0, 1.0, 0.0, 1.0]))
    st_t = convert.state_from_numpy({k: None if v is None else np.asarray(v) for k, v in st_j._asdict().items()},
                                    "cpu")
    hj, ht = jd.check_state(st_j), gd.check_state(st_t)
    for f in ht._fields:
        assert np.array_equal(getattr(ht, f).numpy(), np.asarray(getattr(hj, f))), f
    assert np.array_equal(gd.expert_mask(st_t).numpy(), np.asarray(jd.expert_mask(st_j)))
    assert gd.expert_mask(st_t).tolist() == [True, True, False, False]
    assert gd.summarize(st_t) == jd.summarize(st_j) == {"n_experts": 4, "n_failed": 1, "n_jitter_escalated": 2,
                                                        "max_jitter": 0.1}


def test_checkify_nlml_raises_on_a_nan_parameter():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(0, 2, (16, 1)))
    y = torch.sin(2 * x[:, 0])
    f = gd.checkify_nlml(gt.Sum((gt.RBF(), gt.WhiteNoise())), x, y)
    ok = f(torch.tensor([1.0, 1.0, 0.1], dtype=torch.float64))
    assert torch.isfinite(ok)
    with pytest.raises(ValueError, match="NLML is non-finite"):
        f(torch.tensor([float("nan"), 1.0, 0.1], dtype=torch.float64))


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    x = torch.rand(64, 2, dtype=torch.float64)
    cov = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    evaluate = annotate("nlml")(lambda: gt.nlml(cov, torch.tensor([1.0, 1.0, 1.0, 0.1], dtype=torch.float64),
                                                x, x[:, 0]))
    assert evaluate.__name__ == "<lambda>"
    with trace(str(tmp_path / "tr")):
        v = evaluate()
    assert torch.isfinite(v)
    with open(tmp_path / "tr" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "nlml" in names
