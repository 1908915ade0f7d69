"""Port parity: every kernel family of the JAX package against its port on
the CPU in f64.

The same NumPy inputs, made from a seed, go through both packages:
``matrix`` (train and cross), ``diag``, ``matrix_and_grad`` and
``gram_adjoint`` of every class (the 18 composites of the JAX package's
own ``gram_adjoint`` test, ``ArcCosine`` of order 0, 1 and 2, the four
``Separable`` profiles, ``ActiveDims``, ``ChangePoint``, ``ICM`` with
``TaskNoise`` and ``FixedNoise``), the data-driven inits, the fast NLML
of five composites at n = 256, and the small names of the slice
(``priors.Uniform``, ``euclidean_dist``, ``default_dtype``,
``convert.kernel_spec``).  The JAX side of each family runs once, under
one ``jax.jit``, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch import convert

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's spinning one oversubscribes
    the cores and slows torch tenfold or more: one thread in this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: name -> (JAX kernel, input columns: "plain", "task" or "noise")
FAMILIES = {
    "rbf": (gj.RBF(), "plain"),
    "matern12": (gj.Matern(0.5), "plain"),
    "matern32": (gj.Matern(1.5), "plain"),
    "matern52": (gj.Matern(2.5), "plain"),
    "white_noise": (gj.WhiteNoise(), "plain"),
    "sum_rbf_noise": (gj.Sum((gj.RBF(), gj.WhiteNoise())), "plain"),
    "sum_matern32_noise": (gj.Sum((gj.Matern(1.5), gj.WhiteNoise())), "plain"),
    "rq": (gj.RationalQuadratic(), "plain"),
    "sum_rq_noise": (gj.Sum((gj.RationalQuadratic(), gj.WhiteNoise())), "plain"),
    "prod_rbf_matern32": (gj.Product((gj.RBF(), gj.Matern(1.5))), "plain"),
    "sum_prod_rbf_rbf_noise": (gj.Sum((gj.Product((gj.RBF(), gj.RBF())), gj.WhiteNoise())), "plain"),
    "periodic": (gj.Periodic(), "plain"),
    "prod_rbf_periodic": (gj.Product((gj.RBF(), gj.Periodic())), "plain"),
    "linear": (gj.Linear(), "plain"),
    "sum_rbf_constant_noise": (gj.Sum((gj.RBF(), gj.Constant(), gj.WhiteNoise())), "plain"),
    "prod_linear_periodic": (gj.Product((gj.Linear(), gj.Periodic())), "plain"),
    "sm2": (gj.SpectralMixture(2), "plain"),
    "sum_sm3_noise": (gj.Sum((gj.SpectralMixture(3), gj.WhiteNoise())), "plain"),
    "arccos0": (gj.ArcCosine(0), "plain"),
    "arccos1": (gj.ArcCosine(1), "plain"),
    "arccos2": (gj.ArcCosine(2), "plain"),
    "separable_rbf": (gj.Separable("rbf"), "plain"),
    "separable_exp": (gj.Separable("exp"), "plain"),
    "separable_matern32": (gj.Separable("matern32"), "plain"),
    "separable_matern52": (gj.Separable("matern52"), "plain"),
    "active_dims": (gj.Sum((gj.ActiveDims(gj.Matern(2.5), (0, 2)), gj.ActiveDims(gj.RBF(), (1,)))), "plain"),
    "changepoint": (gj.ChangePoint(gj.RBF(), gj.Matern(1.5), axis=1), "plain"),
    "icm_task_noise": (gj.Sum((gj.ICM(gj.RBF(), 3, 2), gj.TaskNoise(3))), "task"),
    "fixed_noise": (gj.FixedNoise(gj.Matern(2.5)), "noise"),
}
N, NP, D = 40, 17, 3


def _inputs(kind, rng, n):
    """``[n, 3]`` in [0, 2)³ with a coincident pair (rows 3 and 7), plus
    the task index (0, 1, 2) or a noise variance in [0.01, 0.1) as a
    fourth column where the family reads one."""
    x = rng.uniform(0.0, 2.0, (n, D))
    if n > 7:
        x[7] = x[3]
    if kind == "task":
        return np.concatenate([x, (np.arange(n) % 3)[:, None].astype(float)], axis=1)
    if kind == "noise":
        return np.concatenate([x, rng.uniform(0.01, 0.1, (n, 1))], axis=1)
    return x


#: composites whose fast NLML at n = 256 is held against the JAX
#: package's: the chip's families, each with its noise term
NLML_CASES = {
    "sum_matern32_noise": (gj.Sum((gj.Matern(1.5), gj.WhiteNoise())), "plain"),
    "sum_prod_rbf_periodic_noise": (gj.Sum((gj.Product((gj.RBF(), gj.Periodic())), gj.WhiteNoise())), "plain"),
    "sum_sm3_noise": (gj.Sum((gj.SpectralMixture(3), gj.WhiteNoise())), "plain"),
    "sum_changepoint_noise": (gj.Sum((gj.ChangePoint(gj.RBF(), gj.Matern(1.5), axis=1), gj.WhiteNoise())), "plain"),
    "icm_task_noise": (gj.Sum((gj.ICM(gj.RBF(), 3, 2), gj.TaskNoise(3))), "task"),
}
NLML_N = 256


def _family_inputs(i, kj, kind):
    rng = np.random.default_rng(100 + i)
    x, xp = _inputs(kind, rng, N), _inputs(kind, rng, NP)
    p = np.abs(rng.uniform(0.5, 1.5, kj.n_params(x.shape[-1])))
    a = rng.standard_normal((N, N))
    xb = rng.uniform(0.0, 2.0, (2, 10, x.shape[-1]))
    return dict(p=p, x=x, xp=xp, abar=0.5 * (a + a.T), x_batch=xb)


def _nlml_inputs(i, kj, kind):
    rng = np.random.default_rng(200 + i)
    x = _inputs(kind, rng, NLML_N)
    y = np.sin(2.0 * x[:, :D].sum(-1)) + 0.1 * rng.normal(size=NLML_N)
    p = np.abs(rng.uniform(0.5, 1.5, kj.n_params(x.shape[-1])))
    return dict(p=p, x=x, y=y)


def _misc_inputs():
    rng = np.random.default_rng(3)
    return dict(x_batch=rng.uniform(0, 2, (2, 12, 3)), xp=rng.uniform(0, 2, (5, 3)),
                p_batch=np.stack([np.full(8, 0.9), np.full(8, 1.2)]),
                a=rng.uniform(size=(20, 2)), b=rng.uniform(size=(5, 2)), theta=np.array([0.1, 0.5, 1.0, 2.0, 2.5]))


#: the product whose batched cross block is compared (8 parameters at d = 3)
BATCHED = gj.Matern(1.5) * gj.RBF()


@pytest.fixture(scope="module")
def jax_side():
    """The inputs and the JAX package's results for every test of this
    file, from one jitted program: per family its matrices, diagonals,
    ``matrix_and_grad``, ``gram_adjoint`` (where it has one) and
    ``init_params`` of a batched input; the fast NLML of each of
    :data:`NLML_CASES`; a batched cross block, ``euclidean_dist`` and
    ``priors.Uniform``."""
    from pygpr_tpu.models import priors as pj

    inputs = {
        "families": {n: _family_inputs(i, kj, kind) for i, (n, (kj, kind)) in enumerate(FAMILIES.items())},
        "nlml": {n: _nlml_inputs(i, kj, kind) for i, (n, (kj, kind)) in enumerate(NLML_CASES.items())},
        "misc": _misc_inputs(),
    }

    def family(kj, p, x, xp, abar, x_batch):
        res = {"cross": kj.matrix(p, x, xp), "diag": kj.diag(p, x), "diag_cross": kj.diag(p, xp),
               "and_grad": kj.matrix_and_grad(p, x), "init": kj.init_params(x_batch)}
        ga = kj.gram_adjoint(p, x, abar)
        if ga is not None:
            res["gram_adjoint"] = ga
        return res

    def run(inp):
        m = inp["misc"]
        return {
            "families": {n: family(FAMILIES[n][0], **inp["families"][n]) for n in FAMILIES},
            "nlml": {n: gj.nlml_value_and_grad(NLML_CASES[n][0], c["p"], c["x"], c["y"])
                     for n, c in inp["nlml"].items()},
            "batched_cross": gj.kernel_matrix(BATCHED, m["p_batch"], m["x_batch"], m["xp"]),
            "euclidean_dist": gj.euclidean_dist(m["a"], m["b"]),
            "uniform": pj.Uniform(0.5, 2.0).log_prob(m["theta"]),
        }

    want = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, inputs))
    return inputs, jax.tree_util.tree_map(np.asarray, want)


@pytest.fixture(scope="module")
def parity(jax_side):
    inputs, want = jax_side
    return {n: dict(inputs["families"][n], want=want["families"][n],
                    kt=convert.kernel_from_spec(convert.kernel_spec(FAMILIES[n][0]))) for n in FAMILIES}


def _tol(name):
    """The JAX package's own tolerance for Matérn-½ (its
    ``test_gram_adjoint_matches_vjp``) where it is a part: its
    K = σ² exp(−√sqd) turns a round-off of ≈ 1e-16 in sqd into ≈ 1e-8 in
    K, at the coincident pair (the two packages' products sum in another
    order) and on the diagonal (the JAX package's f64 product leaves such
    a residue there; the port's Matérn sets it to 0)."""
    return (1e-6, 1e-6) if "matern12" in name else (RTOL, ATOL)


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_matrix_and_diag_match_jax(parity, name):
    c = parity[name]
    kt, p, x, xp, want = c["kt"], _t(c["p"]), _t(c["x"]), _t(c["xp"]), c["want"]
    rtol, atol = _tol(name)
    assert kt.n_params(x.shape[-1]) == len(c["p"])
    np.testing.assert_allclose(kt.matrix(p, x).numpy(), want["and_grad"][0], rtol=rtol, atol=atol)
    np.testing.assert_allclose(kt.matrix(p, x, xp).numpy(), want["cross"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(kt.diag(p, x).numpy(), want["diag"], rtol=rtol, atol=atol)
    # the query's own columns (a task index, a noise variance) at xp
    np.testing.assert_allclose(kt.diag(p, xp).numpy(), want["diag_cross"], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(kt.init_params(_t(c["x_batch"])).numpy(), want["init"])


@pytest.mark.parametrize("name", list(FAMILIES))
def test_matrix_and_grad_matches_jax(parity, name):
    c = parity[name]
    K, dK = c["kt"].matrix_and_grad(_t(c["p"]), _t(c["x"]))
    Kj, dKj = c["want"]["and_grad"]
    rtol, atol = _tol(name)
    assert dK.shape == (len(c["p"]), N, N)
    np.testing.assert_allclose(K.numpy(), Kj, rtol=rtol, atol=atol)
    np.testing.assert_allclose(dK.numpy(), dKj, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gram_adjoint_matches_jax(parity, name):
    """Where the JAX class has a gram adjoint the port's equals it, and
    equals autograd through the port's gram at the JAX test's tolerance
    (1e-6 where Matérn-½ is a part, whose autodiff reference carries its
    own noise at the coincident pair; 1e-9 otherwise); where it has none
    the port's is None too."""
    c = parity[name]
    kt, p, x, abar = c["kt"], _t(c["p"]), _t(c["x"]), _t(c["abar"])
    ga = kt.gram_adjoint(p, x, abar)
    assert (ga is not None) == ("gram_adjoint" in c["want"])
    if ga is None:
        return
    rtol, atol = _tol(name)
    np.testing.assert_allclose(ga.numpy(), c["want"]["gram_adjoint"], rtol=rtol, atol=atol)
    q = p.clone().requires_grad_(True)
    (vjp,) = torch.autograd.grad(gt.train_gram(kt, q, x), q, abar)
    tol = 1e-6 if "matern12" in name else 1e-9
    np.testing.assert_allclose(ga.numpy(), vjp.numpy(), rtol=tol, atol=tol)


def test_gram_adjoint_none_cases():
    """A class without an adjoint, and a Sum or Product with such a
    child, returns None (the JAX package's ``tests/test_kernels.py``)."""
    x = torch.tensor(np.random.default_rng(0).uniform(0, 1, (8, 2)))
    abar = torch.eye(8, dtype=torch.float64)
    cp = gt.ChangePoint(gt.RBF(), gt.RBF())
    for k in (cp, gt.Sum((gt.RBF(), cp)), gt.Product((gt.RBF(), cp))):
        assert k.gram_adjoint(k.init_params(x), x, abar) is None


def test_operators_and_batched_cross(jax_side):
    """``*`` flattens into a Product as ``+`` does into a Sum; a batched
    ``x`` and parameters with an unbatched cross block ``xp`` (the JAX
    package's ``n_array_rest``)."""
    assert gt.RBF() * gt.Periodic() * gt.Linear() == gt.Product((gt.RBF(), gt.Periodic(), gt.Linear()))
    assert gt.RBF() + gt.Matern(2.5) == gt.Sum((gt.RBF(), gt.Matern(2.5)))
    inputs, want = jax_side
    m = inputs["misc"]
    kt = convert.kernel_from_spec(convert.kernel_spec(BATCHED))
    got = gt.kernel_matrix(kt, _t(m["p_batch"]), _t(m["x_batch"]), _t(m["xp"]))
    assert got.shape == (2, 5, 12)
    np.testing.assert_allclose(got.numpy(), want["batched_cross"], rtol=RTOL, atol=ATOL)


def test_init_from_data_bit_equal():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 3, (50, 2))
    for q, restarts in ((3, 1), (2, 4)):
        want = gj.SpectralMixture(q).init_from_data(x, seed=7, n_restarts=restarts)
        got = gt.SpectralMixture(q).init_from_data(x, seed=7, n_restarts=restarts)
        np.testing.assert_array_equal(got, want)
    cpj, cpt = gj.ChangePoint(gj.RBF(), gj.Matern(2.5), axis=1), gt.ChangePoint(gt.RBF(), gt.Matern(2.5), axis=1)
    for restarts in (1, 3):
        want = np.asarray(cpj.init_from_data(x, restarts))
        np.testing.assert_array_equal(cpt.init_from_data(x, restarts), want)
        got = cpt.init_from_data(_t(x), restarts)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), want)
    # a gate axis below zero: the location is clamped, with the warning
    xn = x - 2.5
    with pytest.warns(UserWarning, match="clamped"):
        want = np.asarray(cpj.init_from_data(xn, 3))
    with pytest.warns(UserWarning, match="clamped"):
        got = cpt.init_from_data(xn, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(NLML_CASES))
def test_fast_nlml_matches_jax(jax_side, name):
    inputs, want = jax_side
    c = inputs["nlml"][name]
    vj, gj_ = want["nlml"][name]
    kt = convert.kernel_from_spec(convert.kernel_spec(NLML_CASES[name][0]))
    v, g = gt.nlml_value_and_grad(kt, _t(c["p"]), _t(c["x"]), _t(c["y"]))
    np.testing.assert_allclose(v.item(), vj, rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), gj_, rtol=1e-8, atol=1e-8 * np.abs(gj_).max())


def test_uniform_prior_matches_jax(jax_side):
    inputs, want = jax_side
    got = gt.priors.Uniform(0.5, 2.0).log_prob(_t(inputs["misc"]["theta"]))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want["uniform"], rtol=1e-15)
    with pytest.raises(ValueError):
        gt.priors.Uniform(2.0, 1.0)


def test_euclidean_dist_matches_jax(jax_side):
    inputs, want = jax_side
    a, b = inputs["misc"]["a"], inputs["misc"]["b"]
    got = gt.euclidean_dist(a, b)
    assert isinstance(got, np.ndarray) and got.shape == (20, 5)
    np.testing.assert_allclose(got, want["euclidean_dist"], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(gt.euclidean_dist(_t(a), b).numpy(), want["euclidean_dist"], rtol=1e-12, atol=1e-14)


def test_default_dtype():
    assert gt.default_dtype("cpu") is torch.float64
    assert gt.default_dtype(torch.device("cpu")) is torch.float64
    assert gt.default_dtype("cuda") is torch.float32
    assert gt.default_dtype() is torch.float32


def test_kernel_spec_round_trip():
    for name, (kj, _) in {**FAMILIES, **NLML_CASES}.items():
        spec = convert.kernel_spec(kj)
        kt = convert.kernel_from_spec(spec)
        assert convert.kernel_spec(kt) == spec, name
        assert type(kt).__module__.startswith("pygpr_torch"), name
    with pytest.raises(ValueError):
        convert.kernel_from_spec(("Nope", {}, []))


def family_gaps(pkg_name, n=4096):
    """f32-against-f64 relative gaps of the fast NLML value and gradient
    for each of ``chip_smoke.py``'s kernel families, on its data and start,
    in the JAX package (its XLA path) or the port (the kernels' plain
    versions), on the CPU."""
    import chip_smoke

    out = {}
    for name, kern, kind in chip_smoke.kernel_families(gj if pkg_name == "jax" else gt):
        x, y, _ = chip_smoke.family_problem(kind, n)
        p = chip_smoke.family_params(gj if pkg_name == "jax" else gt, kern, x)
        res = {}
        for dt in ("f32", "f64"):
            args = [a.astype(np.float32 if dt == "f32" else np.float64) for a in (p, x, y)]
            if pkg_name == "jax":
                v, g = jax.jit(lambda p, x, y, k=kern: gj.nlml_value_and_grad(k, p, x, y))(*map(jnp.asarray, args))
            else:
                v, g = gt.nlml_value_and_grad(kern, *(torch.as_tensor(a) for a in args))
            res[dt] = (float(v), np.asarray(g, dtype=np.float64))
        (v32, g32), (v64, g64) = res["f32"], res["f64"]
        out[name] = {"rel_value": abs(v32 - v64) / abs(v64),
                     "rel_grad": float(np.linalg.norm(g32 - g64) / np.linalg.norm(g64))}
        print(pkg_name, n, name, out[name], flush=True)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_kernel_families.py [jax|torch] [n]
    # prints the f32-vs-f64 gaps of chip_smoke.py's kernel families on the
    # CPU (default: the JAX package at n = 4096, the yardstick of the
    # phase's limits; a few minutes and a few GB)
    import sys

    jax.config.update("jax_enable_x64", True)
    family_gaps(sys.argv[1] if len(sys.argv) > 1 else "jax", int(sys.argv[2]) if len(sys.argv) > 2 else 4096)
