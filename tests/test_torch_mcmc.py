"""Port parity: MCMC over hyperparameters (``pygpr_torch/sample/mcmc.py``)
against the JAX package.

RWM and HMC are held trajectory for trajectory: the test reproduces the
JAX package's key schedule (``sample_posterior``: ``split(key, C + 1)``,
the chains' starts from the first C keys, the chains' keys from the last;
in a chain each step takes ``key, sub = split(key)`` and
``k1, k2 = split(sub)``: a normal from k1 and a uniform from k2) with
``jax.random``, and feeds those draws to the port's chain functions.  The
JAX side, its samplers and the draws, runs under one ``jax.jit`` in a
module fixture.  Samples, log posteriors, acceptance and the adapted step
agree to 1e-8 in f64: the same arithmetic on the same draws, and what is
left is round-off of the NLML's Cholesky and of its gradient (the JAX
package's JVP of the ladder against the port's backward), which the
chains carry forward.  RWM runs 40 warmup and 40 sampling steps.  HMC runs
20 and 20 at the default 8 leapfrog steps: its trajectories amplify that
round-off about 1.3x a step (1e-15 after one step, 2e-10 after 20 warmup
steps, 1e-8 to 1e-7 after 40 + 40 on some seeds, on this problem), so at
40 + 40 the bound would hold only for some seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pygpr_torch as gt
import pygpr_tpu as gj
from pygpr_torch.sample import mcmc as mt
from pygpr_tpu.sample import mcmc as mj

N, C, NW, NS = 60, 2, 40, 40
NW_HMC, NS_HMC = 20, 20
NHP = 3
N_LEAPFROG = 8
#: f64 parity bound (relative) of the trajectories
RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's CPU thread pool beside JAX's oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=N, seed=0):
    """The JAX test's problem (tests/test_sample.py): y = sin(2x) + 0.1ε."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 3, size=(n, 1))
    y = np.sin(2.0 * x[:, 0]) + 0.1 * rng.normal(size=n)
    return x, y


def _jax_priors():
    return [gj.LogNormal(0.0, 1.0), None, gj.Gamma(2.0, 10.0)]


def _torch_priors():
    return [gt.LogNormal(0.0, 1.0), None, gt.Gamma(2.0, 10.0)]


def _chain_draws(key, total, n_chains=C, dtype=jnp.float64):
    """The starts' normals ``[C, nhp]`` and the chains' normals
    ``[T, C, nhp]`` and uniforms ``[T, C]``, by the JAX package's key
    schedule."""
    keys = jax.random.split(key, n_chains + 1)
    init = jax.vmap(lambda k: jax.random.normal(k, (NHP,), dtype))(keys[:n_chains])
    chain_keys = jax.random.split(keys[-1], n_chains)

    def per_chain(k):
        def body(k, _):
            k, sub = jax.random.split(k)
            k1, k2 = jax.random.split(sub)
            return k, (jax.random.normal(k1, (NHP,), dtype), jax.random.uniform(k2, (), dtype))

        _, out = jax.lax.scan(body, k, None, length=total)
        return out

    normals, uniforms = jax.vmap(per_chain)(chain_keys)
    return init, jnp.swapaxes(normals, 0, 1), uniforms.T


@pytest.fixture(scope="module")
def parity():
    x, y = _problem()
    cov = gj.Sum((gj.RBF(), gj.WhiteNoise()))

    def run(x, y):
        out = {}
        for name, priors in (("plain", None), ("priors", _jax_priors())):
            key = jax.random.PRNGKey(7)
            out[f"rwm_{name}"] = mj.sample_posterior(cov, x, y, key, n_samples=NS, n_warmup=NW, n_chains=C,
                                                     priors=priors)._asdict()
            out[f"rwm_{name}_draws"] = _chain_draws(key, NW + NS)
            key = jax.random.PRNGKey(11)
            out[f"hmc_{name}"] = mj.sample_posterior_hmc(cov, x, y, key, n_samples=NS_HMC, n_warmup=NW_HMC,
                                                         n_chains=C, n_leapfrog=N_LEAPFROG, priors=priors)._asdict()
            out[f"hmc_{name}_draws"] = _chain_draws(key, NW_HMC + NS_HMC)
            lp = mj.log_posterior_fn(cov, x, y, priors=priors)
            u = jnp.log(out[f"rwm_{name}"]["samples"][:, -1])
            out[f"lp_{name}"] = jax.vmap(lp)(u)
            out[f"grad_{name}"] = jax.vmap(jax.grad(lp))(u)
        return out

    want = jax.tree.map(np.asarray, jax.jit(run)(jnp.asarray(x), jnp.asarray(y)))
    return x, y, want


def T(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _torch_lp(x, y, name):
    return mt.log_posterior_fn(gt.Sum((gt.RBF(), gt.WhiteNoise())), T(x), T(y),
                               priors=_torch_priors() if name == "priors" else None)


def _start(init):
    """The chains' start: log θ₀ = 0 jittered by 0.5 × the init normals."""
    return torch.zeros(C, NHP, dtype=torch.float64) + 0.5 * T(init)


@pytest.mark.parametrize("name", ["plain", "priors"])
def test_log_posterior_and_grad(parity, name):
    """Both ``log_posterior_fn`` variants over a ``[C, nhp]`` batch of
    chain states: one factorization of the ``[C, n, n]`` stack."""
    x, y, want = parity
    u = torch.log(T(want[f"rwm_{name}"]["samples"][:, -1]))
    lp = _torch_lp(x, y, name)
    close(lp(u), want[f"lp_{name}"])
    v, g = mt._value_and_grad(lp, u)
    close(v, want[f"lp_{name}"])
    close(g, want[f"grad_{name}"])
    # one state without the chain axis gives the same value
    close(lp(u[0]), want[f"lp_{name}"][0])


@pytest.mark.parametrize("name", ["plain", "priors"])
def test_rwm_trajectory(parity, name):
    x, y, want = parity
    init, normals, uniforms = want[f"rwm_{name}_draws"]
    got = mt.MCMCResult(*mt._rwm_chain(_torch_lp(x, y, name), _start(init), T(normals), T(uniforms), NS, NW,
                                       0.3, 0.1, lambda s: s))
    ref = want[f"rwm_{name}"]
    for f in ("samples", "log_prob", "accept_rate", "step_size"):
        close(getattr(got, f), ref[f])
    assert 0.0 < float(got.accept_rate.min()) and float(got.accept_rate.max()) < 1.0


@pytest.mark.parametrize("name", ["plain", "priors"])
def test_hmc_trajectory(parity, name):
    x, y, want = parity
    init, momenta, uniforms = want[f"hmc_{name}_draws"]
    got = mt.MCMCResult(*mt._hmc_chain(_torch_lp(x, y, name), _start(init), T(momenta), T(uniforms), NS_HMC,
                                       NW_HMC, 0.75, 0.05, N_LEAPFROG, lambda s: s))
    ref = want[f"hmc_{name}"]
    for f in ("samples", "log_prob", "accept_rate", "step_size"):
        close(getattr(got, f), ref[f])


def test_sync_fn_sees_the_warmup_statistic(parity):
    """``sync_fn`` gets the ``[C]`` adaptation statistic once per warmup
    step, and its output is what adapts the step (here: the chains'
    mean, so every chain ends on one step size)."""
    x, y, want = parity
    init, normals, uniforms = want["rwm_plain_draws"]
    seen = []

    def sync(s):
        seen.append(tuple(s.shape))
        return s.mean().expand_as(s)

    res = mt._rwm_chain(_torch_lp(x, y, "plain"), _start(init), T(normals), T(uniforms), NS, NW, 0.3, 0.1, sync)
    assert seen == [(C,)] * NW
    assert torch.equal(res[3], res[3][:1].expand(C))


def test_rwm_rejects_a_non_finite_log_posterior():
    """A proposal whose log posterior is NaN (a factorization that failed
    every rung) is rejected with acceptance 0, so the adapted step stays
    finite and the chain moves on (the JAX package's RWM would carry the
    NaN into its step size and stop the chain: ROADMAP §C, C3)."""
    def lp(u):
        v = -0.5 * torch.sum(u * u, dim=-1)
        return torch.where(u[..., 0] > 1.0, torch.nan, v)

    g = torch.Generator().manual_seed(1)
    T_ = NW + NS
    res = mt._rwm_chain(lp, torch.zeros(C, NHP, dtype=torch.float64),
                        torch.randn((T_, C, NHP), generator=g, dtype=torch.float64),
                        torch.rand((T_, C), generator=g, dtype=torch.float64), NS, NW, 0.3, 1.0, lambda s: s)
    assert torch.isfinite(res[0]).all() and torch.isfinite(res[1]).all() and torch.isfinite(res[3]).all()
    assert (res[0][..., 0] <= np.e).all() and (res[2] > 0).all()


def test_public_samplers_on_generator():
    """``sample_posterior`` and ``sample_posterior_hmc`` from a
    ``torch.Generator``: shapes, finite draws, the same draws from the same
    seed, and θ = exp(u) > 0."""
    x, y = _problem(24)
    kern = gt.Sum((gt.RBF(), gt.WhiteNoise()))
    for fn, kw in ((gt.sample_posterior, {}), (gt.sample_posterior_hmc, {"n_leapfrog": 3})):
        a = fn(kern, T(x), T(y), torch.Generator().manual_seed(3), n_samples=6, n_warmup=6, n_chains=3, **kw)
        b = fn(kern, T(x), T(y), torch.Generator().manual_seed(3), n_samples=6, n_warmup=6, n_chains=3, **kw)
        assert a.samples.shape == (3, 6, NHP) and a.log_prob.shape == (3, 6)
        assert a.accept_rate.shape == (3,) and a.step_size.shape == (3,)
        assert torch.isfinite(a.samples).all() and (a.samples > 0).all()
        assert torch.equal(a.samples, b.samples)


def _sample_arrays():
    rng = np.random.default_rng(5)
    return np.exp(0.3 * rng.normal(size=(3, 50, NHP)) + np.cumsum(0.05 * rng.normal(size=(3, 50, NHP)), axis=1))


def test_statistics_match_jax():
    """``posterior_moments``, ``split_rhat`` and ``effective_sample_size``
    on the same sample arrays."""
    s = _sample_arrays()
    m_j, s_j = mj.posterior_moments(jnp.asarray(s))
    m_t, s_t = mt.posterior_moments(T(s))
    close(m_t, m_j, rtol=1e-12)
    close(s_t, s_j, rtol=1e-12)
    close(mt.split_rhat(T(s)), mj.split_rhat(jnp.asarray(s)), rtol=1e-12)
    np.testing.assert_array_equal(mt.effective_sample_size(T(s)), mj.effective_sample_size(s))


def test_effective_sample_size_calibration():
    """The JAX test's calibration: iid draws → ESS ≈ n; AR(1), φ = 0.9 →
    ESS ≈ n(1−φ)/(1+φ)."""
    rng = np.random.default_rng(0)
    nc, ns = 4, 4000
    ess = mt.effective_sample_size(T(rng.normal(size=(nc, ns, 1))))[0]
    assert 0.7 * nc * ns < ess < 1.3 * nc * ns, ess
    phi = 0.9
    z = np.empty((nc, ns))
    z[:, 0] = rng.normal(size=nc)
    eps = rng.normal(size=(nc, ns))
    for t in range(1, ns):
        z[:, t] = phi * z[:, t - 1] + np.sqrt(1 - phi**2) * eps[:, t]
    ess_ar = mt.effective_sample_size(z[:, :, None])[0]
    want = nc * ns * (1 - phi) / (1 + phi)
    assert 0.5 * want < ess_ar < 2.0 * want, (ess_ar, want)


def test_predictive_mixture_matches_jax():
    """The hyperparameter-marginalized predictive on the same draws
    (the JAX test's tolerance, 1e-8 on the mean and 1e-7 on the variance)."""
    x, y = _problem(48, seed=3)
    xs = np.random.default_rng(4).uniform(0, 3, size=(16, 1))
    s = 0.1 + 0.9 * _sample_arrays()
    m_j, v_j = mj.predictive_mixture(gj.Sum((gj.RBF(), gj.WhiteNoise())), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(s), jnp.asarray(xs), n_use=24)
    m_t, v_t = mt.predictive_mixture(gt.Sum((gt.RBF(), gt.WhiteNoise())), T(x), T(y), T(s), T(xs), n_use=24)
    close(m_t, m_j, rtol=1e-8)
    close(v_t, v_j, rtol=1e-7)


def test_log_prior_u_matches_jax():
    from pygpr_torch.models.priors import log_prior_u as lt
    from pygpr_tpu.models.priors import log_prior_u as lj

    u = np.random.default_rng(2).normal(size=(4, NHP))
    close(lt(_torch_priors(), T(u)), lj(_jax_priors(), jnp.asarray(u)), rtol=1e-12)


def test_mcmc_posterior_moments():
    """The JAX package's north-star check (tests/test_sample.py) on the
    port: 4 RWM chains bracket the true noise 0.1 (BASELINE config 3)."""
    x, y = _problem()
    res = gt.sample_posterior(gt.Sum((gt.RBF(), gt.WhiteNoise())), T(x), T(y), torch.Generator().manual_seed(0),
                              n_samples=400, n_warmup=400, n_chains=4)
    acc = res.accept_rate.numpy()
    assert np.all(acc > 0.1) and np.all(acc < 0.7)
    mean, _ = mt.posterior_moments(res.samples)
    assert 0.05 < float(mean[-1]) < 0.25
    assert np.all(mt.split_rhat(res.samples).numpy() < 1.3)


@pytest.mark.slow
def test_hmc_posterior_moments():
    """The JAX package's HMC check on the port (about 17 s on one CPU
    thread: under ``slow``, as the JAX test is)."""
    x, y = _problem()
    res = gt.sample_posterior_hmc(gt.Sum((gt.RBF(), gt.WhiteNoise())), T(x), T(y),
                                  torch.Generator().manual_seed(0), n_samples=200, n_warmup=200, n_chains=4)
    assert np.all(res.accept_rate.numpy() > 0.3)
    mean, _ = mt.posterior_moments(res.samples)
    assert 0.05 < float(mean[-1]) < 0.25
    assert np.all(mt.split_rhat(res.samples).numpy() < 1.3)


#: θ at the mean of ``chip_smoke.py``'s drifted RWM chain on an NVIDIA
#: H100 (its ``drift_vs_f64`` center; ROADMAP §C, C4)
DRIFT_CENTER = (9.354206274032594, 0.42627204170823096, 0.016638054038397968)


def chain_gaps(pkg_name, where="mode"):
    """The log posterior's and its gradient's largest relative f32-vs-f64
    gaps over 8 chain states of ``chip_smoke.py``'s MCMC problem (n =
    1024), ``chip_smoke.chain_states()`` near the mode or around
    :data:`DRIFT_CENTER`, in the JAX package (its XLA path) or the
    port's plain path, on this CPU, with the jitter the ladder chose for
    each state's gram in f32 and in f64: the yardstick of the phase's
    limits."""
    import chip_smoke

    x, y = chip_smoke.mcmc_problem()
    u = chip_smoke.chain_states() if where == "mode" else chip_smoke.chain_states(center=DRIFT_CENTER)
    out = {}
    for name, dt in (("f32", 32), ("f64", 64)):
        if pkg_name == "jax":
            from pygpr_tpu.ops.kernels import train_gram
            from pygpr_tpu.ops.linalg import safe_cholesky

            d = jnp.float32 if dt == 32 else jnp.float64
            kern, xd = gj.Sum((gj.RBF(), gj.WhiteNoise())), jnp.asarray(x, d)
            lp = mj.log_posterior_fn(kern, xd, jnp.asarray(y, d))
            v, g = jax.vmap(jax.value_and_grad(lp))(jnp.asarray(u, d))
            jit = jax.vmap(lambda p: safe_cholesky(train_gram(kern, p, xd)).jitter)(jnp.exp(jnp.asarray(u, d)))
        else:
            from pygpr_torch.ops.kernels import train_gram
            from pygpr_torch.ops.linalg import safe_cholesky

            d = torch.float32 if dt == 32 else torch.float64
            kern, xd = gt.Sum((gt.RBF(), gt.WhiteNoise())), torch.tensor(x, dtype=d)
            lp = mt.log_posterior_fn(kern, xd, torch.tensor(y, dtype=d))
            v, g = mt._value_and_grad(lp, torch.tensor(u, dtype=d))
            jit = safe_cholesky(torch.stack([train_gram(kern, p, xd) for p in torch.exp(torch.tensor(u, dtype=d))])
                                ).jitter
        out[name] = (np.asarray(v, np.float64), np.asarray(g, np.float64), np.asarray(jit, np.float64))
    (v, g, j32), (v64, g64, j64) = out["f32"], out["f64"]
    rel_v = np.abs(v - v64) / np.abs(v64)
    rel_g = np.linalg.norm(g - g64, axis=-1) / np.linalg.norm(g64, axis=-1)
    print({"package": pkg_name, "states": where, "rel_value": rel_v.max(), "rel_grad": rel_g.max(),
           "rel_value_each": rel_v.tolist(), "rel_grad_each": rel_g.tolist(), "value_f32": v.tolist(),
           "value_f64": v64.tolist(), "jitter_f32": j32.tolist(),
           "jitter_f64": j64.tolist(), "noise_var": np.exp(2 * u[:, -1]).tolist()})


def rwm_run(pkg_name="torch", bits=64, seed=0):
    """``chip_smoke.py``'s RWM run (its defaults, 4 chains, n = 1024) on
    this CPU, in the port (a CPU generator of ``seed``) or the JAX package
    (``PRNGKey(seed)``), in f32 or f64: acceptance, posterior mean, split
    R-hat and effective samples, the yardstick of the phase's R-hat check."""
    import chip_smoke

    x, y = chip_smoke.mcmc_problem()
    if pkg_name == "jax":
        d = jnp.float32 if bits == 32 else jnp.float64
        res = jax.jit(lambda x, y, k: mj.sample_posterior(gj.Sum((gj.RBF(), gj.WhiteNoise())), x, y, k,
                                                          n_chains=chip_smoke.MCMC_CHAINS))(
            jnp.asarray(x, d), jnp.asarray(y, d), jax.random.PRNGKey(seed))
        s = torch.tensor(np.asarray(res.samples, np.float64))
    else:
        torch.set_num_threads(8)
        d = torch.float32 if bits == 32 else torch.float64
        res = gt.sample_posterior(gt.Sum((gt.RBF(), gt.WhiteNoise())), torch.tensor(x, dtype=d),
                                  torch.tensor(y, dtype=d), torch.Generator().manual_seed(seed),
                                  n_chains=chip_smoke.MCMC_CHAINS)
        s = res.samples.double()
    mean, _ = mt.posterior_moments(s)
    print({"package": pkg_name, "bits": bits, "seed": seed, "accept": np.asarray(res.accept_rate).tolist(),
           "posterior_mean": mean.tolist(), "chain_noise_means": s[:, :, -1].mean(dim=1).tolist(),
           "chain_noise_min": s[:, :, -1].min(dim=1).values.tolist(),
           "split_rhat": mt.split_rhat(s).tolist(), "ess": mt.effective_sample_size(s).tolist()}, flush=True)


def rwm_from_jax_draws(bits=32, seed=0):
    """The port's RWM chains fed the JAX package's own draws for
    ``PRNGKey(seed)`` (its key schedule, as the trajectory tests rebuild
    it) on ``chip_smoke.py``'s problem (its defaults, 4 chains, n = 1024)
    on this CPU in f32 or f64, beside the JAX package's own run from the
    same key: whether the port's sampler follows the reference's at the
    phase's size."""
    import chip_smoke

    torch.set_num_threads(8)
    nc, nw, ns = chip_smoke.MCMC_CHAINS, 500, 1000
    x, y = chip_smoke.mcmc_problem()
    dj, dt = (jnp.float32, torch.float32) if bits == 32 else (jnp.float64, torch.float64)
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(lambda x, y: mj.sample_posterior(gj.Sum((gj.RBF(), gj.WhiteNoise())), x, y, key,
                                                   n_chains=nc))(jnp.asarray(x, dj), jnp.asarray(y, dj))
    init, normals, uniforms = (torch.tensor(np.asarray(a), dtype=dt)
                               for a in jax.jit(lambda k: _chain_draws(k, nw + ns, nc, dj))(key))
    lp = mt.log_posterior_fn(gt.Sum((gt.RBF(), gt.WhiteNoise())), torch.tensor(x, dtype=dt),
                             torch.tensor(y, dtype=dt))
    got = mt.MCMCResult(*mt._rwm_chain(lp, 0.5 * init, normals, uniforms, ns, nw, 0.3, 0.1, lambda s: s))
    for name, s in (("jax", torch.tensor(np.asarray(ref.samples, np.float64))), ("port", got.samples.double())):
        print({"run": name, "bits": bits, "seed": seed, "chain_noise_means": s[:, :, -1].mean(dim=1).tolist(),
               "chain_noise_min": s[:, :, -1].min(dim=1).values.tolist(),
               "split_rhat": mt.split_rhat(s).tolist()}, flush=True)
    gap = (torch.log(got.samples.double()) - torch.log(torch.tensor(np.asarray(ref.samples, np.float64)))).abs()
    print({"max_abs_log_gap_by_chain": gap.amax(dim=(1, 2)).tolist(),
           "first_step_above_1e-3": [int(torch.nonzero(gap[c].amax(-1) > 1e-3)[0]) if (gap[c] > 1e-3).any()
                                     else None for c in range(nc)]}, flush=True)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mcmc.py [jax|torch] [mode|drift]
    #   the f32-vs-f64 gaps of chip_smoke.py's chain log posterior on the
    #   CPU (default: the JAX package near the mode; about a minute)
    # ... tests/test_torch_mcmc.py rwm [torch|jax] [64|32] [seed]
    #   the phase's RWM run in the port or the JAX package (minutes)
    # ... tests/test_torch_mcmc.py rwm jaxdraws [64|32] [seed]
    #   the port's RWM from the JAX package's draws, beside the JAX run
    import sys

    arg = sys.argv[1:] or ["jax"]
    # the JAX package's f32 run as its users run it: x64 off
    jax.config.update("jax_enable_x64", arg[2:3] != ["32"])
    if arg[0] == "rwm" and arg[1:2] == ["jaxdraws"]:
        rwm_from_jax_draws(*[int(a) for a in arg[2:4]])
    elif arg[0] == "rwm":
        rwm_run(*(arg[1:2] or ["torch"]), *[int(a) for a in arg[2:4]])
    else:
        chain_gaps(*arg[:2])
