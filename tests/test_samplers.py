"""HMC/NUTS samplers: exactness on a known Gaussian, GP-posterior sanity,
sharded chains on the virtual mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu.parallel import samplers
from gaussian_process_transportation_tpu.parallel.mesh import make_mesh
from gaussian_process_transportation_tpu import kernels as K

rng = np.random.RandomState(4)


def gaussian_logprob(mu, sigma):
    def lp(x):
        return -0.5 * jnp.sum(((x - mu) / sigma) ** 2)

    return lp


@pytest.mark.parametrize("alg", ["hmc", "nuts"])
def test_sampler_recovers_gaussian(alg):
    mu = jnp.asarray([1.0, -2.0, 0.5])
    sigma = jnp.asarray([0.5, 2.0, 1.0])
    sampler = samplers.hmc if alg == "hmc" else samplers.nuts
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    run = jax.jit(
        jax.vmap(
            lambda k: sampler(
                gaussian_logprob(mu, sigma),
                jnp.zeros(3),
                k,
                num_warmup=400,
                num_samples=500,
            )[0]
        )
    )
    chains = run(keys)  # (4, 500, 3)
    flat = np.asarray(chains).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), np.asarray(mu), atol=0.15)
    np.testing.assert_allclose(flat.std(0), np.asarray(sigma), atol=0.3)
    rhat = np.asarray(samplers.split_rhat(chains))
    assert np.all(rhat < 1.1), rhat


def test_ess_reasonable():
    # iid normal chains → ESS close to C*S
    x = jnp.asarray(rng.randn(4, 400, 2))
    ess = np.asarray(samplers.effective_sample_size(x))
    assert np.all(ess > 800), ess


@pytest.mark.slow
def test_gp_posterior_sampling_with_mesh():
    N = 25
    X = rng.randn(N, 1) * 2
    Y = np.sin(X) + 0.1 * rng.randn(N, 1)
    kernel = K.Constant(1.0, bounds=(0.01, 10.0)) * K.RBF(
        jnp.ones(1), bounds=(0.1, 10.0)
    ) + K.White(0.05, bounds=(1e-4, 1.0))
    mesh = make_mesh(n_ens=8, n_data=1)
    samples, diags = samplers.sample_gp_posterior(
        kernel,
        jnp.asarray(X),
        jnp.asarray(Y),
        jax.random.PRNGKey(0),
        num_chains=8,
        num_warmup=150,
        num_samples=150,
        mesh=mesh,
        num_leapfrog=12,
    )
    assert samples.shape == (8, 150, 3)
    theta = np.asarray(samples).reshape(-1, 3)
    bounds = np.asarray(kernel.theta_bounds)
    # samples stay within (slightly padded) bounds
    assert np.all(theta > bounds[:, 0] - 0.5)
    assert np.all(theta < bounds[:, 1] + 0.5)
    # lengthscale posterior should concentrate near a plausible value
    ls = np.exp(theta[:, 1])
    assert 0.2 < np.median(ls) < 6.0, np.median(ls)
    assert float(diags["mean_accept"].mean()) > 0.5


@pytest.mark.slow
def test_posterior_predictive_from_chains():
    """Hyperparameter-marginalized prediction: average posteriors over θ
    samples — the capability that replaces Optuna lengthscale search."""
    from gaussian_process_transportation_tpu.models import exact_gp as core

    N = 20
    X = rng.randn(N, 1)
    Y = np.cos(2 * X) + 0.05 * rng.randn(N, 1)
    kernel = K.Constant(1.0, bounds=(0.01, 10.0)) * K.RBF(jnp.ones(1), bounds=(0.1, 10.0)) + K.White(
        0.05, bounds=(1e-4, 1.0)
    )
    samples, _ = samplers.sample_gp_posterior(
        kernel, jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(1),
        num_chains=2, num_warmup=100, num_samples=50, num_leapfrog=8,
    )
    thetas = samples.reshape(-1, 3)[::10]  # thin
    xq = jnp.asarray(np.linspace(-2, 2, 15)[:, None])

    def predict_at(theta):
        gp = core.condition(kernel.with_theta(theta), jnp.asarray(X), jnp.asarray(Y))
        return core.predict(gp, xq)

    preds = jax.vmap(predict_at)(thetas)
    mean = np.asarray(preds.mean(0))
    truth = np.cos(2 * np.asarray(xq))
    assert np.sqrt(np.mean((mean - truth) ** 2)) < 0.35


def test_nuts_batched_recovers_gaussian():
    """Ensemble-last batched NUTS (the fused production path's kernel)
    draws from the right target: diagonal Gaussian recovered to MC error,
    matching the generic per-chain nuts semantics."""
    mu = np.array([1.0, -2.0, 0.5])
    sigma = np.array([0.5, 2.0, 1.0])
    muj = jnp.asarray(mu)[:, None]
    sigj = jnp.asarray(sigma)[:, None]

    def lp_and_grad(q):  # (T, E) -> ((E,), (T, E)), finite-guarded contract
        z = (q - muj) / sigj
        lp = -0.5 * jnp.sum(z * z, axis=0)
        g = -z / sigj
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -1e10, lp)
        g = jnp.where(jnp.isfinite(g) & ~bad[None, :], g, 0.0)
        return lp, g

    E = 16
    samples, info = samplers.nuts_batched(
        lp_and_grad, jnp.zeros((3, E)), key=jax.random.PRNGKey(0),
        num_warmup=200, num_samples=300, max_depth=6,
    )
    assert samples.shape == (E, 300, 3)
    acc = np.asarray(info["mean_accept"])
    assert np.isfinite(acc).all() and acc.mean() > 0.5, acc
    flat = np.asarray(samples).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.15)
    np.testing.assert_allclose(flat.std(0), sigma, atol=0.3)
    chains = np.asarray(samples)
    rhat = np.asarray(samplers.split_rhat(jnp.asarray(chains)))
    assert np.all(rhat < 1.1), rhat


@pytest.mark.slow  # the generic vmapped-AD NUTS reference costs minutes on CPU
def test_nuts_fused_gp_posterior_matches_generic():
    """sample_gp_posterior(algorithm='nuts') now routes through the fused
    batched NUTS for the small-N transport family; its posterior moments
    must match the generic vmapped NUTS (fused=False)."""
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01)
    rs = np.random.RandomState(3)
    X = jnp.asarray(rs.randn(14, 2))
    Y = jnp.asarray(np.sin(np.asarray(X)[:, :1]) + 0.1 * rs.randn(14, 1))
    # the generic vmapped-AD NUTS reference dominates the test's CPU time —
    # it gets a small 8×100 budget (moments only) while the cheap fused run
    # keeps the full 16×150 the R̂ gate needs
    s_fused, d_fused = samplers.sample_gp_posterior(
        kernel, X, Y, jax.random.PRNGKey(0), algorithm="nuts",
        num_chains=16, num_warmup=150, num_samples=150,
    )
    s_ref, _ = samplers.sample_gp_posterior(
        kernel, X, Y, jax.random.PRNGKey(1), algorithm="nuts", fused=False,
        num_chains=8, num_warmup=100, num_samples=100,
    )
    assert s_fused.shape == (16, 150, 4)
    assert np.isfinite(np.asarray(s_fused)).all()
    assert float(np.max(np.asarray(d_fused["rhat"]))) < 1.2
    m_f = np.asarray(s_fused).reshape(-1, 4).mean(0)
    m_r = np.asarray(s_ref).reshape(-1, 4).mean(0)
    sd = np.asarray(s_ref).reshape(-1, 4).std(0)
    assert np.all(np.abs(m_f - m_r) < 0.8 * sd + 0.3), (m_f, m_r, sd)
