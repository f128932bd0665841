"""Goldens for the batched small-N LML value+grad (ops/fused_lml.py)
and the ensemble-last batched HMC path that consumes it.

The canonical golden is per-chain ``jax.value_and_grad`` of the existing
``models.exact_gp.log_marginal_likelihood`` (itself golden-checked against
sklearn) — the batched LML must reproduce value AND gradient for every
chain, every family, isotropic and ARD lengthscales, with and without a
White term, for shared and per-lane data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models.exact_gp import (
    log_marginal_likelihood,
    small_lml_theta_layout,
)
from gaussian_process_transportation_tpu.ops.fused_lml import (
    small_lml_value_grad,
    small_lml_value_grad_md,
)


def _workload(n=20, D=2, p=1, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.standard_normal((n, D)).astype(np.float32))
    Y = jnp.asarray(
        (np.sin(np.asarray(X)[:, :1]) + 0.1 * rng.standard_normal((n, p))).astype(
            np.float32
        )
    )
    return X, Y


def _thetas(kernel, E, seed=1):
    rng = np.random.default_rng(seed)
    T = kernel.theta.shape[0]
    return jnp.asarray(rng.uniform(-1.0, 1.0, size=(E, T)).astype(np.float32))


def _adg_golden(kernel, X, Y, thetas, jitter):
    f = lambda th: log_marginal_likelihood(kernel.with_theta(th), X, Y, jitter)
    vals, grads = jax.vmap(jax.value_and_grad(f))(thetas.astype(jnp.float64))
    return np.asarray(vals), np.asarray(grads)


CASES = [
    ("rbf-ard", lambda: K.Constant(2.0) * K.RBF(jnp.ones(2)) + K.White(0.05), 2),
    ("rbf-iso", lambda: K.Constant(2.0) * K.RBF(0.7) + K.White(0.05), 2),
    ("matern52", lambda: K.Constant(1.5) * K.Matern(jnp.ones(2), nu=2.5) + K.White(0.02), 2),
    ("matern32-no-noise", lambda: K.Constant(1.0) * K.Matern(0.8, nu=1.5), 3),
    # matern12's dphi is ~-5e17 at s=0 (diagonal): the gradient stays
    # finite only because the diagonal d2 term is exactly 0 — assert the
    # 0*huge==0 cancellation holds end-to-end
    ("matern12", lambda: K.Constant(1.2) * K.Matern(jnp.ones(2), nu=0.5) + K.White(0.03), 2),
]


@pytest.mark.parametrize("name,mk,D", CASES, ids=[c[0] for c in CASES])
def test_fused_ref_matches_per_chain_ad(name, mk, D):
    kernel = mk()
    X, Y = _workload(n=17, D=D)
    layout = small_lml_theta_layout(kernel)
    assert layout is not None
    family, n_ls, has_noise, perm = layout
    thetas = _thetas(kernel, E=11)
    jitter = 1e-8

    vals_g, grads_g = _adg_golden(kernel, X, Y, thetas, jitter)
    te = jnp.transpose(thetas[:, perm], (1, 0))
    vals, grads = small_lml_value_grad(
        X, Y, te, family=family, n_ls=n_ls, has_noise=has_noise, jitter=jitter
    )
    grads_theta = np.asarray(grads).T[:, np.argsort(perm)]
    scale = np.maximum(np.abs(vals_g), 1.0)
    np.testing.assert_allclose(np.asarray(vals), vals_g, atol=2e-3 * scale.max())
    gs = np.maximum(np.abs(grads_g).max(), 1.0)
    np.testing.assert_allclose(grads_theta, grads_g, atol=3e-3 * gs)


@pytest.mark.parametrize("name,mk,D", CASES, ids=[c[0] for c in CASES])
def test_fused_md_matches_per_member_ad_all_families(name, mk, D):
    """Per-lane data, every family: lane e against AD of its own dataset."""
    kernel = mk()
    family, n_ls, has_noise, perm = small_lml_theta_layout(kernel)
    rng = np.random.default_rng(5)
    E, n = 5, 12
    Xe = jnp.asarray(rng.standard_normal((E, n, D)))
    Ye = jnp.asarray(rng.standard_normal((E, n, 2)))
    thetas = _thetas(kernel, E=E)
    jitter = 1e-8

    def one(x, y, th):
        f = lambda t: log_marginal_likelihood(kernel.with_theta(t), x, y, jitter)
        return jax.value_and_grad(f)(th)

    vals_g, grads_g = jax.vmap(one)(Xe, Ye, thetas.astype(jnp.float64))
    te = jnp.transpose(thetas[:, perm], (1, 0))
    v, g = small_lml_value_grad_md(
        Xe, Ye, te, family=family, n_ls=n_ls, has_noise=has_noise, jitter=jitter
    )
    scale = max(1.0, float(np.abs(np.asarray(vals_g)).max()))
    np.testing.assert_allclose(np.asarray(v), np.asarray(vals_g), atol=2e-3 * scale)
    gs = max(1.0, float(np.abs(np.asarray(grads_g)).max()))
    np.testing.assert_allclose(
        np.asarray(g).T[:, np.argsort(perm)], np.asarray(grads_g), atol=3e-3 * gs
    )


def test_fused_multioutput_and_padding():
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.1)
    X, Y = _workload(n=9, D=2, p=3)
    family, n_ls, has_noise, perm = small_lml_theta_layout(kernel)
    thetas = _thetas(kernel, E=7)
    vals_g, grads_g = _adg_golden(kernel, X, Y, thetas, 1e-8)
    te = jnp.transpose(thetas[:, perm], (1, 0))
    v_k, g_k = small_lml_value_grad(
        X, Y, te, family=family, n_ls=n_ls, has_noise=has_noise, jitter=1e-8,
    )
    np.testing.assert_allclose(np.asarray(v_k), vals_g, atol=2e-3 * max(1, np.abs(vals_g).max()))
    gs = max(1.0, np.abs(grads_g).max())
    np.testing.assert_allclose(
        np.asarray(g_k).T[:, np.argsort(perm)], grads_g, atol=3e-3 * gs
    )


def test_fused_md_matches_per_member_ad():
    """Multi-data LML: every lane owns its own dataset — golden is
    per-member jax.value_and_grad of log_marginal_likelihood, and lane e
    of the multi-data call equals the shared-data call on dataset e."""
    kernel = K.Constant(2.0) * K.RBF(jnp.ones(2)) + K.White(0.05)
    family, n_ls, has_noise, perm = small_lml_theta_layout(kernel)
    rng = np.random.default_rng(3)
    E, n, D, p = 6, 13, 2, 1
    Xe = jnp.asarray(rng.standard_normal((E, n, D)).astype(np.float32))
    Ye = jnp.asarray(rng.standard_normal((E, n, p)).astype(np.float32))
    thetas = jnp.asarray(rng.uniform(-1.0, 1.0, (E, 4)).astype(np.float32))
    jitter = 1e-8

    def one(x, y, th):
        f = lambda t: log_marginal_likelihood(kernel.with_theta(t), x, y, jitter)
        return jax.value_and_grad(f)(th.astype(jnp.float64))

    vals_g, grads_g = jax.vmap(one)(Xe, Ye, thetas)
    te = jnp.transpose(thetas[:, perm], (1, 0))
    v_ref, g_ref = small_lml_value_grad_md(
        Xe, Ye, te, family=family, n_ls=n_ls, has_noise=has_noise, jitter=jitter
    )
    gs = max(1.0, float(np.abs(np.asarray(grads_g)).max()))
    np.testing.assert_allclose(
        np.asarray(v_ref), np.asarray(vals_g),
        atol=2e-3 * max(1.0, float(np.abs(np.asarray(vals_g)).max())),
    )
    np.testing.assert_allclose(
        np.asarray(g_ref).T[:, np.argsort(perm)], np.asarray(grads_g),
        atol=3e-3 * gs,
    )
    for e in range(E):
        v1, g1 = small_lml_value_grad(
            Xe[e], Ye[e], te[:, e:e + 1], family=family, n_ls=n_ls,
            has_noise=has_noise, jitter=jitter,
        )
        np.testing.assert_allclose(float(v1[0]), float(v_ref[e]), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(g1[:, 0]), np.asarray(g_ref[:, e]),
                                   rtol=1e-5, atol=1e-6)


def test_fit_ensemble_fused_matches_fit_jit_quality():
    """Batched E-last L-BFGS over the fused multi-data LML must reach the
    same optima as per-member fit_jit (optax L-BFGS), within a small LML
    tolerance, on members with different datasets."""
    from gaussian_process_transportation_tpu.models.exact_gp import (
        fit_ensemble_fused,
        fit_jit,
        log_marginal_likelihood,
    )

    rng = np.random.default_rng(7)
    E, n, D = 4, 16, 2
    Xe = rng.uniform(-2, 2, (E, n, D)).astype(np.float32)
    f = np.sin(1.3 * Xe[:, :, :1]) * np.cos(0.6 * Xe[:, :, 1:2])
    Ye = (f + 0.05 * rng.standard_normal((E, n, 1))).astype(np.float32)
    kernel = (
        K.Constant(1.0, bounds=(1e-2, 1e2))
        * K.RBF(jnp.ones(D, jnp.float32), bounds=(1e-1, 1e1))
        + K.White(0.2, bounds=(1e-4, 1.0))
    )
    thetas, lmls = fit_ensemble_fused(
        kernel, jnp.asarray(Xe), jnp.asarray(Ye), n_restarts=6,
        maxiter=40, key=jax.random.PRNGKey(0),
    )
    assert thetas.shape == (E, 4) and np.isfinite(np.asarray(lmls)).all()
    for e in range(E):
        gp = fit_jit(kernel, jnp.asarray(Xe[e]), jnp.asarray(Ye[e]),
                     n_restarts=2, maxiter=40)
        lml_ref = float(
            log_marginal_likelihood(gp.kernel, jnp.asarray(Xe[e]),
                                    jnp.asarray(Ye[e]), 1e-10)
        )
        lml_fused = float(lmls[e])
        # fused must not be materially worse than the optax path
        assert lml_fused > lml_ref - 0.5, (e, lml_fused, lml_ref)
        # and the reported LML must be consistent with its theta
        lml_check = float(
            log_marginal_likelihood(
                kernel.with_theta(thetas[e]), jnp.asarray(Xe[e]),
                jnp.asarray(Ye[e]), 1e-10,
            )
        )
        assert abs(lml_check - lml_fused) < 2e-2 * max(1.0, abs(lml_fused))


def test_theta_layout_detection():
    k1 = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01)
    fam, n_ls, has_noise, perm = small_lml_theta_layout(k1)
    assert fam == "rbf" and n_ls == 2 and has_noise
    np.testing.assert_array_equal(perm, [0, 1, 2, 3])
    # swapped Sum order
    k2 = K.White(0.01) + K.Constant(1.0) * K.RBF(0.5)
    fam, n_ls, has_noise, perm = small_lml_theta_layout(k2)
    assert fam == "rbf" and n_ls == 1 and has_noise
    np.testing.assert_array_equal(perm, [1, 2, 0])
    # unsupported: two stationary terms
    assert small_lml_theta_layout(K.RBF(1.0) + K.RBF(2.0)) is None


@pytest.mark.slow
def test_hmc_batched_statistics_match_vmapped_hmc():
    """The batched sampler must draw from the same posterior as vmap(hmc):
    compare chain moments and R̂ on the bench workload target."""
    from gaussian_process_transportation_tpu.parallel import samplers

    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01)
    X, Y = _workload(n=14, D=2)
    common = dict(num_chains=16, num_warmup=150, num_samples=150)

    s_fused, d_fused = samplers.sample_gp_posterior(
        kernel, X, Y, jax.random.PRNGKey(0), algorithm="hmc", **common
    )
    # the generic vmapped NUTS path as an independent reference
    s_ref, d_ref = samplers.sample_gp_posterior(
        kernel, X, Y, jax.random.PRNGKey(1), algorithm="nuts", fused=False,
        **common
    )
    assert s_fused.shape == (16, 150, 4)
    assert np.isfinite(np.asarray(s_fused)).all()
    assert float(np.max(np.asarray(d_fused["rhat"]))) < 1.2
    # posterior moments agree between samplers within MC error
    m_f = np.asarray(s_fused).reshape(-1, 4).mean(0)
    m_r = np.asarray(s_ref).reshape(-1, 4).mean(0)
    sd = np.asarray(s_ref).reshape(-1, 4).std(0)
    assert np.all(np.abs(m_f - m_r) < 0.8 * sd + 0.3)


def test_hmc_batched_bit_invariant_under_shard_map():
    """hmc_batched's per-chain random streams make the sampler itself
    bit-identical sharded vs unsharded (the multihost determinism story;
    the LML's own independence of the lane count is tested separately,
    here a closed-form target isolates the sampler)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from gaussian_process_transportation_tpu.parallel import samplers

    T, E = 3, 8

    def lp_and_grad(q):
        return -0.5 * jnp.sum(q * q, axis=0), -q

    q0 = jnp.asarray(np.random.default_rng(0).standard_normal((T, E)))
    cks = jax.random.split(jax.random.PRNGKey(1), E)

    def run(q0, cks):
        return samplers.hmc_batched(
            lp_and_grad, q0, num_warmup=10, num_samples=10,
            num_leapfrog=4, chain_keys=cks,
        )

    s0, _ = jax.jit(run)(q0, cks)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("ens", "data"))
    q0s = jax.device_put(q0, NamedSharding(mesh, P(None, "ens")))
    ckss = jax.device_put(cks, NamedSharding(mesh, P("ens")))
    s1, _ = jax.jit(
        shard_map(
            run, mesh=mesh, in_specs=(P(None, "ens"), P("ens")),
            out_specs=(P("ens"), {"step_size": P("ens"),
                                  "inv_mass": P("ens"),
                                  "mean_accept": P("ens")}),
            check_vma=False,
        )
    )(q0s, ckss)
    np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))


def test_hmc_batched_fused_on_mesh():
    from gaussian_process_transportation_tpu.parallel import samplers
    from gaussian_process_transportation_tpu.parallel.mesh import make_mesh

    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01)
    X, Y = _workload(n=10, D=2)
    mesh = make_mesh(8, 1)
    s, d = samplers.sample_gp_posterior(
        kernel, X, Y, jax.random.PRNGKey(0),
        num_chains=16, num_warmup=40, num_samples=40, mesh=mesh,
    )
    assert s.shape == (16, 40, 4)
    assert np.isfinite(np.asarray(s)).all()


def test_small_lml_layout_errors_and_shapes():
    """Theta rows must match the canonical layout; outputs are (E,) and
    (T, E), finite, with or without a White term."""
    X, Y = _workload(n=6, D=2)
    with pytest.raises(ValueError, match="layout"):
        small_lml_value_grad(X, Y, jnp.zeros((3, 4)), n_ls=2)
    for has_noise in (True, False):
        T = 3 + int(has_noise)
        v, g = small_lml_value_grad(X, Y, jnp.zeros((T, 4)), n_ls=2,
                                    has_noise=has_noise)
        assert v.shape == (4,) and g.shape == (T, 4)
        assert np.isfinite(np.asarray(v)).all() and np.isfinite(np.asarray(g)).all()


@pytest.mark.parametrize("family", ["rbf", "matern32"])
def test_small_lml_jits_and_vmaps_over_datasets(family):
    """The shared-data call under jit, vmapped over datasets, equals the
    multi-data call (same batched math, two layouts)."""
    rng = np.random.default_rng(9)
    E, n = 4, 10
    Xe = jnp.asarray(rng.standard_normal((E, n, 2)))
    Ye = jnp.asarray(rng.standard_normal((E, n, 1)))
    te = jnp.asarray(rng.uniform(-1, 1, (4, E)))
    f = jax.jit(lambda x, y, t: small_lml_value_grad(x, y, t[:, None], family=family,
                                                    n_ls=2))
    vs, gs = jax.vmap(f, in_axes=(0, 0, 1))(Xe, Ye, te)
    vm, gm = small_lml_value_grad_md(Xe, Ye, te, family=family, n_ls=2)
    np.testing.assert_allclose(np.asarray(vs[:, 0]), np.asarray(vm), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(gs[:, :, 0]).T, np.asarray(gm),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("md", [False, True], ids=["shared", "per_lane_data"])
def test_small_lml_lane_count_invariant(md):
    """Lane e's value and gradient are the same bits whether 4 or 16 lanes
    share the call: what sharded hyperposterior chains rely on."""
    rng = np.random.default_rng(11)
    E, n = 16, 9
    te = jnp.asarray(rng.uniform(-1, 1, (4, E)), jnp.float32)
    if md:
        Xe = jnp.asarray(rng.standard_normal((E, n, 2)), jnp.float32)
        Ye = jnp.asarray(rng.standard_normal((E, n, 1)), jnp.float32)
        f = jax.jit(lambda x, y, t: small_lml_value_grad_md(x, y, t, n_ls=2))
        a, b = f(Xe, Ye, te), f(Xe[:4], Ye[:4], te[:, :4])
    else:
        X, Y = (jnp.asarray(v, jnp.float32) for v in _workload(n=n, D=2))
        f = jax.jit(lambda t: small_lml_value_grad(X, Y, t, n_ls=2))
        a, b = f(te), f(te[:, :4])
    np.testing.assert_array_equal(np.asarray(a[0])[:4], np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1])[:, :4], np.asarray(b[1]))


@pytest.mark.parametrize("fused", [False, True], ids=["generic", "fused"])
def test_sample_gp_posterior_sharded_bit_identical(fused):
    """Chains sharded over a 4-device mesh are the unsharded chains, bit
    for bit, on both sampler paths."""
    from gaussian_process_transportation_tpu.parallel import samplers
    from gaussian_process_transportation_tpu.parallel.mesh import make_mesh

    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.01)
    X, Y = _workload(n=8, D=2)
    common = dict(num_chains=8, num_warmup=6, num_samples=6, fused=fused)
    s_m, _ = samplers.sample_gp_posterior(kernel, X, Y, jax.random.PRNGKey(3),
                                          mesh=make_mesh(4, 1), **common)
    s_1, _ = samplers.sample_gp_posterior(kernel, X, Y, jax.random.PRNGKey(3),
                                          **common)
    np.testing.assert_array_equal(np.asarray(s_m), np.asarray(s_1))
