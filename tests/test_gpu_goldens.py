"""GPU golden tier: ``GPT_GPU_TESTS=1 python -m pytest tests/ -q -m gpu``
on a machine with a GPU (``chip_smoke.py`` phase g runs the same).

Every test computes its golden in numpy float64 on the host and asserts
the GPU float32 output (matmul precision HIGHEST) against it, at the
workloads' real sizes.  Whether a GPU is present is decided inside the
``gpu`` fixture (``conftest.py``), so collection is the same on every
machine; elsewhere the tests skip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_transportation_tpu import kernels as K

pytestmark = pytest.mark.gpu


def _workload_2d(n_traj=400, n_dist=20):
    """The bench's synthetic 2-D drawing."""
    t = np.linspace(0, 1, n_traj)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, n_dist)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def _phi_np(s, family):
    if family == "rbf":
        return np.exp(-0.5 * s), -0.5 * np.exp(-0.5 * s)
    d = np.sqrt(s + 1e-36)
    if family == "matern12":
        return np.exp(-d), -np.exp(-d) / (2.0 * np.maximum(d, 1e-18))
    if family == "matern32":
        r = np.sqrt(3.0) * d
        return (1 + r) * np.exp(-r), -1.5 * np.exp(-r)
    r = np.sqrt(5.0) * d
    return (1 + r + r * r / 3.0) * np.exp(-r), -(5.0 / 6.0) * (1 + r) * np.exp(-r)


def _lml_value_grad_f64(X, Y, theta, family, jitter=1e-10):
    """LML of C·stationary(ARD)+White at θ = (log amp, log ℓ_d…, log noise)
    and its θ-gradient by the trace identity, all in numpy float64."""
    X, Y = np.asarray(X, np.float64), np.asarray(Y, np.float64)
    amp, noise = np.exp(theta[0]), np.exp(theta[-1])
    ls = np.exp(np.asarray(theta[1:-1], np.float64))
    d2 = (X[:, None, :] - X[None, :, :]) ** 2                  # (n, n, D)
    s = np.sum(d2 / ls**2, axis=-1)
    phi, dphi = _phi_np(s, family)
    Km = amp * phi + (noise + jitter) * np.eye(len(X))
    Ki = np.linalg.inv(Km)
    a = Ki @ Y
    n, p = Y.shape
    val = (-0.5 * np.sum(Y * a) - 0.5 * p * np.linalg.slogdet(Km)[1]
           - 0.5 * p * n * np.log(2 * np.pi))
    W = 0.5 * (a @ a.T - p * Ki)
    g = [np.sum(W * amp * phi)]
    g += [np.sum(W * amp * dphi * d2[:, :, d] / ls[d] ** 2) * -2.0
          for d in range(len(ls))]
    g.append(noise * np.trace(W))
    return val, np.asarray(g)


def _transport_golden_f64(X, dX, S, S1, amp=10.0, ls=4.0, noise=0.01,
                          jitter=1e-6):
    """The reference pipeline in f64 numpy (Kabsch + GP delta + velocity
    transport) — mirrors ``policy_transportation/models/gaussian_process.py``
    and ``gaussian_process_transportation.py`` math with fixed
    hyperparameters (the bench workload)."""
    cs, ct = S.mean(0), S1.mean(0)
    H = (S - cs).T @ (S1 - ct)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V[:, -1] *= -1
        R = V @ U.T
    gamma = lambda x: (R @ (x - cs).T).T + ct
    Sg = gamma(S)
    delta = S1 - Sg
    d2 = ((Sg[:, None, :] - Sg[None, :, :]) ** 2).sum(-1)
    Km = amp * np.exp(-0.5 * d2 / ls**2) + (noise + jitter) * np.eye(len(Sg))
    alpha = np.linalg.solve(Km, delta)
    Xg = gamma(X)
    d2s = ((Xg[:, None, :] - Sg[None, :, :]) ** 2).sum(-1)
    ks = amp * np.exp(-0.5 * d2s / ls**2)
    mean = ks @ alpha
    return Xg + mean


def test_transport_engine_f32_matches_f64_golden(gpu):
    """The headline engine: batched fit+transport at the bench workload;
    GPU f32 vs host f64."""
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    X, dX, S, S1 = _workload_2d()
    kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2, jnp.float32)) + K.White(0.01)
    E = 64
    shifts = np.linspace(0.0, 1.0, E)
    targets = jnp.asarray((S1[None] + shifts[:, None, None]).astype(np.float32))
    res = jax.jit(
        lambda tg: gpt_mod.fit_and_transport_batched(
            kernel, jnp.asarray(S, jnp.float32), tg,
            jnp.asarray(X, jnp.float32), jnp.asarray(dX, jnp.float32),
        )
    )(targets)
    traj = np.asarray(res.traj)
    assert np.isfinite(traj).all()
    scale = np.abs(X).max()
    for e in (0, E // 2, E - 1):
        golden = _transport_golden_f64(X, dX, S, S1 + shifts[e])
        err = np.abs(traj[e] - golden).max() / scale
        assert err < 1e-3, (e, err)


@pytest.mark.parametrize("family,nu", [("rbf", None), ("matern52", 2.5)])
def test_predict_mean_on_gpu_vs_f64(gpu, family, nu):
    """Dense-grid posterior mean k(X*, X)·α (Nq=4096, N=2048) vs host f64."""
    from gaussian_process_transportation_tpu.models import exact_gp as core

    rng = np.random.default_rng(0)
    N, Nq, D, P = 2048, 4096, 2, 2
    X = rng.standard_normal((N, D))
    Xq = rng.standard_normal((Nq, D))
    alpha = rng.standard_normal((N, P))
    ls, amp = 1.5, 2.0
    base = K.RBF(ls * jnp.ones(D)) if nu is None else K.Matern(ls * jnp.ones(D), nu=nu)
    gp = core.ExactGP(
        kernel=K.Constant(amp) * base + K.White(0.01),
        X=jnp.asarray(X, jnp.float32), Y=jnp.zeros((N, P), jnp.float32),
        alpha=jnp.asarray(alpha, jnp.float32),
    )
    got = np.asarray(jax.jit(core.predict)(gp, jnp.asarray(Xq, jnp.float32)))
    d2 = ((Xq[:, None, :] / ls - X[None, :, :] / ls) ** 2).sum(-1)
    if family == "rbf":
        k = amp * np.exp(-0.5 * d2)
    else:
        r = np.sqrt(5.0 * d2)
        k = amp * (1 + r + r * r / 3.0) * np.exp(-r)
    golden = k @ alpha
    err = np.abs(got - golden).max() / np.abs(golden).max()
    assert err < 5e-5, err


@pytest.mark.parametrize("N", [2048, 4096])
def test_predict_mean_var_on_gpu_vs_f64(gpu, N):
    """Dense-grid mean and std (Nq=10240) through the triangular-solve
    variance path vs host f64."""
    from gaussian_process_transportation_tpu.models import exact_gp as core

    rng = np.random.default_rng(1)
    Nq, D = 10240, 2
    X = rng.standard_normal((N, D))
    Y = np.stack([np.sin(X[:, 0]), np.cos(X[:, 1])], 1)
    Xq = rng.standard_normal((Nq, D))
    amp, ls, noise = 2.0, 1.5, 0.05
    kern = K.Constant(amp) * K.RBF(ls * jnp.ones(D, jnp.float32)) + K.White(noise)
    gp = core.condition(
        kern, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
    )
    mean, std = core.predict(gp, jnp.asarray(Xq, jnp.float32), return_std=True)
    mean, std = np.asarray(mean), np.asarray(std)

    jit = core._eff_jitter(jnp.float32, 1e-10)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    K64 = amp * np.exp(-0.5 * d2 / ls**2) + (noise + jit) * np.eye(N)
    d2s = ((Xq[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    ks = amp * np.exp(-0.5 * d2s / ls**2)
    alpha64 = np.linalg.solve(K64, Y)
    mean64 = ks @ alpha64
    var64 = (amp + noise) - np.einsum(
        "qn,qn->q", ks @ np.linalg.inv(K64), ks
    )
    std64 = np.sqrt(np.maximum(var64, 0.0))
    assert np.abs(mean - mean64).max() / np.abs(mean64).max() < 1e-4
    # var ≈ 0.05 is the difference of prior 2.05 and a quadratic form, so
    # float32 rounding in the N=4096 triangular solve is amplified ~40×
    # (measured 4e-4 relative std error on the H100 at N=4096)
    assert np.abs(std[:, 0] - std64).max() / np.abs(std64).max() < 1e-3


def test_hmc_fused_chain_moments_match_xla_reference(gpu):
    """Short fused-path HMC (batched small-LML, all chains in one scan) vs
    the generic vmapped-AD HMC — same target, moments within MC error."""
    from gaussian_process_transportation_tpu.parallel import samplers

    rng = np.random.default_rng(0)
    n = 20
    Xs = rng.standard_normal((n, 2)).astype(np.float32)
    Ys = (np.sin(Xs[:, :1]) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.01)
    common = dict(num_chains=64, num_warmup=200, num_samples=200)

    s_gpu, d_gpu = samplers.sample_gp_posterior(
        kernel, jnp.asarray(Xs), jnp.asarray(Ys), jax.random.PRNGKey(0), **common
    )
    s_gpu = np.asarray(s_gpu)
    assert np.isfinite(s_gpu).all()

    # independent reference chains through the generic per-chain sampler
    # (AD of log_marginal_likelihood) — implementation-vs-implementation
    s_cpu, _ = samplers.sample_gp_posterior(
        kernel, jnp.asarray(Xs), jnp.asarray(Ys), jax.random.PRNGKey(1),
        fused=False, **common
    )
    s_cpu = np.asarray(s_cpu)

    m_t = s_gpu.reshape(-1, 4).mean(0)
    m_c = s_cpu.reshape(-1, 4).mean(0)
    sd = s_cpu.reshape(-1, 4).std(0)
    assert np.all(np.abs(m_t - m_c) < 0.8 * sd + 0.3), (m_t, m_c, sd)


def test_smc_step_on_gpu_matches_f64_reweight(gpu):
    """One SMC reweight+resample at E=4096: log-weight update and ESS vs
    host f64; resampled particles are members of the input set."""
    from gaussian_process_transportation_tpu.parallel import smc

    rng = np.random.default_rng(2)
    E, T, D = 4096, 50, 2
    trajs = rng.standard_normal((E, T, D)).astype(np.float32)
    lw0 = np.full(E, -np.log(E), np.float32)
    particles = smc.ParticleEnsemble(
        trajectories=jnp.asarray(trajs), log_weights=jnp.asarray(lw0)
    )
    goal = jnp.asarray([1.0, 1.0], jnp.float32)
    ll_fn = smc.goal_likelihood(goal, scale=2.0)
    p1, ess = smc.smc_step(particles, ll_fn, jax.random.PRNGKey(0),
                           ess_threshold=0.0)  # no resample: check weights
    ll64 = -0.5 * ((trajs[:, -1, :].astype(np.float64)
                    - np.asarray(goal)) ** 2).sum(-1) / 2.0**2
    lw64 = lw0.astype(np.float64) + ll64
    lw64 = lw64 - np.log(np.exp(lw64 - lw64.max()).sum()) - lw64.max()
    got = np.asarray(p1.log_weights, np.float64)
    got = got - np.log(np.exp(got - got.max()).sum()) - got.max()
    assert np.abs(got - lw64).max() < 1e-3
    ess64 = 1.0 / np.exp(2 * lw64).sum() / E
    assert abs(float(ess) / E - ess64) < 1e-3 or abs(float(ess) - ess64 * E) < E * 1e-3

    # forced resample: every output trajectory is one of the inputs
    p2, _ = smc.smc_step(particles, ll_fn, jax.random.PRNGKey(1),
                         ess_threshold=1.0)
    out = np.asarray(p2.trajectories)
    idx = np.abs(out[:, 0, 0][:, None] - trajs[:, 0, 0][None, :]).argmin(1)
    assert np.abs(out - trajs[idx]).max() < 1e-6


def test_fit_ensemble_fused_on_gpu_improves_members(gpu):
    """Batched fused hyperopt on the GPU: every member's fitted LML must
    beat its initial-kernel LML, and the fitted thetas must reproduce the
    reported LML on the host in f64."""
    from gaussian_process_transportation_tpu.models.exact_gp import (
        fit_ensemble_fused,
        log_marginal_likelihood,
    )

    rng = np.random.default_rng(5)
    E, n, D = 64, 20, 2
    Xe = rng.uniform(-2, 2, (E, n, D)).astype(np.float32)
    f = np.sin(1.3 * Xe[:, :, :1]) * np.cos(0.6 * Xe[:, :, 1:2])
    Ye = (f + 0.05 * rng.standard_normal((E, n, 1))).astype(np.float32)
    kernel = (
        K.Constant(1.0, bounds=(1e-2, 1e2))
        * K.RBF(jnp.ones(D, jnp.float32), bounds=(1e-1, 1e1))
        + K.White(0.2, bounds=(1e-4, 1.0))
    )
    thetas, lmls = fit_ensemble_fused(
        kernel, jnp.asarray(Xe), jnp.asarray(Ye), n_restarts=4, maxiter=30,
        key=jax.random.PRNGKey(0),
    )
    thetas, lmls = np.asarray(thetas), np.asarray(lmls)
    assert np.isfinite(thetas).all() and np.isfinite(lmls).all()
    for e in range(0, E, 16):
        th0 = np.log([1.0, 1.0, 1.0, 0.2])
        lml0, _ = _lml_value_grad_f64(Xe[e], Ye[e], th0, "rbf")
        lml_fit, _ = _lml_value_grad_f64(Xe[e], Ye[e], thetas[e], "rbf")
        assert lml_fit >= lml0 - 1e-3, (e, lml_fit, lml0)
        # the GPU-reported LML agrees with the host-f64 recompute
        assert abs(lml_fit - float(lmls[e])) < 5e-2 * max(1.0, abs(lml_fit)), (
            e, lml_fit, float(lmls[e]))


def test_blocked_lml_grad_step_improves_at_n10240(gpu):
    """One gradient step of the panel LML at the full bench size N=10240
    increases the LML (the fit_blocked L-BFGS inner step, on the GPU)."""
    from gaussian_process_transportation_tpu.ops.blocked_lml import (
        blocked_lml_value_and_grad,
    )

    rng = np.random.default_rng(3)
    N = 10240
    X = jnp.asarray(rng.standard_normal((N, 3)).astype(np.float32))
    Y = jnp.asarray(rng.standard_normal((N, 1)).astype(np.float32))
    la = jnp.asarray(np.log(2.0), jnp.float32)
    ll = jnp.zeros(3, jnp.float32)
    ln = jnp.asarray(np.log(0.1), jnp.float32)
    v0, (ga, gl, gn) = jax.jit(
        lambda a, l, n_: blocked_lml_value_and_grad(
            X, Y, "rbf", a, l, n_, block=512,
            precision=jax.lax.Precision.HIGHEST,
        )
    )(la, ll, ln)
    g = np.concatenate([[float(ga)], np.asarray(gl), [float(gn)]])
    assert np.isfinite(float(v0)) and np.isfinite(g).all()
    lr = 1e-4 / max(1.0, np.abs(g).max())
    v1, _ = jax.jit(
        lambda a, l, n_: blocked_lml_value_and_grad(
            X, Y, "rbf", a, l, n_, block=512,
            precision=jax.lax.Precision.HIGHEST,
        )
    )(la + lr * float(ga), ll + lr * gl, ln + lr * float(gn))
    assert float(v1) > float(v0), (float(v0), float(v1))


@pytest.mark.parametrize("family", ["rbf", "matern12", "matern32", "matern52"])
def test_small_lml_vs_f64(gpu, family):
    """The batched small-LML value+grad at n=20 (both entry points) vs the
    per-lane f64 trace-identity gradient on the host."""
    from gaussian_process_transportation_tpu.models.exact_gp import (
        log_marginal_likelihood,
        small_lml_theta_layout,
    )
    from gaussian_process_transportation_tpu.ops.fused_lml import (
        small_lml_value_grad,
        small_lml_value_grad_md,
    )

    nu = {"rbf": None, "matern12": 0.5, "matern32": 1.5, "matern52": 2.5}[family]
    base = K.RBF(jnp.ones(2)) if nu is None else K.Matern(jnp.ones(2), nu=nu)
    kernel = K.Constant(2.0) * base + K.White(0.05)
    fam, n_ls, has_noise, perm = small_lml_theta_layout(kernel)
    rng = np.random.default_rng(11)
    E, n = 96, 20
    Xe = rng.standard_normal((E, n, 2))
    Ye = np.sin(Xe[:, :, :1]) + 0.1 * rng.standard_normal((E, n, 1))
    th = rng.uniform(-1.0, 1.0, (E, 4))
    te = jnp.asarray(th[:, perm].T, jnp.float32)
    v1, g1 = small_lml_value_grad(
        jnp.asarray(Xe[0], jnp.float32), jnp.asarray(Ye[0], jnp.float32), te,
        family=fam, n_ls=n_ls, has_noise=has_noise,
    )
    vm, gm = small_lml_value_grad_md(
        jnp.asarray(Xe, jnp.float32), jnp.asarray(Ye, jnp.float32), te,
        family=fam, n_ls=n_ls, has_noise=has_noise,
    )
    inv = np.argsort(perm)
    for e in range(0, E, 19):
        for v, g, x, y in ((v1, g1, Xe[0], Ye[0]), (vm, gm, Xe[e], Ye[e])):
            v64, g64 = _lml_value_grad_f64(x, y, th[e], family)
            assert abs(float(v[e]) - v64) < 1e-4 * max(1.0, abs(v64))
            gk = np.asarray(g)[:, e][inv]
            assert np.abs(gk - g64).max() < 1e-3 * max(1.0, np.abs(g64).max())
