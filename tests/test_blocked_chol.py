"""Blocked panel Cholesky (`ops/blocked_chol.py`) against float64 numpy.

The gpu-marked tests at the end repeat the large-N goldens on a GPU
(``GPT_GPU_TESTS=1 python -m pytest -m gpu``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_transportation_tpu.ops import blocked_chol as bc

rng = np.random.RandomState(0)


def _spd(n, dtype=np.float32):
    A = rng.randn(n, n)
    return (A @ A.T + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("B", [128, 256, 96, 512])
def test_factor_panel_matches_lapack(B):
    K = _spd(B)
    L, Linv = bc.factor_panel(jnp.asarray(K))
    L64 = np.linalg.cholesky(K.astype(np.float64))
    Linv64 = np.linalg.inv(L64)
    assert np.abs(np.asarray(L) - L64).max() / np.abs(L64).max() < 5e-6
    assert np.abs(np.asarray(Linv) - Linv64).max() / np.abs(Linv64).max() < 5e-6
    # strictly lower-triangular outputs
    assert np.allclose(np.triu(np.asarray(L), 1), 0.0)
    assert np.allclose(np.triu(np.asarray(Linv), 1), 0.0)


@pytest.mark.parametrize("n,B", [(640, 128), (1000, 256), (333, 100)])
def test_panel_factor_solve_matches_f64(n, B):
    """XLA panel factor (Cholesky + triangular inverse per diagonal block)
    driving the blocked solve, vs float64, at several (N, B)."""
    K = _spd(n)
    ch = bc.cholesky_panels(bc._split_panels(jnp.asarray(K), B, n), n)
    assert ch.block == B and len(ch.panels) == -(-n // B)
    for k in range(len(ch.panels)):
        Lkk = np.asarray(ch.panels[k][:B], np.float64)
        np.testing.assert_allclose(
            np.asarray(ch.linvs[k], np.float64) @ Lkk, np.eye(B), atol=1e-4
        )
    b = rng.randn(n, 2)
    x64 = np.linalg.solve(K.astype(np.float64), b)
    x = np.asarray(ch.solve(jnp.asarray(b, jnp.float32)))
    assert np.abs(x - x64).max() / np.abs(x64).max() < 1e-4


@pytest.mark.parametrize("n,B", [(384, 128), (500, 128), (300, 256)])
def test_blocked_cholesky_matches_dense(n, B):
    K = _spd(n)
    ch = bc.blocked_cholesky(jnp.asarray(K), block=B)
    L64 = np.linalg.cholesky(K.astype(np.float64))
    assert np.abs(np.asarray(ch.dense()) - L64).max() / np.abs(L64).max() < 1e-5


def test_blocked_solve_and_logdet():
    n, B = 500, 128
    K = _spd(n)
    ch = bc.blocked_cholesky(jnp.asarray(K), block=B)
    b = rng.randn(n, 3).astype(np.float32)
    x64 = np.linalg.solve(K.astype(np.float64), b)
    x = ch.solve(jnp.asarray(b))
    assert np.abs(np.asarray(x) - x64).max() / np.abs(x64).max() < 1e-4
    # 1-D RHS round-trips shape
    x1 = ch.solve(jnp.asarray(b[:, 0]))
    assert x1.shape == (n,)
    assert np.allclose(np.asarray(x1), x64[:, 0], atol=1e-4)
    # forward-only solve
    L64 = np.linalg.cholesky(K.astype(np.float64))
    y = ch.solve_lower(jnp.asarray(b))
    y64 = np.linalg.solve(L64, b)
    assert np.abs(np.asarray(y) - y64).max() / np.abs(y64).max() < 1e-4
    # logdet excludes the padding blocks
    ld64 = np.linalg.slogdet(K.astype(np.float64))[1]
    assert abs(float(ch.logdet()) - ld64) / abs(ld64) < 1e-5


def test_gram_cholesky_solve_matches_dense_gp():
    N, D, P = 300, 3, 2
    X = rng.randn(N, D)
    Y = rng.randn(N, P)
    ls = np.array([1.5, 0.8, 1.2])
    amp, noise = 2.0, 0.1
    alpha, ch = bc.gram_cholesky_solve(
        jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
        jnp.asarray(ls, jnp.float32), amp, noise, block=128,
    )
    D2 = (((X[:, None, :] - X[None, :, :]) / ls) ** 2).sum(-1)
    Kf = amp * np.exp(-0.5 * D2) + noise * np.eye(N)
    a64 = np.linalg.solve(Kf, Y)
    assert np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max() < 2e-4


@pytest.mark.parametrize("refine_iters", [0, 2])
def test_gram_cholesky_solve_refine_iters(refine_iters):
    """Iterative refinement count: every setting reaches the f64 solve, and
    the factor (hence logdet) does not depend on it."""
    N, B = 700, 128
    X = rng.randn(N, 3)
    Y = rng.randn(N, 2).astype(np.float32)
    ls = np.ones(3)
    alpha, ch = bc.gram_cholesky_solve(
        jnp.asarray(X, jnp.float32), jnp.asarray(Y), jnp.asarray(ls, jnp.float32),
        2.0, 0.1, block=B, refine_iters=refine_iters,
    )
    D2 = (((X[:, None, :] - X[None, :, :]) / ls) ** 2).sum(-1)
    Kf = 2.0 * np.exp(-0.5 * D2) + 0.1 * np.eye(N)
    a64 = np.linalg.solve(Kf, Y.astype(np.float64))
    assert np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max() < 2e-4
    ld64 = np.linalg.slogdet(Kf)[1]
    assert abs(float(ch.logdet()) - ld64) / abs(ld64) < 1e-5


def test_blocked_cholesky_under_jit():
    n, B = 384, 128
    K = _spd(n)
    f = jax.jit(lambda A: bc.blocked_cholesky(A, block=B).solve(
        jnp.ones((n,), jnp.float32)))
    x = f(jnp.asarray(K))
    x64 = np.linalg.solve(K.astype(np.float64), np.ones(n))
    assert np.allclose(np.asarray(x), x64, atol=1e-4)


def _matern52_gram(X, ls, amp):
    d = np.sqrt((((X[:, None, :] - X[None, :, :]) / ls) ** 2).sum(-1))
    s = np.sqrt(5.0) * d
    return amp * (1.0 + s + s * s / 3.0) * np.exp(-s)


@pytest.mark.parametrize("family", ["matern12", "matern32", "matern52"])
def test_stationary_gram_panels_matern_golden(family):
    """Matern panel Gram matches the dense f64 kernel."""
    N, D = 200, 3
    X = rng.randn(N, D)
    ls = np.array([1.5, 0.8, 1.2])
    amp, noise = 2.0, 0.1
    panels, n = bc.stationary_gram_panels(
        jnp.asarray(X, jnp.float32), jnp.asarray(ls, jnp.float32),
        amp, noise, block=128, family=family,
    )
    d = np.sqrt((((X[:, None, :] - X[None, :, :]) / ls) ** 2).sum(-1))
    if family == "matern12":
        K = amp * np.exp(-d)
    elif family == "matern32":
        s = np.sqrt(3.0) * d
        K = amp * (1.0 + s) * np.exp(-s)
    else:
        K = _matern52_gram(X, ls, amp)
    K = K + noise * np.eye(N)
    # reassemble lower triangle from the column panels
    B = 128
    got = np.zeros((256, 256), np.float32)
    for k, p in enumerate(panels):
        got[k * B :, k * B : (k + 1) * B] = np.asarray(p)
    tril = np.tril_indices(N)
    assert np.abs(got[:N, :N][tril] - K[tril]).max() < 5e-5


def test_gram_cholesky_solve_matern_matches_dense():
    """N=300 Matern(2.5) fused gram→chol→solve vs f64 dense solve."""
    N, D, P = 300, 3, 2
    X = rng.randn(N, D)
    Y = rng.randn(N, P)
    ls = np.array([1.5, 0.8, 1.2])
    amp, noise = 2.0, 0.1
    alpha, _ = bc.gram_cholesky_solve(
        jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
        jnp.asarray(ls, jnp.float32), amp, noise, block=128,
        family="matern52",
    )
    Kf = _matern52_gram(X, ls, amp) + noise * np.eye(N)
    a64 = np.linalg.solve(Kf, Y)
    assert np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max() < 2e-4


@pytest.mark.parametrize("kernel_name", ["rbf", "matern52"])
def test_condition_blocked_variance_paths_match_dense(kernel_name):
    """A blocked-factor GP (panel form, no dense L) must reproduce every
    dense-path posterior query: mean/std, full covariance, Jacobian
    variance, variance gradient."""
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as eg

    N, D, P, Nq = 300, 2, 2, 40
    X = jnp.asarray(rng.randn(N, D), jnp.float32)
    Y = jnp.asarray(rng.randn(N, P), jnp.float32)
    x = jnp.asarray(rng.randn(Nq, D), jnp.float32)
    if kernel_name == "rbf":
        kern = K.Constant(2.0) * K.RBF(jnp.asarray([1.5, 0.8], jnp.float32)) + K.White(0.1)
    else:
        kern = (
            K.Constant(2.0) * K.Matern(jnp.asarray([1.5, 0.8], jnp.float32), nu=2.5)
            + K.White(0.1)
        )

    gp_blocked = eg.condition_blocked(kern, X, Y, block=128)
    assert gp_blocked.L is None and gp_blocked.chol is not None
    gp_dense = eg.condition(kern, X, Y)

    m_b, s_b = eg.predict(gp_blocked, x, return_std=True)
    m_d, s_d = eg.predict(gp_dense, x, return_std=True)
    assert np.abs(np.asarray(m_b - m_d)).max() < 2e-3
    assert np.abs(np.asarray(s_b - s_d)).max() < 2e-3

    _, cov_b = eg.predict_cov(gp_blocked, x)
    _, cov_d = eg.predict_cov(gp_dense, x)
    assert np.abs(np.asarray(cov_b - cov_d)).max() < 2e-3

    jm_b, jv_b = eg.jacobian(gp_blocked, x, return_var=True)
    jm_d, jv_d = eg.jacobian(gp_dense, x, return_var=True)
    assert np.abs(np.asarray(jm_b - jm_d)).max() < 2e-3
    assert np.abs(np.asarray(jv_b - jv_d)).max() < 2e-3

    vg_b = eg.variance_gradient(gp_blocked, x)
    vg_d = eg.variance_gradient(gp_dense, x)
    assert np.abs(np.asarray(vg_b - vg_d)).max() < 2e-3


def test_condition_blocked_transport_apply_matches_dense():
    """The transport hot path (q-last variance + Jacobian quadratics) runs
    through the panel factor when the GP carries one."""
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import affine as affine_core
    from gaussian_process_transportation_tpu.models import exact_gp as eg
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    N, D, Q = 200, 2, 50
    S = jnp.asarray(rng.randn(N, D), jnp.float32)
    S1 = S + 0.3 * jnp.asarray(rng.randn(N, D), jnp.float32)
    traj = jnp.asarray(rng.randn(Q, D), jnp.float32)
    delta = jnp.asarray(0.1 * rng.randn(Q, D), jnp.float32)
    kern = K.Constant(2.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.05)

    aff = affine_core.fit(S, S1)
    src_aligned = affine_core.predict(aff, S)
    dY = S1 - src_aligned
    gp_b = eg.condition_blocked(kern, src_aligned, dY, block=128)
    gp_d = eg.condition(kern, src_aligned, dY)
    out_b = gpt_mod.transport_apply(aff, gp_b, traj, delta)
    out_d = gpt_mod.transport_apply(aff, gp_d, traj, delta)
    assert np.abs(np.asarray(out_b.traj - out_d.traj)).max() < 2e-3
    assert np.abs(np.asarray(out_b.std - out_d.std)).max() < 2e-3
    assert np.abs(np.asarray(out_b.delta - out_d.delta)).max() < 2e-3
    assert np.abs(np.asarray(out_b.delta_var - out_d.delta_var)).max() < 2e-3


@pytest.mark.gpu
def test_condition_blocked_variance_on_gpu_matches_f64(gpu):
    """GPU golden for the panel-factor variance path at N=4352:
    predict(return_std=True) through condition_blocked (no dense L) must
    match the f64 golden within the f32 conditioning limit."""
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as eg

    N, Nq, D = 4352, 512, 3
    X = rng.randn(N, D).astype(np.float32)
    Y = np.sin(X[:, :2]).astype(np.float32)
    Xq = rng.randn(Nq, D).astype(np.float32)
    amp, noise = 2.0, 0.1
    kern = K.Constant(amp) * K.RBF(jnp.ones(D, jnp.float32)) + K.White(noise)

    gp = eg.condition_blocked(kern, jnp.asarray(X), jnp.asarray(Y), jitter=1e-6)
    assert gp.chol is not None and gp.L is None
    mean, std = eg.predict(gp, jnp.asarray(Xq), return_std=True)
    mean, std = np.asarray(mean), np.asarray(std)

    X64, Xq64 = X.astype(np.float64), Xq.astype(np.float64)
    d2 = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    K64 = amp * np.exp(-0.5 * d2) + (noise + 1e-6) * np.eye(N)
    ks = amp * np.exp(-0.5 * ((Xq64[:, None, :] - X64[None, :, :]) ** 2).sum(-1))
    sol = np.linalg.solve(K64, np.concatenate([Y.astype(np.float64), ks.T], 1))
    mean64 = ks @ sol[:, :2]
    var64 = (amp + noise) - np.sum(ks * sol[:, 2:].T, axis=1)
    std64 = np.sqrt(np.maximum(var64, 0.0))

    m_scale = np.abs(mean64).max()
    assert np.abs(mean - mean64).max() / m_scale < 5e-3
    # predictive std at the f32 conditioning limit (same as builtin f32)
    assert np.abs(std - std64[:, None]).max() < 5e-3 * np.abs(std64).max() + 1e-3


@pytest.mark.gpu
def test_blocked_cholesky_on_gpu_matches_f64(gpu):
    """GPU golden: panel gram→Cholesky→solve at N=2560, B=512, HIGHEST."""
    N = 2560
    X = rng.randn(N, 3).astype(np.float32)
    Y = rng.randn(N, 3).astype(np.float32)
    ls = np.ones(3, np.float32)
    alpha, _ = jax.jit(
        lambda Xs, Ys: bc.gram_cholesky_solve(
            Xs, Ys, jnp.asarray(ls), 2.0, 0.1, block=512)
    )(jnp.asarray(X), jnp.asarray(Y))
    X64 = X.astype(np.float64)
    sq = (X64 ** 2).sum(1)
    K64 = 2.0 * np.exp(-0.5 * np.maximum(sq[:, None] + sq[None, :] - 2 * X64 @ X64.T, 0)) + 0.1 * np.eye(N)
    a64 = np.linalg.solve(K64, Y)
    assert np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max() < 5e-3
