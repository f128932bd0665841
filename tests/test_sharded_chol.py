"""Distributed blocked Cholesky (parallel/sharded_chol.py).

The multi-chip large-N conditioning path: Gram build + factorization +
solve block-cyclic over a mesh axis.  Reference anchor: the exact-GP
active-learning cap of 20 000 points
(/root/reference/policy_transportation/models/gaussian_process_al.py:16)
is a single-host dense-Cholesky limit this path removes.

All tests run on the virtual 8-device CPU mesh (conftest).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from gaussian_process_transportation_tpu.ops.blocked_chol import (
    gram_cholesky_solve,
)
from gaussian_process_transportation_tpu.parallel.sharded_chol import (
    sharded_gram_cholesky_solve,
)

rng = np.random.RandomState(0)


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("data",))


def _golden(X, Y, ls, amp, noise, family="rbf"):
    X64 = X.astype(np.float64) / ls
    d2 = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    if family == "rbf":
        k = np.exp(-0.5 * d2)
    elif family == "matern52":
        d = np.sqrt(np.maximum(d2, 0))
        s = np.sqrt(5.0) * d
        k = (1 + s + s * s / 3) * np.exp(-s)
    K = amp * k + noise * np.eye(len(X64))
    return np.linalg.solve(K, Y.astype(np.float64))


@pytest.mark.parametrize("n_dev,n", [(2, 512), (4, 700), (8, 1024)])
def test_sharded_matches_f64_golden(n_dev, n):
    """Distributed gram+chol+solve vs dense f64, incl. padding (n=700 is
    not a multiple of block·D)."""
    X = rng.randn(n, 3).astype(np.float32)
    Y = rng.randn(n, 2).astype(np.float32)
    ls, amp, noise = np.ones(3, np.float32), 2.0, 0.1
    alpha, _ = sharded_gram_cholesky_solve(
        jnp.asarray(X), jnp.asarray(Y), ls, amp, noise,
        mesh=_mesh(n_dev), block=128,
    )
    a64 = _golden(X, Y, ls, amp, noise)
    err = np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max()
    assert err < 5e-4, err


def test_sharded_equals_single_device_blocked():
    """The distributed factorization must agree with ops.blocked_chol's
    single-device panel path to f32 round-off (same algorithm, same
    diagonal-block factor — only the layout and collectives differ)."""
    n = 640
    X = rng.randn(n, 3).astype(np.float32)
    Y = rng.randn(n, 1).astype(np.float32)
    ls, amp, noise = np.ones(3, np.float32), 1.5, 0.2
    a_single, _ = gram_cholesky_solve(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(ls), amp, noise,
        block=128, refine_iters=0,
    )
    a_shard, _ = sharded_gram_cholesky_solve(
        jnp.asarray(X), jnp.asarray(Y), ls, amp, noise,
        mesh=_mesh(4), block=128,
    )
    diff = np.abs(np.asarray(a_shard) - np.asarray(a_single)).max()
    assert diff < 1e-4 * np.abs(np.asarray(a_single)).max(), diff


def test_sharded_matern_family():
    n = 512
    X = rng.randn(n, 2).astype(np.float32)
    Y = rng.randn(n, 1).astype(np.float32)
    ls, amp, noise = np.full(2, 0.8, np.float32), 1.0, 0.3
    alpha, _ = sharded_gram_cholesky_solve(
        jnp.asarray(X), jnp.asarray(Y), ls, amp, noise,
        mesh=_mesh(4), block=128, family="matern52",
    )
    a64 = _golden(X, Y, ls, amp, noise, family="matern52")
    err = np.abs(np.asarray(alpha) - a64).max() / np.abs(a64).max()
    assert err < 5e-4, err


def test_sharded_factor_reuse_solve_and_logdet():
    """The returned distributed factor supports fresh solves (new RHS) and
    logdet without refactorizing — the LML building blocks at scale."""
    n = 512
    X = rng.randn(n, 3).astype(np.float32)
    Y = rng.randn(n, 1).astype(np.float32)
    B = rng.randn(n, 4).astype(np.float32)
    ls, amp, noise = np.ones(3, np.float32), 2.0, 0.1
    _, chol = sharded_gram_cholesky_solve(
        jnp.asarray(X), jnp.asarray(Y), ls, amp, noise,
        mesh=_mesh(8), block=128,
    )
    xb = np.asarray(chol.solve(jnp.asarray(B)))
    b64 = _golden(X, B, ls, amp, noise)
    assert np.abs(xb - b64).max() / np.abs(b64).max() < 5e-4

    # logdet vs f64
    X64 = X.astype(np.float64)
    d2 = ((X64[:, None, :] - X64[None, :, :]) ** 2).sum(-1)
    K = 2.0 * np.exp(-0.5 * d2) + 0.1 * np.eye(n)
    sign, logdet64 = np.linalg.slogdet(K)
    assert sign > 0
    ld = float(chol.logdet())
    assert abs(ld - logdet64) < 1e-3 * abs(logdet64) + 1e-2
