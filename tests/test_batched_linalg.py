"""SPD inverse of batches of small matrices (``ops/batched_linalg.py``)
against numpy — the transport fit stage of ``transport/gpt.py``."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu.ops.batched_linalg import spd_inverse


def _spd_batch(n, E, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    K = np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)
    return K


@pytest.mark.parametrize("n,E,lanes", [(20, 70, 64), (7, 129, 128), (32, 64, 64)])
def test_fused_matches_unrolled_and_numpy(n, E, lanes):
    """Factor and inverse in float32 against numpy float64, eager and
    under jit."""
    K = _spd_batch(n, E)
    L, Ki = spd_inverse(jnp.asarray(K))
    L2, Ki2 = jax.jit(spd_inverse)(jnp.asarray(K))
    np.testing.assert_allclose(np.asarray(L2), np.asarray(L), atol=1e-5)
    np.testing.assert_allclose(np.asarray(Ki2), np.asarray(Ki), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(L), np.linalg.cholesky(K.astype(np.float64)), atol=2e-5)
    ref = np.linalg.inv(K.astype(np.float64))
    assert np.abs(np.asarray(Ki) - ref).max() < 1e-4


def test_fused_lower_triangular_and_reconstruction():
    n, E = 12, 40
    K = _spd_batch(n, E, seed=3)
    L, Ki = spd_inverse(jnp.asarray(K))
    Lb = np.asarray(L)
    assert np.allclose(Lb, np.tril(Lb)), "L must be lower-triangular"
    np.testing.assert_allclose(
        np.einsum("eij,ekj->eik", Lb, Lb), K, rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.einsum("eij,ejk->eik", np.asarray(Ki), K),
        np.broadcast_to(np.eye(n), K.shape), atol=1e-4,
    )


@pytest.mark.parametrize("n,E", [(1, 3), (9, 5), (20, 4)])
def test_elast_chain_matches_numpy(n, E):
    """The ensemble-last factor and triangular inverse against numpy
    float64, lane by lane."""
    from gaussian_process_transportation_tpu.ops.batched_linalg import (
        cholesky_elast, inv_lower_elast,
    )

    K = _spd_batch(n, E).astype(np.float64)
    L = cholesky_elast(jnp.asarray(np.moveaxis(K, 0, -1)))
    Li = np.moveaxis(np.asarray(inv_lower_elast(L)), -1, 0)
    L64 = np.linalg.cholesky(K)
    np.testing.assert_allclose(np.moveaxis(np.asarray(L), -1, 0), L64, atol=1e-10)
    np.testing.assert_allclose(Li, np.linalg.inv(L64), atol=1e-10)


def test_elast_chain_lane_count_invariant():
    """A lane's factor and inverse are the same bits whether 4 or 16 lanes
    share the call (float32, jitted)."""
    from gaussian_process_transportation_tpu.ops.batched_linalg import (
        cholesky_elast, inv_lower_elast,
    )

    Ke = jnp.asarray(np.moveaxis(_spd_batch(10, 16, seed=4), 0, -1))
    f = jax.jit(lambda k: inv_lower_elast(cholesky_elast(k)))
    np.testing.assert_array_equal(np.asarray(f(Ke))[..., :4], np.asarray(f(Ke[..., :4])))


@pytest.mark.parametrize("m", [1, 2, 7, 400])
def test_sum_lanes_matches_sum(m):
    from gaussian_process_transportation_tpu.ops.batched_linalg import sum_lanes

    x = np.random.default_rng(m).standard_normal((m, 5))
    np.testing.assert_allclose(np.asarray(sum_lanes(jnp.asarray(x))), x.sum(0),
                               rtol=1e-12, atol=1e-12)
