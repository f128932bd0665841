"""Mixed-precision blocked Cholesky + iterative refinement (ops/mixed_linalg).

CPU ignores jax.lax.Precision, so the low-precision error profile is
exercised via ``emulate_bf16`` (panel rounded through bfloat16 before the
trailing update).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.ops import mixed_linalg as mx
from gaussian_process_transportation_tpu.ops.linalg import add_diagonal, cho_solve_lower


def _spd(n, d=3, noise=0.1, seed=0, dtype=jnp.float64):
    key = jax.random.PRNGKey(seed)
    X = jax.random.normal(key, (n, d), dtype)
    kern = K.Constant(2.0) * K.RBF(jnp.ones(d, dtype)) + K.White(noise)
    return add_diagonal(kern(X), 1e-8), X, kern


@pytest.mark.parametrize("n,block", [(256, 64), (300, 128), (512, 512), (130, 64)])
def test_blocked_cholesky_matches_builtin(n, block):
    Km, _, _ = _spd(n)
    L = mx.blocked_cholesky(Km, block=block, syrk_precision="highest")
    Lref = jnp.linalg.cholesky(Km)
    np.testing.assert_allclose(np.asarray(L), np.asarray(Lref), rtol=1e-9, atol=1e-9)


def test_blocked_cholesky_reconstructs():
    Km, _, _ = _spd(320)
    L = mx.blocked_cholesky(Km, block=128)
    np.testing.assert_allclose(np.asarray(L @ L.T), np.asarray(Km), rtol=1e-9, atol=1e-9)
    # strictly lower: upper part must be zero
    assert float(jnp.abs(jnp.triu(L, 1)).max()) == 0.0


def test_pcg_recovers_accuracy_from_bf16_factor():
    # GP-realistic conditioning (kappa ~ 1.7e3): fixed-point IR DIVERGES here
    # (measured contraction rho ~ 2.6) — PCG must still converge.
    Km, _, _ = _spd(384, noise=0.1, dtype=jnp.float32)
    Km = Km.astype(jnp.float64)
    B = jax.random.normal(jax.random.PRNGKey(1), (384, 3), jnp.float64)
    L_lo = mx.blocked_cholesky(Km, block=128, emulate_bf16=True)
    assert bool(jnp.isfinite(L_lo).all())
    # the low-precision factor alone is visibly wrong ...
    x_lo = cho_solve_lower(L_lo, B)
    x_ref = cho_solve_lower(jnp.linalg.cholesky(Km), B)
    err_lo = float(jnp.linalg.norm(x_lo - x_ref) / jnp.linalg.norm(x_ref))
    assert err_lo > 1e-6
    # ... PCG refinement restores it
    x_ir, rel = mx.pcg_solve(Km, L_lo, B, iters=30)
    err_ir = float(jnp.linalg.norm(x_ir - x_ref) / jnp.linalg.norm(x_ref))
    assert float(rel) < 1e-10
    assert err_ir < 1e-8


def test_ir_solve_converges_when_well_conditioned():
    Km, _, _ = _spd(256, noise=1.0)  # big noise floor → small kappa
    B = jax.random.normal(jax.random.PRNGKey(3), (256, 2), jnp.float64)
    L_lo = mx.blocked_cholesky(Km, block=128, emulate_bf16=True)
    x, rel = mx.ir_solve(Km, L_lo, B, sweeps=5)
    assert float(rel) < 1e-9


def test_gram_chol_solve_mixed_end_to_end():
    n = 320
    Km, X, kern = _spd(n)
    Y = jax.random.normal(jax.random.PRNGKey(2), (n, 2), jnp.float64)
    alpha, L, rel = mx.gram_chol_solve_mixed(
        kern, X, Y, jitter=1e-8, block=128, emulate_bf16=True, iters=30
    )
    assert float(rel) < 1e-9
    alpha_ref = cho_solve_lower(jnp.linalg.cholesky(Km), Y)
    np.testing.assert_allclose(np.asarray(alpha), np.asarray(alpha_ref), rtol=1e-6, atol=1e-8)


def test_blocked_cholesky_jits_and_grids():
    # must stay a single traceable program
    Km, _, _ = _spd(256, dtype=jnp.float32)
    f = jax.jit(lambda A: mx.blocked_cholesky(A, block=64))
    L = f(Km)
    assert bool(jnp.isfinite(L).all())
