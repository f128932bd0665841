"""Elastic recovery: checkpointed HMC resumes bit-identically
(SURVEY.md §5 failure-detection row; closes the r1 'nothing built' gap)."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_transportation_tpu.parallel import samplers
from gaussian_process_transportation_tpu.parallel.checkpointed import (
    run_hmc_checkpointed,
)


def _logprob(q):
    return -0.5 * jnp.sum(q**2) - 0.1 * jnp.sum(q**4)


def _inits(C=4, D=3):
    return jnp.asarray(np.random.RandomState(0).randn(C, D) * 0.5)


COMMON = dict(num_warmup=40, num_samples=60, num_leapfrog=8)


def test_segmented_matches_monolithic(tmp_path):
    """Same PRNG stream as hmc(); only XLA fusion noise (amplified by the
    chaotic leapfrog) separates different-jit-boundary programs — bitwise
    equality across IDENTICAL segmenting is asserted in the resume test."""
    inits = _inits()
    key = jax.random.PRNGKey(7)

    mono = jax.vmap(
        lambda q0, k: samplers.hmc(_logprob, q0, k, **COMMON)[0]
    )(inits, jax.random.split(key, inits.shape[0]))

    seg, _ = run_hmc_checkpointed(
        _logprob, inits, key, str(tmp_path / "run"), segment=25, **COMMON
    )
    assert np.allclose(np.asarray(seg), np.asarray(mono), atol=1e-2), np.abs(
        np.asarray(seg) - np.asarray(mono)
    ).max()


def test_resume_after_kill(tmp_path):
    """Simulate preemption: run only the warmup+first segment (by a
    truncated num_samples trick we instead interrupt by running a partial
    helper), then a NEW process-like call must pick up the checkpoint and
    produce the identical final stream."""
    inits = _inits()
    key = jax.random.PRNGKey(7)
    path = str(tmp_path / "run")

    # full uninterrupted reference with the SAME segmenting (bit-identical
    # programs; only the kill/restart differs)
    full, _ = run_hmc_checkpointed(
        _logprob, inits, key, str(tmp_path / "ref"), segment=20, **COMMON
    )

    # "crashed" run: monkey-set segment so only one segment completes, by
    # calling with num_samples=20 first... instead simply run the real API
    # with segment=20 but stop after the first save by raising from a
    # wrapped dynamic_update_slice? Simplest honest kill: run a copy with
    # num_samples=20 (writes a checkpoint with done=20 and a short buffer),
    # then rewrite the buffer length by re-saving — exercised through the
    # public API below instead:
    # first call: completes 20 of 60 by segment carving
    import gaussian_process_transportation_tpu.parallel.checkpointed as cp

    orig_save = cp._save
    calls = {"n": 0}

    def killing_save(*a, **kw):
        orig_save(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:  # after warmup ckpt + first segment ckpt
            raise KeyboardInterrupt("simulated preemption")

    cp._save = killing_save
    try:
        run_hmc_checkpointed(_logprob, inits, key, path, segment=20, **COMMON)
        raise AssertionError("expected simulated preemption")
    except KeyboardInterrupt:
        pass
    finally:
        cp._save = orig_save

    meta_done = 20
    assert os.path.exists(path + ".ckpt.npz")

    # restart: must resume from done=20 and finish identically
    resumed, _ = run_hmc_checkpointed(
        _logprob, inits, key, path, segment=20, **COMMON
    )
    assert np.array_equal(np.asarray(resumed), np.asarray(full))


# ---------------------------------------------------------------------------
# Fused production sampler (hmc_batched)
# ---------------------------------------------------------------------------

def _lp_and_grad_batched(q):
    """Ensemble-last analytic value+grad of the same quartic target:
    q (T, E) -> (lp (E,), grad (T, E)) — stands in for the batched
    LML kernel, including the finite-guards the production wrappers apply
    (`samplers._fused_local_runner`): an unguarded diverging leapfrog can
    reach q=inf -> lp=NaN -> NaN step-size adaptation."""
    lp = -0.5 * jnp.sum(q**2, axis=0) - 0.1 * jnp.sum(q**4, axis=0)
    grad = -q - 0.4 * q**3
    bad = ~jnp.isfinite(lp)
    lp = jnp.where(bad, -1e10, lp)
    grad = jnp.where(jnp.isfinite(grad) & ~bad[None, :], grad, 0.0)
    return lp, grad


BATCHED = dict(num_warmup=40, num_samples=60, num_leapfrog=8)


def _batched_inits(T=3, E=8):
    return jnp.asarray(np.random.RandomState(1).randn(T, E) * 0.5)


def test_batched_segmented_matches_monolithic():
    """Segmented hmc_batched_sample_range = monolithic hmc_batched
    bit-exactly: per-step keys are fold_in(chain_key, phase, s), so the
    stream does not depend on segment boundaries (unlike jit-boundary
    fusion noise, the draws themselves are identical; on CPU the arithmetic
    is too)."""
    from gaussian_process_transportation_tpu.parallel.checkpointed import (
        run_hmc_batched_checkpointed,
    )
    import tempfile

    inits = _batched_inits()
    key = jax.random.PRNGKey(3)

    mono, info_m = samplers.hmc_batched(
        _lp_and_grad_batched, inits, key=key, **BATCHED
    )
    with tempfile.TemporaryDirectory() as d:
        seg, info_s = run_hmc_batched_checkpointed(
            _lp_and_grad_batched, inits, key, os.path.join(d, "run"),
            segment=25, **BATCHED
        )
    # jit-boundary fusion noise amplified by the chaotic leapfrog, same as
    # the vmapped test above — bitwise equality across IDENTICAL segmenting
    # is asserted in test_batched_resume_after_kill
    assert np.allclose(np.asarray(seg), np.asarray(mono), atol=1e-2), np.abs(
        np.asarray(seg) - np.asarray(mono)
    ).max()
    acc_m = np.asarray(info_m["mean_accept"])
    assert np.isfinite(acc_m).all() and acc_m.min() > 0.2
    assert np.allclose(np.asarray(info_s["mean_accept"]), acc_m, atol=1e-2)
    # chains actually explore (a stuck sampler would also be "bit-equal")
    assert np.asarray(seg).std(axis=1).min() > 0.05


def test_batched_resume_after_kill(tmp_path):
    """Kill the fused checkpointed run after its first sampling segment;
    the restarted run must resume from the checkpoint and produce the
    bit-identical final stream."""
    from gaussian_process_transportation_tpu.parallel.checkpointed import (
        run_hmc_batched_checkpointed,
    )
    import gaussian_process_transportation_tpu.parallel.checkpointed as cp

    inits = _batched_inits()
    key = jax.random.PRNGKey(3)
    path = str(tmp_path / "run")

    full, _ = run_hmc_batched_checkpointed(
        _lp_and_grad_batched, inits, key, str(tmp_path / "ref"),
        segment=20, **BATCHED
    )

    orig_save = cp._save_batched
    calls = {"n": 0}

    def killing_save(*a, **kw):
        orig_save(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:  # after warmup ckpt + first segment ckpt
            raise KeyboardInterrupt("simulated preemption")

    cp._save_batched = killing_save
    try:
        run_hmc_batched_checkpointed(
            _lp_and_grad_batched, inits, key, path, segment=20, **BATCHED
        )
        raise AssertionError("expected simulated preemption")
    except KeyboardInterrupt:
        pass
    finally:
        cp._save_batched = orig_save

    assert os.path.exists(path + ".ckpt.npz")

    resumed, _ = run_hmc_batched_checkpointed(
        _lp_and_grad_batched, inits, key, path, segment=20, **BATCHED
    )
    assert np.array_equal(np.asarray(resumed), np.asarray(full))
