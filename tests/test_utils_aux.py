"""Aux subsystems: config, artifact store, logging/metrics."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussian_process_transportation_tpu.utils import config as cfg
from gaussian_process_transportation_tpu.utils import artifacts
from gaussian_process_transportation_tpu.utils.logging_utils import MetricsRecorder, timed
from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.models import exact_gp as core

rng = np.random.RandomState(3)


def test_kernel_config_roundtrip():
    c = cfg.surface_2d_transport_config()
    k = c.kernel.build()
    expected = K.Constant(10.0) * K.RBF(jnp.asarray([4.0, 4.0])) + K.White(0.01)
    X = jnp.asarray(rng.randn(6, 2))
    np.testing.assert_allclose(np.asarray(k(X)), np.asarray(expected(X)), atol=1e-12)
    # json roundtrip
    c2 = cfg.KernelConfig.from_json(c.kernel.to_json())
    np.testing.assert_allclose(np.asarray(c2.build()(X)), np.asarray(expected(X)), atol=1e-12)


def test_dynamics_config_matches_reference_kernel():
    k = cfg.dynamics_2d_config().build()
    expected = K.Constant(float(np.sqrt(0.1))) * K.Matern(jnp.ones(2), nu=2.5) + K.White(0.01)
    X = jnp.asarray(rng.randn(5, 2))
    np.testing.assert_allclose(np.asarray(k(X)), np.asarray(expected(X)), atol=1e-12)


def test_artifact_store_roundtrip_gp_state(tmp_path):
    """A fitted GP checkpoints and resumes exactly — the capability the
    reference lacks (it refits from data every run)."""
    X = rng.randn(20, 2)
    Y = np.sin(X)
    kern = K.Constant(1.0) * K.RBF(jnp.ones(2)) + K.White(0.05)
    gp = core.condition(kern, jnp.asarray(X), jnp.asarray(Y))

    store = artifacts.ArtifactStore(str(tmp_path))
    v = store.save("delta_map", gp, metadata={"workload": "test"})
    assert v == 1
    gp2 = store.load("delta_map", like=gp)
    xq = jnp.asarray(rng.randn(7, 2))
    np.testing.assert_allclose(
        np.asarray(core.predict(gp2, xq)), np.asarray(core.predict(gp, xq)), atol=1e-12
    )
    # versioning
    v2 = store.save("delta_map", gp)
    assert v2 == 2 and store.latest_version("delta_map") == 2


def test_artifact_metadata(tmp_path):
    artifacts.save_pytree(str(tmp_path / "x"), {"a": jnp.ones(3)}, metadata={"k": 1})
    assert artifacts.load_metadata(str(tmp_path / "x")) == {"k": 1}


def test_metrics_recorder(tmp_path):
    rec = MetricsRecorder()
    with timed("block", rec):
        pass
    rec.record("loss", 1.5)
    rec.record("loss", 1.0)
    assert rec.last("loss") == 1.0
    rec.dump(str(tmp_path / "metrics.json"))
    import json

    data = json.load(open(tmp_path / "metrics.json"))
    assert len(data["loss"]) == 2 and "time/block" in data


def test_package_sets_accurate_matmul_precision():
    """Importing the package must pin float32-accurate matmuls: TF32/bf16
    passes corrupt the Gram matrix into non-PSD (Cholesky NaNs)."""
    import gaussian_process_transportation_tpu  # noqa: F401

    assert str(jax.config.jax_default_matmul_precision) == "highest"


def test_sampler_chain_checkpoint_resume(tmp_path):
    """NUTS/HMC chains checkpoint into the artifact store and resume
    exactly (the checkpoint/resume capability of SURVEY §5)."""
    import numpy as np
    from gaussian_process_transportation_tpu.parallel import samplers

    lp = lambda x: -0.5 * jnp.sum(x**2)
    samples1, _ = samplers.hmc(lp, jnp.zeros(2), jax.random.PRNGKey(0),
                               num_warmup=50, num_samples=30, num_leapfrog=8)
    store = artifacts.ArtifactStore(str(tmp_path))
    store.save("chains", {"samples": samples1, "last": samples1[-1]})
    loaded = store.load("chains", like={"samples": samples1, "last": samples1[-1]})
    np.testing.assert_array_equal(np.asarray(loaded["samples"]), np.asarray(samples1))
    # resume: continue sampling from the checkpointed last state
    samples2, _ = samplers.hmc(lp, jnp.asarray(loaded["last"]), jax.random.PRNGKey(1),
                               num_warmup=10, num_samples=30, num_leapfrog=8)
    assert np.isfinite(np.asarray(samples2)).all()
