"""Worker for the 2-process jax.distributed CPU test (run by
``tests/test_multihost.py``; argv: process_id num_processes port).

Each process forces the CPU platform (through jax.config, which wins over
any JAX_PLATFORMS setting or plugin), carves virtual
devices, joins a 2-process cluster, and runs the production multi-host
paths — ``multihost_mesh`` + ``transport_ensemble`` +
``make_ensemble_train_step`` + ``sample_gp_posterior`` — asserting the
globally-sharded results equal a locally computed single-process golden.
"""
import os
import sys

import time

_t0 = time.perf_counter()


def _stage(msg):
    print(f"[worker {sys.argv[1]} +{time.perf_counter()-_t0:6.1f}s] {msg}",
          flush=True)


flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=2").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# both workers trace/compile the same programs — the persistent cache makes
# one process reuse the other's compiles (and reruns nearly compile-free)
from gaussian_process_transportation_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np
import jax.numpy as jnp

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from gaussian_process_transportation_tpu.parallel import distributed

_stage("imports done; joining cluster")
distributed.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.device_count() == 2 * nproc, jax.device_count()
_stage("cluster up")

from jax.experimental import multihost_utils

from gaussian_process_transportation_tpu import kernels as K
from gaussian_process_transportation_tpu.parallel import (
    ensemble as ens_mod,
    samplers,
)
from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

mesh = distributed.multihost_mesh(n_data_per_host=1)
assert mesh.devices.shape == (2 * nproc, 1), mesh.devices.shape
# the 'data' axis must never cross the process (DCN) boundary
procs = np.vectorize(lambda d: d.process_index)(mesh.devices)
for row in procs:
    assert len(set(row.tolist())) == 1, procs

E = 2 * nproc
rng = np.random.default_rng(0)
t = np.linspace(0, 1, 60)
traj = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
delta = np.zeros_like(traj)
delta[:-1] = np.diff(traj, axis=0)
s = np.linspace(0, 1, 20)
source = np.stack([10 * s, -2 + 0 * s], 1)
shifts = np.linspace(0.0, 1.0, E)
targets = source[None] + np.stack(
    [np.zeros_like(s), np.sin(2 * s)], 1
)[None] + shifts[:, None, None]

kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.01)

# ---- 1. transport ensemble: sharded == local unsharded vmap ------------
_stage("stage 1: transport ensemble")
golden = jax.jit(
    lambda tg: gpt_mod.fit_and_transport_batched(
        kernel, jnp.asarray(source), tg, jnp.asarray(traj), jnp.asarray(delta)
    )
)(jnp.asarray(targets))
sharded = ens_mod.transport_ensemble(
    kernel, jnp.asarray(source), jnp.asarray(targets), jnp.asarray(traj),
    jnp.asarray(delta), mesh=mesh,
)
for name in ("traj", "delta", "std", "delta_var"):
    a = multihost_utils.process_allgather(getattr(sharded, name), tiled=True)
    b = np.asarray(getattr(golden, name))
    assert np.allclose(a, b, atol=1e-9, rtol=1e-9), (
        name, np.abs(a - b).max())

# ---- 2. ensemble hyperparameter train step -----------------------------
_stage("stage 2: ensemble train step")
step, opt = ens_mod.make_ensemble_train_step(kernel)
sources_E = np.broadcast_to(source, (E,) + source.shape)

theta_g = kernel.theta
state_g = opt.init(theta_g)
for _ in range(3):
    theta_g, state_g, loss_g = step(theta_g, state_g, jnp.asarray(sources_E),
                                    jnp.asarray(targets))

from gaussian_process_transportation_tpu.parallel.mesh import (
    ensemble_sharding, global_put)

src_sh = global_put(sources_E, ensemble_sharding(mesh))
tgt_sh = global_put(targets, ensemble_sharding(mesh))
theta_s = kernel.theta
state_s = opt.init(theta_s)
for _ in range(3):
    theta_s, state_s, loss_s = step(theta_s, state_s, src_sh, tgt_sh)
theta_s = multihost_utils.process_allgather(theta_s, tiled=True)
assert np.allclose(np.asarray(theta_s), np.asarray(theta_g), atol=1e-9), (
    np.asarray(theta_s), np.asarray(theta_g))
loss_s = multihost_utils.process_allgather(loss_s, tiled=True)
assert np.isclose(float(loss_s), float(loss_g), atol=1e-9)

# ---- 3. one sharded HMC round over kernel hyperposterior ----------------
# n_data=12 keeps the unrolled small-N LML inside the leapfrog tiny — two
# processes compile this program simultaneously on CI boxes with few cores
_stage("stage 3: sharded HMC")
Xs = rng.standard_normal((12, 2))
Ys = np.sin(Xs[:, :1]) + 0.1 * rng.standard_normal((12, 1))
# equality gate on the GENERIC vmapped sampler (fused=False); the fused
# path's sharded equality is unit-tested on one process
# (test_fused_lml.py::test_sample_gp_posterior_sharded_bit_identical)
samples, diags = samplers.sample_gp_posterior(
    kernel, jnp.asarray(Xs), jnp.asarray(Ys), jax.random.PRNGKey(0),
    num_chains=E, num_warmup=10, num_samples=10, mesh=mesh, fused=False,
)
samples_g, _ = samplers.sample_gp_posterior(
    kernel, jnp.asarray(Xs), jnp.asarray(Ys), jax.random.PRNGKey(0),
    num_chains=E, num_warmup=10, num_samples=10, mesh=None, fused=False,
)
a = multihost_utils.process_allgather(samples, tiled=True)
assert np.allclose(a, np.asarray(samples_g), atol=1e-9), np.abs(
    a - np.asarray(samples_g)).max()
assert np.isfinite(a).all()

# the fused ensemble-last path on the same multi-process mesh: plumbing +
# finiteness (statistical equivalence is gated in test_fused_lml.py)
samples_f, _ = samplers.sample_gp_posterior(
    kernel, jnp.asarray(Xs), jnp.asarray(Ys), jax.random.PRNGKey(0),
    num_chains=E, num_warmup=10, num_samples=10, mesh=mesh,
)
af = multihost_utils.process_allgather(samples_f, tiled=True)
assert af.shape == (E, 10, kernel.n_theta)
assert np.isfinite(af).all()

_stage("all stages passed")
print(f"MULTIHOST_OK process={pid}", flush=True)
