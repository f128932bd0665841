"""Pod-scale capabilities demo: sharded transport ensembles + NUTS
hyperparameter chains (the new first-class layers, SURVEY.md §2d).

Runs on whatever devices exist — one GPU, the GPUs of one host, or a
virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8).

Run:  python examples/pod_scale_ensembles.py [--cpu] [--members 4096]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--members", type=int, default=1024)
    p.add_argument("--chains", type=int, default=8)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.parallel import (
        make_mesh,
        transport_ensemble,
        posterior_transport_ensemble,
    )
    from gaussian_process_transportation_tpu.parallel.samplers import sample_gp_posterior

    devs = jax.devices()
    n_data = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    mesh = make_mesh(n_ens=len(devs) // n_data, n_data=n_data)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} on {devs[0].platform}")

    t = np.linspace(0, 1, 200, dtype=np.float32)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    s = np.linspace(0, 1, 20, dtype=np.float32)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2, jnp.float32)) + K.White(0.01)

    import time

    # 1) E-member multi-target transport ensemble, sharded over 'ens'
    E = args.members
    shifts = jnp.linspace(0, 2, E, dtype=jnp.float32)
    targets = jnp.asarray(S1)[None] + shifts[:, None, None]
    with mesh:
        t0 = time.time()
        res = transport_ensemble(kernel, jnp.asarray(S), targets, jnp.asarray(X), jnp.asarray(dX), mesh=mesh)
        jax.block_until_ready(res)
        t1 = time.time()
        res = transport_ensemble(kernel, jnp.asarray(S), targets, jnp.asarray(X), jnp.asarray(dX), mesh=mesh)
        jax.block_until_ready(res)
        dt = time.time() - t1
    print(f"transport ensemble: E={E} members, compile {t1-t0:.1f}s, steady {dt*1e3:.0f}ms "
          f"→ {E/dt:.0f} transported trajectories/s")

    # 2) posterior-draw particle ensemble (SMC-style particle set)
    with mesh:
        particles = posterior_transport_ensemble(
            kernel, jnp.asarray(S), jnp.asarray(S1), jnp.asarray(X),
            jax.random.PRNGKey(0), n_members=E, mesh=mesh,
        )
        jax.block_until_ready(particles)
    print(f"posterior particles: {particles.shape}")

    # 3) NUTS/HMC hyperparameter chains sharded over the mesh
    kb = (K.Constant(1.0, bounds=(0.01, 100.0)) * K.RBF(jnp.ones(2), bounds=(0.5, 50.0))
          + K.White(0.05, bounds=(1e-4, 1.0)))
    t0 = time.time()
    samples, diags = sample_gp_posterior(
        kb, jnp.asarray(S), jnp.asarray(S1 - S), jax.random.PRNGKey(1),
        num_chains=args.chains, num_warmup=200, num_samples=200, mesh=mesh,
    )
    dt = time.time() - t0
    total = samples.shape[0] * samples.shape[1]
    print(f"HMC: {samples.shape[0]} chains × {samples.shape[1]} samples in {dt:.1f}s "
          f"→ {total/dt:.0f} samples/s; R̂ = {np.asarray(diags['rhat']).round(3)}")


if __name__ == "__main__":
    main()
