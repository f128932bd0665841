"""Large-N exact-GP hyperparameter optimization through the panel LML.

The reference caps its active-learning exact GP at 20 000 training points
(``policy_transportation/models/gaussian_process_al.py:16``) because
sklearn's dense L-BFGS fit is minutes per restart there; above the cap it
throws data away (greedy subset selection) and still fits only the subset.
This example runs the same workload shape — a dense surface-scan point
cloud regressed to heights + greedy subset selection — but the hyperopt is
``models.exact_gp.fit_blocked``: compiled L-BFGS whose value-and-grad is
the closed-form panel LML (``ops/blocked_lml.py``).

Run:  python examples/large_n_hyperopt.py [--cpu] [--n 2048] [--cap 1024]
      (defaults sized for --cpu; on a GPU try --n 40000 --cap 16384)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--n", type=int, default=2048, help="raw point-cloud size")
    p.add_argument("--cap", type=int, default=1024, help="active-learning cap")
    p.add_argument("--maxiter", type=int, default=15)
    p.add_argument("--block", type=int, default=0, help="panel width (0 = auto)")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as core
    from gaussian_process_transportation_tpu.models.gp_active import (
        GaussianProcessActiveLearning,
    )

    block = args.block or (512 if jax.devices()[0].platform == "gpu" else 128)

    # synthetic cleaning-surface scan: wavy height field + sensor noise
    # (the reference's surface pointcloud detector workload shape)
    rng = np.random.default_rng(0)
    Xy = rng.uniform(-3.0, 3.0, (args.n, 2)).astype(np.float32)
    z = (
        0.6 * np.sin(1.3 * Xy[:, :1]) * np.cos(0.9 * Xy[:, 1:2])
        + 0.2 * np.sin(3.1 * Xy[:, 1:2])
        + 0.05 * rng.standard_normal((args.n, 1))
    ).astype(np.float32)

    kernel = (
        K.Constant(1.0, bounds=(1e-3, 1e3))
        * K.RBF(jnp.ones(2, jnp.float32), bounds=(1e-2, 1e2))
        + K.White(0.5, bounds=(1e-6, 1e1))
    )

    model = GaussianProcessActiveLearning(
        kernel,
        n_samples_max=args.cap,
        use_blocked=True,
        blocked_kwargs=dict(block=block, maxiter=args.maxiter),
    )
    t0 = time.perf_counter()
    model.fit(Xy, z)
    fit_s = time.perf_counter() - t0
    gp = model.state

    mean, std = model.predict(Xy[:512])
    rmse = float(np.sqrt(np.mean((np.asarray(mean) - z[:512]) ** 2)))
    c = gp.kernel
    print(
        f"n={args.n} -> subset {gp.X.shape[0]} (cap {args.cap}), "
        f"fit_blocked {args.maxiter} L-BFGS iters in {fit_s:.1f}s"
    )
    print(
        f"fitted: amp={float(c.k1.k1.constant_value):.3f} "
        f"ls={np.asarray(c.k1.k2.lengthscale).round(3)} "
        f"noise={float(c.k2.noise_level):.4f} (true noise var 0.0025)"
    )
    print(
        f"rmse={rmse:.4f}  mean|std|={float(jnp.mean(std)):.4f}  "
        f"factor form: {'panel (no dense L)' if gp.chol is not None else 'dense'}"
    )
    assert np.isfinite(rmse) and rmse < 0.2


if __name__ == "__main__":
    main()
