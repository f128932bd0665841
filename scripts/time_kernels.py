"""Time the GPU forms of the operations whose hand-written kernels were replaced,
at the shapes the package runs: the batched small SPD inverse, dense vs
panel Gram+Cholesky+solve, dense-grid predict with std, the per-lane
small-n LML value+grad, and the two loops built on it (HMC and the
per-member L-BFGS).

    python scripts/time_kernels.py [--out chiprun_out/time_kernels.json]

Each timing is the median over ``--reps`` runs of a warm, compiled call
ending in ``block_until_ready``; compile time of the first call is
reported separately.  Needs a GPU: exits non-zero on any other platform.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def timed(fn, *args, reps=5):
    """(compile+first seconds, median warm seconds) of fn(*args)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/time_kernels.json")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", help="sections to run (default: all)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"needs a GPU, found {jax.devices()[0].platform!r}")
    from gaussian_process_transportation_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as core
    from gaussian_process_transportation_tpu.ops import batched_linalg as bl
    from gaussian_process_transportation_tpu.ops import blocked_chol as bc
    from gaussian_process_transportation_tpu.ops import fused_lml as fl
    from gaussian_process_transportation_tpu.ops.linalg import cho_solve_lower
    from gaussian_process_transportation_tpu.parallel import samplers

    card = gpu_name_and_limit()
    print(f"card: {card}", flush=True)
    rows = []

    def record(name, shape, first, warm, **extra):
        row = dict(name=name, shape=shape, compile_first_s=round(first, 3),
                   warm_ms=round(warm * 1e3, 4), **extra)
        rows.append(row)
        print(json.dumps(row), flush=True)

    rng = np.random.default_rng(0)
    H = jax.lax.Precision.HIGHEST
    n = 20
    Xs = jnp.asarray(rng.standard_normal((n, 2)).astype(np.float32))
    Ys = jnp.sin(Xs[:, :1])
    L = 256 * 7
    Xe = jnp.asarray(rng.standard_normal((L, n, 2)).astype(np.float32))
    Ye = jnp.sin(Xe[:, :, :1])

    def spd():
        """SPD inverse of (E, n, n), the transport fit stage."""
        E = 16384
        A = rng.standard_normal((E, n, n)).astype(np.float32)
        Kb = jnp.asarray(np.einsum("eij,ekj->eik", A, A) / n
                         + np.eye(n, dtype=np.float32))
        record("spd_inverse_batched_cusolver", [E, n, n],
               *timed(jax.jit(bl.spd_inverse), Kb, reps=args.reps))

    def chol():
        """Gram + Cholesky + solve: dense cuSOLVER vs the panel form."""
        kern = K.Constant(2.0) * K.RBF(jnp.ones(3, jnp.float32)) + K.White(0.1)

        def dense(X, Y):
            Kx = kern(X) + 1e-6 * jnp.eye(X.shape[0], dtype=X.dtype)
            return cho_solve_lower(jnp.linalg.cholesky(Kx), Y)

        def panels(X, Y):
            return bc.gram_cholesky_solve(
                X, Y, jnp.ones(3, jnp.float32), 2.0, 0.1 + 1e-6, block=512,
                precision=H, refine_iters=1,
            )[0]

        for N in (2500, 10240, 20000):
            X = jnp.asarray(rng.standard_normal((N, 3)).astype(np.float32))
            Y = jnp.asarray(rng.standard_normal((N, 3)).astype(np.float32))
            fd, fp = jax.jit(dense), jax.jit(panels)
            flops = N**3 / 3 + 2 * N * N * 3
            first, warm = timed(fd, X, Y, reps=args.reps)
            record("gram_chol_solve_dense", [N], first, warm,
                   tflops=flops / warm / 1e12)
            first, warm = timed(fp, X, Y, reps=args.reps)
            a_d, a_p = np.asarray(fd(X, Y)), np.asarray(fp(X, Y))
            record("gram_chol_solve_panels_b512", [N], first, warm,
                   tflops=flops / warm / 1e12,
                   rel_diff_vs_dense=float(np.abs(a_d - a_p).max() / np.abs(a_d).max()))

    def predict():
        """Dense-grid predict with std (Nq=10240, N=2048), XLA."""
        N, Nq = 2048, 10240
        X = jnp.asarray(rng.standard_normal((N, 2)).astype(np.float32))
        Xq = jnp.asarray(rng.standard_normal((Nq, 2)).astype(np.float32))
        kern = K.Constant(2.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.05)
        f_pr = jax.jit(lambda g, q: core.predict(g, q, return_std=True))
        for cache in (False, True):
            gp = core.condition(kern, X, jnp.sin(X), cache_k_inv=cache)
            record(f"predict_mean_std_xla_{'kinv' if cache else 'trisolve'}",
                   [Nq, N], *timed(f_pr, gp, Xq, reps=args.reps))

    def lml():
        """Per-lane small-LML value+grad at 256 shared-data lanes and at
        1792 per-lane-data lanes (256 members × 7 restarts)."""
        th = jnp.asarray(rng.uniform(-1, 1, (4, 256)).astype(np.float32))
        f = jax.jit(lambda t: fl.small_lml_value_grad(Xs, Ys, t, n_ls=2))
        record("small_lml_per_lane_xla", [256, n], *timed(f, th, reps=args.reps))
        th = jnp.asarray(rng.uniform(-1, 1, (4, L)).astype(np.float32))
        f = jax.jit(lambda t: fl.small_lml_value_grad_md(Xe, Ye, t, n_ls=2))
        record("small_lml_md_per_lane_xla", [L, n], *timed(f, th, reps=args.reps))

    def e2e():
        """End to end: HMC (256 chains, 48+48) and per-member L-BFGS
        (E=256, R=7, 30 iterations)."""
        kern = K.Constant(1.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.01)
        hmc = lambda key: samplers.sample_gp_posterior(
            kern, Xs, Ys, key, num_chains=256, num_warmup=48, num_samples=48)[0]
        record("hmc_256ch_48w48s", [256, n],
               *timed(hmc, jax.random.PRNGKey(0), reps=3))
        f = jax.jit(lambda x, y: core.fit_ensemble_fused(
            kern, x, y, n_restarts=6, maxiter=30))
        record("fit_ensemble_E256_R7_it30", [256, n],
               *timed(f, Xe[:256], Ye[:256], reps=3))

    sections = dict(spd=spd, chol=chol, predict=predict, lml=lml, e2e=e2e)
    for name in (args.only or list(sections)):
        try:
            sections[name]()
        except Exception as e:  # keep measuring the other sections
            rows.append(dict(name=name, error=repr(e)[:2000]))
            print(f"section {name} failed: {e!r}"[:2000], flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "device_kind": jax.devices()[0].device_kind,
                   "jax": jax.__version__, "rows": rows}, fh, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
