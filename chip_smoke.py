"""Smoke test of the GP transport path on one GPU, through the package's
own entry points, at the reference workloads' real sizes.

    python chip_smoke.py                # phases a-g on one GPU
    python chip_smoke.py --devices 4    # only the four-GPU mesh phase

Data is generated from ``--seed``.  Every phase prints what it compares,
against what, the tolerance and the matmul precision; any failed phase
makes the script exit non-zero.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``,
printed only when every phase passed.  There is no CPU fallback.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PREC = "f32 storage, matmul precision HIGHEST"


def log(msg):
    print(msg, flush=True)


class Checks:
    """Collects comparisons; a failed one fails its phase."""

    def __init__(self):
        self.failed = []

    def le(self, phase, what, value, tol):
        ok = bool(np.isfinite(value)) and value <= tol
        log(f"  [{phase}] {what}: {value:.3e} (tol {tol:.1e}; {PREC}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{phase}: {what} = {value:.3e} > {tol:.1e}")

    def true(self, phase, what, cond):
        log(f"  [{phase}] {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            raise AssertionError(f"{phase}: {what}")


# ---------------------------------------------------------------------------
# float64 numpy references
# ---------------------------------------------------------------------------


def curve_2d(n_traj=400, n_dist=20):
    """The bench's synthetic 2-D drawing: demo X, velocity dX, source S and
    target S1 distributions."""
    t = np.linspace(0, 1, n_traj)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, n_dist)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def kabsch_f64(S, T):
    cs, ct = S.mean(0), T.mean(0)
    U, _, Vt = np.linalg.svd((S - cs).T @ (T - ct))
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V[:, -1] *= -1
        R = V @ U.T
    return R, cs, ct


def rbf_f64(A, B, amp, ls):
    d2 = (((A[:, None, :] - B[None, :, :]) / ls) ** 2).sum(-1)
    return amp * np.exp(-0.5 * d2)


def transport_f64(X, dX, S, T, amp, ls, noise, jitter):
    """Reference pipeline in f64 (Kabsch γ + GP residual Ψ, fixed
    hyperparameters): transported positions and velocities."""
    R, cs, ct = kabsch_f64(S, T)
    g = lambda x: (x - cs) @ R.T + ct
    Sg, Xg = g(S), g(X)
    Km = rbf_f64(Sg, Sg, amp, ls) + (noise + jitter) * np.eye(len(S))
    alpha = np.linalg.solve(Km, T - Sg)
    ks = rbf_f64(Xg, Sg, amp, ls)                                # (Q, N)
    traj = Xg + ks @ alpha
    diff = (Sg[None, :, :] - Xg[:, None, :]) / ls**2             # (Q, N, D)
    J_psi = np.einsum("qnd,qn,np->qpd", diff, ks, alpha)         # (Q, P, D)
    J_phi = R[None] + J_psi @ R[None]
    vel = np.einsum("qpd,qd->qp", J_phi, dX)
    return traj, vel


def lml_grad_f64(X, Y, theta, jitter=1e-10):
    """LML and its gradient in θ = (log amp, log ℓ₁, log ℓ₂, log noise),
    the trace identity ½⟨ααᵀ − P·K⁻¹, ∂K/∂θ⟩ in f64."""
    amp, l1, l2, noise = np.exp(theta)
    ls = np.array([l1, l2])
    phi = rbf_f64(X, X, 1.0, ls)
    Km = amp * phi + (noise + jitter) * np.eye(len(X))
    Ki = np.linalg.inv(Km)
    a = Ki @ Y
    n, p = Y.shape
    val = (-0.5 * np.sum(Y * a) - 0.5 * p * np.linalg.slogdet(Km)[1]
           - 0.5 * p * n * np.log(2 * np.pi))
    W = 0.5 * (a @ a.T - p * Ki)
    g = [np.sum(W * amp * phi)]
    for d in range(2):
        d2 = ((X[:, None, d] - X[None, :, d]) / ls[d]) ** 2
        g.append(np.sum(W * amp * phi * d2))
    g.append(noise * np.trace(W))
    return val, np.array(g)


def lml_f64(X, Y, amp, ls, noise, jitter):
    Km = rbf_f64(X, X, amp, ls) + (noise + jitter) * np.eye(len(X))
    L = np.linalg.cholesky(Km)
    a = np.linalg.solve(Km, Y)
    n, p = Y.shape
    return (-0.5 * np.sum(Y * a) - p * np.sum(np.log(np.diag(L)))
            - 0.5 * p * n * np.log(2 * np.pi))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_b_facade(C, seed):
    import jax.numpy as jnp
    import gaussian_process_transportation_tpu as gpt
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models.exact_gp import small_lml_theta_layout

    Xc, dXc, Sc, S1c = curve_2d()
    X = gpt.resample(jnp.asarray(Xc, jnp.float32), num_points=400)
    S = gpt.resample(jnp.asarray(Sc, jnp.float32), num_points=20)
    S1 = gpt.resample(jnp.asarray(S1c, jnp.float32), num_points=20)
    dX = jnp.zeros_like(X).at[:-1].set(jnp.diff(X, axis=0))
    k = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2)) + K.White(0.01)
    tr = gpt.GaussianProcessTransportation(kernel_transport=k)
    tr.source_distribution, tr.target_distribution = S, S1
    tr.training_traj, tr.training_delta = X, dX
    tr.fit_transportation()          # L-BFGS hyperparameter fit (restarts)
    tr.apply_transportation()
    traj, std = np.asarray(tr.training_traj), np.asarray(tr.std)
    C.true("b", "transported demo finite, shape (400, 2)",
           traj.shape == (400, 2) and np.isfinite(traj).all()
           and np.isfinite(np.asarray(tr.training_delta)).all())
    C.true("b", "std finite", np.isfinite(std).all())
    C.true("b", "map is diffeomorphic", bool(tr.method.is_diffeomorphic))
    moved = float(np.abs(traj - np.asarray(X)).mean())
    C.true("b", f"demo moved (mean |Δ| = {moved:.3f})", moved > 1e-2)
    # the same transport in f64 at the hyperparameters the fit chose
    k_fit = tr.method.delta_map.kernel_
    _, _, _, perm = small_lml_theta_layout(k_fit)
    amp, l0, l1, noise = np.exp(np.asarray(k_fit.theta, np.float64)[perm])
    log(f"  [b] fitted amp {amp:.4g}, ℓ ({l0:.4g}, {l1:.4g}), noise {noise:.4g}")
    g_tr, g_v = transport_f64(*(np.asarray(a, np.float64) for a in (X, dX, S, S1)),
                              amp, np.array([l0, l1]), noise, 1e-10)
    # the fit takes the White noise to its lower bound, so K is nearly
    # singular (κ printed); each limit is ~10× the float32 error seen on a
    # CPU at this fit (1.2e-4 and 3.9e-4)
    Sg = np.asarray(S, np.float64)
    Km = rbf_f64(Sg, Sg, amp, np.array([l0, l1])) + noise * np.eye(len(Sg))
    log(f"  [b] κ(K) at the fitted θ: {np.linalg.cond(Km):.2e}")
    C.le("b", "transported demo vs f64 at the fitted θ, max |err| / max|X|",
         float(np.abs(traj - g_tr).max() / np.abs(g_tr).max()), 1e-3)
    C.le("b", "transported velocity vs f64 at the fitted θ, max |err| / max|v|",
         float(np.abs(np.asarray(tr.training_delta) - g_v).max()
               / np.abs(g_v).max()), 4e-3)


def phase_c_batched_2d(C, seed, E=16384):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    X, dX, S, S1 = curve_2d()
    amp, ls, noise = 10.0, 4.0, 0.01
    kern = K.Constant(amp) * K.RBF(ls * jnp.ones(2, jnp.float32)) + K.White(noise)
    rng = np.random.default_rng(seed)
    shifts = rng.uniform(-1.0, 1.0, (E, 1, 2))
    targets = S1[None] + shifts
    f = jax.jit(lambda tg: gpt_mod.fit_and_transport_batched(
        kern, jnp.asarray(S, jnp.float32), tg, jnp.asarray(X, jnp.float32),
        jnp.asarray(dX, jnp.float32)))
    t0 = time.perf_counter()
    res = jax.block_until_ready(f(jnp.asarray(targets, jnp.float32)))
    log(f"  [c] E={E} n=20 Q=400 compile+first {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    jax.block_until_ready(f(jnp.asarray(targets, jnp.float32)))
    log(f"  [c] warm call {1e3 * (time.perf_counter() - t0):.1f} ms (host clock)")
    traj, vel = np.asarray(res.traj), np.asarray(res.delta)
    C.true("c", f"outputs finite, shape ({E}, 400, 2)",
           traj.shape == (E, 400, 2) and np.isfinite(traj).all()
           and np.isfinite(vel).all() and np.isfinite(np.asarray(res.std)).all())
    scale = np.abs(X).max()
    e_tr = e_v = 0.0
    for e in rng.choice(E, 8, replace=False):
        g_tr, g_v = transport_f64(X, dX, S, targets[e], amp, ls, noise, 1e-6)
        e_tr = max(e_tr, np.abs(traj[e] - g_tr).max() / scale)
        e_v = max(e_v, np.abs(vel[e] - g_v).max() / np.abs(g_v).max())
    C.le("c", "trajectory vs f64 numpy, max |err| / max|X| over 8 members", e_tr, 2e-4)
    C.le("c", "velocity vs f64 numpy, max |err| / max|v| over 8 members", e_v, 2e-4)


def phase_d_surface_3d(C, seed, E=4):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.data.datasets import spiral_demo
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    demo, old, new = spiral_demo(jax.random.PRNGKey(seed), n_grid=50)
    S = old.reshape(-1, 3)                                   # (2500, 3)
    T0 = new.reshape(-1, 3)
    rng = np.random.default_rng(seed)
    targets = T0[None] + rng.uniform(-0.2, 0.2, (E, 1, 3))
    dX = np.zeros_like(demo)
    dX[:-1] = np.diff(demo, axis=0)
    q = rng.standard_normal((demo.shape[0], 4)) * 0.1 + np.array([1.0, 0, 0, 0])
    ori = q / np.linalg.norm(q, axis=1, keepdims=True)
    amp, ls, noise = 0.1, 1.0, 1e-2
    kern = K.Constant(amp) * K.RBF(ls * jnp.ones(3, jnp.float32)) + K.White(noise)
    f = jax.jit(lambda tg: gpt_mod.fit_and_transport_batched(
        kern, jnp.asarray(S, jnp.float32), tg, jnp.asarray(demo, jnp.float32),
        jnp.asarray(dX, jnp.float32), ori=jnp.asarray(ori, jnp.float32)))
    t0 = time.perf_counter()
    res = jax.block_until_ready(f(jnp.asarray(targets, jnp.float32)))
    log(f"  [d] E={E} n=2500 Q={demo.shape[0]} compile+first "
        f"{time.perf_counter() - t0:.1f} s")
    traj, qo = np.asarray(res.traj), np.asarray(res.ori)
    C.true("d", f"outputs finite, traj {traj.shape}, ori {qo.shape}",
           traj.shape == (E, 460, 3) and qo.shape == (E, 460, 4)
           and np.isfinite(traj).all() and np.isfinite(qo).all())
    C.le("d", "max | |q| − 1 | of transported quaternions",
         float(np.abs(np.linalg.norm(qo, axis=-1) - 1).max()), 1e-4)
    scale = np.abs(demo).max()
    err = 0.0
    for e in range(E):
        g_tr, _ = transport_f64(demo, dX, S, targets[e], amp, ls, noise, 1e-6)
        err = max(err, np.abs(traj[e] - g_tr).max() / scale)
    C.le("d", "trajectory vs f64 numpy, max |err| / max|X|", err, 1e-5)


def phase_e_large_n(C, seed, N_big=10240, N_mid=2500):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as core
    from gaussian_process_transportation_tpu.ops.blocked_chol import gram_cholesky_solve

    rng = np.random.default_rng(seed)
    amp, noise = 2.0, 0.1
    kern = K.Constant(amp) * K.RBF(jnp.ones(3, jnp.float32)) + K.White(noise)
    N = N_big
    X = jnp.asarray(rng.standard_normal((N, 3)), jnp.float32)
    Y = jnp.asarray(rng.standard_normal((N, 3)), jnp.float32)
    Kf = kern(X) + 1e-6 * jnp.eye(N, dtype=jnp.float32)

    def resid(a):
        return float(jnp.linalg.norm(Kf @ a - Y) / jnp.linalg.norm(Y))

    gp = jax.jit(lambda x, y: core.condition(kern, x, y))(X, Y)
    C.le("e", f"condition N={N}: ‖Kα − Y‖/‖Y‖", resid(gp.alpha), 1e-3)
    a_p = jax.jit(lambda x, y: gram_cholesky_solve(
        x, y, jnp.ones(3, jnp.float32), amp, noise + 1e-6, block=512)[0])(X, Y)
    C.le("e", f"gram_cholesky_solve (panels, B=512) N={N}: ‖Kα − Y‖/‖Y‖",
         resid(a_p), 1e-3)
    del Kf

    N = N_mid
    X = rng.standard_normal((N, 3))
    Y = np.sin(X[:, :2])
    Xq = rng.standard_normal((1000, 3))
    gp = core.condition(kern, jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32))
    mean = np.asarray(core.predict(gp, jnp.asarray(Xq, jnp.float32)))
    Km = rbf_f64(X, X, amp, 1.0) + (noise + 1e-6) * np.eye(N)
    mean64 = rbf_f64(Xq, X, amp, 1.0) @ np.linalg.solve(Km, Y)
    C.le("e", f"condition+predict N={N}: mean vs f64, max|err|/max|mean|",
         float(np.abs(mean - mean64).max() / np.abs(mean64).max()), 5e-5)


def phase_f_hyperposterior(C, seed, chains=256, E=256):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.models import exact_gp as core
    from gaussian_process_transportation_tpu.ops import fused_lml as fl
    from gaussian_process_transportation_tpu.parallel import samplers
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    rng = np.random.default_rng(seed)
    n = 20
    Xs = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    Ys = jnp.asarray(np.sin(np.asarray(Xs)[:, :1]) + 0.1 * rng.standard_normal((n, 1)),
                     jnp.float32)
    kern = K.Constant(1.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.01)
    t0 = time.perf_counter()
    s, d = samplers.sample_gp_posterior(
        kern, Xs, Ys, jax.random.PRNGKey(seed), num_chains=chains,
        num_warmup=40, num_samples=40)
    s = np.asarray(s)
    log(f"  [f] HMC {chains} chains x (40 warmup + 40 samples) in "
        f"{time.perf_counter() - t0:.1f} s incl. compile")
    acc = float(np.mean(np.asarray(d["mean_accept"])))
    C.true("f", f"HMC samples finite, shape ({chains}, 40, 4), mean accept {acc:.2f}",
           s.shape == (chains, 40, 4) and np.isfinite(s).all() and 0.2 < acc <= 1.0)
    # batched value+grad against f64 at 256 parameter vectors drawn in the
    # box the restarts use (log θ ∈ [-1, 1])
    th = jnp.asarray(rng.uniform(-1.0, 1.0, (4, 256)), jnp.float32)
    v, g = jax.jit(lambda t: fl.small_lml_value_grad(Xs, Ys, t, n_ls=2))(th)
    err_v = err_g = 0.0
    th64 = np.asarray(th, np.float64)
    for c in range(0, th64.shape[1], 16):
        v64, g64 = lml_grad_f64(np.asarray(Xs, np.float64), np.asarray(Ys, np.float64),
                                th64[:, c])
        err_v = max(err_v, abs(float(v[c]) - v64) / max(1.0, abs(v64)))
        err_g = max(err_g, float(np.abs(np.asarray(g[:, c]) - g64).max())
                    / max(1.0, np.abs(g64).max()))
    C.le("f", "small-LML value vs f64, max |err|/max(1,|v|) over 16 θ", err_v, 2e-6)
    C.le("f", "small-LML gradient vs f64, max |err|/max(1,|g|) over 16 θ", err_g, 2e-6)

    # per-member L-BFGS hyperparameter fits, E=256 members × 7 restarts
    X, dX, S, S1 = curve_2d()
    targets = S1[None] + rng.uniform(-1.0, 1.0, (E, 1, 2))
    kt = (K.Constant(10.0, bounds=(1e-2, 1e2)) * K.RBF(4.0 * jnp.ones(2, jnp.float32),
          bounds=(1e-1, 1e1)) + K.White(0.01, bounds=(1e-3, 1.0)))
    res = jax.block_until_ready(gpt_mod.fit_and_transport_batched_opt(
        kt, jnp.asarray(S, jnp.float32), jnp.asarray(targets, jnp.float32),
        jnp.asarray(X, jnp.float32), jnp.asarray(dX, jnp.float32)))
    C.true("f", f"fit_and_transport_batched_opt E={E}: outputs finite",
           np.isfinite(np.asarray(res.traj)).all()
           and np.isfinite(np.asarray(res.delta)).all())
    # the same fits, checked member by member against an f64 recompute
    Sg, D = [], []
    for e in range(E):
        R, cs, ct = kabsch_f64(S, targets[e])
        sg = (S - cs) @ R.T + ct
        Sg.append(sg)
        D.append(targets[e] - sg)
    Sg, D = np.asarray(Sg), np.asarray(D)
    thetas, lmls = core.fit_ensemble_fused(
        kt, jnp.asarray(Sg, jnp.float32), jnp.asarray(D, jnp.float32),
        n_restarts=6, maxiter=30)
    thetas, lmls = np.asarray(thetas, np.float64), np.asarray(lmls)
    worst_gain, worst_rel = np.inf, 0.0
    for e in range(0, E, max(1, E // 8)):
        amp, l0, l1, nz = np.exp(thetas[e])
        l_fit = lml_f64(Sg[e], D[e], amp, np.array([l0, l1]), nz, 1e-10)
        l_init = lml_f64(Sg[e], D[e], 10.0, np.array([4.0, 4.0]), 0.01, 1e-10)
        worst_gain = min(worst_gain, l_fit - l_init)
        worst_rel = max(worst_rel, abs(l_fit - lmls[e]) / max(1.0, abs(l_fit)))
    C.true("f", f"fitted LML ≥ initial LML (f64 recompute, 8 members; worst "
           f"gain {worst_gain:.3f})", worst_gain >= -1e-3)
    C.le("f", "reported LML vs f64 recompute at the fitted θ, relative", worst_rel, 1e-3)


def phase_g_goldens(C, seed):
    import pytest

    os.environ["GPT_GPU_TESTS"] = "1"
    # only the files that hold gpu-marked tests: other test modules import
    # packages (sklearn) that a GPU machine need not have
    tests = os.path.join(ROOT, "tests")
    files = sorted(
        os.path.join(tests, f) for f in os.listdir(tests)
        if f.startswith("test_") and f.endswith(".py")
        and "mark.gpu" in open(os.path.join(tests, f)).read()
    )
    log(f"  [g] files: {[os.path.basename(f) for f in files]}")

    class Outcomes:  # a skip on the GPU would hide a golden: count them
        def __init__(self):
            self.n = {"passed": 0, "failed": 0, "skipped": 0}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.n[report.outcome] += 1

    out = Outcomes()
    rc = pytest.main(files + ["-q", "-m", "gpu", "-p", "no:cacheprovider",
                              "-p", "no:randomly"], plugins=[out])
    C.true("g", f"GPU goldens (pytest -m gpu) exit code {int(rc)}, {out.n}",
           int(rc) == 0 and out.n["passed"] > 0 and out.n["skipped"] == 0)


def phase_mesh4(C, seed, E=16384, N=8192):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.ops.blocked_chol import gram_cholesky_solve
    from gaussian_process_transportation_tpu.parallel import samplers
    from gaussian_process_transportation_tpu.parallel.ensemble import transport_ensemble
    from gaussian_process_transportation_tpu.parallel.mesh import make_mesh
    from gaussian_process_transportation_tpu.parallel.sharded_chol import (
        sharded_gram_cholesky_solve,
    )
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    mesh = make_mesh(4, 1)
    log(f"  [mesh] {dict(mesh.shape)} over {[d.id for d in mesh.devices.ravel()]}")
    X, dX, S, S1 = curve_2d()
    rng = np.random.default_rng(seed)
    targets = jnp.asarray(S1[None] + rng.uniform(-1, 1, (E, 1, 2)), jnp.float32)
    kern = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2, jnp.float32)) + K.White(0.01)
    args = (jnp.asarray(S, jnp.float32), targets, jnp.asarray(X, jnp.float32),
            jnp.asarray(dX, jnp.float32))
    sh = transport_ensemble(kern, args[0], args[1], args[2], args[3], mesh=mesh)
    one = jax.jit(lambda *a: gpt_mod.fit_and_transport_batched(kern, *a))(*args)
    C.true("mesh", f"transport_ensemble output sharded over "
           f"{len(sh.traj.sharding.device_set)} devices",
           len(sh.traj.sharding.device_set) == 4)
    # two float32 compilations of the same math (per-device batch sizes
    # differ, so XLA may pick other algorithms); each is within 1e-3 of f64
    C.le("mesh", f"transport_ensemble (4 devices) vs single device, E={E}: "
         "max |Δtraj| / max|X|",
         float(np.abs(np.asarray(sh.traj) - np.asarray(one.traj)).max()
               / np.abs(X).max()), 1e-4)

    n = 20
    Xs = jnp.asarray(rng.standard_normal((n, 2)), jnp.float32)
    Ys = jnp.asarray(np.sin(np.asarray(Xs)[:, :1]), jnp.float32)
    kl = K.Constant(1.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.01)

    def run(mesh_or_none, fused, **kw):
        s, _ = samplers.sample_gp_posterior(kl, Xs, Ys, jax.random.PRNGKey(seed),
                                            num_chains=64, mesh=mesh_or_none,
                                            fused=fused, **kw)
        return np.asarray(s)

    # fused path (the default for this kernel): random streams are per chain
    # key and the LML runs one elementwise program per chain, so sharding
    # over 4 devices (16 chains each) must change no bit of any chain
    s_m, s_1 = (run(m, None, num_warmup=20, num_samples=20) for m in (mesh, None))
    same = int(np.all(s_m == s_1, axis=(1, 2)).sum())
    C.true("mesh", f"sample_gp_posterior (fused path) sharded over 4 devices vs "
           f"unsharded: {same}/64 chains bit-identical", same == 64)
    # generic path (vmapped AD): its Gram pullback's reductions are compiled
    # for the per-device batch, so the last bits may differ and accept/reject
    # amplifies them over a long run; the draws must not differ, so six
    # short transitions (inits, momenta and accept draws, 2 leapfrog steps
    # each; a wrong key moves θ by ~0.1) must agree chain by chain
    s_m, s_1 = (run(m, False, num_warmup=20, num_samples=20) for m in (mesh, None))
    log(f"  [mesh] sample_gp_posterior (generic path), 20+20 steps: "
        f"{int(np.all(s_m == s_1, axis=(1, 2)).sum())}/64 chains bit-identical "
        "(reported)")
    s_m, s_1 = (run(m, False, num_warmup=4, num_samples=2, num_leapfrog=2)
                for m in (mesh, None))
    C.le("mesh", "sample_gp_posterior (generic path) first 6 transitions, sharded vs "
         "unsharded: max over 64 chains of max |Δθ|", float(np.abs(s_m - s_1).max()),
         1e-4)

    Xg = jnp.asarray(rng.standard_normal((N, 3)), jnp.float32)
    Yg = jnp.asarray(rng.standard_normal((N, 2)), jnp.float32)
    ls = jnp.ones(3, jnp.float32)
    dmesh = make_mesh(1, 4)
    a_sh, _ = sharded_gram_cholesky_solve(Xg, Yg, ls, 2.0, 0.1, mesh=dmesh,
                                          block=512)
    a_1 = jax.jit(lambda x, y: gram_cholesky_solve(
        x, y, ls, 2.0, 0.1, block=512, refine_iters=0)[0])(Xg, Yg)
    C.le("mesh", f"sharded_gram_cholesky_solve (4 devices) vs single-device panel "
         f"solve, N={N}: max|Δα|/max|α|",
         float(np.abs(np.asarray(a_sh) - np.asarray(a_1)).max()
               / np.abs(np.asarray(a_1)).max()), 1e-3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    import jax

    # a. device check: a GPU or nothing
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"chip_smoke: needs a GPU, found platform {dev.platform!r}")
        return 2
    if len(jax.devices()) < args.devices:
        log(f"chip_smoke: --devices {args.devices} but {len(jax.devices())} present")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(f"card: {card[0]}")
    log(f"jax {jax.__version__}, devices: {[d.device_kind for d in jax.devices()]}")

    sys.path.insert(0, ROOT)
    from gaussian_process_transportation_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")

    phases = ([("mesh4", phase_mesh4)] if args.devices == 4 else [
        ("b facade", phase_b_facade),
        ("c batched 2-D transport", phase_c_batched_2d),
        ("d 3-D surface transport", phase_d_surface_3d),
        ("e large-N conditioning", phase_e_large_n),
        ("f hyperposterior sampling and fits", phase_f_hyperposterior),
        ("g GPU goldens", phase_g_goldens),
    ])
    C = Checks()
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn(C, args.seed)
            log(f"phase {name}: passed in {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            C.failed.append(name)
            log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
    if C.failed:
        log(f"chip_smoke: failed phases: {C.failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
