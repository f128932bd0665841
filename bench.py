"""Benchmark harness.

Prints ONE JSON line:
  {"metric": "transported_trajectories_per_s_per_chip", "value": N,
   "unit": "traj/s/chip", "vs_baseline": R,
   "tflops_chol_n10240": T, "hmc_samples_per_s": S,
   "smc_particles_per_s": P, "stages_failed": [...]}

Workloads:
* transport — the canonical 2D transport (N_traj=400, 20-point
  distributions, reference example/2D/surface_generalization.py scale) as a
  batched ensemble of E independent fit+transport problems — one jitted
  vmapped program per iteration on the default device.
* cholesky — fused Gram→blocked-Cholesky→solve at N=10240 through the
  panel path (ops/blocked_chol.py) at HIGHEST precision — the BASELINE.json
  "batched GP Cholesky+solve TFLOP/s at N=10k" metric.  Its stderr also
  reports the measured float32 (HIGHEST) matmul rate and the achieved
  fraction of it.
* hmc — 256 HMC chains over GP kernel hyperposteriors (BASELINE scaling
  gate: measured samples/s at 1 chip).
* smc — SMC particle-ensemble reweight+resample throughput at E=8192
  (BASELINE scaling gate: ≥10k-member transported-policy ensembles as
  SMC-style particles).

``vs_baseline`` is the measured speedup over the reference *algorithm*
(a GP with fixed hyperparameters + Kabsch pipeline in float64 numpy/scipy
— the same math our pipeline runs) executing the same transports
one-by-one on CPU, i.e. ours(traj/s) / reference(traj/s).

Process layout: the parent process never touches JAX; every device stage
runs in its own subprocess, one at a time, so only one process holds the
device.  Each stage STREAMS its metric out the moment it exists, the
parent persists banked metrics to ``BENCH_PARTIAL.json`` and lists failed
stages in ``stages_failed``; ``python bench.py --warmup`` pre-populates the
persistent compile cache outside any timed budget.

Timing: every timed section queues its iterations asynchronously and ends
with ONE small host transfer (a device-side scalar slice), repeated 3× and
reported as the median.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_workload(dtype=np.float32, n_traj=400, n_dist=20):
    """The synthetic 2-D drawing: demo X (n_traj points), velocity dX, and
    the floor / new-floor distributions S, S1 (n_dist points each)."""
    t = np.linspace(0, 1, n_traj, dtype=dtype)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    s = np.linspace(0, 1, n_dist, dtype=dtype)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    S1 = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)
    return X, dX, S, S1


def _timed_median(fn, sync, iters, reps=3):
    """Median over ``reps`` of (queue ``iters`` async dispatches + ONE
    small host transfer)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn()
        sync(out)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times)), times


# Committed nominal CPU-baseline rate (traj/s) of the single-CPU float64
# numpy/scipy reference (measured ~1450 traj/s on one core of a shared
# x86 build host).
# A contended box can measure several times slower and inflate
# vs_baseline — when the live measurement falls outside [NOMINAL/2,
# NOMINAL*2] the ratio is computed against the nominal instead and the
# artifact self-flags.
NOMINAL_CPU_BASELINE = 1450.0


def bench_reference_cpu(X, dX, S, S1, iters=5):
    """The reference pipeline (a GP with fixed hyperparameters — what
    sklearn's GPR computes with ``optimizer=None`` — in float64
    numpy/scipy) — baseline."""
    from scipy.linalg import cho_solve, cholesky, solve_triangular

    amp, ls, noise, jitter = 10.0, np.array([4.0, 4.0]), 0.01, 1e-10

    def k(A, B):  # C·RBF cross-covariance (White adds nothing off-diagonal)
        d2 = (((A[:, None, :] - B[None, :, :]) / ls) ** 2).sum(-1)
        return amp * np.exp(-0.5 * d2)

    X = X.astype(np.float64)
    dX = dX.astype(np.float64)
    S = S.astype(np.float64)
    S1 = S1.astype(np.float64)

    def one(shift):
        tgt = S1 + shift
        cs, ct = S.mean(0), tgt.mean(0)
        H = (S - cs).T @ (tgt - ct)
        U, _, Vt = np.linalg.svd(H)
        V = Vt.T
        R = V @ U.T
        if np.linalg.det(R) < 0:
            V[:, -1] *= -1
            R = V @ U.T
        gamma = lambda x: (R @ (x - cs).T).T + ct
        Sg = gamma(S)
        delta = tgt - Sg
        # GP fit and predict with std (sklearn GPR semantics, alpha=1e-10)
        K_ = k(Sg, Sg) + (noise + jitter) * np.eye(len(Sg))
        L = cholesky(K_, lower=True)
        alfa = cho_solve((L, True), delta)
        Xg = gamma(X)
        k_star = k(Xg, Sg)
        mean = k_star @ alfa
        v = solve_triangular(L, k_star.T, lower=True)
        std = np.sqrt(np.maximum(amp + noise - np.sum(v * v, axis=0), 0.0))
        # velocity transport (reference gaussian_process.py:63-101)
        K_inv = np.linalg.inv(K_)
        lsc = ls.reshape(-1, 1)
        diff = Sg.T[:, None, :] - Xg.T[:, :, None]
        dk = (diff / (lsc[:, :, None] ** 2)) * k_star
        J_psi = (dk.transpose(1, 0, 2) @ alfa).transpose(0, 2, 1)
        dk_Kinv = dk @ K_inv
        var = amp / lsc**2 - np.sum(dk_Kinv * dk, axis=2)
        J_psi_var = np.repeat(var[None], 2, axis=0).transpose(2, 0, 1)
        J_gamma = np.repeat(R[None], len(X), axis=0)
        J_phi = J_gamma + J_psi @ J_gamma
        v = dX[:, :, None]
        vel = (J_phi @ v)[:, :, 0]
        vvar = (J_psi_var @ (J_gamma @ v) ** 2)[:, :, 0]
        return Xg + mean, std, vel, vvar

    one(0.0)  # warm numpy/BLAS
    # best-of per-iter times: the CPU reference shares cores with whatever
    # else runs on the box, and a noisy (slow) reference would inflate
    # vs_baseline — take its fastest observed iteration (conservative)
    best = float("inf")
    for i in range(iters):
        t0 = time.perf_counter()
        one(0.01 * i)
        best = min(best, time.perf_counter() - t0)
    return 1.0 / best


def bench_ours(X, dX, S, S1, ensemble=16384, iters=5):
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.transport import gpt as gpt_mod

    dtype = jnp.float32
    kernel = K.Constant(10.0) * K.RBF(4.0 * jnp.ones(2, dtype)) + K.White(0.01)
    Xd, dXd, Sd = jnp.asarray(X), jnp.asarray(dX), jnp.asarray(S)
    shifts = jnp.linspace(0.0, 1.0, ensemble, dtype=dtype)
    targets = jnp.asarray(S1)[None] + shifts[:, None, None]

    f = jax.jit(
        lambda tgts: gpt_mod.fit_and_transport_batched(kernel, Sd, tgts, Xd, dXd)
    )
    t0 = time.perf_counter()
    first = f(targets)
    first_traj = np.asarray(first.traj[0])  # host transfer = true sync
    log(f"compile+first run: {time.perf_counter()-t0:.1f}s "
        f"(backend={jax.default_backend()}, devices={jax.devices()})")
    # validity guard: a throughput number for non-finite output is garbage
    # (reduced-precision matmuls corrupt the Gram into NaNs)
    assert np.isfinite(first_traj).all(), "transport produced non-finite output"

    dt, times = _timed_median(
        lambda: f(targets),
        lambda out: np.asarray(out.traj[0, 0, 0]),
        iters,
    )
    log(f"ours per-iter times (ms): {[f'{t*1e3:.0f}' for t in times]}")
    return ensemble / dt, {
        "rep_ms": [round(t * 1e3, 1) for t in times], "ensemble": ensemble,
    }


def _matmul_roofline(precision, m=8192, iters=10):
    """Measured TFLOP/s of one big square float32 matmul at the given
    precision — the denominator for utilization claims."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((m, m), jnp.float32) * 1e-3
    f = jax.jit(lambda x: jnp.dot(x, x, precision=precision))
    np.asarray(f(a)[0, 0])  # compile + warm
    dt, _ = _timed_median(lambda: f(a), lambda out: np.asarray(out[0, 0]), iters, reps=2)
    return 2 * m**3 / dt / 1e12


def bench_cholesky(n=10240, block=512, iters=15):
    """Fused Gram→blocked-Cholesky→solve TFLOP/s at N=10240 (the second
    BASELINE metric), through the panel path (ops/blocked_chol.py) at
    HIGHEST precision — golden-checked against f64 in
    tests/test_blocked_chol.py.

    stderr additionally reports the measured float32 (HIGHEST) matmul rate
    and the achieved fraction of it."""
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu.ops.blocked_chol import gram_cholesky_solve

    rng = np.random.default_rng(0)
    Xd = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    Yd = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    ls = jnp.ones(3, jnp.float32)

    fused = jax.jit(
        lambda Xs, Ys: gram_cholesky_solve(
            Xs, Ys, ls, 2.0, 0.1, block=block,
            precision=jax.lax.Precision.HIGHEST,
        )[0]
    )
    t0 = time.perf_counter()
    first = np.asarray(fused(Xd, Yd)[:4])
    log(f"cholesky compile+first: {time.perf_counter()-t0:.1f}s")
    assert np.isfinite(first).all(), "cholesky produced non-finite output"

    dt, times = _timed_median(
        lambda: fused(Xd, Yd),
        lambda out: np.asarray(out[0, 0]),
        iters,
    )
    log(f"cholesky per-iter times (ms): {[f'{t*1e3:.0f}' for t in times]}")
    flops = 2 * n * n * 3 + n**3 / 3 + 4 * n * n * 3
    tflops = flops / dt / 1e12

    details = {"rep_ms": [round(t * 1e3, 1) for t in times]}
    # measured float32 matmul rate (cheap: one 8192² matmul)
    try:
        r_highest = _matmul_roofline(jax.lax.Precision.HIGHEST)
        log(f"float32 HIGHEST matmul: {r_highest:.1f} TFLOP/s; achieved "
            f"{tflops:.1f} = {100*tflops/r_highest:.0f}% of it")
        details["matmul_f32_highest_tflops"] = round(r_highest, 1)
    except Exception as e:  # roofline is diagnostic only
        log(f"roofline measurement failed: {e}")
    return tflops, details


def bench_smc(n_particles=8192, n_steps=16, n_traj=100):
    """SMC particle-ensemble throughput (particles·steps/s) at E=8192.

    One jitted ``lax.scan`` over reweight → conditional systematic
    resample steps on (E, N, D) transported-trajectory particles — the
    BASELINE scaling-gate workload (≥10k-member transported-policy
    ensembles with collective resampling)."""
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu.parallel import smc

    rng = np.random.default_rng(0)
    trajs = jnp.asarray(rng.standard_normal((n_particles, n_traj, 2)).astype(np.float32))
    particles = smc.ParticleEnsemble(
        trajectories=trajs,
        log_weights=jnp.zeros(n_particles, jnp.float32) - np.log(n_particles),
    )
    ll_fn = smc.goal_likelihood(jnp.asarray([1.0, 1.0], jnp.float32), scale=2.0)

    @jax.jit
    def run(p0, key):
        def step(p, k):
            p, ess = smc.smc_step(p, ll_fn, k)
            return p, ess

        keys = jax.random.split(key, n_steps)
        p, esss = jax.lax.scan(step, p0, keys)
        return p, esss

    t0 = time.perf_counter()
    p, esss = run(particles, jax.random.PRNGKey(0))
    first = np.asarray(p.trajectories[0, 0, 0])
    log(f"smc compile+first: {time.perf_counter()-t0:.1f}s")
    assert np.isfinite(first), "smc produced non-finite output"

    dt, times = _timed_median(
        lambda: run(particles, jax.random.PRNGKey(1)),
        lambda out: np.asarray(out[0].trajectories[0, 0, 0]),
        iters=3,
    )
    log(f"smc per-iter times (ms): {[f'{t*1e3:.0f}' for t in times]}")
    return n_particles * n_steps / dt, {
        "rep_ms": [round(t * 1e3, 1) for t in times], "particles": n_particles,
    }


def bench_hmc(num_chains=256, num_warmup=48, num_samples=48, n_data=20,
              extra_budget_s=120.0, emit=None):
    """HMC hyperposterior sampling throughput (samples/s/chip).

    n_data=20 matches the transport-GP hyperposterior workload (the
    reference's 20-point distributions) and keeps the unrolled small-N
    LML inside the leapfrog small."""
    import jax
    import jax.numpy as jnp
    from gaussian_process_transportation_tpu import kernels as K
    from gaussian_process_transportation_tpu.parallel import samplers

    rng = np.random.default_rng(0)
    Xs = jnp.asarray(rng.standard_normal((n_data, 2)).astype(np.float32))
    Ys = jnp.asarray(
        (np.sin(np.asarray(Xs)[:, :1]) + 0.1 * rng.standard_normal((n_data, 1))).astype(np.float32)
    )
    kernel = K.Constant(1.0) * K.RBF(jnp.ones(2, jnp.float32)) + K.White(0.01)

    t_stage = time.perf_counter()
    t0 = time.perf_counter()
    samples, diags = samplers.sample_gp_posterior(
        kernel, Xs, Ys, jax.random.PRNGKey(0),
        num_chains=num_chains, num_warmup=num_warmup, num_samples=num_samples,
    )
    first = np.asarray(samples[0, 0])  # sync
    compile_s = time.perf_counter() - t0
    assert np.isfinite(first).all()

    # median of 3 reps
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        samples, _ = samplers.sample_gp_posterior(
            kernel, Xs, Ys, jax.random.PRNGKey(1 + rep),
            num_chains=num_chains, num_warmup=num_warmup, num_samples=num_samples,
        )
        np.asarray(samples[0, 0])
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    rate = num_chains * num_samples / dt
    log(f"hmc: compile {compile_s:.1f}s, runs (ms) {[f'{t*1e3:.0f}' for t in times]}, "
        f"{num_chains} chains x {num_samples} samples -> {rate:.0f} samples/s")
    details = {
        "rep_s": [round(t, 2) for t in times],
        "chains": num_chains, "samples_per_chain": num_samples,
    }
    # emit the headline number IMMEDIATELY, so a later kill of the stage
    # cannot lose it
    if emit is not None:
        emit("hmc", rate, details)
    # throughput-bound point (the C=256 headline is latency-bound): one
    # extra width, opt-in (BENCH_HMC_EXTRA=1) and skipped past the stage
    # budget
    try:
        if os.environ.get("BENCH_HMC_EXTRA", "0") != "1":
            raise RuntimeError("extra point disabled (set BENCH_HMC_EXTRA=1)")
        if time.perf_counter() - t_stage > extra_budget_s:
            raise RuntimeError(
                f"stage already at {time.perf_counter()-t_stage:.0f}s"
            )
        big = 4096
        t0 = time.perf_counter()
        samples, _ = samplers.sample_gp_posterior(
            kernel, Xs, Ys, jax.random.PRNGKey(99),
            num_chains=big, num_warmup=num_warmup, num_samples=num_samples,
        )
        np.asarray(samples[0, 0])
        t0 = time.perf_counter()
        samples, _ = samplers.sample_gp_posterior(
            kernel, Xs, Ys, jax.random.PRNGKey(100),
            num_chains=big, num_warmup=num_warmup, num_samples=num_samples,
        )
        np.asarray(samples[0, 0])
        big_rate = big * num_samples / (time.perf_counter() - t0)
        log(f"hmc: C={big} -> {big_rate:.0f} samples/s")
        details["samples_per_s_c4096"] = round(big_rate, 1)
        if emit is not None:
            emit("hmc", rate, details)  # refresh with the extra point
    except Exception as e:  # diagnostic only
        log(f"hmc C=4096 extra point failed: {e}")
    return rate, details


def _run_stage(stage: str) -> None:
    """Subprocess entry: run one or more device metrics, STREAMING each
    result the moment it exists as ``STAGE_RESULT <name> <float>`` +
    ``STAGE_DETAILS <name> <json>`` lines.  The parent parses these lines
    incrementally, so a deadline-kill mid-stage keeps everything already
    printed."""
    from gaussian_process_transportation_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    def emit(name, val, details):
        print(f"STAGE_RESULT {name} {val}", flush=True)
        print(f"STAGE_DETAILS {name} {json.dumps(details)}", flush=True)

    if stage == "transport":
        X, dX, S, S1 = make_workload()
        emit("transport", *bench_ours(X, dX, S, S1))
    elif stage == "cholesky":
        emit("cholesky", *bench_cholesky())
    elif stage == "hmc":
        bench_hmc(emit=emit)
    elif stage == "smc":
        emit("smc", *bench_smc())
    elif stage == "samplers":
        # SMC + HMC share one process: one interpreter start, one jax init,
        # cheapest metric first
        emit("smc", *bench_smc())
        bench_hmc(emit=emit)
    else:
        raise SystemExit(f"unknown stage {stage}")


def _stage_subprocess(stage: str, timeout_s: float):
    """Run a device stage in a killable subprocess, collecting streamed
    results incrementally.

    A subprocess can be SIGKILLed at its deadline, so one stuck stage costs
    only its own deadline — and because results stream, it keeps every
    metric it finished before the kill.  Stages run one at a time."""
    import signal
    import subprocess
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stage", stage],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        start_new_session=True,  # own process group: killable with children
    )
    results = {}  # name -> [val, details]

    def read_stdout():
        for line in proc.stdout:
            line = line.rstrip("\n")
            parts = line.split(None, 2)
            if line.startswith("STAGE_RESULT ") and len(parts) == 3:
                results.setdefault(parts[1], [None, {}])[0] = float(parts[2])
            elif line.startswith("STAGE_DETAILS ") and len(parts) == 3:
                try:
                    results.setdefault(parts[1], [None, {}])[1] = json.loads(parts[2])
                except ValueError:
                    pass

    def read_stderr():
        for line in proc.stderr:
            sys.stderr.write(line)
        sys.stderr.flush()

    t_out = threading.Thread(target=read_stdout, daemon=True)
    t_err = threading.Thread(target=read_stderr, daemon=True)
    t_out.start()
    t_err.start()
    try:
        proc.wait(timeout=timeout_s)
        killed = False
    except subprocess.TimeoutExpired:
        killed = True
        log(f"stage {stage}: killed after {timeout_s:.0f}s — "
            f"keeping {sorted(results)} already streamed")
        try:  # kill the exact process group we started (never by pattern)
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    t_out.join(timeout=5.0)
    t_err.join(timeout=5.0)
    done = {k: (v, d) for k, (v, d) in results.items() if v is not None}
    if done:
        log(f"stage {stage}: {sorted(done)} in {time.perf_counter()-t0:.0f}s"
            + (" (partial, killed)" if killed else ""))
        return done
    if not killed:
        log(f"stage {stage}: failed (rc={proc.returncode})")
    return None


def _stage_with_retry(stage: str, deadline_fn, attempts: int = 2, min_deadline: float = 40.0):
    """Run a stage subprocess with up to ``attempts`` tries.

    ``deadline_fn(attempt)`` returns the per-attempt deadline in seconds;
    attempts whose deadline falls below ``min_deadline`` are skipped.  Each
    retry is a fresh subprocess."""
    for attempt in range(attempts):
        deadline = float(deadline_fn(attempt))
        if deadline < min_deadline:
            log(f"stage {stage}: skipping attempt {attempt+1} (budget: {deadline:.0f}s left)")
            return None
        if attempt:
            log(f"stage {stage}: retrying in a fresh process "
                f"({deadline:.0f}s deadline)")
        out = _stage_subprocess(stage, deadline)
        if out is not None:
            return out
    return None


def warmup():
    """Populate the persistent compile cache for every stage, outside any
    timed budget; a later timed run then hits warm caches only."""
    for stage in ("cholesky", "transport", "samplers"):
        t0 = time.perf_counter()
        out = _stage_subprocess(stage, 1200.0)
        names = sorted(out) if out else []
        log(f"warmup {stage}: {'ok ' + str(names) if out else 'FAILED'} "
            f"({time.perf_counter()-t0:.0f}s)")


# metric name -> (final-JSON key, rounding digits)
_METRIC_KEYS = {
    "cholesky": ("tflops_chol_n10240", 2),
    "hmc": ("hmc_samples_per_s", 1),
    "smc": ("smc_particles_per_s", 1),
}


def main():
    t_start = time.perf_counter()
    budget = float(os.environ.get("BENCH_BUDGET_S", "500"))

    def remaining():
        return budget - (time.perf_counter() - t_start)

    X, dX, S, S1 = make_workload()

    # CPU baseline with sanity guard: best-of-5 already protects against
    # transient stalls; a *persistently* loaded box gets one re-measure
    # after a settle, then falls back to the committed nominal with a
    # self-diagnosing flag rather than inflating the ratio.
    baseline_degraded = False
    ref_rate = bench_reference_cpu(X, dX, S, S1)
    log(f"reference (numpy/scipy f64, 1 CPU): {ref_rate:.1f} traj/s")
    if not (NOMINAL_CPU_BASELINE / 2 <= ref_rate <= NOMINAL_CPU_BASELINE * 2):
        log(f"baseline outside nominal [{NOMINAL_CPU_BASELINE/2:.0f}, "
            f"{NOMINAL_CPU_BASELINE*2:.0f}] — re-measuring after settle")
        time.sleep(5.0)
        ref_rate = bench_reference_cpu(X, dX, S, S1)
        log(f"reference re-measure: {ref_rate:.1f} traj/s")
        if not (NOMINAL_CPU_BASELINE / 2 <= ref_rate <= NOMINAL_CPU_BASELINE * 2):
            baseline_degraded = True
            log(f"baseline degraded ({ref_rate:.1f} traj/s) — using nominal "
                f"{NOMINAL_CPU_BASELINE} for vs_baseline")
            ref_rate = NOMINAL_CPU_BASELINE

    # Stage order: samplers first (the cheapest device programs), then
    # transport (the required headline), then cholesky, then retries for
    # anything missing.  Every metric streams out of its stage subprocess
    # the moment it exists and is persisted to BENCH_PARTIAL.json, so a
    # later kill can never lose an earlier number.
    results = {}  # name -> (val, details)
    partial_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "BENCH_PARTIAL.json")

    def record(out):
        if out:
            results.update(out)
            try:
                with open(partial_path, "w") as fh:
                    json.dump({k: {"value": v, "details": d}
                               for k, (v, d) in results.items()}, fh)
            except OSError:
                pass

    record(_stage_with_retry(
        "samplers",
        # leave ≥220s for transport+cholesky; a 250s cap still banks partial
        # results (smc, then the hmc headline) even if the tail is killed
        lambda a: min(250.0, remaining() - 220.0),
        attempts=1,
    ))

    # the required headline metric
    record(_stage_with_retry(
        "transport",
        lambda a: max(remaining() - 130.0, 60.0) if a == 0 else remaining() - 20.0,
        min_deadline=30.0,
    ))

    record(_stage_with_retry(
        "cholesky",
        lambda a: min(240.0, remaining() - 20.0),
        attempts=1,
    ))

    # retry pass for anything still missing, cheapest-first, with whatever
    # budget is left
    for name, stage in (("smc", "smc"), ("hmc", "hmc"), ("cholesky", "cholesky")):
        if name not in results and remaining() > 60.0:
            record(_stage_with_retry(stage, lambda a: remaining() - 10.0,
                                     attempts=1))

    if "transport" not in results:
        log("FATAL: transport stage failed — no headline")
        print(
            json.dumps(
                {
                    "metric": "transported_trajectories_per_s_per_chip",
                    "value": None,
                    "unit": "traj/s/chip",
                    "stages_failed": sorted(
                        {"transport", "cholesky", "hmc", "smc"} - set(results)),
                    **{k: round(results[m][0], nd)
                       for m, (k, nd) in _METRIC_KEYS.items() if m in results},
                }
            )
        )
        raise SystemExit(1)

    ours_rate = results["transport"][0]
    log(f"ours (batched, 1 chip): {ours_rate:.1f} traj/s")
    if "cholesky" in results:
        log(f"Gram+Cholesky+solve N=10240: {results['cholesky'][0]:.2f} TFLOP/s")

    extras = {}
    for m, (k, nd) in _METRIC_KEYS.items():
        if m in results:
            extras[k] = round(results[m][0], nd)
    # always present (empty = every stage captured) so the artifact is
    # explicitly self-diagnosing rather than diagnosing-by-absence
    extras["stages_failed"] = sorted({"cholesky", "hmc", "smc"} - set(results))
    if baseline_degraded:
        extras["baseline_degraded"] = True
    extras["cpu_baseline_traj_per_s"] = round(ref_rate, 1)
    extras["stages"] = {k: d for k, (v, d) in results.items()}

    print(
        json.dumps(
            {
                "metric": "transported_trajectories_per_s_per_chip",
                "value": round(ours_rate, 2),
                "unit": "traj/s/chip",
                "vs_baseline": round(ours_rate / ref_rate, 2),
                **extras,
            }
        )
    )


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        _run_stage(sys.argv[2])
    elif len(sys.argv) >= 2 and sys.argv[1] == "--warmup":
        warmup()
    else:
        main()
