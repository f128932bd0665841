"""Hamiltonian Monte Carlo over GP kernel hyperparameters, mesh-sharded.

The reference point-estimates hyperparameters (sklearn L-BFGS restarts) and
searches one lengthscale bound with Optuna
(``transportation/gaussian_process_transportation_diffeomorphic.py:123-167``).
Here the full posterior p(θ | data) ∝ exp(LML(θ)) · prior(θ) is sampled:

* ``hmc``  — leapfrog HMC with dual-averaging step-size adaptation and
  diagonal mass-matrix (Welford) warm-up, all inside one ``lax.scan`` jit.
* ``nuts`` — iterative No-U-Turn sampler (fixed max tree depth, multinomial
  sampling across the trajectory), same adaptation.
* ``sample_gp_posterior`` — convenience: chains over the GP marginal
  likelihood, vmapped over the chain axis and sharded over the mesh's
  'ens' axis; cross-chain diagnostics (split-R̂, ESS) computed on device.

Chains are embarrassingly parallel — C chains on a mesh communicate only
at the final diagnostics reduction, so scaling to a pod is a sharding
annotation, not new code.
"""
from __future__ import annotations

import functools
import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array


class HMCState(NamedTuple):
    position: Array
    log_prob: Array
    grad: Array


def _leapfrog(logprob_and_grad, position, momentum, grad, step_size, inv_mass, n_steps):
    def body(carry, _):
        q, p, g = carry
        p = p + 0.5 * step_size * g
        q = q + step_size * inv_mass * p
        lp, g = logprob_and_grad(q)
        p = p + 0.5 * step_size * g
        return (q, p, g), lp

    (q, p, g), lps = jax.lax.scan(body, (position, momentum, grad), None, length=n_steps)
    return q, p, g, lps[-1]


def _dual_averaging_init(step_size0):
    log_step = jnp.log(step_size0)  # scalar, or (E,) for per-chain batched HMC
    return dict(
        log_step=log_step,
        log_step_avg=log_step,
        h_avg=jnp.zeros_like(log_step),
        mu=jnp.log(10.0 * step_size0),
        t=jnp.zeros_like(log_step),
    )


def _dual_averaging_update(state, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    t = state["t"] + 1.0
    h_avg = (1.0 - 1.0 / (t + t0)) * state["h_avg"] + (target - accept_prob) / (t + t0)
    log_step = state["mu"] - jnp.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state["log_step_avg"]
    return dict(log_step=log_step, log_step_avg=log_step_avg, h_avg=h_avg, mu=state["mu"], t=t)


def _make_kernel(logprob_fn, num_leapfrog):
    """(safe value-and-grad, one Metropolis-adjusted leapfrog step)."""
    lp_and_grad = jax.value_and_grad(logprob_fn)

    def safe_lp_and_grad(q):
        lp, g = lp_and_grad(q)
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -1e10, lp)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        return lp, g

    def one_step(state, key, step_size, inv_mass):
        D = state.position.shape[0]
        k_mom, k_acc = jax.random.split(key)
        p0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
        q, p, g, lp = _leapfrog(
            safe_lp_and_grad, state.position, p0, state.grad, step_size, inv_mass, num_leapfrog
        )
        ke0 = 0.5 * jnp.sum(p0 * p0 * inv_mass)
        ke1 = 0.5 * jnp.sum(p * p * inv_mass)
        log_accept = (lp - ke1) - (state.log_prob - ke0)
        accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
        accept = jax.random.uniform(k_acc) < accept_prob
        new_state = HMCState(
            position=jnp.where(accept, q, state.position),
            log_prob=jnp.where(accept, lp, state.log_prob),
            grad=jnp.where(accept, g, state.grad),
        )
        return new_state, accept_prob

    return safe_lp_and_grad, one_step


def hmc_warmup(
    logprob_fn: Callable[[Array], Array],
    init_position: Array,
    key: Array,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[HMCState, Array, Array]:
    """Adaptation phase only: dual-averaging step size + Welford diagonal
    mass.  Returns (state, step_size, inv_mass) — exactly the state
    :func:`hmc` holds when sampling starts, so checkpointed runs
    (``parallel.checkpointed``) resume bit-identically."""
    safe_lp_and_grad, one_step = _make_kernel(logprob_fn, num_leapfrog)
    lp0, g0 = safe_lp_and_grad(init_position)
    D = init_position.shape[0]

    def warmup_step(carry, key):
        state, da, mean, m2, count, inv_mass = carry
        step_size = jnp.exp(da["log_step"])
        state, accept_prob = one_step(state, key, step_size, inv_mass)
        da = _dual_averaging_update(da, accept_prob, target=target_accept)
        # Welford
        count += 1.0
        delta = state.position - mean
        mean = mean + delta / count
        m2 = m2 + delta * (state.position - mean)
        return (state, da, mean, m2, count, inv_mass), accept_prob

    state0 = HMCState(init_position, lp0, g0)
    da0 = _dual_averaging_init(initial_step_size)
    carry = (state0, da0, jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0), jnp.ones(D))

    half = num_warmup // 2
    keys_w1 = jax.random.split(jax.random.fold_in(key, 0), half)
    carry, _ = jax.lax.scan(warmup_step, carry, keys_w1)
    # set mass from first-half variance, reset Welford, continue
    state, da, mean, m2, count, _ = carry
    var = m2 / jnp.maximum(count - 1.0, 1.0)
    inv_mass = jnp.clip(var, 1e-4, 1e4)
    da = _dual_averaging_init(jnp.exp(da["log_step_avg"]))
    carry = (state, da, jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0), inv_mass)
    keys_w2 = jax.random.split(jax.random.fold_in(key, 1), num_warmup - half)
    carry, _ = jax.lax.scan(warmup_step, carry, keys_w2)
    state, da, _, _, _, inv_mass = carry
    step_size = jnp.exp(da["log_step_avg"])
    return state, step_size, inv_mass


def hmc_sample_range(
    logprob_fn: Callable[[Array], Array],
    state: HMCState,
    key: Array,
    num_samples_total: int,
    start: int,
    stop: int,
    step_size: Array,
    inv_mass: Array,
    num_leapfrog: int = 16,
) -> Tuple[HMCState, Array, Array]:
    """Draw samples [start, stop) of the SAME stream :func:`hmc` produces
    with ``num_samples=num_samples_total`` — per-step keys are sliced from
    the one precomputed key array, so segmented runs are bit-identical to
    monolithic ones.  Returns (state, samples, accept_probs)."""
    _, one_step = _make_kernel(logprob_fn, num_leapfrog)

    def sample_step(state, key):
        state, accept_prob = one_step(state, key, step_size, inv_mass)
        return state, (state.position, accept_prob)

    keys_s = jax.random.split(jax.random.fold_in(key, 2), num_samples_total)[start:stop]
    state, (samples, accept_probs) = jax.lax.scan(sample_step, state, keys_s)
    return state, samples, accept_probs


def hmc(
    logprob_fn: Callable[[Array], Array],
    init_position: Array,
    key: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[Array, dict]:
    """Single-chain HMC; returns (samples (num_samples, D), info)."""
    state, step_size, inv_mass = hmc_warmup(
        logprob_fn, init_position, key, num_warmup, num_leapfrog,
        initial_step_size, target_accept,
    )
    state, samples, accept_probs = hmc_sample_range(
        logprob_fn, state, key, num_samples, 0, num_samples,
        step_size, inv_mass, num_leapfrog,
    )
    info = dict(
        step_size=step_size,
        inv_mass=inv_mass,
        mean_accept=jnp.mean(accept_probs),
    )
    return samples, info


def hmc_batched(
    lp_and_grad_batched: Callable[[Array], Tuple[Array, Array]],
    init_positions: Array,
    key: Optional[Array] = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_keys: Optional[Array] = None,
) -> Tuple[Array, dict]:
    """All-chains-in-ONE-scan HMC with ensemble-last state.

    ``lp_and_grad_batched(q (T, E)) -> (lp (E,), grad (T, E))`` evaluates
    every chain at once — the caller supplies the batched gradient
    directly (e.g. the fused small-LML of
    ``ops.fused_lml.small_lml_value_grad``), so no AD and no per-chain
    ``vmap`` ever runs.

    Why not ``vmap(hmc)``: each vmapped leapfrog step lowers to hundreds
    of tiny XLA fusions on (n, E) tiles, a cost set by launches rather
    than arithmetic.  Here one leapfrog step is a handful of (T, E)
    elementwise ops plus ONE batched value+grad call.  Step size and mass adapt per chain (dual averaging
    / Welford on (E,)-vectors), matching :func:`hmc` chainwise.

    All randomness derives PER CHAIN from ``chain_keys[e]`` (folded by
    phase and step index), so the draws are invariant to how the lane
    axis is sharded — a mesh run equals the unsharded run bit-exactly
    (asserted by tests/multihost_worker.py stage 3).

    Returns (samples (E, S, T), info).
    """
    T, E = init_positions.shape
    if chain_keys is None:
        if key is None:
            raise ValueError(
                "hmc_batched needs either `key` or `chain_keys` "
                "(both were None)"
            )
        chain_keys = jax.random.split(key, E)

    state, step, inv_mass = hmc_batched_warmup(
        lp_and_grad_batched, init_positions, chain_keys, num_warmup,
        num_leapfrog, initial_step_size, target_accept,
    )
    state, samples, accepts = hmc_batched_sample_range(
        lp_and_grad_batched, state, chain_keys, 0, num_samples,
        step, inv_mass, num_leapfrog,
    )
    info = dict(
        step_size=step,
        inv_mass=jnp.transpose(inv_mass, (1, 0)),
        mean_accept=jnp.mean(accepts, axis=0),
    )
    return samples, info


def _batched_machinery(lp_and_grad_batched, chain_keys, T, num_leapfrog):
    """(step_keys, one_step) shared by the batched warmup and sampling
    phases.  All randomness derives per chain from ``chain_keys[e]`` folded
    by (phase, step-index) — so any [start, stop) slice of steps draws the
    exact keys the monolithic run would (checkpointed resume is
    bit-identical by construction)."""

    def step_keys(phase, s):
        """(E,) per-chain keys for step s of warmup-1/warmup-2/sampling."""
        return jax.vmap(
            lambda ck: jax.random.fold_in(jax.random.fold_in(ck, phase), s)
        )(chain_keys)

    def leapfrog(q, p, g, step, inv_mass):
        def body(carry, _):
            q, p, g = carry
            p = p + 0.5 * step[None, :] * g
            q = q + step[None, :] * inv_mass * p
            lp, g = lp_and_grad_batched(q)
            p = p + 0.5 * step[None, :] * g
            return (q, p, g), lp

        (q, p, g), lps = jax.lax.scan(body, (q, p, g), None, length=num_leapfrog)
        return q, p, g, lps[-1]

    def one_step(state, keys_e, step, inv_mass):
        q0, lp0, g0 = state
        pair = jax.vmap(lambda k: jax.random.split(k))(keys_e)  # (E, 2, ...)
        k_mom, k_acc = pair[:, 0], pair[:, 1]
        p0 = jnp.transpose(
            jax.vmap(lambda k: jax.random.normal(k, (T,)))(k_mom)
        ) / jnp.sqrt(inv_mass)
        q, p, g, lp = leapfrog(q0, p0, g0, step, inv_mass)
        ke0 = 0.5 * jnp.sum(p0 * p0 * inv_mass, axis=0)
        ke1 = 0.5 * jnp.sum(p * p * inv_mass, axis=0)
        log_accept = (lp - ke1) - (lp0 - ke0)
        accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
        u = jax.vmap(lambda k: jax.random.uniform(k))(k_acc)
        accept = u < accept_prob
        state = (
            jnp.where(accept[None, :], q, q0),
            jnp.where(accept, lp, lp0),
            jnp.where(accept[None, :], g, g0),
        )
        return state, accept_prob

    return step_keys, one_step


def _batched_adaptation(one_step, step_keys, state0, T, E, num_warmup,
                        initial_step_size, target_accept):
    """The two-window dual-averaging + Welford adaptation shared by
    :func:`hmc_batched_warmup` and :func:`nuts_batched` — generic over the
    transition kernel ``one_step(state, keys_e, step, inv_mass)``."""

    def make_warmup_step(phase):
        def warmup_step(carry, s):
            state, da, mean, m2, count, inv_mass = carry
            step = jnp.exp(da["log_step"])
            state, accept_prob = one_step(state, step_keys(phase, s), step, inv_mass)
            da = _dual_averaging_update(da, accept_prob, target=target_accept)
            count += 1.0
            delta = state[0] - mean
            mean = mean + delta / count
            m2 = m2 + delta * (state[0] - mean)
            return (state, da, mean, m2, count, inv_mass), accept_prob

        return warmup_step

    da0 = _dual_averaging_init(jnp.full((E,), initial_step_size))
    carry = (state0, da0, jnp.zeros((T, E)), jnp.zeros((T, E)),
             jnp.asarray(0.0), jnp.ones((T, E)))
    half = num_warmup // 2
    carry, _ = jax.lax.scan(make_warmup_step(0), carry, jnp.arange(half))
    state, da, mean, m2, count, _ = carry
    var = m2 / jnp.maximum(count - 1.0, 1.0)
    inv_mass = jnp.clip(var, 1e-4, 1e4)
    da = _dual_averaging_init(jnp.exp(da["log_step_avg"]))
    carry = (state, da, jnp.zeros((T, E)), jnp.zeros((T, E)),
             jnp.asarray(0.0), inv_mass)
    carry, _ = jax.lax.scan(
        make_warmup_step(1), carry, jnp.arange(num_warmup - half)
    )
    state, da, _, _, _, inv_mass = carry
    step = jnp.exp(da["log_step_avg"])
    return state, step, inv_mass


def hmc_batched_warmup(
    lp_and_grad_batched: Callable[[Array], Tuple[Array, Array]],
    init_positions: Array,
    chain_keys: Array,
    num_warmup: int = 500,
    num_leapfrog: int = 16,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[Tuple[Array, Array, Array], Array, Array]:
    """Adaptation phase of :func:`hmc_batched` alone: dual-averaging step
    size + Welford diagonal mass on (E,)/(T, E) vectors.  Returns
    (state (q, lp, g), step (E,), inv_mass (T, E)) — exactly the carry
    :func:`hmc_batched` holds when sampling starts, so checkpointed runs
    (``parallel.checkpointed.run_hmc_batched_checkpointed``) resume
    bit-identically."""
    T, E = init_positions.shape
    step_keys, one_step = _batched_machinery(
        lp_and_grad_batched, chain_keys, T, num_leapfrog
    )
    lp0, g0 = lp_and_grad_batched(init_positions)
    state0 = (init_positions, lp0, g0)
    return _batched_adaptation(
        one_step, step_keys, state0, T, E, num_warmup, initial_step_size,
        target_accept,
    )


def hmc_batched_sample_range(
    lp_and_grad_batched: Callable[[Array], Tuple[Array, Array]],
    state: Tuple[Array, Array, Array],
    chain_keys: Array,
    start: int,
    stop: int,
    step: Array,
    inv_mass: Array,
    num_leapfrog: int = 16,
) -> Tuple[Tuple[Array, Array, Array], Array, Array]:
    """Draw samples [start, stop) of the SAME stream :func:`hmc_batched`
    produces — step s uses key fold_in(fold_in(chain_key, 2), s) regardless
    of segmenting, so segmented runs are bit-identical to monolithic ones.
    Returns (state, samples (E, stop-start, T), accept_probs (stop-start, E))."""
    T = state[0].shape[0]
    step_keys, one_step = _batched_machinery(
        lp_and_grad_batched, chain_keys, T, num_leapfrog
    )

    def sample_step(state, s):
        state, a = one_step(state, step_keys(2, s), step, inv_mass)
        return state, (state[0], a)

    state, (samples, accepts) = jax.lax.scan(
        sample_step, state, jnp.arange(start, stop)
    )
    # (S, T, E) -> (E, S, T)
    return state, jnp.transpose(samples, (2, 0, 1)), accepts


def _nuts_batched_machinery(lp_and_grad_batched, chain_keys, T, max_depth):
    """(step_keys, one_step) for ensemble-last batched NUTS.

    Same tree policy as the single-chain :func:`nuts` (iterative doubling,
    multinomial proposal across the trajectory, no intra-subtree U-turn
    checks), evaluated for ALL lanes at once over the caller's batched
    value+grad — e.g. the fused small-LML — so one doubling round's
    2^depth leapfrog steps are each a handful of (T, E) elementwise ops
    plus ONE batched value+grad call.

    Per-lane dynamic tree depth is handled with masks: a round runs while
    ANY lane is still building (``lax.cond`` skips whole rounds once every
    lane has turned/diverged — only the taken branch executes), and
    finished lanes' tree state is frozen by per-lane ``where``.  Worst lane
    in the batch sets the round count; for the GP hyperposterior workload
    typical depths are 2–5 of ``max_depth``.
    """

    def step_keys(phase, s):
        return jax.vmap(
            lambda ck: jax.random.fold_in(jax.random.fold_in(ck, phase), s)
        )(chain_keys)

    def one_step(state, keys_e, step, inv_mass):
        q0, lp0, g0 = state
        E = q0.shape[1]
        k_mom = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys_e)
        p0 = jnp.transpose(
            jax.vmap(lambda k: jax.random.normal(k, (T,)))(k_mom)
        ) / jnp.sqrt(inv_mass)
        ke0 = 0.5 * jnp.sum(p0 * p0 * inv_mass, axis=0)
        H0 = -lp0 + ke0  # (E,)

        tree = dict(
            q_l=q0, p_l=p0, g_l=g0, q_r=q0, p_r=p0, g_r=g0,
            q_prop=q0, lp_prop=lp0, g_prop=g0,
            log_w=-H0,
            turning=jnp.zeros(E, bool), diverged=jnp.zeros(E, bool),
            sum_accept=jnp.zeros(E), n_leap=jnp.zeros(E),
        )

        def fold2(base, a, b):
            return jax.vmap(
                lambda k: jax.random.fold_in(jax.random.fold_in(k, a), b)
            )(base)

        for depth in range(max_depth):
            k_dir = fold2(keys_e, 1, depth)
            k_merge = fold2(keys_e, 2, depth)
            k_sel_base = fold2(keys_e, 3, depth)
            active = (~tree["turning"]) & (~tree["diverged"])

            def run_round(tree, depth=depth, k_dir=k_dir, k_merge=k_merge,
                          k_sel_base=k_sel_base, active=active):
                go_right = jax.vmap(jax.random.bernoulli)(k_dir)  # (E,)
                eps = jnp.where(go_right, step, -step)
                q = jnp.where(go_right[None, :], tree["q_r"], tree["q_l"])
                p = jnp.where(go_right[None, :], tree["p_r"], tree["p_l"])
                g = jnp.where(go_right[None, :], tree["g_r"], tree["g_l"])

                def leap(carry, i):
                    q, p, g, log_w_sub, q_p, lp_p, g_p, sum_a, n_l, div = carry
                    p_half = p + 0.5 * eps[None, :] * g
                    q_new = q + eps[None, :] * inv_mass * p_half
                    lp_new, g_new = lp_and_grad_batched(q_new)
                    p_new = p_half + 0.5 * eps[None, :] * g_new
                    ke = 0.5 * jnp.sum(p_new * p_new * inv_mass, axis=0)
                    dH = H0 - (-lp_new + ke)
                    div = div | (dH < -1000.0)
                    log_w_tot = jnp.logaddexp(log_w_sub, dH)
                    u = jax.vmap(
                        lambda k, ii: jax.random.uniform(jax.random.fold_in(k, ii)),
                        in_axes=(0, None),
                    )(k_sel_base, i)
                    take = jnp.log(u) < (dH - log_w_tot)
                    q_p = jnp.where(take[None, :], q_new, q_p)
                    lp_p = jnp.where(take, lp_new, lp_p)
                    g_p = jnp.where(take[None, :], g_new, g_p)
                    sum_a = sum_a + jnp.minimum(1.0, jnp.exp(dH))
                    n_l = n_l + 1.0
                    return (q_new, p_new, g_new, log_w_tot, q_p, lp_p, g_p,
                            sum_a, n_l, div), None

                carry0 = (
                    q, p, g, jnp.full((E,), -jnp.inf),
                    tree["q_prop"], tree["lp_prop"], tree["g_prop"],
                    jnp.zeros(E), jnp.zeros(E), jnp.zeros(E, bool),
                )
                carry, _ = jax.lax.scan(leap, carry0, jnp.arange(2 ** depth))
                (q_e, p_e, g_e, log_w_sub, q_p, lp_p, g_p,
                 sum_a, n_l, div_sub) = carry

                log_w_tot = jnp.logaddexp(tree["log_w"], log_w_sub)
                u_m = jax.vmap(jax.random.uniform)(k_merge)
                take_sub = jnp.log(u_m) < (log_w_sub - log_w_tot)
                sel = active & take_sub
                sel2 = sel[None, :]
                act2 = active[None, :]
                upd_r = act2 & go_right[None, :]
                upd_l = act2 & ~go_right[None, :]

                q_l = jnp.where(upd_l, q_e, tree["q_l"])
                p_l = jnp.where(upd_l, p_e, tree["p_l"])
                g_l = jnp.where(upd_l, g_e, tree["g_l"])
                q_r = jnp.where(upd_r, q_e, tree["q_r"])
                p_r = jnp.where(upd_r, p_e, tree["p_r"])
                g_r = jnp.where(upd_r, g_e, tree["g_r"])
                dq = q_r - q_l
                turn = (jnp.sum(dq * inv_mass * p_l, axis=0) < 0) | (
                    jnp.sum(dq * inv_mass * p_r, axis=0) < 0
                )
                return dict(
                    q_l=q_l, p_l=p_l, g_l=g_l, q_r=q_r, p_r=p_r, g_r=g_r,
                    q_prop=jnp.where(sel2, q_p, tree["q_prop"]),
                    lp_prop=jnp.where(sel, lp_p, tree["lp_prop"]),
                    g_prop=jnp.where(sel2, g_p, tree["g_prop"]),
                    log_w=jnp.where(active, log_w_tot, tree["log_w"]),
                    turning=jnp.where(active, turn, tree["turning"]),
                    diverged=jnp.where(active, tree["diverged"] | div_sub,
                                       tree["diverged"]),
                    sum_accept=tree["sum_accept"] + jnp.where(active, sum_a, 0.0),
                    n_leap=tree["n_leap"] + jnp.where(active, n_l, 0.0),
                )

            tree = jax.lax.cond(jnp.any(active), run_round, lambda t: t, tree)

        accept_stat = tree["sum_accept"] / jnp.maximum(tree["n_leap"], 1.0)
        new_state = (tree["q_prop"], tree["lp_prop"], tree["g_prop"])
        return new_state, accept_stat

    return step_keys, one_step


def nuts_batched(
    lp_and_grad_batched: Callable[[Array], Tuple[Array, Array]],
    init_positions: Array,
    key: Optional[Array] = None,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    chain_keys: Optional[Array] = None,
) -> Tuple[Array, dict]:
    """All-chains-in-one-scan NUTS over a batched value+grad — the fused
    twin of :func:`hmc_batched` for :func:`nuts`.

    Same contract as :func:`hmc_batched`: ``lp_and_grad_batched(q (T, E))
    -> (lp (E,), grad (T, E))``, finite-guarded by the caller; returns
    (samples (E, S, T), info).  Same two-window adaptation, same per-chain
    fold_in key discipline (draws invariant to lane sharding).
    """
    T, E = init_positions.shape
    if chain_keys is None:
        if key is None:
            raise ValueError(
                "nuts_batched needs either `key` or `chain_keys` "
                "(both were None)"
            )
        chain_keys = jax.random.split(key, E)
    step_keys, one_step = _nuts_batched_machinery(
        lp_and_grad_batched, chain_keys, T, max_depth
    )
    lp0, g0 = lp_and_grad_batched(init_positions)
    state, step, inv_mass = _batched_adaptation(
        one_step, step_keys, (init_positions, lp0, g0), T, E, num_warmup,
        initial_step_size, target_accept,
    )

    def sample_step(state, s):
        state, a = one_step(state, step_keys(2, s), step, inv_mass)
        return state, (state[0], a)

    state, (samples, accepts) = jax.lax.scan(
        sample_step, state, jnp.arange(num_samples)
    )
    samples = jnp.transpose(samples, (2, 0, 1))
    info = dict(
        step_size=step,
        inv_mass=jnp.transpose(inv_mass, (1, 0)),
        mean_accept=jnp.mean(accepts, axis=0),
    )
    return samples, info


def nuts(
    logprob_fn: Callable[[Array], Array],
    init_position: Array,
    key: Array,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
) -> Tuple[Array, dict]:
    """Iterative No-U-Turn sampler (multinomial, Hoffman & Gelman 2014 /
    Betancourt 2017 style) with the same warm-up as :func:`hmc`.

    The doubling tree is built iteratively under ``lax.while_loop`` with a
    fixed ``max_depth`` so the program is shape-static for XLA.
    """
    lp_and_grad = jax.value_and_grad(logprob_fn)

    def safe_lp_and_grad(q):
        lp, g = lp_and_grad(q)
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -1e10, lp)
        g = jnp.where(jnp.isfinite(g), g, 0.0)
        return lp, g

    D = init_position.shape[0]

    def energy(lp, p, inv_mass):
        return -lp + 0.5 * jnp.sum(p * p * inv_mass)

    def one_step(state, key, step_size, inv_mass):
        """One NUTS transition via iterative doubling."""
        k_mom, k_dir, k_mult = jax.random.split(key, 3)
        p0 = jax.random.normal(k_mom, (D,)) / jnp.sqrt(inv_mass)
        H0 = energy(state.log_prob, p0, inv_mass)

        # tree state: endpoints (q,p,g) left/right, proposal, log weight
        init = dict(
            q_l=state.position, p_l=p0, g_l=state.grad,
            q_r=state.position, p_r=p0, g_r=state.grad,
            q_prop=state.position, lp_prop=state.log_prob, g_prop=state.grad,
            log_w=-H0,
            sum_p=p0,
            depth=0,
            turning=False,
            diverged=False,
            key=jax.random.fold_in(k_mult, 0),
            sum_accept=jnp.asarray(0.0),
            n_leapfrog=jnp.asarray(0.0),
        )

        def cond(t):
            return (~t["turning"]) & (~t["diverged"]) & (t["depth"] < max_depth)

        def body(t):
            key = jax.random.fold_in(t["key"], t["depth"])
            k_d, k_sel, k_nxt = jax.random.split(key, 3)
            go_right = jax.random.bernoulli(k_d)

            # Build a subtree of 2^depth leapfrog steps in the chosen
            # direction, accumulating a multinomial proposal.
            n_steps = 2 ** jnp.minimum(t["depth"], max_depth)

            def leap(carry, _):
                q, p, g, log_w, q_p, lp_p, g_p, sum_a, n_l, sum_p, div, key_in = carry
                eps = jnp.where(go_right, step_size, -step_size)
                p_half = p + 0.5 * eps * g
                q_new = q + eps * inv_mass * p_half
                lp_new, g_new = safe_lp_and_grad(q_new)
                p_new = p_half + 0.5 * eps * g_new
                H = energy(lp_new, p_new, inv_mass)
                dH = H0 - H
                div = div | (dH < -1000.0)
                w_new = dH  # log weight of this point
                # multinomial: keep new point with prob w_new/(w_tot)
                log_w_tot = jnp.logaddexp(log_w, w_new)
                k_sel2, key_out = jax.random.split(key_in)
                take = jnp.log(jax.random.uniform(k_sel2)) < (w_new - log_w_tot)
                q_p = jnp.where(take, q_new, q_p)
                lp_p = jnp.where(take, lp_new, lp_p)
                g_p = jnp.where(take, g_new, g_p)
                sum_a += jnp.minimum(1.0, jnp.exp(dH))
                n_l += 1.0
                sum_p = sum_p + p_new
                return (q_new, p_new, g_new, log_w_tot, q_p, lp_p, g_p, sum_a, n_l, sum_p, div, key_out), None

            q0 = jnp.where(go_right, t["q_r"], t["q_l"])
            p0_ = jnp.where(go_right, t["p_r"], t["p_l"])
            g0_ = jnp.where(go_right, t["g_r"], t["g_l"])
            carry0 = (
                q0, p0_, g0_, -jnp.inf,
                t["q_prop"], t["lp_prop"], t["g_prop"],
                t["sum_accept"], t["n_leapfrog"], t["sum_p"], t["diverged"], k_sel,
            )
            # NOTE: n_steps is dynamic; use fori_loop over max 2^max_depth
            # with masking is wasteful — instead scan 2^depth via switch on
            # static depth values.
            def make_scan(n):
                def run(c):
                    c_out, _ = jax.lax.scan(leap, c, None, length=n)
                    return c_out
                return run

            branches = [make_scan(2**d) for d in range(max_depth)]
            c_out = jax.lax.switch(jnp.minimum(t["depth"], max_depth - 1), branches, carry0)
            (q_e, p_e, g_e, log_w_sub, q_p, lp_p, g_p, sum_a, n_l, sum_p, div, _) = c_out

            # combine subtree with main tree (multinomial between trees)
            log_w_tot = jnp.logaddexp(t["log_w"], log_w_sub)
            take_sub = jnp.log(jax.random.uniform(k_sel)) < (log_w_sub - log_w_tot)
            q_prop = jnp.where(take_sub, q_p, t["q_prop"])
            lp_prop = jnp.where(take_sub, lp_p, t["lp_prop"])
            g_prop = jnp.where(take_sub, g_p, t["g_prop"])

            q_l = jnp.where(go_right, t["q_l"], q_e)
            p_l = jnp.where(go_right, t["p_l"], p_e)
            g_l = jnp.where(go_right, t["g_l"], g_e)
            q_r = jnp.where(go_right, q_e, t["q_r"])
            p_r = jnp.where(go_right, p_e, t["p_r"])
            g_r = jnp.where(go_right, g_e, t["g_r"])

            dq = q_r - q_l
            turning = (jnp.dot(dq, inv_mass * p_l) < 0) | (jnp.dot(dq, inv_mass * p_r) < 0)

            return dict(
                q_l=q_l, p_l=p_l, g_l=g_l, q_r=q_r, p_r=p_r, g_r=g_r,
                q_prop=q_prop, lp_prop=lp_prop, g_prop=g_prop,
                log_w=log_w_tot, sum_p=sum_p,
                depth=t["depth"] + 1, turning=turning, diverged=div,
                key=k_nxt, sum_accept=sum_a, n_leapfrog=n_l,
            )

        t = jax.lax.while_loop(cond, body, init)
        accept_stat = t["sum_accept"] / jnp.maximum(t["n_leapfrog"], 1.0)
        new_state = HMCState(t["q_prop"], t["lp_prop"], t["g_prop"])
        return new_state, accept_stat

    # ---- same two-window warmup as hmc ----
    lp0, g0 = safe_lp_and_grad(init_position)
    state0 = HMCState(init_position, lp0, g0)

    def warmup_step(carry, key):
        state, da, mean, m2, count, inv_mass = carry
        step_size = jnp.exp(da["log_step"])
        state, accept_prob = one_step(state, key, step_size, inv_mass)
        da = _dual_averaging_update(da, accept_prob, target=target_accept)
        count += 1.0
        delta = state.position - mean
        mean = mean + delta / count
        m2 = m2 + delta * (state.position - mean)
        return (state, da, mean, m2, count, inv_mass), accept_prob

    da0 = _dual_averaging_init(initial_step_size)
    carry = (state0, da0, jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0), jnp.ones(D))
    half = num_warmup // 2
    carry, _ = jax.lax.scan(warmup_step, carry, jax.random.split(jax.random.fold_in(key, 0), half))
    state, da, mean, m2, count, _ = carry
    var = m2 / jnp.maximum(count - 1.0, 1.0)
    inv_mass = jnp.clip(var, 1e-4, 1e4)
    da = _dual_averaging_init(jnp.exp(da["log_step_avg"]))
    carry = (state, da, jnp.zeros(D), jnp.zeros(D), jnp.asarray(0.0), inv_mass)
    carry, _ = jax.lax.scan(warmup_step, carry, jax.random.split(jax.random.fold_in(key, 1), num_warmup - half))
    state, da, _, _, _, inv_mass = carry
    step_size = jnp.exp(da["log_step_avg"])

    def sample_step(state, key):
        state, a = one_step(state, key, step_size, inv_mass)
        return state, (state.position, a)

    state, (samples, accepts) = jax.lax.scan(
        sample_step, state, jax.random.split(jax.random.fold_in(key, 2), num_samples)
    )
    return samples, dict(step_size=step_size, inv_mass=inv_mass, mean_accept=jnp.mean(accepts))


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------

def split_rhat(chains: Array) -> Array:
    """Split-R̂ per dimension.  chains: (C, S, D) → (D,)."""
    C, S, D = chains.shape
    half = S // 2
    x = chains[:, : 2 * half, :].reshape(C * 2, half, D)
    m = x.mean(axis=1)  # (2C, D)
    w = x.var(axis=1, ddof=1).mean(axis=0)  # within
    b = half * m.var(axis=0, ddof=1)  # between
    var_plus = (half - 1) / half * w + b / half
    return jnp.sqrt(var_plus / jnp.maximum(w, 1e-30))


def effective_sample_size(chains: Array, max_lag: int = 100) -> Array:
    """Bulk ESS per dimension via autocorrelation (Geyer initial positive
    sequence, truncated).  chains: (C, S, D) → (D,)."""
    C, S, D = chains.shape
    x = chains - chains.mean(axis=1, keepdims=True)
    max_lag = min(max_lag, S - 1)

    den = jnp.mean(x * x, axis=(0, 1))
    t_idx = jnp.arange(S)

    def rho_at(lag):
        # roll+mask keeps shapes static so `lag` can be traced under vmap
        y = jnp.roll(x, -lag, axis=1)
        mask = (t_idx < S - lag)[None, :, None]
        num = jnp.sum(x * y * mask, axis=(0, 1)) / jnp.maximum(
            C * (S - lag), 1
        )
        return num / jnp.maximum(den, 1e-30)

    rhos = jax.vmap(rho_at)(jnp.arange(1, max_lag + 1))  # (L, D)
    positive = jnp.cumprod(rhos > -0.05, axis=0).astype(rhos.dtype)
    tau = 1.0 + 2.0 * jnp.sum(rhos * positive, axis=0)
    return C * S / jnp.maximum(tau, 1.0)


# ---------------------------------------------------------------------------
# GP hyperparameter posterior, sharded chains
# ---------------------------------------------------------------------------

def sample_gp_posterior(
    kernel,
    X: Array,
    Y: Array,
    key: Array,
    num_chains: int = 8,
    num_warmup: int = 300,
    num_samples: int = 300,
    algorithm: str = "hmc",
    mesh: Optional[Mesh] = None,
    jitter: float = 1e-10,
    fused: Optional[bool] = None,
    **kw,
):
    """Sample p(θ | X, Y) ∝ exp(LML) with a flat prior inside the kernel's
    log-bounds (matching the search region of the reference's restarts).

    Chains vmap over the leading axis; with a mesh they shard over 'ens'.
    Returns (samples (C, S, n_theta), diagnostics dict).

    Fast path: for the C·stationary(+White) family at n ≤ 32 with
    ``algorithm='hmc'``, all chains run ensemble-last in ONE scan
    (:func:`hmc_batched`) over the per-lane LML value+grad
    (``ops.fused_lml``) instead of vmapped AD, whose per-leapfrog cost is
    launches, not arithmetic.
    """
    from ..models.exact_gp import log_marginal_likelihood, small_lml_theta_layout

    bounds = kernel.theta_bounds
    lo, hi = bounds[:, 0], bounds[:, 1]

    Y2 = Y if Y.ndim == 2 else Y[:, None]
    layout = small_lml_theta_layout(kernel)
    use_fused = (
        algorithm in ("hmc", "nuts")
        and layout is not None
        and X.shape[0] <= 32
        and Y2.shape[1] <= 8
    )
    if fused is not None:
        use_fused = bool(fused) and use_fused
    # NOTE on distributed determinism: random streams are per chain
    # (sharding-invariant) and hmc_batched itself is bit-equal under
    # shard_map.  The fused path's LML runs one elementwise program per lane
    # (``ops.fused_lml``), so a chain's arithmetic does not depend on how
    # many chains share a device: sharded and unsharded runs are
    # bit-identical.  The generic path's vmapped AD reduces over the Gram
    # with XLA reductions compiled for the per-device batch; bit-identical
    # on the CPU (the multihost gate), but on a GPU the last bits may
    # differ and accept/reject amplifies them (PERF.md).
    if use_fused:
        return _sample_gp_posterior_fused(
            kernel, X, Y2, key, layout, lo, hi, num_chains, num_warmup,
            num_samples, mesh, jitter, algorithm=algorithm, **kw,
        )

    def logprob(theta):
        lml = log_marginal_likelihood(kernel.with_theta(theta), X, Y, jitter)
        # smooth barrier keeping chains inside the bounds
        barrier = jnp.sum(
            jax.nn.softplus(-(theta - lo) * 20.0) + jax.nn.softplus((theta - hi) * 20.0)
        )
        return lml - 100.0 * barrier

    k_init, k_run = jax.random.split(key)
    u = jax.random.uniform(k_init, (num_chains, lo.shape[0]))
    inits = lo + u * (hi - lo) * 0.5 + 0.25 * (hi - lo)  # central half of the box
    chain_keys = jax.random.split(k_run, num_chains)
    if mesh is not None:
        sh = NamedSharding(mesh, P("ens"))
        from .mesh import global_put
        inits = global_put(inits, sh)
        chain_keys = global_put(chain_keys, sh)

    sampler = hmc if algorithm == "hmc" else nuts
    run = jax.jit(
        jax.vmap(
            lambda q0, k: sampler(
                logprob, q0, k, num_warmup=num_warmup, num_samples=num_samples, **kw
            )
        )
    )
    samples, info = run(inits, chain_keys)
    diags = dict(
        rhat=split_rhat(samples),
        ess=effective_sample_size(samples),
        mean_accept=info["mean_accept"],
    )
    return samples, diags


@functools.lru_cache(maxsize=64)
def _fused_local_runner(family, n_ls, has_noise, jitter,
                        num_warmup, num_samples, kw_items, algo="hmc"):
    """Jitted (X, Y2, lo_c, hi_c, q0, key) -> {hmc,nuts}_batched(...),
    cached on the static config so repeat `sample_gp_posterior` calls hit
    the SAME jit wrapper — a fresh `jax.jit(closure)` per call retraces
    every time (~1 s of pure host work per call at the bench workload,
    dwarfing the 160 ms of device time on the fused path)."""
    from ..ops.fused_lml import small_lml_value_grad

    kw = dict(kw_items)
    sampler = hmc_batched if algo == "hmc" else nuts_batched

    @jax.jit
    def run(X, Y2, lo_c, hi_c, q0_te, cks):
        def lp_and_grad(theta_te):
            val, grad = small_lml_value_grad(
                X, Y2, theta_te, family=family, n_ls=n_ls,
                has_noise=has_noise, jitter=jitter,
            )
            z_lo = (theta_te - lo_c) * 20.0
            z_hi = (theta_te - hi_c) * 20.0
            barrier = jnp.sum(
                jax.nn.softplus(-z_lo) + jax.nn.softplus(z_hi), axis=0
            )
            d_barrier = 20.0 * (jax.nn.sigmoid(z_hi) - jax.nn.sigmoid(-z_lo))
            lp = val - 100.0 * barrier
            g = grad - 100.0 * d_barrier
            bad = ~jnp.isfinite(lp)
            lp = jnp.where(bad, -1e10, lp)
            g = jnp.where(jnp.isfinite(g) & ~bad[None, :], g, 0.0)
            return lp, g

        return sampler(
            lp_and_grad, q0_te, num_warmup=num_warmup,
            num_samples=num_samples, chain_keys=cks, **kw,
        )

    return run


@functools.lru_cache(maxsize=64)
def _fused_mesh_runner(mesh, family, n_ls, has_noise, jitter,
                       num_warmup, num_samples, kw_items, algo="hmc"):
    """Mesh twin of :func:`_fused_local_runner`: the jitted ``shard_map``
    runner cached on (mesh, static config) — a fresh ``jax.jit(shard_map)``
    per call re-incurs the ~1 s host-side retrace the local cache was added
    to avoid."""
    from ..ops.fused_lml import small_lml_value_grad

    try:
        from jax import shard_map
    except ImportError:  # pragma: no cover - older jax
        from jax.experimental.shard_map import shard_map

    kw = dict(kw_items)
    sampler = hmc_batched if algo == "hmc" else nuts_batched

    def run_local(X, Y2, lo_c, hi_c, q0_te, cks):
        def lp_and_grad(theta_te):
            val, grad = small_lml_value_grad(
                X, Y2, theta_te, family=family, n_ls=n_ls,
                has_noise=has_noise, jitter=jitter,
            )
            z_lo = (theta_te - lo_c) * 20.0
            z_hi = (theta_te - hi_c) * 20.0
            barrier = jnp.sum(
                jax.nn.softplus(-z_lo) + jax.nn.softplus(z_hi), axis=0
            )
            d_barrier = 20.0 * (jax.nn.sigmoid(z_hi) - jax.nn.sigmoid(-z_lo))
            lp = val - 100.0 * barrier
            g = grad - 100.0 * d_barrier
            bad = ~jnp.isfinite(lp)
            lp = jnp.where(bad, -1e10, lp)
            g = jnp.where(jnp.isfinite(g) & ~bad[None, :], g, 0.0)
            return lp, g

        return sampler(
            lp_and_grad, q0_te, num_warmup=num_warmup,
            num_samples=num_samples, chain_keys=cks, **kw,
        )

    return jax.jit(
        shard_map(
            run_local, mesh=mesh,
            in_specs=(P(None, None), P(None, None), P(None, None),
                      P(None, None), P(None, "ens"), P("ens")),
            out_specs=(P("ens"), {"step_size": P("ens"),
                                  "inv_mass": P("ens"),
                                  "mean_accept": P("ens")}),
            check_vma=False,
        )
    )


def _sample_gp_posterior_fused(
    kernel, X, Y2, key, layout, lo, hi, num_chains, num_warmup, num_samples,
    mesh, jitter, algorithm="hmc", **kw,
):
    """Ensemble-last chains over the per-lane small-LML value+grad.

    Same target as the generic path (LML + the soft bound barrier), same
    init distribution; the barrier gradient is closed-form (softplus' =
    sigmoid) so the whole logprob_and_grad is AD-free.  With a mesh the
    lane (chain) axis shards over 'ens' via ``shard_map`` — chains are
    embarrassingly parallel, so each device runs its lanes independently
    with a device-folded key.
    """
    family, n_ls, has_noise, perm = layout
    inv_perm = np.argsort(perm)
    T = lo.shape[0]
    lo_c = jnp.asarray(lo)[perm][:, None]
    hi_c = jnp.asarray(hi)[perm][:, None]

    k_init, k_run = jax.random.split(key)
    u = jax.random.uniform(k_init, (num_chains, T))
    inits = lo + u * (hi - lo) * 0.5 + 0.25 * (hi - lo)  # central half of the box
    inits_te = jnp.transpose(inits[:, perm], (1, 0))  # (T, E) canonical order
    # per-CHAIN key streams: the random draws depend only on a chain's own
    # key, so sharded and unsharded runs are bit-identical
    chain_keys = jax.random.split(k_run, num_chains)

    if mesh is not None and num_chains % mesh.shape["ens"]:
        # shard_map needs the lane (chain) axis divisible by 'ens'; tiny
        # chain counts just run unsharded (chains are cheap E-last lanes)
        mesh = None
    if mesh is None:
        run = _fused_local_runner(
            family, n_ls, bool(has_noise), float(jitter),
            int(num_warmup), int(num_samples), tuple(sorted(kw.items())),
            algo=algorithm,
        )
        samples_c, info = run(X, Y2, lo_c, hi_c, inits_te, chain_keys)
    else:
        from .mesh import global_put

        inits_te = global_put(inits_te, NamedSharding(mesh, P(None, "ens")))
        chain_keys = global_put(chain_keys, NamedSharding(mesh, P("ens")))
        run = _fused_mesh_runner(
            mesh, family, n_ls, bool(has_noise), float(jitter),
            int(num_warmup), int(num_samples),
            tuple(sorted(kw.items())), algo=algorithm,
        )
        samples_c, info = run(X, Y2, lo_c, hi_c, inits_te, chain_keys)

    samples = samples_c[:, :, inv_perm]  # back to kernel.theta ordering
    diags = dict(
        rhat=split_rhat(samples),
        ess=effective_sample_size(samples),
        mean_accept=info["mean_accept"],
    )
    return samples, diags
