"""Distributed exact LML + hyperparameter gradients over a device mesh.

Extends the single-chip panel LML of ``ops/blocked_lml.py`` to the
block-cyclic distributed factor of ``parallel/sharded_chol.py`` — GP
hyperparameter optimization past one device's memory, a regime the reference cannot touch at all (its active-learning GP
subsets to 20 000 points *and* fits only the subset,
``policy_transportation/models/gaussian_process_al.py:16``).

SPMD design (one ``shard_map`` program over mesh axis ``data``, D devices;
all shapes static, all dynamic offsets are ``lax.dynamic_slice`` with
static sizes — the same discipline as ``sharded_chol``):

* **T = L⁻¹ columns, block-cyclic** (`_tri_inv_body`): outer loop over the
  P global panel steps; per step ONE masked-psum broadcast of the owner's
  factored panel + diagonal-block inverse (≈ Np² floats total, the same
  order as the factorization's own comms), then every device advances the
  forward substitution of the T columns it owns.  Device-local compute is
  ~Np³/D FLOPs (full-slot-height GEMMs; ~3× the serial-optimal N³/3 in
  exchange for static shapes and zero idle devices).
* **Trace-identity gradient** (`_lml_trace_body`): ∂LML/∂θ =
  ½⟨ααᵀ − P·K⁻¹, ∂K/∂θ⟩ accumulated block-pair-wise — K⁻¹(i,s) =
  T(:,i)ᵀT(:,s) is formed as ONE GEMM per pair by the owner of column i
  after a per-step broadcast of column s; ∂K blocks are rebuilt
  elementwise from the replicated inputs (no (N, N) object, distributed
  or otherwise, ever exists).
* α, log det and the LML value reuse the existing distributed
  substitution/logdet bodies.

No iterative refinement on α here (single-chip ``blocked_lml`` has it):
at HIGHEST precision, the default, it is unnecessary.  Cited reference semantics:
sklearn-equivalent LML and gradient, ``gaussian_process.py:17-29``.
"""
from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops.blocked_chol import stationary_from_sqdist
from ..ops.blocked_lml import stationary_dk_dd2
from .sharded_chol import (
    _bwd_sub,
    _factor_body,
    _fwd_sub,
    _local_gram_panels,
    _pad_rows,
    _plan,
)

Array = jax.Array
_HIGHEST = jax.lax.Precision.HIGHEST
_LOG_2PI = math.log(2.0 * math.pi)


def _dot(a, b, precision):
    return jnp.dot(a, b, preferred_element_type=jnp.float32, precision=precision)


def _tri_inv_body(L_loc, linv_loc, d, axis, block, D, Pl, Np, precision):
    """T = L⁻¹ columns in the block-cyclic slot layout (diag block at local
    row 0, slot height H_j = Np − j·D·B, zero overhang).

    ``lax.fori_loop`` over the Pnl global panel steps — the body compiles
    ONCE (the unrolled form put O(Pnl·Pl) GEMM/slice HLOs in the program
    and dominated its compile time).  The Pl-slot
    inner loop stays unrolled so every slot keeps its exact static
    trapezoid height; the now-dynamic panel index selects its slot with
    ``lax.switch`` (one slot touched, not a masked sum over all), and
    slots whose column hasn't started skip their GEMMs under ``lax.cond``
    instead of being peeled off the (static) loop bounds.
    """
    Pnl = Pl * D
    zero = jnp.zeros((), jnp.int32)
    eye = jnp.eye(block, dtype=jnp.float32)
    T0 = tuple(jnp.zeros_like(w) for w in L_loc)
    rest0 = tuple(_pad_rows(eye, Np - j * D * block) for j in range(Pl))

    def step(k, carry):
        T_loc, rest_loc = carry
        jk = k // D
        mine_k = d == (k % D)
        # ONE broadcast pair per step: the owner's factored panel (padded
        # to the tallest slot height — overhang rows are exactly zero) +
        # L_kk⁻¹.  Local coords: row m ↔ global row k·B + m.
        Lk_own = lax.switch(
            jk, [lambda j=j: _pad_rows(L_loc[j], Np) for j in range(Pl)]
        )
        linv_own = lax.switch(
            jk, [lambda j=j: linv_loc[j] for j in range(Pl)]
        )
        Lk = lax.psum(jnp.where(mine_k, Lk_own, 0.0), axis)
        linv_k = lax.psum(jnp.where(mine_k, linv_own, 0.0), axis)
        Lk_below = Lk.at[:block].set(0.0)  # diag block must not re-apply
        T_new, rest_new = [], []
        for j in range(Pl):
            Hj = Np - j * D * block
            s = j * D + d
            need = s <= k
            r = (k - s) * block
            r_safe = jnp.clip(r, 0, Hj - block).astype(jnp.int32)

            def upd(Tj, rj, Hj=Hj, r_safe=r_safe):
                blk = lax.dynamic_slice(rj, (r_safe, zero), (block, block))
                yk = _dot(linv_k, blk, precision)
                Tj = lax.dynamic_update_slice(Tj, yk, (r_safe, zero))
                # trailing update: rest[i] -= Lk_below[i - r] @ yk for
                # i >= r+B, as a shifted static-size slice of a zero-padded
                # Lk (rows of Lk past Hj are zero whenever need holds:
                # s <= k ⇒ true height Np−kB <= Hj)
                Lk_ext = jnp.concatenate(
                    [
                        jnp.zeros((Hj, block), jnp.float32),
                        _pad_rows(Lk_below[:Hj], Hj + D * block),
                    ],
                    axis=0,
                )
                shifted = lax.dynamic_slice(
                    Lk_ext, ((Hj - r_safe).astype(jnp.int32), zero),
                    (Hj, block),
                )
                rj = rj - _dot(shifted, yk, precision)
                return Tj, rj

            Tj, rj = lax.cond(
                need, upd, lambda Tj, rj: (Tj, rj), T_loc[j], rest_loc[j]
            )
            T_new.append(Tj)
            rest_new.append(rj)
        return tuple(T_new), tuple(rest_new)

    T_out, _ = lax.fori_loop(0, Pnl, step, (T0, rest0))
    return list(T_out)


def _lml_trace_body(
    T_loc, alpha_pad, Z_ext, d, axis, block, D, Pl, Np, n, p_out,
    amp, noise, family, precision,
):
    """(g_amp, g_ls (D_in,), g_noise) via the trace identity, block-pair-wise.

    Pair (i, s), i ≥ s, is handled by the owner of T column i after a
    broadcast of column s; results are psum-reduced at the end.
    ``Z_ext`` is the ℓ-scaled padded input (replicated).

    Same compile-once ``fori_loop``/``switch``/``cond`` structure as
    :func:`_tri_inv_body`, for the same compile-time reason.
    """
    Pnl = Pl * D
    nd = Z_ext.shape[1]
    zero = jnp.zeros((), jnp.int32)

    def step(s, carry):
        g_amp, g_ls, g_noise = carry
        js = s // D
        mine_s = d == (s % D)
        Ts_own = lax.switch(
            js, [lambda j=j: _pad_rows(T_loc[j], Np) for j in range(Pl)]
        )
        # pad to the tallest slot height (+ D·B) so every (even cond-
        # skipped) pair's static-size slice is in bounds
        Ts_ext = _pad_rows(
            lax.psum(jnp.where(mine_s, Ts_own, 0.0), axis), Np + D * block
        )
        off_s = (s * block).astype(jnp.int32)
        a_s = lax.dynamic_slice(
            alpha_pad, (off_s, zero), (block, alpha_pad.shape[1])
        )
        cols_s = lax.dynamic_slice(Z_ext, (off_s, zero), (block, nd))

        for j in range(Pl):
            i = j * D + d
            need = i >= s
            Hj = Np - j * D * block
            r = (i - s) * block
            r_safe = jnp.clip(r, 0, Np + D * block - Hj).astype(jnp.int32)

            def pair(i=i, j=j, Hj=Hj, r_safe=r_safe):
                Tsi = lax.dynamic_slice(Ts_ext, (r_safe, zero), (Hj, block))
                kinv_blk = _dot(T_loc[j].T, Tsi, precision)  # K⁻¹(i,s)ᵀ…
                # K⁻¹(i,s) = Σ_m T[m][i]ᵀ T[m][s]; rows index column-i
                # block rows, columns index column-s block rows.
                off_i = (i * block).astype(jnp.int32)
                a_i = lax.dynamic_slice(
                    alpha_pad, (off_i, zero), (block, alpha_pad.shape[1])
                )
                G = jnp.zeros((block, block), jnp.float32)
                for p in range(alpha_pad.shape[1]):
                    G = G + a_i[:, p, None] * a_s[None, :, p]
                rows_g = off_i + jnp.arange(block)[:, None]
                cols_g = off_s + jnp.arange(block)[None, :]
                w = jnp.where(i == s, 1.0, 2.0)
                mask = ((rows_g < n) & (cols_g < n)).astype(jnp.float32)
                Wk = (0.5 * (G - p_out * kinv_blk)) * (w * mask)
                rows_z = lax.dynamic_slice(Z_ext, (off_i, zero), (block, nd))
                d2 = jnp.zeros((block, block), jnp.float32)
                for dim in range(nd):
                    diff = rows_z[:, dim, None] - cols_s[None, :, dim]
                    d2 = d2 + diff * diff
                da = jnp.sum(Wk * (amp * stationary_from_sqdist(d2, family)))
                Wdk = Wk * (amp * stationary_dk_dd2(d2, family))
                dl = jnp.stack([
                    jnp.sum(
                        Wdk
                        * (-2.0)
                        * (rows_z[:, dim, None] - cols_s[None, :, dim]) ** 2
                    )
                    for dim in range(nd)
                ])
                dn = jnp.where(
                    i == s, noise * jnp.sum(jnp.diagonal(Wk)), 0.0
                )
                return da, dl, dn

            da, dl, dn = lax.cond(
                need,
                pair,
                lambda: (
                    jnp.zeros((), jnp.float32),
                    jnp.zeros((nd,), jnp.float32),
                    jnp.zeros((), jnp.float32),
                ),
            )
            g_amp = g_amp + da
            g_ls = g_ls + dl
            g_noise = g_noise + dn
        return g_amp, g_ls, g_noise

    g_amp, g_ls, g_noise = lax.fori_loop(
        0,
        Pnl,
        step,
        (
            jnp.zeros((), jnp.float32),
            jnp.zeros((nd,), jnp.float32),
            jnp.zeros((), jnp.float32),
        ),
    )
    g_amp = lax.psum(g_amp, axis)
    g_ls = lax.psum(g_ls, axis)
    g_noise = lax.psum(g_noise, axis)
    return g_amp, g_ls, g_noise


def sharded_lml_value_and_grad(
    X: Array,
    Y: Array,
    family: str,
    log_amp: Array,
    log_ls: Array,
    log_noise: Array,
    mesh: Mesh,
    axis: str = "data",
    block: int = 512,
    jitter: float = 1e-6,
    precision=_HIGHEST,
):
    """(LML, (∂/∂log amp, ∂/∂log ℓ (D_in,), ∂/∂log σ²)) — fully distributed.

    X (n, D_in) and Y (n, p) are replicated inputs; every O(N²) object
    (Gram, factor, L⁻¹) lives block-cyclically sharded over ``axis``.
    """
    D = mesh.shape[axis]
    n, nd = X.shape
    Np, Pnl, Pl = _plan(n, block, D)

    amp = jnp.exp(jnp.asarray(log_amp)).astype(jnp.float32)
    ls = jnp.exp(jnp.atleast_1d(jnp.asarray(log_ls))).astype(jnp.float32)
    ls = jnp.broadcast_to(ls, (nd,))
    noise = jnp.exp(jnp.asarray(log_noise)).astype(jnp.float32)

    Z = jnp.asarray(X, jnp.float32) / ls
    n_ext = Np + D * block
    far = 1e6 * (1.0 + jnp.arange(n_ext - n, dtype=jnp.float32))[:, None]
    Z_ext = jnp.concatenate([Z, jnp.broadcast_to(far, (n_ext - n, nd))], axis=0)

    Y2 = Y if Y.ndim == 2 else Y[:, None]
    p_out = Y2.shape[1]
    Yp = _pad_rows(jnp.asarray(Y2, jnp.float32), Np)

    amp_a = amp[None]
    nz_a = (noise + jitter)[None]
    noise_only = noise[None]

    def body(Z_rep, Y_rep, amp_v, nzj_v, nz_v):
        d = lax.axis_index(axis)
        work = _local_gram_panels(
            Z_rep, d, block, D, Pl, Np, amp_v[0], nzj_v[0], family
        )
        L_loc, linv_loc = _factor_body(
            work, d, axis, block, D, Pl, Np, precision
        )
        # value: alpha, quad, logdet
        y = _fwd_sub(L_loc, linv_loc, d, axis, Y_rep, block, D, Pl, Np, precision)
        alpha = _bwd_sub(L_loc, linv_loc, d, axis, y, block, D, Pl, Np, precision)
        quad = jnp.sum(Y_rep * alpha)
        ld = jnp.zeros((), jnp.float32)
        for j in range(Pl):
            k = j * D + d
            diag = jnp.diagonal(L_loc[j][:block])
            rows = k * block + jnp.arange(block)
            ld = ld + jnp.sum(
                jnp.where(rows < n, jnp.log(jnp.maximum(diag, 1e-30)), 0.0)
            )
        logdet = 2.0 * lax.psum(ld, axis)
        val = -0.5 * quad - p_out * (0.5 * logdet + 0.5 * n * _LOG_2PI)
        # gradient: T columns then block-pair traces
        T_loc = _tri_inv_body(
            L_loc, linv_loc, d, axis, block, D, Pl, Np, precision
        )
        g_amp, g_ls, g_noise = _lml_trace_body(
            T_loc, alpha, Z_rep, d, axis, block, D, Pl, Np, n, p_out,
            amp_v[0], nz_v[0], family, precision,
        )
        return (
            val[None],
            g_amp[None],
            g_ls[None],
            g_noise[None],
            alpha,
        )

    in_specs = (P(), P(), P(), P(), P())
    out_specs = (P(axis), P(axis), P(axis), P(axis), P())
    fn = shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    val, g_amp, g_ls, g_noise, alpha = fn(Z_ext, Yp, amp_a, nz_a, noise_only)
    return val[0], (g_amp[0], g_ls[0], g_noise[0])


def make_sharded_lml(
    family: str,
    mesh: Mesh,
    axis: str = "data",
    block: int = 512,
    jitter: float = 1e-6,
    precision=_HIGHEST,
):
    """``lml(theta, X, Y) -> scalar`` with closed-form VJP, distributed.

    Same contract as ``ops.blocked_lml.make_blocked_lml`` (theta dict of
    log_amp / log_ls / log_noise), but value AND gradient run the sharded
    bodies above.  The VJP recomputes forward state — at multi-chip N the
    factor is too large to keep as a residual across the optax step, and
    the recompute is the same ~Np³/(3D) the value already cost.
    """

    def _vg(theta, X, Y):
        return sharded_lml_value_and_grad(
            X, Y, family, theta["log_amp"], theta["log_ls"],
            theta["log_noise"], mesh=mesh, axis=axis, block=block,
            jitter=jitter, precision=precision,
        )

    @jax.custom_vjp
    def lml(theta, X, Y):
        return _vg(theta, X, Y)[0]

    def fwd(theta, X, Y):
        val, grads = _vg(theta, X, Y)
        return val, (theta, grads, X, Y)

    def bwd(res, g):
        theta, (g_amp, g_ls, g_noise), X, Y = res
        ls_shape = jnp.shape(theta["log_ls"])
        ls_size = math.prod(ls_shape) if ls_shape else 1
        if ls_size == 1 and g_ls.shape[0] > 1:
            g_ls = jnp.sum(g_ls)
        g_theta = {
            "log_amp": (g_amp * g).astype(jnp.asarray(theta["log_amp"]).dtype),
            "log_ls": (g_ls * g).reshape(ls_shape).astype(
                jnp.asarray(theta["log_ls"]).dtype
            ),
            "log_noise": (g_noise * g).astype(
                jnp.asarray(theta["log_noise"]).dtype
            ),
        }
        return g_theta, jnp.zeros_like(X), jnp.zeros_like(Y)

    lml.defvjp(fwd, bwd)
    return lml


def fit_sharded(
    kernel,
    X: Array,
    Y: Array,
    mesh: Mesh,
    axis: str = "data",
    maxiter: int = 30,
    block: int = 512,
    jitter: float = 1e-10,
    precision=_HIGHEST,
):
    """Distributed L-BFGS hyperparameter fit; returns the fitted kernel and
    the final (theta, LML-trace) — conditioning at the optimum is the
    caller's choice of ``sharded_gram_cholesky_solve`` (multi-chip) or
    ``models.exact_gp.condition_blocked`` (if it fits on one chip).

    Mirrors ``models.exact_gp.fit_blocked`` semantics (bounds-clipped
    log-space L-BFGS on the C·stationary(+White) family).
    """
    from ..models.exact_gp import (
        _eff_jitter,
        _family_nodes,
        stationary_family_params,
        white_noise_level,
    )
    from ..kernels import Constant, Matern, RBF, White
    from ..kernels.stationary import DEFAULT_BOUNDS

    parts = stationary_family_params(kernel)
    if parts is None:
        raise ValueError(
            "fit_sharded requires a C*stationary(+White) kernel; got "
            f"{type(kernel).__name__}"
        )
    fam, amp0, ls0 = parts
    const_node, base_node, white_node = _family_nodes(kernel)
    X = jnp.asarray(X, jnp.float32)
    Y2 = jnp.asarray(Y if Y.ndim == 2 else Y[:, None], jnp.float32)
    nd = X.shape[1]

    noise0 = white_noise_level(kernel)
    theta0 = {
        "log_amp": jnp.log(jnp.asarray(amp0, jnp.float32)),
        "log_ls": jnp.log(
            jnp.broadcast_to(jnp.atleast_1d(ls0).astype(jnp.float32), (nd,))
        ),
        "log_noise": jnp.log(
            jnp.maximum(jnp.asarray(noise0, jnp.float32), 1e-8)
        ),
    }

    def _log_bounds(node):
        b = node.bounds if node is not None else DEFAULT_BOUNDS
        return math.log(b[0]), math.log(b[1])

    lo_hi = {
        "log_amp": _log_bounds(const_node),
        "log_ls": _log_bounds(base_node),
        "log_noise": _log_bounds(white_node),
    }
    lo = {k: jnp.full_like(theta0[k], v[0]) for k, v in lo_hi.items()}
    hi = {k: jnp.full_like(theta0[k], v[1]) for k, v in lo_hi.items()}

    lml = make_sharded_lml(
        fam, mesh, axis=axis, block=block,
        jitter=_eff_jitter(jnp.float32, jitter), precision=precision,
    )

    def nll(theta):
        v = -lml(theta, X, Y2)
        return jnp.where(jnp.isfinite(v), v, 1e25)

    opt = optax.lbfgs()

    @jax.jit
    def run(t0):
        state0 = opt.init(t0)

        def step(carry, _):
            theta, state = carry
            v, g = jax.value_and_grad(nll)(theta)
            g = jax.tree_util.tree_map(
                lambda x: jnp.where(jnp.isfinite(x), x, 0.0), g
            )
            updates, state = opt.update(
                g, state, theta, value=v, grad=g, value_fn=nll
            )
            theta = optax.apply_updates(theta, updates)
            theta = jax.tree_util.tree_map(jnp.clip, theta, lo, hi)
            return (theta, state), v

        (theta, _), vals = jax.lax.scan(step, (t0, state0), None, length=maxiter)
        return theta, vals

    theta, vals = run(theta0)

    base_kwargs = {"lengthscale": jnp.exp(theta["log_ls"])}
    if isinstance(base_node, Matern):
        base = Matern(nu=base_node.nu, bounds=base_node.bounds, **base_kwargs)
    else:
        base = RBF(
            bounds=base_node.bounds if base_node is not None else DEFAULT_BOUNDS,
            **base_kwargs,
        )
    fitted = Constant(
        jnp.exp(theta["log_amp"]),
        bounds=const_node.bounds if const_node is not None else DEFAULT_BOUNDS,
    ) * base + White(
        jnp.exp(theta["log_noise"]),
        bounds=white_node.bounds if white_node is not None else DEFAULT_BOUNDS,
    )
    return fitted, theta, vals
