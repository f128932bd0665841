"""Multi-chip blocked Cholesky: column panels block-cyclic over a mesh axis.

Scales the large-N exact-GP conditioning path (``ops/blocked_chol.py``)
past one device's memory and compute: the Gram matrix is built, factored and
solved **distributed** — the full (N, N) never exists on any device, and
no host ever sees more than the (N, nrhs) solution.

Reference anchor: the active-learning exact GP caps itself at 20 000
samples purely because a single-host dense Cholesky stops being practical
(``policy_transportation/models/gaussian_process_al.py:16``).  Each device
holds about Np²/(2D) f32 of the factor, so D devices hold D times the N²
that fits on one.

Design (SPMD, one program under ``shard_map`` over axis ``data``):

* **Layout** — lower-trapezoid column panel ``k`` (rows k·B…Np of columns
  k·B…(k+1)·B) lives on device ``k mod D``; device-local slot ``j`` holds
  global panel ``k = j·D + d``.  Block-cyclic assignment keeps every
  device busy until the final panels (a contiguous split would idle
  device 0 after the first P/D steps).  Every local slot stores the panel
  with its OWN diagonal at row 0 and a static height ``H_j = Np − j·D·B``
  (the per-device offset is baked into the storage, so all shapes are
  identical across devices — the shard_map requirement — while every
  GEMM still runs at the exact trapezoid height).
* **Factor step k** (unrolled, k static): the owner's up-to-date panel is
  broadcast with ONE masked ``psum``; *every* device then factors the
  (B, B) diagonal block (``ops.blocked_chol.factor_panel`` → L_kk and
  L_kk⁻¹) and forms the TRSM ``below = G[B:] @ L_kk⁻ᵀ`` redundantly.
  Redundant is deliberate: the non-owners would otherwise sit idle at the
  psum barrier, so the replicated panel work costs zero wall-clock and
  saves a second broadcast.
* **Trailing update** — each device updates only the panels it owns:
  ``work[j'] −= Lk[r : r+H_{j'}] @ Lk[r : r+B]ᵀ`` with a *dynamic* row
  offset ``r = k'·B − k·B`` (k' = j'·D + axis_index) and *static* sizes,
  so XLA sees fixed-shape GEMMs and total FLOPs stay at the exact
  N³/3 + O(N²BD) — no full-rectangle waste.
* **Solve** — blocked forward/backward substitution against the retained
  diagonal-block inverses (GEMMs, no triangular solves); per
  step the owner's contribution is zero-masked and ``psum``-broadcast, so
  the right-hand side stays replicated and the result needs no gather.

Communication: one (H_j, B) psum per factor step ≈ Np²/2 floats total —
the same order as a single all_gather of the factor.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
try:  # jax ≥ 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.blocked_chol import factor_panel, stationary_from_sqdist

Array = jax.Array
_HIGHEST = jax.lax.Precision.HIGHEST


def _dot(a, b, precision):
    return jnp.dot(a, b, preferred_element_type=jnp.float32, precision=precision)


def _pad_rows(x: Array, rows: int) -> Array:
    """Zero-pad axis 0 up to ``rows`` (static)."""
    if x.shape[0] == rows:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((rows - x.shape[0],) + x.shape[1:], x.dtype)], axis=0
    )


@jax.tree_util.register_pytree_node_class
class ShardedBlockedCholesky:
    """Distributed lower-Cholesky factor.

    ``panels[j]`` is a global (D·H_j, B) array sharded over the mesh axis:
    device d's slice holds global panel k = j·D + d with its diagonal
    block at local row 0 (height H_j = Np − j·D·B, zero rows past the
    panel's true trapezoid).  ``linvs[j]`` is (D·B, B) likewise sharded —
    the retained diagonal-block inverses.  ``n`` is the logical size, ``block``
    the panel width, ``axis`` the mesh axis name.
    """

    def __init__(self, panels, linvs, n, block, mesh, axis):
        self.panels = tuple(panels)
        self.linvs = tuple(linvs)
        self.n = n
        self.block = block
        self.mesh = mesh
        self.axis = axis

    def tree_flatten(self):
        return (self.panels, self.linvs), (self.n, self.block, self.mesh, self.axis)

    @classmethod
    def tree_unflatten(cls, aux, children):
        panels, linvs = children
        return cls(panels, linvs, aux[0], aux[1], aux[2], aux[3])

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.axis]

    # -- derived quantities -------------------------------------------------
    def logdet(self) -> Array:
        """log det K = 2 Σ log diag(L) over real (row < n) entries."""
        B, D, n = self.block, self.n_shards, self.n
        spec_p = [P(self.axis) for _ in self.panels]

        def body(*panels):
            d = lax.axis_index(self.axis)
            total = jnp.zeros((), jnp.float32)
            for j, p in enumerate(panels):
                k = j * D + d
                diag = jnp.diagonal(p[:B])
                rows = k * B + jnp.arange(B)
                total = total + jnp.sum(
                    jnp.where(rows < n, jnp.log(jnp.maximum(diag, 1e-30)), 0.0)
                )
            return lax.psum(total, self.axis)[None]

        out = shard_map(
            body, mesh=self.mesh, in_specs=tuple(spec_p), out_specs=P(self.axis)
        )(*self.panels)
        return 2.0 * out[0]

    def solve(self, b: Array, precision=_HIGHEST) -> Array:
        """(L Lᵀ)⁻¹ b — distributed blocked substitution, replicated result."""
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        out = _sharded_solve(
            self.mesh, self.axis, self.block, self.n, precision,
            tuple(self.panels), tuple(self.linvs), b2,
        )
        return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# factor + solve bodies (shard_map programs)
# ---------------------------------------------------------------------------


def _plan(n: int, block: int, D: int) -> Tuple[int, int, int]:
    """(Np, P, Pl): padded size, panel count, panels per device."""
    group = block * D
    Np = -(-n // group) * group
    Pnl = Np // block
    return Np, Pnl, Pnl // D


def _local_gram_panels(Z_ext, d, block, D, Pl, Np, amp, noise, family):
    """Device-local Gram panels, diagonal at local row 0 (see layout note)."""
    nd = Z_ext.shape[1]
    panels = []
    zero = jnp.zeros((), jnp.int32)
    for j in range(Pl):
        Hj = Np - j * D * block
        off = ((j * D + d) * block).astype(jnp.int32)
        rows = lax.dynamic_slice(Z_ext, (off, zero), (Hj, nd))
        cols = lax.dynamic_slice(Z_ext, (off, zero), (block, nd))
        d2 = jnp.zeros((Hj, block), jnp.float32)
        for dim in range(nd):  # unrolled elementwise pass over the small D
            diff = rows[:, dim, None] - cols[None, :, dim]
            d2 = d2 + diff * diff
        p = amp * stationary_from_sqdist(d2, family)
        ridx = jnp.arange(Hj)[:, None]
        cidx = jnp.arange(block)[None, :]
        p = jnp.where(ridx == cidx, p + noise, p)
        # zero any overhang past the true trapezoid (far-point tail rows)
        valid = Np - (j * D + d) * block
        p = jnp.where(ridx < valid, p, 0.0)
        panels.append(p)
    return panels


def _factor_body(work, d, axis, block, D, Pl, Np, precision):
    """Right-looking factorization over block-cyclic local panels.

    ``lax.fori_loop`` over the Pnl global steps: the body — and with it
    the ONE ``factor_panel`` call site — compiles once instead of Pnl
    inlined copies and O(Pnl·Pl) GEMM/slice HLOs, which kept large Pnl
    from compiling in reasonable time.  The Pl-slot inner loop stays unrolled (static trapezoid heights);
    the now-dynamic owner-slot index uses ``lax.switch``; not-yet-started
    slots skip their trailing-update GEMM under ``lax.cond``.
    """
    Pnl = Pl * D
    zero = jnp.zeros((), jnp.int32)
    L0 = tuple(jnp.zeros_like(w) for w in work)
    linv0 = tuple(jnp.zeros((block, block), jnp.float32) for _ in range(Pl))

    def step(k, carry):
        work, L_loc, linv_loc = carry
        jk = k // D
        mine = d == (k % D)
        # ONE broadcast: the owner's up-to-date panel, padded to the
        # tallest slot height (rows past the true Np − k·B are zero)
        G_own = lax.switch(
            jk, [lambda j=j: _pad_rows(work[j], Np) for j in range(Pl)]
        )
        G = lax.psum(jnp.where(mine, G_own, 0.0), axis)
        Lkk, Linv = factor_panel(G[:block])
        below = _dot(G[block:], Linv.T, precision)  # TRSM as GEMM
        Lk = jnp.concatenate([Lkk, below], axis=0)  # (Np, B)
        # dynamic-offset slices may run past Lk's end: pad with D·B zero
        # rows (zero left-rows ⇒ zero updates into the zero overhang)
        Lk_pad = _pad_rows(Lk, Np + D * block)
        work_new, L_new, linv_new = [], [], []
        for j in range(Pl):
            Hj = Np - j * D * block
            mine_j = mine & (jk == j)
            L_new.append(jnp.where(mine_j, Lk[:Hj], L_loc[j]))
            linv_new.append(jnp.where(mine_j, Linv, linv_loc[j]))
            k2 = j * D + d
            need = k2 > k
            r_safe = jnp.maximum((k2 - k) * block, 0).astype(jnp.int32)

            def upd(wj, Hj=Hj, r_safe=r_safe):
                rows = lax.dynamic_slice(Lk_pad, (r_safe, zero), (Hj, block))
                blk = lax.dynamic_slice(
                    Lk_pad, (r_safe, zero), (block, block)
                )
                return wj - _dot(rows, blk.T, precision)

            work_new.append(lax.cond(need, upd, lambda wj: wj, work[j]))
        return tuple(work_new), tuple(L_new), tuple(linv_new)

    _, L_loc, linv_loc = lax.fori_loop(
        0, Pnl, step, (tuple(work), L0, linv0)
    )
    return list(L_loc), list(linv_loc)


def _fwd_sub(L_loc, linv_loc, d, axis, b, block, D, Pl, Np, precision):
    """y = L⁻¹ b with b replicated (Np, nrhs); one masked psum per panel.

    Compile-once ``fori_loop`` over the Pnl panel steps;
    the owner's slot pair is selected with ``lax.switch``.
    """
    Pnl = Pl * D
    nrhs = b.shape[1]
    zero = jnp.zeros((), jnp.int32)

    def step(k, carry):
        rest, y = carry
        jk = k // D
        mine = d == (k % D)
        L_own = lax.switch(
            jk, [lambda j=j: _pad_rows(L_loc[j], Np) for j in range(Pl)]
        )
        linv_own = lax.switch(jk, [lambda j=j: linv_loc[j] for j in range(Pl)])
        off = (k * block).astype(jnp.int32)
        rk = lax.dynamic_slice(rest, (off, zero), (block, nrhs))
        yk = _dot(linv_own, rk, precision)
        u = _dot(L_own[block:], yk, precision)  # rows past trapezoid: zero
        contrib = lax.psum(
            jnp.where(mine, jnp.concatenate([yk, u], axis=0), 0.0), axis
        )
        y = lax.dynamic_update_slice(y, contrib[:block], (off, zero))
        # rest[g] -= contrib[g − k·B] for g ≥ (k+1)·B, as a shifted slice of
        # the zero-headed tail (contrib rows [B:] live at global (k+1)·B…)
        tail_ext = jnp.concatenate(
            [jnp.zeros((Np, nrhs), jnp.float32),
             contrib.at[:block].set(0.0)],
            axis=0,
        )
        shifted = lax.dynamic_slice(tail_ext, (Np - off, zero), (Np, nrhs))
        return rest - shifted, y

    _, y = lax.fori_loop(
        0, Pnl, step, (b, jnp.zeros((Np, nrhs), jnp.float32))
    )
    return y


def _bwd_sub(L_loc, linv_loc, d, axis, y, block, D, Pl, Np, precision):
    """x = L⁻ᵀ y, replicated; same compile-once loop as :func:`_fwd_sub`."""
    Pnl = Pl * D
    nrhs = y.shape[1]
    zero = jnp.zeros((), jnp.int32)

    def step(t, x):
        k = Pnl - 1 - t
        jk = k // D
        mine = d == (k % D)
        L_own = lax.switch(
            jk, [lambda j=j: _pad_rows(L_loc[j], Np) for j in range(Pl)]
        )
        linv_own = lax.switch(jk, [lambda j=j: linv_loc[j] for j in range(Pl)])
        off = (k * block).astype(jnp.int32)
        s = lax.dynamic_slice(y, (off, zero), (block, nrhs))
        # xb[i] = x[(k+1)·B + i] for i < Np − (k+1)·B else 0
        x_ext = jnp.concatenate([x, jnp.zeros((Np, nrhs), jnp.float32)], 0)
        xb = lax.dynamic_slice(
            x_ext, (off + block, zero), (Np - block, nrhs)
        )
        s = s - _dot(L_own[block:].T, xb, precision)
        xk = _dot(linv_own.T, s, precision)
        xk = lax.psum(jnp.where(mine, xk, 0.0), axis)
        return lax.dynamic_update_slice(x, xk, (off, zero))

    return lax.fori_loop(
        0, Pnl, step, jnp.zeros((Np, nrhs), jnp.float32)
    )


def sharded_gram_cholesky_solve(
    X: Array,
    Y: Array,
    lengthscale,
    amplitude,
    noise,
    mesh: Mesh,
    axis: str = "data",
    block: int = 512,
    precision=_HIGHEST,
    family: str = "rbf",
) -> Tuple[Array, ShardedBlockedCholesky]:
    """Distributed K = k(X,X)+σ²I → blocked Cholesky → α = K⁻¹Y.

    X and Y are host/replicated inputs; the Gram panels are built on their
    owning devices (each device materializes only its Np²/(2D) share), the
    factorization runs block-cyclically over ``axis``, and α comes back
    replicated.  The factor is returned for reuse (solves, logdet).
    """
    D = mesh.shape[axis]
    n, nd = X.shape
    Np, Pnl, Pl = _plan(n, block, D)

    ls = jnp.atleast_1d(jnp.asarray(lengthscale)).astype(jnp.float32)
    Z = (jnp.asarray(X, jnp.float32) / ls)
    # pad to Np with far-away pseudo-points (off-diag kernel → 0, diagonal
    # amp+noise: SPD padding the solve masks out), plus D·B safety rows for
    # the dynamic-offset panel-row slices
    n_ext = Np + D * block
    far = 1e6 * (1.0 + jnp.arange(n_ext - n, dtype=jnp.float32))[:, None]
    Z_ext = jnp.concatenate([Z, jnp.broadcast_to(far, (n_ext - n, nd))], axis=0)

    squeeze = Y.ndim == 1
    Y2 = Y[:, None] if squeeze else Y
    Yp = _pad_rows(jnp.asarray(Y2, jnp.float32), Np)

    amp = jnp.asarray([amplitude], jnp.float32)
    nz = jnp.asarray([noise], jnp.float32)

    def body(Z_rep, Y_rep, amp_a, nz_a):
        d = lax.axis_index(axis)
        work = _local_gram_panels(
            Z_rep, d, block, D, Pl, Np, amp_a[0], nz_a[0], family
        )
        L_loc, linv_loc = _factor_body(
            work, d, axis, block, D, Pl, Np, precision
        )
        y = _fwd_sub(L_loc, linv_loc, d, axis, Y_rep, block, D, Pl, Np, precision)
        x = _bwd_sub(L_loc, linv_loc, d, axis, y, block, D, Pl, Np, precision)
        return tuple(L_loc), tuple(linv_loc), x

    in_specs = (P(), P(), P(), P())
    out_specs = (
        tuple(P(axis) for _ in range(Pl)),
        tuple(P(axis) for _ in range(Pl)),
        P(),
    )
    fn = jax.jit(
        shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
    )
    L_panels, linvs, x = fn(Z_ext, Yp, amp, nz)
    alpha = x[:n]
    chol = ShardedBlockedCholesky(L_panels, linvs, n, block, mesh, axis)
    return (alpha[:, 0] if squeeze else alpha), chol


def _sharded_solve(mesh, axis, block, n, precision, panels, linvs, b):
    D = mesh.shape[axis]
    Np = panels[0].shape[0] // D
    Pl = len(panels)
    bp = _pad_rows(jnp.asarray(b, jnp.float32), Np)

    def body(b_rep, *flat):
        d = lax.axis_index(axis)
        L_loc = list(flat[:Pl])
        linv_loc = list(flat[Pl:])
        y = _fwd_sub(L_loc, linv_loc, d, axis, b_rep, block, D, Pl, Np, precision)
        x = _bwd_sub(L_loc, linv_loc, d, axis, y, block, D, Pl, Np, precision)
        return x

    in_specs = (P(),) + tuple(P(axis) for _ in range(2 * Pl))
    fn = jax.jit(
        shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=P(),
                  check_vma=False)
    )
    return fn(bp, *panels, *linvs)[:n]
