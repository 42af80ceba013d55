"""Consensus (parallel) ADMM over a device mesh.

This is the rebuild of the reference's one distributed scheme:
global-variable consensus ADMM over row blocks
(reference: src/PADMMBase.h:7-16)::

    minimize  sum_i f_i(x_i) + g(z)
    s.t.      x_i - z = 0   for every worker i

The reference ships this for the Lasso only (``f_i = 1/2||A_i x - b_i||^2``,
``g = lambda||z||_1``, reference: src/PADMMLasso.h) and left a parallel
Basis-Pursuit variant unfinished in ``src/TODO/ParBP.cppp`` /
``src/TODO/PADMMBP.h`` (the R layer calls ``admm_parbp`` that was never
compiled, reference: R/10_admm_bp.R:100-120).  Here the consensus engine
is generic — one worker x-update hook plus one master prox hook — and is
instantiated for **Lasso**, **Elastic Net** (an extension: the reference
has no ``admm_parenet``) and **Basis Pursuit** (finishing what the
reference left in TODO, with exact per-worker affine projections instead
of its linearized updates).

The reference runs W OpenMP threads in shared memory: worker x/y-updates
are a parallel-for, and the master's z-update + residual reductions are
the synchronisation points (reference: src/PADMMBase.h:174-214,
src/PADMMLasso.h:99-108).  Here the scheme is two-level:

* W workers are laid out as ``W = D * W_local``: a leading worker axis of
  size ``W_local`` *vectorised on each device* (the single-device analog of
  the reference's OpenMP threads — one batched einsum instead of a
  parallel-for) and a 1-D **device mesh of size D** over which the data
  is row-sharded with ``shard_map`` (the multi-device scale-out the
  reference never had);
* each worker caches its local factorization once per cold start,
  mirroring the reference's per-worker Cholesky: direct ridge inverse for
  tall blocks, Woodbury (matrix-inversion-lemma) for wide blocks
  (reference: src/PADMMLasso.h:17-31, :48-63); Basis-Pursuit workers
  cache the affine-projection factors ``(A_i A_i')^{-1}`` instead
  (the consensus analog of reference: src/ADMMBP.h:156-197);
* the master's three OpenMP reduce points collapse into **ONE fused
  ``psum`` per iteration** over the mesh axis: a (p+3)-packed vector
  ``[sum_local(x_i + y_i/rho), sum||x_i||^2, sum||y_i||^2, sum||r_i||^2]``
  — NCCL over the cards' links within a host, the network across hosts;
* the whole lambda path (warm starts included) is one jitted SPMD
  program: ``shard_map`` around ``lax.scan`` around ``lax.while_loop``.

Single-psum protocol note: the reference reduces the primal residual
*after* the dual update (reference: src/PADMMBase.h:200-214), which would
cost a second collective.  We instead carry each worker's ``||r_i||^2``
into the *next* iteration's fused psum, so the convergence test sees the
primal residual of the previous iteration (the dual residual is current).
The solver therefore runs at most one extra (strictly refining) iteration
compared to the reference before stopping — and does one collective per
iteration instead of three.

rho handling matches the reference: auto ``rho = lambda_first / W``
(reference: src/PADMMLasso.h:199-200), fixed across the path (adaptive
rho is disabled in the reference master, src/PADMMBase.h:147-159), so
the per-worker factorizations are computed exactly once.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..core.prox import soft_threshold
from ..data.standardize import recover
from ..data.standardize import standardize as standardize_data
from ..linalg import chol_inverse, dot, gram
from ..models.bp import BPResult
from ..models.lasso import PathResult
from .mesh import make_mesh

BIG = 9999.0

# Batched (worker-axis) matmuls at full f32 precision.
_bmm = partial(jnp.einsum, precision=lax.Precision.HIGHEST)


class _ConsensusState(NamedTuple):
    x: jnp.ndarray        # (Wl, p) local primal iterates of this device
    y: jnp.ndarray        # (Wl, p) local duals
    z: jnp.ndarray        # (p,) consensus variable (replicated by psum)
    r2_local: jnp.ndarray  # sum over local workers of ||x_i - z||^2
    rho: jnp.ndarray
    lam: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


# ---------------------------------------------------------------------------
# Model hooks: worker x-update factories and master prox operators
# ---------------------------------------------------------------------------

def _lasso_x_update(Xi, yi, rho, *, tall_block: bool):
    """Per-worker ridge solve ``argmin 1/2||A_i x - b_i||^2 + rho/2||x-v||^2``
    with the factorization cached once per cold start
    (reference: src/PADMMLasso.h:17-31, :48-63)."""
    Wl, rows, p = Xi.shape
    dtype = Xi.dtype
    # A_i' b_i cached per worker (reference: src/PADMMLasso.h:42).
    Ab = _bmm("wrp,wr->wp", Xi, yi)
    eye = jnp.eye(p if tall_block else rows, dtype=dtype)
    if tall_block:
        # (A_i'A_i + rho I)^-1 per worker (tall branch).
        G = _bmm("wrp,wrq->wpq", Xi, Xi) + rho * eye
        Minv = jax.vmap(chol_inverse)(G)

        def x_update(z, y, rho, x_prev):
            rhs = Ab - y + rho * z[None, :]
            return _bmm("wpq,wq->wp", Minv, rhs)
    else:
        # Woodbury: x = (rhs - A'(AA' + rho I)^-1 A rhs)/rho (wide branch).
        G = _bmm("wrp,wsp->wrs", Xi, Xi) + rho * eye
        Winv = jax.vmap(chol_inverse)(G)

        def x_update(z, y, rho, x_prev):
            rhs = Ab - y + rho * z[None, :]
            t = _bmm("wrs,ws->wr", Winv, _bmm("wrp,wp->wr", Xi, rhs))
            return (rhs - _bmm("wrp,wr->wp", Xi, t)) / rho

    return x_update


def _bp_x_update(Xi, yi, rho, *, jitter: float = 1e-6):
    """Per-worker affine projection onto {x : A_i x = b_i}.

    ``x = v - A_i'(A_i A_i')^{-1}(A_i v - b_i)`` with the (jittered) SPD
    inverse cached once — the consensus analog of the serial BP x-update
    (reference: src/ADMMBP.h:48-67).  The reference's dormant parallel BP
    used linearized soft-threshold worker updates with a period-10 active
    set (reference: src/TODO/PADMMBP.h:20-61); the exact projection
    converges in far fewer iterations and is two batched matvecs.

    Zero-padded rows are exactly inert: a zero row r decouples in
    ``A A' + jitter*I`` (its only nonzero is the jitter diagonal) and
    contributes ``A'_{.r} * t_r = 0`` to the correction.
    """
    Wl, rows, p = Xi.shape
    dtype = Xi.dtype
    eye = jnp.eye(rows, dtype=dtype)
    G = _bmm("wrp,wsp->wrs", Xi, Xi) + jitter * eye
    Winv = jax.vmap(chol_inverse)(G)

    def x_update(z, y, rho, x_prev):
        v = z[None, :] - y / rho
        t = _bmm("wrs,ws->wr", Winv, _bmm("wrp,wp->wr", Xi, v) - yi)
        return v - _bmm("wrp,wr->wp", Xi, t)

    return x_update


def _glm_x_update(Xi, yi, rho, *, family, n_total: int,
                  newton_steps: int = 2, weighted: bool = False,
                  hessian: str = "exact"):
    """Per-worker inexact Newton on ``loss_i/n + rho/2||x - v||^2`` for
    ANY :class:`~admm_tpu.models.glm.GLMFamily` — the model-generic
    consensus worker the reference's template promises (reference:
    src/PADMMBase.h:17-83 — any f_i plugs in).  Each Newton step is one
    batched (q, q) Hessian build + Cholesky solve per worker, assembled
    from the family's ``grad_eta``/``weight_eta`` hooks exactly as the
    serial engine does (models/glm.py::_glm_ops).

    Zero-padded rows are exactly inert for every family: a zero feature
    row contributes zero gradient (X_r * g_r = 0) and zero Hessian
    (w_r X_r X_r' = 0) whatever g_r/w_r evaluate to at eta = 0.

    ``weighted``: observation weights ride STACKED with the response —
    ``yi`` is then (Wl, rows, 2) = [y, w] so the shard_map plumbing
    (specs, partitioning, the fused psum) is untouched; the weights
    multiply the per-observation grad/IRLS terms exactly as the serial
    weighted engine does (models/glm.py::_glm_ops).

    ``hessian="fixed"`` caches the per-worker curvature majorizer
    inverse ``(bound * Xa_i'W Xa_i/n + rho I)^{-1}`` once per cold
    start (the consensus analog of the serial fixed-majorizer design,
    DESIGN.md "GLM tier") — each Newton step is then one batched
    matvec against it, no per-step Hessian build or Cholesky.
    """
    import jax.scipy.linalg as jsl

    Wl, rows, q = Xi.shape
    dtype = Xi.dtype
    eye = jnp.eye(q, dtype=dtype)
    wi = None
    if weighted:
        yi, wi = yi[..., 0], yi[..., 1]

    def chol_solve(H, g):
        c, low = jsl.cho_factor(H)
        return jsl.cho_solve((c, low), g)

    fixed_minv = None
    if hessian == "fixed":
        assert family.curvature_bound is not None
        Xw = Xi if wi is None else Xi * jnp.sqrt(wi)[..., None]
        H_fix = (family.curvature_bound / n_total) * jnp.einsum(
            "wrq,wrs->wqs", Xw, Xw,
            precision=lax.Precision.HIGHEST) + rho * eye
        fixed_minv = jax.vmap(chol_inverse)(H_fix)

    def x_update(z, y, rho_, x_prev):
        v = z[None, :] - y / rho_

        def step(_, b):
            u = _bmm("wrq,wq->wr", Xi, b)
            g = family.grad_eta(u, yi)
            if weighted:
                g = wi * g
            grad = (_bmm("wrq,wr->wq", Xi, g) / n_total
                    + rho_ * (b - v))
            if fixed_minv is not None:
                return b - _bmm("wqs,ws->wq", fixed_minv, grad)
            w = family.weight_eta(u, yi)
            if weighted:
                w = wi * w
            H = (jnp.einsum("wrq,wr,wrs->wqs", Xi, w, Xi,
                            precision=lax.Precision.HIGHEST) / n_total
                 + rho_ * eye)
            return b - jax.vmap(chol_solve)(H, grad)

        return lax.fori_loop(0, newton_steps, step, x_prev)

    return x_update


def _glm_master_prox(W: int, alpha: float, pen_mask):
    """Masked elastic-net prox of the consensus mean: the intercept
    coordinate (pen_mask 0) passes through unpenalized, exactly as in
    the serial GLM z-update (models/glm.py::_glm_ops)."""
    def prox(zbar, lam, rho):
        wr = W * rho
        pen = lam * pen_mask
        zl1 = soft_threshold(wr * zbar, alpha * pen)
        return zl1 / (pen * (1.0 - alpha) + wr)
    return prox


def _lasso_master_prox(W: int):
    """z = soft_threshold(mean_i(x_i + y_i/rho), lambda/(rho W))
    (reference: src/PADMMLasso.h:99-108)."""
    def prox(zbar, lam, rho):
        return soft_threshold(zbar, lam / (rho * W))
    return prox


def _enet_master_prox(W: int, alpha: float):
    """argmin_z lam(alpha||z||_1 + (1-alpha)/2||z||^2) + W rho/2 ||z-m||^2
    = soft_threshold(W rho m, lam alpha) / (lam(1-alpha) + W rho).

    Extension beyond the reference (no ``admm_parenet`` exists there);
    alpha=1 reduces exactly to the Lasso master prox.
    """
    def prox(zbar, lam, rho):
        wr = W * rho
        return soft_threshold(wr * zbar, lam * alpha) / (lam * (1.0 - alpha)
                                                         + wr)
    return prox


def _group_master_prox(W: int, groups, weights, l1_ratio: float = 0.0):
    """Block soft-threshold of the consensus mean: argmin_z
    lam sum_g w_g||z_g|| + W rho/2 ||z - m||^2 (extension; completes the
    consensus family for the group-Lasso model,
    admm_tpu/models/grouplasso.py).  ``l1_ratio > 0`` = the
    sparse-group-lasso compound prox."""
    from ..models.grouplasso import _group_prox_fn

    prox = _group_prox_fn(groups, weights, l1_ratio)

    def master(zbar, lam, rho):
        return prox(zbar, lam / (rho * W))
    return master


def _bp_master_prox(W: int):
    """z = soft_threshold(mean, 1/(rho W)): the consensus split puts the
    whole ||.||_1 objective in g (serial analog reference: src/ADMMBP.h:84-88
    with penalty 1/rho)."""
    def prox(zbar, lam, rho):
        return soft_threshold(zbar, 1.0 / (rho * W))
    return prox


def _mn_x_update(Xi, yi, rho, *, nclass: int, n_total: int,
                 newton_steps: int = 2):
    """Per-worker fixed-majorizer Newton for the consensus MULTINOMIAL
    (softmax) model — the matrix-variable plug-in for the generic
    consensus template: the (q, C) coefficient block rides the engine
    FLATTENED to q*C (the packed psum and all specs are untouched).
    The per-worker majorizer inverse ``(Xa_i'Xa_i/(2n) + rho I)^{-1}``
    (softmax curvature bound 1/2, models/multinomial.py) is cached once
    and shared across classes — each step is two batched matmuls.

    Zero-padded rows one-hot to class 0 but contribute zero grad
    (zero feature rows), so they are exactly inert."""
    Wl, rows, q = Xi.shape
    C = nclass
    dtype = Xi.dtype
    Yoh = jax.nn.one_hot(yi.astype(jnp.int32), C, dtype=dtype)
    eye = jnp.eye(q, dtype=dtype)
    H_fix = (jnp.einsum("wrq,wrs->wqs", Xi, Xi,
                        precision=lax.Precision.HIGHEST)
             / (2.0 * n_total) + rho * eye)
    Minv = jax.vmap(chol_inverse)(H_fix)

    def x_update(z, y, rho_, x_prev):
        V = (z[None, :] - y / rho_).reshape(Wl, q, C)

        def step(_, B):
            eta = _bmm("wrq,wqc->wrc", Xi, B)
            pi = jax.nn.softmax(eta, axis=-1)
            G = (_bmm("wrq,wrc->wqc", Xi, pi - Yoh) / n_total
                 + rho_ * (B - V))
            return B - _bmm("wqs,wsc->wqc", Minv, G)

        B = lax.fori_loop(0, newton_steps, step,
                          x_prev.reshape(Wl, q, C))
        return B.reshape(Wl, q * C)

    return x_update


def _mn_master_prox(W: int, alpha: float, pen_mask, q: int, C: int,
                    grouped: bool):
    """Master prox for the consensus multinomial: masked elastic-net
    per entry (ungrouped) or row-norm group shrinkage (grouped), on the
    (q, C)-reshaped consensus mean; the intercept row (pen_mask 0)
    passes through unpenalized."""
    def prox(zbar, lam, rho):
        wr = W * rho
        V = zbar.reshape(q, C)
        pen = lam * pen_mask[:, None]
        if grouped:
            rn = jnp.sqrt(jnp.sum(V * V, axis=1, keepdims=True))
            Z = V * jnp.maximum(0.0, 1.0 - pen / jnp.maximum(
                wr * rn, 1e-30))
        else:
            zl1 = soft_threshold(wr * V, alpha * pen)
            Z = zl1 / (pen * (1.0 - alpha) + wr)
        return Z.reshape(q * C)

    return prox


def _mt_x_update(Xi, yi, rho, *, ntask: int, tall_block: bool):
    """Per-worker ridge solve with a MATRIX right-hand side for the
    consensus multi-task Lasso (models/multitask.py): the (p, K)
    coefficient block flattened to p*K, the factorization cached once
    (tall direct / wide Woodbury, as reference: src/PADMMLasso.h:17-31
    with K columns at once)."""
    Wl, rows, p = Xi.shape
    K = ntask
    dtype = Xi.dtype
    AtY = _bmm("wrp,wrk->wpk", Xi, yi)   # (Wl, p, K)
    eye = jnp.eye(p if tall_block else rows, dtype=dtype)
    if tall_block:
        G = _bmm("wrp,wrq->wpq", Xi, Xi) + rho * eye
        Minv = jax.vmap(chol_inverse)(G)

        def x_update(z, y, rho_, x_prev):
            rhs = (AtY - y.reshape(Wl, p, K)
                   + rho_ * z.reshape(p, K)[None])
            return _bmm("wpq,wqk->wpk", Minv, rhs).reshape(Wl, p * K)
    else:
        G = _bmm("wrp,wsp->wrs", Xi, Xi) + rho * eye
        Winv = jax.vmap(chol_inverse)(G)

        def x_update(z, y, rho_, x_prev):
            rhs = (AtY - y.reshape(Wl, p, K)
                   + rho_ * z.reshape(p, K)[None])
            t = _bmm("wrs,wsk->wrk", Winv,
                     _bmm("wrp,wpk->wrk", Xi, rhs))
            return ((rhs - _bmm("wrp,wrk->wpk", Xi, t))
                    / rho_).reshape(Wl, p * K)

    return x_update


def _mt_nuclear_master_prox(W: int, p: int, K: int):
    """SVT of the (p, K)-reshaped consensus mean (the trace-norm
    master of the reduced-rank consensus path):
    argmin_Z lam ||Z||_* + W rho/2 ||Z - m||_F^2 = svt(m, lam/(W rho))."""
    from ..models.rpca import svt

    def prox(zbar, lam, rho):
        return svt(zbar.reshape(p, K), lam / (W * rho)).reshape(p * K)

    return prox


def _mt_master_prox(W: int, p: int, K: int, alpha: float = 1.0):
    """Row-norm group soft-threshold of the (p, K)-reshaped consensus
    mean (the multi-task mixed-norm master); ``alpha < 1`` adds the
    exact ridge shrink (glmnet's mgaussian elastic net):
    argmin_Z lam(alpha||Z_j||_2 + (1-alpha)/2||Z_j||_2^2)
    + W rho/2 ||Z - m||_F^2."""
    def prox(zbar, lam, rho):
        wr = W * rho
        V = zbar.reshape(p, K)
        rn = jnp.sqrt(jnp.sum(V * V, axis=1, keepdims=True))
        shrunk = wr * V * jnp.maximum(
            0.0, 1.0 - lam * alpha / jnp.maximum(wr * rn, 1e-30))
        Z = shrunk / (lam * (1.0 - alpha) + wr)
        return Z.reshape(p * K)

    return prox


# ---------------------------------------------------------------------------
# Generic consensus engine (per-device body under shard_map)
# ---------------------------------------------------------------------------

def _consensus_shard(Xi, yi, x0, y0, z0, ilams, rho0, maxit, eps_abs,
                     eps_rel, *, axis: Optional[str], nworkers: int,
                     make_x_update: Callable, master_prox: Callable,
                     auto_rho: Callable, trace_len: Optional[int] = None):
    """Per-device body (under shard_map when ``axis`` is set).

    ``Xi``: (W_local, rows_w, p) worker blocks held by this device;
    ``x0``/``y0`` (W_local, p) and ``z0`` (p,) are the starting iterates
    — zeros for a cold start, a saved state for checkpoint resume
    (admm_tpu.diag.checkpoint).  ``make_x_update(Xi, yi, rho) ->
    x_update(z, y, rho, x_prev)`` builds the worker solve with its
    factorizations cached; ``master_prox(zbar, lam, rho)`` is the
    consensus z-update; ``auto_rho(lam_first)`` supplies the model's
    auto-rho when ``rho0 <= 0``.  With ``trace_len`` set, a
    per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho) buffer rides the
    while_loop carry per lambda (all five are psum-replicated values, so
    the trace is identical on every device); the recorded r_pri is the
    lagged one the convergence test actually used.

    Returns ``(coefs, niter, (x, y, z, rho))`` plus ``traces`` when
    tracing — the final state tuple is what a resumed path needs.
    """
    Wl, rows, _ = Xi.shape
    # The consensus-variable dimension comes from the STATE, not the
    # data block: matrix-variable models (multinomial (q, C),
    # multi-task (p, K)) ride the engine flattened, so x is
    # (W_local, q*C) while Xi stays (W_local, rows, q).
    p = x0.shape[-1]
    dtype = Xi.dtype
    W = nworkers
    sqrtW = math.sqrt(W)
    sqrt_pW = math.sqrt(p * W)

    def allsum(v):
        return lax.psum(v, axis) if axis is not None else v

    lam_first = ilams[0]
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.asarray(auto_rho(lam_first), dtype))
    x_update = make_x_update(Xi, yi, rho)

    def body(st: _ConsensusState) -> _ConsensusState:
        x = x_update(st.z, st.y, st.rho, st.x)
        # THE one fused collective of the iteration.
        packed = jnp.concatenate([
            jnp.sum(x + st.y / st.rho, axis=0),
            jnp.stack([jnp.sum(x * x), jnp.sum(st.y * st.y), st.r2_local]),
        ])
        g = allsum(packed)
        zbar = g[:p] / W
        sx2, sy2, sr2 = g[p], g[p + 1], g[p + 2]
        # Tolerances from the just-reduced norms; the primal residual in
        # sr2 is the previous iteration's (it rode this psum), so the
        # test lags the primal by exactly one refining iteration
        # (reference reduces it separately, src/PADMMBase.h:200-214,
        # which would cost a second collective).
        eps_pri = (jnp.maximum(jnp.sqrt(sx2),
                               jnp.sqrt(jnp.sum(st.z * st.z)) * sqrtW)
                   * eps_rel + sqrt_pW * eps_abs)
        eps_dua = jnp.sqrt(sy2) * eps_rel + sqrt_pW * eps_abs
        # Master z-update (reference: src/PADMMLasso.h:99-108).
        z_new = master_prox(zbar, st.lam, st.rho)
        r_dua = st.rho * sqrtW * jnp.sqrt(jnp.sum((z_new - st.z) ** 2))
        r = x - z_new[None, :]
        y = st.y + st.rho * r
        done = (jnp.sqrt(sr2) < eps_pri) & (r_dua < eps_dua)
        new = st._replace(
            x=x, y=y, z=z_new, r2_local=jnp.sum(r * r),
            it=st.it + 1, done=done,
        )
        rec = jnp.stack([eps_pri, jnp.sqrt(sr2), eps_dua, r_dua, st.rho])
        return new, rec

    def solve(st: _ConsensusState):
        def cond(s):
            return jnp.logical_not(s.done) & (s.it < maxit)

        if trace_len is None:
            return lax.while_loop(cond, lambda s: body(s)[0], st), None

        buf0 = jnp.full((trace_len, 5), jnp.nan, dtype)

        def cond_t(c):
            return cond(c[0])

        def body_t(c):
            s, buf = c
            s2, rec = body(s)
            idx = jnp.minimum(s.it, trace_len - 1)
            buf = lax.dynamic_update_slice(
                buf, rec[None, :], (idx, jnp.zeros((), idx.dtype)))
            return (s2, buf)

        return lax.while_loop(cond_t, body_t, (st, buf0))

    f = lambda v: jnp.asarray(v, dtype)
    st0 = _ConsensusState(
        x=jnp.asarray(x0, dtype), y=jnp.asarray(y0, dtype),
        z=jnp.asarray(z0, dtype), r2_local=f(BIG),
        rho=rho, lam=f(lam_first),
        it=jnp.asarray(0, jnp.int32), done=jnp.asarray(False),
    )

    def step(st, lam):
        # Warm start: keep x, y, z, rho; reset sentinels
        # (reference: src/PADMMLasso.h:215-223).
        st = st._replace(lam=lam, r2_local=f(BIG),
                         it=jnp.asarray(0, jnp.int32),
                         done=jnp.asarray(False))
        st, buf = solve(st)
        # The reported coefficients are the consensus z
        # (reference: src/ParLasso.cpp:99).
        return st, (st.z, st.it, buf)

    fin, (coefs, niter, traces) = lax.scan(step, st0, ilams)
    state_out = (fin.x, fin.y, fin.z, fin.rho)
    if trace_len is None:
        return coefs, niter, state_out
    return coefs, niter, state_out, traces


def _consensus_lasso_shard(Xi, yi, x0, y0, z0, ilams, rho0, maxit,
                           eps_abs, eps_rel, *,
                           axis: Optional[str], nworkers: int,
                           tall_block: bool, alpha: float = 1.0,
                           group_prox=None,
                           trace_len: Optional[int] = None):
    """Lasso/Enet/group-Lasso instantiation of the generic consensus
    engine (same worker ridge solves; the master prox selects the
    penalty)."""
    if callable(group_prox):
        master = group_prox(nworkers)
    elif group_prox is not None:
        master = _group_master_prox(nworkers, *group_prox)
    elif alpha >= 1.0:
        master = _lasso_master_prox(nworkers)
    else:
        master = _enet_master_prox(nworkers, alpha)
    return _consensus_shard(
        Xi, yi, x0, y0, z0, ilams, rho0, maxit, eps_abs, eps_rel,
        axis=axis, nworkers=nworkers,
        make_x_update=partial(_lasso_x_update, tall_block=tall_block),
        master_prox=master,
        # Auto-rho (reference: src/PADMMLasso.h:199-200).
        auto_rho=lambda lam_first: lam_first / nworkers,
        trace_len=trace_len)


# ---------------------------------------------------------------------------
# Drivers (partition -> shard_map wiring -> recover)
# ---------------------------------------------------------------------------

def _resolve_mesh(nworkers: Optional[int], mesh: Optional[Mesh]):
    """Resolve (W, mesh, axis, D) from the user's worker count / mesh.

    Any mesh rank is accepted: a multi-axis mesh (e.g. a two-level
    ``(hosts, chips)`` layout) shards the worker axis over ALL its axes
    and the per-iteration psum reduces over the axis tuple — XLA lowers
    that to one collective over the axis tuple, with no change to the
    math.
    """
    if nworkers is None and mesh is None:
        nworkers = len(jax.devices())
    if mesh is None:
        # Auto mesh: the largest device count that divides W, so any
        # worker count the reference accepts (any nthread < ncol/5,
        # reference: R/30_admm_lasso.R:99-112) works here too — e.g.
        # W=12 on 8 devices runs as D=6 with 2 workers per device.
        ndev = len(jax.devices())
        D = max(d for d in range(1, min(nworkers, ndev) + 1)
                if nworkers % d == 0)
        mesh = make_mesh(D)
    axes = tuple(mesh.axis_names)
    axis = axes if len(axes) > 1 else axes[0]
    D = math.prod(mesh.shape[a] for a in axes)
    W = nworkers if nworkers is not None else D
    if W % D != 0:
        raise ValueError(f"nworkers={W} must be a multiple of the "
                         f"explicit mesh size {D}")
    return W, mesh, axis, D


def _to_global(mesh, spec, arr):
    """Make an input usable under a possibly multi-process mesh.

    Single-process: return as-is (jit handles placement).  Multi-process
    (``jax.distributed``): every process holds the full host value and
    contributes its addressable shards, producing one global
    ``jax.Array`` — replicated inputs via process-local data, row-sharded
    inputs by slicing the leading axis per device.
    """
    if jax.process_count() == 1:
        return arr
    from jax.sharding import NamedSharding

    sh = NamedSharding(mesh, spec)
    arr = np.asarray(arr)
    if spec == P():
        return jax.make_array_from_process_local_data(sh, arr)
    flat = list(mesh.devices.flat)
    per = arr.shape[0] // len(flat)
    pieces = [jax.device_put(arr[i * per:(i + 1) * per], d)
              for i, d in enumerate(flat)
              if d.process_index == jax.process_index()]
    return jax.make_array_from_single_device_arrays(arr.shape, sh, pieces)


def _partition_rows(Xs, ys, W):
    """Reshape rows into (W, rows_w, p) worker blocks (zero-padded).

    Zero rows do not change A_i'A_i or A_i'b_i (Lasso) and are exactly
    inert under the jittered BP projection, so the consensus optimum is
    unchanged (the reference gives the last OpenMP worker the remainder
    instead, reference: src/PADMMLasso.h:163-179).  ``ys`` may be (n,)
    or a (n, K) multi-response matrix.
    """
    n, p = Xs.shape
    n_pad = -(-n // W) * W
    if n_pad != n:
        Xs = jnp.pad(Xs, ((0, n_pad - n), (0, 0)))
        ys = jnp.pad(ys, ((0, n_pad - n),) + ((0, 0),) * (ys.ndim - 1))
    rows_w = n_pad // W
    return (Xs.reshape(W, rows_w, p),
            ys.reshape((W, rows_w) + ys.shape[1:]), rows_w)


# jitted-program memo for _run_consensus (keyed by solver identity;
# the stored solver reference both pins the id and guards against
# id reuse after garbage collection).
_RUN_CACHE: dict = {}


def _run_consensus(Xb, yb, ilams, rho, maxit, eps_abs, eps_rel, *,
                   mesh, axis, D, solver, traced=False, init=None):
    """jit (+ shard_map over the mesh when D > 1) and run one solver.

    ``axis`` may be an axis-name tuple (multi-axis mesh): the worker
    blocks are sharded over all axes jointly and the per-iteration psum
    reduces over the tuple.  Under ``jax.distributed`` (multi-process)
    the inputs are assembled into global arrays first.  ``traced`` widens
    the output tree by the (psum-replicated) trace buffers.  ``init`` is
    an optional ``(x0, y0, z0)`` warm state ((W, p), (W, p), (p,)) for
    checkpoint resume; zeros otherwise.

    Returns ``(coefs, niter, (x, y, z, rho)[, traces])``.
    """
    dtype = Xb.dtype
    W, _, p = Xb.shape
    if init is None:
        init = (jnp.zeros((W, p), dtype), jnp.zeros((W, p), dtype),
                jnp.zeros((p,), dtype))
    x0, y0, z0 = (jnp.asarray(a, dtype) for a in init)
    state_specs = (P(axis), P(axis), P())
    # Memoize the jitted program by SOLVER IDENTITY: a fresh jax.jit of
    # a fresh shard_map closure has an empty trace cache, so a caller
    # that reuses one solver object across calls — the checkpointed
    # consensus driver advances chunk by chunk — would otherwise pay a
    # full retrace + XLA compile PER CHUNK (the CLAUDE.md module-level-
    # jit rule).  Bounded LRU: distinct solver objects (normal one-shot
    # drivers) each get one slot and age out.
    key = (id(solver), mesh, axis, D, traced)
    cached = _RUN_CACHE.get(key)
    if cached is not None and cached[0] is solver:
        run, g_row, g_rep = cached[1]
    else:
        if D > 1:
            fn = shard_map(
                partial(solver, axis=axis),
                mesh=mesh,
                in_specs=(P(axis), P(axis)) + state_specs
                + (P(), P(), P(), P(), P()),
                out_specs=((P(), P(), state_specs + (P(),), P())
                           if traced
                           else (P(), P(), state_specs + (P(),))),
                # The while_loop carry mixes device-varying
                # (x, y, r2_local) and psum-replicated values; disable
                # the static varying-axes check (the psum-derived
                # outputs are replicated by construction).
                check_vma=False,
            )
            g_row = partial(_to_global, mesh, P(axis))
            g_rep = partial(_to_global, mesh, P())
        else:
            fn = partial(solver, axis=None)
            g_row = g_rep = lambda a: a
        run = jax.jit(fn)
        _RUN_CACHE[key] = (solver, (run, g_row, g_rep))
        while len(_RUN_CACHE) > 32:
            _RUN_CACHE.pop(next(iter(_RUN_CACHE)))
    return run(g_row(Xb), g_row(yb), g_row(x0), g_row(y0), g_rep(z0),
               g_rep(ilams),
               g_rep(jnp.asarray(rho, dtype)),
               g_rep(jnp.asarray(maxit, jnp.int32)),
               g_rep(jnp.asarray(eps_abs, dtype)),
               g_rep(jnp.asarray(eps_rel, dtype)))


def parallel_lasso_path(X, y, *, nworkers: Optional[int] = None,
                        mesh: Optional[Mesh] = None,
                        lambdas: Optional[jnp.ndarray] = None,
                        nlambda: int = 100,
                        lambda_min_ratio: Optional[float] = None,
                        standardize: bool = True, intercept: bool = True,
                        maxit: int = 10000, eps_abs: float = 1e-5,
                        eps_rel: float = 1e-5, rho: float = -1.0,
                        alpha: float = 1.0, _enet_scale: bool = False,
                        _master_prox_override=None,
                        trace_len: Optional[int] = None,
                        weights: Optional[jnp.ndarray] = None,
                        dtype=jnp.float32) -> PathResult:
    """Consensus-ADMM Lasso/Enet lambda path over W = D * W_local workers.

    ``nworkers`` defaults to the mesh size; the mesh defaults to all
    visible devices, capped at ``nworkers``.  With a single device the
    scheme degrades gracefully to the reference's shared-memory layout
    (all workers batched on one device).  ``alpha < 1`` solves the Elastic
    Net by consensus — an extension; the reference parallelizes only the
    Lasso (reference: src/ParLasso.cpp).  ``weights`` (extension —
    glmnet's ``weights``): the standardization scales rows by sqrt(w)
    (data/standardize.py), so the per-worker ridge solves are weighted
    automatically and the result matches the serial weighted path.

    Convergence note: to keep the iteration at ONE collective, the
    primal-residual norm rides the fused psum one iteration late (module
    docstring), so the Boyd primal test certifies the *previous* iterate;
    the returned iterate has run one further refining iteration but its
    own primal residual is not re-tested.
    """
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4

    # Standardization and the lambda grid are global (replicated) work.
    w = None if weights is None else jnp.asarray(weights, dtype)
    Xs, ys, stats = standardize_data(X, y, standardize_x=standardize,
                                     intercept=intercept, weights=w)
    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    else:
        if callable(_master_prox_override):
            # Generic master-prox plug-in (e.g. the consensus SLOPE):
            # an optional ``lambda0`` attribute supplies the penalty's
            # own null threshold.
            lam0_fn = getattr(_master_prox_override, "lambda0", None)
            lam0 = (lam0_fn(Xs, ys) if lam0_fn is not None
                    else jnp.max(jnp.abs(dot(Xs.T, ys))))
        elif _master_prox_override is not None:
            # group-Lasso KKT boundary (admm_tpu/models/grouplasso.py).
            from ..models.grouplasso import _gl_lambda0

            lam0 = _gl_lambda0(Xs, ys, *_master_prox_override)
        else:
            lam0 = jnp.max(jnp.abs(dot(Xs.T, ys)))
        if _enet_scale:
            # Enet lambda0 inflation (reference: src/ADMMEnet.h:56).
            lam0 = lam0 / (alpha + 1e-4)
        lmax = lam0 / n * stats.scale_y
        lmin = lambda_min_ratio * lmax
        lams = jnp.exp(jnp.linspace(jnp.log(lmax), jnp.log(lmin),
                                    int(nlambda)))
    ilams = lams * n / stats.scale_y

    Xb, yb, rows_w = _partition_rows(Xs, ys, W)
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(_consensus_lasso_shard, nworkers=W,
                     tall_block=rows_w >= p, alpha=float(alpha),
                     group_prox=_master_prox_override,
                     trace_len=trace_len)
    out = _run_consensus(Xb, yb, ilams, rho, maxit, eps_abs,
                         eps_rel, mesh=mesh, axis=axis, D=D,
                         solver=solver, traced=trace_len is not None)
    coefs, niter = out[0], out[1]
    traces = out[3] if trace_len is not None else None
    beta0, coef = recover(stats, coefs, standardize_x=standardize,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def parallel_group_lasso_path(X, y, groups, *,
                              weights: Optional[jnp.ndarray] = None,
                              l1_ratio: float = 0.0,
                              **kw) -> PathResult:
    """Consensus group-Lasso path (extension): the Lasso consensus
    scheme with the master prox swapped for the block soft-threshold.
    ``groups``/``weights``/``l1_ratio`` (sparse-group mix) as in
    :func:`admm_tpu.models.grouplasso.group_lasso_path`."""
    from ..models.grouplasso import normalize_groups

    p = np.asarray(X).shape[1]
    dtype = kw.get("dtype", jnp.float32)
    if not 0.0 <= l1_ratio <= 1.0:
        raise ValueError("l1_ratio must be in [0, 1]")
    groups_j, weights_j = normalize_groups(groups, p, weights, dtype)
    return parallel_lasso_path(
        X, y, _master_prox_override=(groups_j, weights_j,
                                     float(l1_ratio)), **kw)


def parallel_slope_path(X, y, *, lam_seq=None, q: float = 0.1,
                        **kw) -> PathResult:
    """Consensus SLOPE path (extension): the Lasso consensus scheme
    with the master prox swapped for the SORTED-l1 prox (the sequence
    scale t plays the lambda role) — the same one-fused-psum iteration.
    ``lam_seq``/``q`` as in :func:`admm_tpu.models.slope.slope_path`."""
    from ..models.slope import _slope_t0, bh_sequence, prox_sorted_l1

    p = np.asarray(X).shape[1]
    dtype = kw.get("dtype", jnp.float32)
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    lam_np = np.asarray(lam_seq, np.float64).ravel()
    if lam_np.shape != (p,):
        raise ValueError("lam_seq must have one entry per column of x")
    if np.any(np.diff(lam_np) > 1e-12) or not lam_np[0] > 0:
        raise ValueError("lam_seq must be nonincreasing with a "
                         "positive largest entry")
    lam_j = jnp.asarray(lam_np, dtype)

    def make_master(W):
        def prox(zbar, lam, rho):
            return prox_sorted_l1(zbar, (lam / (rho * W)) * lam_j)
        return prox

    make_master.lambda0 = lambda Xs, ys: (_slope_t0(Xs, ys, lam_j)
                                          * (1.0 + 1e-4))
    return parallel_lasso_path(X, y, _master_prox_override=make_master,
                               **kw)


def parallel_enet_path(X, y, *, alpha: float = 1.0, **kw) -> PathResult:
    """Consensus Elastic-Net path (extension; the reference has no
    ``admm_parenet``).  ``alpha=1`` reduces exactly to
    :func:`parallel_lasso_path`."""
    return parallel_lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def _conlasso_x_update_maker(C, d):
    """Per-worker EQUALITY-CONSTRAINED ridge solves for the consensus
    constrained lasso: each worker's x-update is the block-eliminated
    KKT system of models/conlasso.py (cached ``(A_i'A_i + rho I)^{-1}``
    plus the m x m dual Schur complement per worker), so every worker
    iterate satisfies ``C x_i = d`` exactly and the consensus mean
    inherits feasibility; the master prox stays the plain soft
    threshold."""
    def make(Xi, yi, rho):
        Wl, rows, p = Xi.shape
        dtype = Xi.dtype
        Ab = _bmm("wrp,wr->wp", Xi, yi)
        eye = jnp.eye(p, dtype=dtype)
        jit = 1e-6 if dtype == jnp.float32 else 0.0
        G = _bmm("wrp,wrq->wpq", Xi, Xi) + rho * eye
        Minv = jax.vmap(lambda A: chol_inverse(A, jitter=jit))(G)
        MCt = _bmm("wpq,mq->wpm", Minv, C)
        S = _bmm("mp,wpk->wmk", C, MCt)
        Sinv = jax.vmap(lambda A: chol_inverse(A, jitter=jit))(S)

        def x_update(z, y, rho, x_prev):
            rhs = Ab - y + rho * z[None, :]
            Mr = _bmm("wpq,wq->wp", Minv, rhs)
            nu = _bmm("wmk,wk->wm",
                      Sinv, _bmm("mp,wp->wm", C, Mr) - d[None, :])
            return Mr - _bmm("wpm,wm->wp", MCt, nu)

        return x_update

    return make


def parallel_constrained_lasso_path(
        X, y, C, d=None, *, nworkers: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        lambdas: Optional[jnp.ndarray] = None, nlambda: int = 50,
        lambda_min_ratio: float = 1e-3, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0,
        weights: Optional[jnp.ndarray] = None,
        trace_len: Optional[int] = None,
        dtype=jnp.float32) -> PathResult:
    """Consensus equality-CONSTRAINED lasso path (extension — VERDICT
    r4 item 9): row blocks solve constrained ridge subproblems (every
    worker iterate exactly feasible), one fused psum per iteration, the
    plain soft-threshold master prox.  Arguments as in
    :func:`admm_tpu.models.conlasso.constrained_lasso_path` plus the
    consensus ``nworkers``/``mesh``.  The reported coefficients are
    the consensus z, so ``C b = d`` holds to solver tolerance (tighten
    eps to tighten it) — the serial driver's contract."""
    from ..models.genlasso import center_weight

    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    C = jnp.atleast_2d(jnp.asarray(C, dtype))
    n, p = X.shape
    if C.shape[1] != p:
        raise ValueError("C must be (m, ncol(x))")
    if C.shape[0] >= p:
        raise ValueError("need fewer constraints than coefficients")
    d = (jnp.zeros((C.shape[0],), dtype) if d is None
         else jnp.asarray(d, dtype).ravel())
    if d.shape != (C.shape[0],):
        raise ValueError("d must have one entry per constraint row")
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)
    w = None if weights is None else jnp.asarray(weights, dtype)
    Xs, ys, mean_x, mean_y = center_weight(X, y, w, intercept)

    if lambdas is not None:
        lams = jnp.sort(jnp.atleast_1d(
            jnp.asarray(lambdas, dtype)))[::-1]
    else:
        # The serial driver's feasible-certificate grid top
        # (models/conlasso.py::_conlasso_path_dev).
        g = dot(Xs.T, ys)
        nu_ls = dot(chol_inverse(
            gram(C.T), jitter=1e-6 if dtype == jnp.float32 else 1e-12),
            dot(C, g))
        lam0 = jnp.max(jnp.abs(g - dot(C.T, nu_ls))) / n
        lam0 = jnp.where(jnp.isfinite(lam0) & (lam0 > 0), lam0,
                         jnp.max(jnp.abs(g)) / n)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0),
            int(nlambda)))
    ilams = lams * n

    Xb, yb, rows_w = _partition_rows(Xs, ys, W)
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(_consensus_shard, nworkers=W,
                     make_x_update=_conlasso_x_update_maker(C, d),
                     master_prox=_lasso_master_prox(W),
                     auto_rho=lambda lam_first: lam_first / W,
                     trace_len=trace_len)
    out = _run_consensus(Xb, yb, ilams, rho, maxit, eps_abs, eps_rel,
                         mesh=mesh, axis=axis, D=D, solver=solver,
                         traced=trace_len is not None)
    coefs, niter = out[0], out[1]
    traces = out[3] if trace_len is not None else None
    beta0 = mean_y - dot(coefs, mean_x)
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs,
                      niter=niter, trace=traces)


def parallel_zerosum_lasso_path(X, y, **kw) -> PathResult:
    """Consensus zero-sum lasso (``sum_j b_j = 0``) — the constrained
    consensus path at C = 1'."""
    p = np.asarray(X).shape[1]
    return parallel_constrained_lasso_path(X, y, np.ones((1, p)), **kw)


def parallel_bp_fit(A, b, *, nworkers: Optional[int] = None,
                    mesh: Optional[Mesh] = None, maxit: int = 10000,
                    eps_abs: Optional[float] = None,
                    eps_rel: Optional[float] = None,
                    rho: Optional[float] = None,
                    trace_len: Optional[int] = None,
                    dtype=None) -> BPResult:
    """Consensus Basis Pursuit: ``min ||z||_1 s.t. A_i z = b_i`` for every
    row block i — the working version of what the reference left dormant
    (reference: src/TODO/ParBP.cppp, src/TODO/PADMMBP.h; the R layer
    dispatches to it at R/10_admm_bp.R:100-120 but it was never compiled).

    Workers project onto their local affine constraint sets exactly
    (cached ``(A_i A_i')^{-1}``); the master soft-thresholds the consensus
    mean.  Defaults mirror the serial BP (eps 1e-4, rho 1.0,
    reference: R/10_admm_bp.R:38-41).

    Convergence note: as in :func:`parallel_lasso_path`, the primal test
    lags one iteration (single-psum protocol); the returned iterate is
    one refining step past the certified one.
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    # f32 default tolerance tightened as in the serial BP (models/bp.py).
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == jnp.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == jnp.float64 else 2e-5
    if rho is None:
        # Measured like the serial BP (DESIGN.md "rho defaults,
        # re-tuned"): rho = 5 is equal-or-better across shapes AND
        # worker counts W=2..8 (up to 3.2x fewer iterations with better
        # recovery at 400x1600); rho = 1.0 is the reference's default.
        rho = 5.0
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    n, p = A.shape
    if p <= n:
        raise ValueError("ncol(x) must be greater than nrow(x)")
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)

    Ab, bb, rows_w = _partition_rows(A, b, W)
    # Never zero: padded zero rows make A_i A_i' exactly singular, and the
    # jitter is what keeps them inert (see _bp_x_update).  Negligible at
    # 1e-10 for f64; 1e-6 guards f32 conditioning.
    jitter = 1e-6 if dtype == jnp.float32 else 1e-10
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(
        _consensus_shard, nworkers=W,
        make_x_update=partial(_bp_x_update, jitter=jitter),
        master_prox=_bp_master_prox(W),
        auto_rho=lambda lam_first: 1.0,
        trace_len=trace_len)
    lams = jnp.ones((1,), dtype)  # single solve; the BP prox ignores lam
    out = _run_consensus(Ab, bb, lams, rho, maxit, eps_abs,
                         eps_rel, mesh=mesh, axis=axis, D=D,
                         solver=solver, traced=trace_len is not None)
    coefs, niter = out[0], out[1]
    traces = out[3][0] if trace_len is not None else None
    return BPResult(coef=coefs[0], niter=niter[0], trace=traces)


def parallel_glm_lasso_path(
        X, y, family, *, nworkers: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        lambdas: Optional[jnp.ndarray] = None, nlambda: int = 50,
        lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
        standardize: bool = True, intercept: bool = True,
        maxit: int = 10000, eps_abs: float = 1e-5,
        eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, trace_len: Optional[int] = None,
        weights: Optional[jnp.ndarray] = None, hessian: str = "auto",
        dtype=jnp.float32) -> PathResult:
    """Consensus penalized-GLM path over the mesh for ANY
    :class:`~admm_tpu.models.glm.GLMFamily` (extension): the distributed
    smooth-loss tier the reference never had, honoring its model-generic
    consensus template (reference: src/PADMMBase.h:17-83 — any f_i plugs
    in).  Each worker runs the family's inexact-Newton x-update on ITS
    row block's share of the loss; the master applies the masked
    elastic-net prox; the iteration is still exactly one fused psum.
    Semantics (objective, glmnet lambda_max rule, standardization,
    unpenalized intercept) match :func:`admm_tpu.models.glm.
    glm_lasso_path`, to which the result converges (tested for the
    binomial, huber and poisson families).
    """
    from ..models.glm import GLMFamily, prep_design, recover_glm

    fam = family() if not isinstance(family, GLMFamily) else family
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype).ravel()
    n, p = X.shape
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1] for GLM paths")
    if hessian == "auto":
        hessian = "fixed" if fam.curvature_bound is not None else "exact"
    if hessian == "fixed" and fam.curvature_bound is None:
        raise ValueError(f"family {fam.name!r} has unbounded curvature; "
                         "hessian='fixed' is not available")
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)

    # Shared GLM design prep / lambda rule (models/glm.py) so the
    # consensus path cannot diverge from the serial semantics.
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))  # glmnet: weights sum to n
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    else:
        r0 = fam.null_resid(y, intercept, w)
        if w is not None:
            r0 = w * r0
        lam0 = (jnp.max(jnp.abs(dot(Xs.T, r0))) / n
                / jnp.maximum(alpha, 1e-3))
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0),
            int(nlambda)))

    Xb, yb, rows_w = _partition_rows(Xa, y, W)
    if w is not None:
        # Weights ride stacked with the response so the shard_map specs
        # and the fused psum are untouched (see _glm_x_update).
        _, wb, _ = _partition_rows(Xa, w, W)
        yb = jnp.stack([yb, wb], axis=-1)
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(
        _consensus_shard, nworkers=W,
        make_x_update=partial(_glm_x_update, family=fam, n_total=n,
                              newton_steps=int(newton_steps),
                              weighted=w is not None, hessian=hessian),
        master_prox=_glm_master_prox(W, float(alpha), pen_mask),
        # Auto-rho = (curvature bound or 1)/W: each worker's loss share
        # carries ~ bound/W of the global curvature, so the prox term
        # balances it at that scale.  MEASURED on the 8-worker mesh
        # (DESIGN.md "GLM rho, measured"): 4-20x fewer iterations than
        # the old rho = 1 guess across binomial/huber/poisson, with
        # serial-agreement gaps unchanged; the W-scaling was confirmed
        # at W = 4 (optimum moves to bound/4).
        auto_rho=lambda lam_first: (fam.curvature_bound or 1.0) / W,
        trace_len=trace_len)
    # st.lam is the USER-scale lambda here (the GLM ops carry the 1/n
    # inside the loss gradient, unlike the gaussian paths' ilams).
    out = _run_consensus(Xb, yb, lams, rho, maxit, eps_abs, eps_rel,
                         mesh=mesh, axis=axis, D=D, solver=solver,
                         traced=trace_len is not None)
    coefs_a, niter = out[0], out[1]
    traces = out[3] if trace_len is not None else None

    beta0, coef = recover_glm(coefs_a, mean_x, sd_x, intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def parallel_logistic_lasso_path(X, y, **kw) -> PathResult:
    """Consensus sparse logistic regression: the binomial instantiation
    of :func:`parallel_glm_lasso_path` (converges to
    :func:`admm_tpu.models.logistic.logistic_lasso_path`, tested)."""
    from ..models.glm import binomial

    return parallel_glm_lasso_path(X, y, binomial(), **kw)


def parallel_huber_lasso_path(X, y, *, M: float = 1.345,
                              **kw) -> PathResult:
    """Consensus robust (Huber-loss) Lasso/Enet path — the distributed
    counterpart of :func:`admm_tpu.models.glm.huber_lasso_path`."""
    from ..models.glm import huber

    return parallel_glm_lasso_path(X, y, huber(float(M)), **kw)


def parallel_poisson_lasso_path(X, y, **kw) -> PathResult:
    """Consensus sparse Poisson regression path — the distributed
    counterpart of :func:`admm_tpu.models.glm.poisson_lasso_path`."""
    from ..models.glm import poisson

    return parallel_glm_lasso_path(X, y, poisson(), **kw)


def parallel_multinomial_lasso_path(
        X, y, *, nclass: Optional[int] = None,
        nworkers: Optional[int] = None, mesh: Optional[Mesh] = None,
        lambdas: Optional[jnp.ndarray] = None, nlambda: int = 50,
        lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
        grouped: bool = False, standardize: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        newton_steps: int = 2, trace_len: Optional[int] = None,
        dtype=jnp.float32):
    """Consensus sparse MULTINOMIAL (softmax) regression over the mesh
    (extension): the matrix-variable instance of the generic consensus
    template — each worker runs the fixed-majorizer Newton on its row
    block's share of the softmax NLL with the (q, C) coefficient block
    flattened to q*C lanes, the master applies the (un)grouped prox,
    and the iteration is still exactly one fused psum (now of length
    q*C + 3).  Semantics match
    :func:`admm_tpu.models.multinomial.multinomial_lasso_path`, to
    which the result converges (tested).
    """
    from ..models.glm import prep_design
    from ..models.multinomial import MNPathResult

    X = jnp.asarray(X, dtype)
    y_np = np.asarray(y).ravel()
    n, p = X.shape
    if nclass is None:
        nclass = int(y_np.max()) + 1
    C = int(nclass)
    if C < 2:
        raise ValueError("need at least 2 classes")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)

    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize, intercept)
    Xs = Xa[:, 1:] if intercept else Xa
    q = Xa.shape[1]
    yj = jnp.asarray(y_np.astype(np.float32), dtype)
    Yoh = jax.nn.one_hot(yj.astype(jnp.int32), C, dtype=dtype)

    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    else:
        # Same grid rule as the serial driver (models/multinomial.py).
        pi0 = (jnp.mean(Yoh, axis=0) if intercept
               else jnp.full((C,), 1.0 / C, dtype))
        G0 = dot(Xs.T, pi0[None, :] - Yoh) / n
        if grouped:
            lam0 = 1.001 * jnp.max(jnp.sqrt(jnp.sum(G0 * G0, axis=1)))
        else:
            lam0 = jnp.max(jnp.abs(G0)) / jnp.maximum(alpha, 1e-3)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0),
            int(nlambda)))

    Xb, yb, rows_w = _partition_rows(Xa, yj, W)
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(
        _consensus_shard, nworkers=W,
        make_x_update=partial(_mn_x_update, nclass=C, n_total=n,
                              newton_steps=int(newton_steps)),
        master_prox=_mn_master_prox(W, float(alpha), pen_mask, q, C,
                                    bool(grouped)),
        # Per-class curvature scale 1/(4C) (the serial measured default,
        # models/multinomial.py::_mn_engine), split over W workers (the
        # measured bound/W principle, DESIGN.md "GLM rho").
        auto_rho=lambda lam_first: 1.0 / (4.0 * C * W),
        trace_len=trace_len)
    init = (jnp.zeros((W, q * C), dtype), jnp.zeros((W, q * C), dtype),
            jnp.zeros((q * C,), dtype))
    out = _run_consensus(Xb, yb, lams, rho, maxit, eps_abs, eps_rel,
                         mesh=mesh, axis=axis, D=D, solver=solver,
                         traced=trace_len is not None, init=init)
    coefs_flat, niter = out[0], out[1]
    coefs_a = coefs_flat.reshape(-1, q, C)

    from ..models.multinomial import mn_recover

    beta0, coef = mn_recover(coefs_a, sd_x, mean_x, C, intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter)


def parallel_multitask_lasso_path(
        X, Y, *, nworkers: Optional[int] = None,
        mesh: Optional[Mesh] = None,
        lambdas: Optional[jnp.ndarray] = None, nlambda: int = 50,
        lambda_min_ratio: float = 1e-2, alpha: float = 1.0,
        standardize: bool = True,
        intercept: bool = True, maxit: int = 10000,
        eps_abs: float = 1e-5, eps_rel: float = 1e-5, rho: float = -1.0,
        trace_len: Optional[int] = None, penalty: str = "rows",
        dtype=jnp.float32):
    """Consensus MULTI-TASK Lasso over the mesh (extension): per-worker
    cached ridge solves with a MATRIX right-hand side (tall direct /
    wide Woodbury, the K-column generalization of the reference's
    per-worker factorizations, reference: src/PADMMLasso.h:17-31), the
    master applying the row-norm mixed prox — or the SVT trace-norm
    prox with ``penalty="nuclear"`` (the reduced-rank consensus path);
    one fused psum of length p*K + 3 per iteration.  Converges to
    :func:`admm_tpu.models.multitask.multitask_lasso_path` (tested).
    """
    from ..models.multitask import MTPathResult, _mt_lambda0

    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    if penalty == "nuclear" and alpha != 1.0:
        raise ValueError("alpha is a row concept; the nuclear penalty "
                         "does not support it")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    X = jnp.asarray(X, dtype)
    Y = jnp.asarray(Y, dtype)
    if Y.ndim != 2:
        raise ValueError("Y must be (n, K)")
    n, p = X.shape
    K = Y.shape[1]
    W, mesh, axis, D = _resolve_mesh(nworkers, mesh)

    # Standardization SHARED with the serial driver (models/multitask).
    from ..models.multitask import mt_recover, mt_standardize

    Xs, Ys, sd_x, sd_y, mean_x, mean_y, _w = mt_standardize(
        X, Y, standardize_x=standardize, intercept=intercept)

    lam0 = _mt_lambda0(Xs, Ys, alpha=alpha, penalty=penalty) / n
    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
    else:
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0),
            int(nlambda)))
    ilams = lams * n

    Xb, Yb, rows_w = _partition_rows(Xs, Ys, W)
    trace_len = None if trace_len is None else int(trace_len)
    solver = partial(
        _consensus_shard, nworkers=W,
        make_x_update=partial(_mt_x_update, ntask=K,
                              tall_block=rows_w >= p),
        master_prox=(_mt_nuclear_master_prox(W, p, K)
                     if penalty == "nuclear"
                     else _mt_master_prox(W, p, K, float(alpha))),
        # Consensus-lasso auto-rho rule (reference:
        # src/PADMMLasso.h:199-200), on the internal lambda scale.
        auto_rho=lambda lam_first: lam_first / W,
        trace_len=trace_len)
    init = (jnp.zeros((W, p * K), dtype), jnp.zeros((W, p * K), dtype),
            jnp.zeros((p * K,), dtype))
    out = _run_consensus(Xb, Yb, ilams, rho, maxit, eps_abs, eps_rel,
                         mesh=mesh, axis=axis, D=D, solver=solver,
                         traced=trace_len is not None, init=init)
    coefs_flat, niter = out[0], out[1]
    coefs = coefs_flat.reshape(-1, p, K)
    beta0, coef = mt_recover(coefs, sd_x, sd_y, mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter)
