"""Basis Pursuit solver: ``minimize ||x||_1  s.t.  A x = b`` with p > n.

ADMM splitting (reference: src/ADMMBP.h:7-17)::

    minimize f(x) + g(z)   s.t.  x - z = 0
    f = indicator{A x = b},  g = ||.||_1

The x-update is the affine projection onto {x : Ax = b}::

    x = v - A'(AA')^{-1} A v + A'(AA')^{-1} b,   v = adj_z - adj_y/rho

(reference: src/ADMMBP.h:48-67).  The reference caches ``L^{-1}A`` from
the Cholesky AA' = LL' and applies the projection as two BLAS gemvs;
here the cache is ``K = (AA')^{-1} A`` (one-time explicit SPD inverse +
matmul, no triangular solves anywhere) so each iteration is two skinny
matvecs: ``x = v + AAAb - A'(K v)``.

z-update: soft-threshold with penalty 1/rho (reference: src/ADMMBP.h:84-88).
Accelerated FADMM engine with rho fixed (see the note at the solver
construction below).  No standardization (reference: src/BP.cpp:24-35).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.engine import (ProblemOps, make_fadmm_solver, make_state,
                           make_traced_solve)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import chol_inverse, dot, tgram


class BPResult(NamedTuple):
    coef: jnp.ndarray   # (p,) the sparse iterate z (reference: src/BP.cpp:37-43)
    niter: jnp.ndarray  # int32
    # (trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua, r_dua, rho)
    # when tracing was requested (admm_tpu.diag.trace).
    trace: Optional[jnp.ndarray] = None


def _bp_ops(A, K, n, p, aaab_of) -> ProblemOps:
    """``aaab_of(st)`` supplies the cached ``A'(AA')^{-1} b``: a closure
    constant for the single-signal solver, the lane state ``st.aux`` for
    the batched multi-signal solver — one factory for both."""
    def next_x(st):
        v = st.adj_z - st.adj_y / st.rho
        return v + aaab_of(st) - dot(A.T, dot(K, v))

    def next_z(st, x_new):
        v = x_new + st.adj_y / st.rho
        return soft_threshold(v, 1.0 / st.rho), st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.x), l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=p,
    )


@partial(jax.jit, static_argnames=("trace_len",))
def _bp_fit(A, b, rho, maxit, eps_abs, eps_rel, trace_len=None):
    n, p = A.shape
    dtype = A.dtype
    AAt = tgram(A)
    jitter = 1e-6 if dtype == jnp.float32 else 0.0
    Winv = chol_inverse(AAt, jitter=jitter)       # (AA')^-1
    AAAb = dot(A.T, dot(Winv, b))                 # A'(AA')^-1 b

    K = dot(Winv, A)                              # (AA')^-1 A, n x p
    ops = _bp_ops(A, K, n, p, lambda st: AAAb)
    # Fixed rho: FADMM's restart analysis (Goldstein et al. 2014) assumes
    # a constant penalty; with the adaptive ladder active the combined
    # residual can cycle without converging (observed on small p/n ~ 2.5
    # problems).  The reference's own Lasso engines pin rho for the same
    # family of reasons (reference: src/ADMMLassoTall.h:96-97).
    solve = make_fadmm_solver(ops, adapt_rho=False)

    zeros = jnp.zeros((p,), dtype)
    st = make_state(zeros, zeros, zeros, rho, 0.0, dtype=dtype)
    if trace_len is None:
        st = solve(st, maxit, eps_abs, eps_rel)
        buf = None
    else:
        st, buf = make_traced_solve(solve, trace_len)(st, maxit, eps_abs,
                                                      eps_rel)
    return BPResult(coef=st.z, niter=st.it, trace=buf)


def bp_fit(A, b, *, maxit: int = 10000,
           eps_abs: Optional[float] = None,
           eps_rel: Optional[float] = None,
           rho: Optional[float] = None,
           trace_len: Optional[int] = None,
           data_mesh=None, dtype=None) -> BPResult:
    """Solve Basis Pursuit.  Defaults mirror reference: R/10_admm_bp.R:37-41
    (eps 1e-4, rho = 1) — under f64.  As for LAD, the reference's 1e-4
    is an f64 tolerance (reference: src/BP.cpp:20); on f32 backends the
    default tightens to 2e-5, which brings the recovery error 3x BELOW
    the reference's published number (measured sweep: DESIGN.md
    "f64-class accuracy").  Pass eps explicitly for literal reference
    semantics.  Requires p > n (validated by the builder API).
    ``trace_len`` records the per-iteration residual trace.

    ``data_mesh`` (extension — operator parallelism): A is sharded
    along its LONG (column, p) axis — the AA' build becomes per-shard
    partial outer products + an all-reduce, and the per-iteration
    projection's A'(Kv) matvecs distribute with the (p,) iterate
    sharded; the (n, n) inverse stays replicated (n is the short axis).
    The reference's BLAS threads accelerate the same products
    (reference: src/BP.cpp:20 + src/Makevars:3-4)."""
    if dtype is None:
        # Match the reference's float64 for this model class when the
        # backend supports it (reference: src/LAD.cpp / src/BP.cpp use
        # double); float32 otherwise (SURVEY.md 2.6 caveat 2).
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == jnp.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == jnp.float64 else 2e-5
    if rho is None:
        # Measured across shapes (DESIGN.md "rho defaults, re-tuned"):
        # the reference's rho = 1.0 (R/10_admm_bp.R:38-41) converges
        # 2-5x slower than rho = 5 with equal-or-better recovery.  Pass
        # rho=1.0 for the reference's literal default.
        rho = 5.0
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        A = put_dim_sharded(A, data_mesh, 1)
    return _bp_fit(A, b, rho, maxit, eps_abs, eps_rel,
                   trace_len=(None if trace_len is None
                              else int(trace_len)))


@jax.jit
def _bp_fit_batch(A, B, rho, maxit, eps_abs, eps_rel):
    from ..core.engine import make_batched_solver
    from .lasso import _batched_cold_states

    n, p = A.shape
    m = B.shape[0]
    dtype = A.dtype
    AAt = tgram(A)
    jitter = 1e-6 if dtype == jnp.float32 else 0.0
    Winv = chol_inverse(AAt, jitter=jitter)
    K = dot(Winv, A)
    # (m, p) per-signal caches A'(AA')^{-1} b_i — one matmul for all.
    AAAB = dot(B, dot(Winv, A))

    ops = _bp_ops(A, K, n, p, lambda st: st.aux)
    solve = make_batched_solver(make_fadmm_solver(ops, adapt_rho=False))
    st = _batched_cold_states(m, p, rho, jnp.zeros((m,), dtype), dtype,
                              aux_dim=p)
    st = st._replace(aux=AAAB)
    st = solve(st, maxit, eps_abs, eps_rel)
    return BPResult(coef=st.z, niter=st.it)


def bp_fit_batch(A, B, *, maxit: int = 10000,
                 eps_abs: Optional[float] = None,
                 eps_rel: Optional[float] = None,
                 rho: Optional[float] = None,
                 dtype=None) -> BPResult:
    """Recover MANY sparse signals against one measurement matrix.

    Extension beyond the reference (which solves one b at a time): all m
    right-hand sides share the one-time ``(AA')^{-1}`` factorization and
    solve simultaneously as batched lanes (the batched-lane engine of the
    lambda-path solvers, admm_tpu/core/engine.py::make_batched_solver) —
    the standard compressed-sensing serving workload.

    ``B`` is (m, n); returns ``coef`` (m, p) and ``niter`` (m,).
    """
    if dtype is None:
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    if eps_abs is None:
        eps_abs = 1e-4 if dtype == jnp.float64 else 2e-5
    if eps_rel is None:
        eps_rel = 1e-4 if dtype == jnp.float64 else 2e-5
    if rho is None:
        rho = 5.0  # measured default; see bp_fit
    A = jnp.asarray(A, dtype)
    B = jnp.atleast_2d(jnp.asarray(B, dtype))
    return _bp_fit_batch(A, B, rho, maxit, eps_abs, eps_rel)
