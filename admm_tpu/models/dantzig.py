"""Dantzig selector lambda-path solver.

Model: ``minimize ||beta||_1  s.t.  ||X'(X beta - y)||_inf <= lambda``.

The reference *ships this model broken*: ``admm_dantzig`` is exported and
the R class calls into native code that was never compiled (it lives in
``src/TODO/`` — SURVEY.md section 2.6 caveat 1).  The math is fully
specified there, so this module finishes the job as a first-class model.

Linearized ADMM with ``A = X'X``, ``c = X'y``
(reference: src/TODO/ADMMDantzig.h:9-21)::

    minimize f(x) + g(z)   s.t.  A x + z = c
    f = ||.||_1,  g = indicator{||z||_inf <= lambda}

x-update (prox-gradient on the augmented term, step ``1/(rho*sprad)``
with ``sprad = eigmax(X'X)^2``; reference: src/TODO/ADMMDantzig.h:125-137)::

    v = x - A'(Ax + z + y/rho - c)/sprad
    x = soft_threshold(v, 1/(rho*sprad))

z-update is the box projection ``z = -clip(Ax + y/rho - c, -lambda, lambda)``
(reference: src/TODO/ADMMDantzig.h:164-181).  Auto-rho ``1/sqrt(sprad)``
(reference: src/TODO/ADMMDantzig.h:257-260).

Deliberate fix over the reference: the dormant solver inherits the
adaptive-rho ladder from ``ADMMBase::update_rho`` — on this doubly
ill-conditioned linearized splitting (the operator is (X'X)^2) the ladder
drives rho away from the 1/sqrt(sprad) balance point and convergence
collapses (measured: 20000+ iterations and a violated constraint vs ~550
iterations to exact constraint satisfaction with fixed rho).  This
build runs the plain engine with rho FIXED — plausibly one reason the
reference left this solver unfinished in ``src/TODO/``.

The Gram matrix X'X is cached when it is smaller than X itself (n > p),
mirroring the reference's ``use_XX`` switch but without its p <= 1000
cap — a p x p matvec is a cheap dense product here.  Otherwise the
operator is applied matrix-free as X'(X v).

Lambda-path protocol identical to the Lasso driver: internal penalty
``lambda * n / scale_y``, log-linear auto grid from
``lambda0 = ||X'y||_inf``, warm starts via lax.scan
(reference: src/TODO/Dantzig.cpp:60-91).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.engine import (ProblemOps, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import box_clamp_neg, l2norm, soft_threshold
from ..data.standardize import recover, standardize
from ..linalg import dot, gram, spectral_radius_sym
from .lasso import PathResult, _batched_cold_states, _scan_path


def _dantzig_ops(apply_A, Xty, Xty_norm, sprad, lambda0, p) -> ProblemOps:
    sqrt_sprad = jnp.sqrt(sprad)

    def next_x(st):
        rhs = (st.aux + st.z + st.y / st.rho - Xty) / (-sprad)
        v = st.x + apply_A(rhs)
        x_new = soft_threshold(v, 1.0 / (st.rho * sprad))
        # Relative early-exit slack (see models/lasso.py::_wide_ops).
        return jnp.where(st.lam > lambda0 * (1.0 - 1e-5),
                         jnp.zeros_like(x_new), x_new)

    def next_z(st, x_new):
        cache_Ax = apply_A(x_new)
        v = cache_Ax + st.y / st.rho - Xty
        return box_clamp_neg(v, st.lam), cache_Ax

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux + z - Xty,
        eps_primal_scale=lambda st: jnp.maximum(
            jnp.maximum(l2norm(st.aux), l2norm(st.z)), Xty_norm),
        eps_dual_scale=lambda st: sqrt_sprad * l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * sqrt_sprad
        * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p, dim_dual=p,
    )


def _dantzig_setup(Xs, ys, rho0):
    n, p = Xs.shape
    dtype = Xs.dtype
    Xty = dot(Xs.T, ys)
    Xty_norm = l2norm(Xty)
    lambda0 = jnp.max(jnp.abs(Xty))

    if n > p:
        XtX = gram(Xs)
        apply_A = lambda v: dot(XtX, v)
        sprad_g = spectral_radius_sym(XtX)
    else:
        apply_A = lambda v: dot(Xs.T, dot(Xs, v))
        XXt = dot(Xs, Xs.T)
        sprad_g = spectral_radius_sym(XXt)
    sprad = sprad_g * sprad_g  # eigmax(X'X X'X) = eigmax(X'X)^2

    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    1.0 / jnp.sqrt(sprad))
    ops = _dantzig_ops(apply_A, Xty, Xty_norm, sprad, lambda0, p)
    return ops, rho


def _dantzig_engine(Xs, ys, lam_first, rho0):
    """Cold state, solver and reported iterate for the Dantzig path —
    the engine triple consumed by both the path driver and the chunked
    checkpoint driver (admm_tpu.diag.checkpoint)."""
    p = Xs.shape[1]
    dtype = Xs.dtype
    ops, rho = _dantzig_setup(Xs, ys, rho0)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = jnp.zeros((p,), dtype)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, aux=zeros,
                     dtype=dtype)
    return st0, solve, (lambda st: st.x)


def _solve_path_dantzig(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                        trace_len=None):
    st0, solve, report = _dantzig_engine(Xs, ys, ilams[0], rho0)
    _, coefs, niter, traces = _scan_path(st0, solve, report,
                                         ilams, maxit, eps_abs, eps_rel,
                                         trace_len)
    return coefs, niter, traces


def _solve_path_dantzig_batch(Xs, ys, ilams, rho0, maxit, eps_abs,
                              eps_rel):
    """All-lambdas-at-once Dantzig solve: one while_loop whose body is
    the single-lambda engine body vmapped over lanes (the same batched
    protocol as the Lasso, see make_batched_solver).  The x-update's
    apply_A matvec becomes a (k, p) x (p, p) matmul."""
    n, p = Xs.shape
    dtype = Xs.dtype
    ops, rho = _dantzig_setup(Xs, ys, rho0)
    solve = make_batched_solver(make_admm_solver(ops, adapt_rho=False))
    st = _batched_cold_states(ilams.shape[0], p, rho, ilams, dtype,
                              aux_dim=p)
    st = solve(st, maxit, eps_abs, eps_rel)
    return st.x, st.it, None


@partial(jax.jit, static_argnames=("standardize_x", "intercept", "nlambda",
                                   "path_mode", "trace_len"))
def _dpath_auto(X, y, nlambda, lambda_min_ratio, rho, maxit, eps_abs,
                eps_rel, weights=None, *, standardize_x, intercept,
                path_mode, trace_len=None):
    n = X.shape[0]
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    lam0 = jnp.max(jnp.abs(dot(Xs.T, ys)))
    lmax = lam0 / n * stats.scale_y
    lmin = lambda_min_ratio * lmax
    lams = jnp.exp(jnp.linspace(jnp.log(lmax), jnp.log(lmin), nlambda))
    return _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                       standardize_x, intercept, path_mode, trace_len)


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "path_mode", "trace_len"))
def _dpath_user(X, y, lams, rho, maxit, eps_abs, eps_rel, weights=None,
                *, standardize_x, intercept, path_mode, trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    return _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                       standardize_x, intercept, path_mode, trace_len)


def _dpath_from(Xs, ys, stats, lams, rho, maxit, eps_abs, eps_rel,
                standardize_x, intercept, path_mode="scan",
                trace_len=None):
    n = Xs.shape[0]
    ilams = lams * n / stats.scale_y
    if path_mode == "batch":
        coefs, niter, traces = _solve_path_dantzig_batch(
            Xs, ys, ilams, rho, maxit, eps_abs, eps_rel)
    else:
        coefs, niter, traces = _solve_path_dantzig(
            Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, trace_len)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def dantzig_path(X, y, *, lambdas: Optional[jnp.ndarray] = None,
                 nlambda: int = 100,
                 lambda_min_ratio: Optional[float] = None,
                 standardize: bool = True, intercept: bool = True,
                 maxit: int = 10000, eps_abs: float = 1e-5,
                 eps_rel: float = 1e-5, rho: float = -1.0,
                 path_mode: str = "scan",
                 trace_len: Optional[int] = None,
                 weights: Optional[jnp.ndarray] = None,
                 data_mesh=None, dtype=jnp.float32) -> PathResult:
    """Solve the Dantzig-selector lambda path on device.

    API mirrors the Lasso path (the reference's R class extends
    ADMM_Lasso unchanged, reference: R/50_admm_dantzig.R:2), including
    ``path_mode``: "scan" = sequential warm starts, "batch" = all
    lambdas simultaneously as batched lanes, ``trace_len`` (per-iteration
    residual trace; implies "scan"), and ``data_mesh`` (operator
    parallelism: X/y row-sharded over the mesh so the standardization
    moments and the cached X'X / X'y builds distribute — iteration
    state works on the cached (p, p) operator and stays replicated).

    ``weights`` (extension — the weighted Dantzig selector): the
    residual-correlation constraint becomes
    ``||X' W (y - X b)||_inf <= lambda`` via the shared sqrt(w) row
    scaling (data/standardize.py), so an integer weight k equals
    repeating the row k times (tested) and weight-zero rows drop out —
    the fold-as-lane CV protocol rides it like every other family.
    """
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        y = put_dim_sharded(y, data_mesh, 0)
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    w = None if weights is None else jnp.asarray(weights, dtype).ravel()
    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
        return _dpath_user(X, y, lams, rho, maxit, eps_abs, eps_rel, w,
                           standardize_x=standardize, intercept=intercept,
                           path_mode=path_mode, trace_len=trace_len)
    return _dpath_auto(X, y, int(nlambda), lambda_min_ratio, rho, maxit,
                       eps_abs, eps_rel, w, standardize_x=standardize,
                       intercept=intercept, path_mode=path_mode,
                       trace_len=trace_len)
