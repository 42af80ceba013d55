"""SLOPE: Sorted L-One Penalized Estimation by ADMM.

Extension beyond the reference: the sorted-l1 norm regression of
Bogdan, van den Berg, Sabatti, Su & Candes (2015) —

    minimize  1/(2n) ||y - X b||^2 + t * sum_i lam_i |b|_(i)

with ``lam_1 >= lam_2 >= ... >= lam_p >= 0`` a DECREASING penalty
sequence applied to the DECREASINGLY SORTED coefficient magnitudes
(|b|_(1) the largest).  With the Benjamini-Hochberg sequence
``lam_i = z(1 - q i / (2p))`` SLOPE controls the false discovery rate
of the selected support at level q under orthogonal designs — the
adaptive-threshold refinement of the lasso.  All lam_i equal reduces
EXACTLY to the lasso (tested).

The solver is the tall/wide Lasso pair with ONE swap — the z-prox
becomes the sorted-l1 prox.  That prox (paper Alg. 4) is a soft
threshold by the sorted sequence followed by an ISOTONIC projection
onto the nonincreasing cone.  Classic implementations use the
sequential pool-adjacent-violators stack; here the projection is the
closed-form MINIMAX formula

    w_i = max_{j<=i} min_{k>=i} mean(z_j..z_k)

computed as two (p, p) masked cumulative reductions over a prefix-sum
table — dense O(p^2) VPU work with no data-dependent control flow, the
same dense-beats-bookkeeping trade the wide-regime active-set question
settled (DESIGN.md).  Oracle: sklearn ``isotonic_regression`` plus an
independent numpy proximal-gradient SLOPE solver (tests/test_slope.py).

The path is over the SCALE t of the sequence (lambdas = t values), with
the exact null threshold ``t0 = max_k cumsum(sorted |X'y|/n)_k /
cumsum(lam)_k`` (the dual sorted-l1 norm) as the grid top.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (make_admm_solver, make_batched_solver,
                           make_fadmm_solver, make_state)
from ..data.standardize import recover, standardize
from ..linalg import dot
from .lasso import (PathResult, _batched_cold_states, _scan_path,
                    _tall_ops, _tall_setup, _wide_ops, _wide_setup)


def isotonic_nonincreasing(z):
    """Euclidean projection of ``z`` onto the nonincreasing cone
    (isotonic regression with decreasing constraint), via the minimax
    formula on the reversed (nondecreasing) problem:
    ``w_i = max_{j<=i} min_{k>=i} mean(x_j..x_k)``.

    Dense (p, p) cumulative reductions instead of the sequential PAVA
    stack — no data-dependent control flow, vmappable, O(p^2) VPU work
    (p here is the coefficient count of a feature-selection problem,
    not a data dimension)."""
    x = z[::-1]
    p = x.shape[0]
    C = jnp.concatenate([jnp.zeros((1,), x.dtype), jnp.cumsum(x)])
    j = jnp.arange(p)[:, None]
    k = jnp.arange(p)[None, :]
    avg = (C[1:][None, :] - C[:-1][:, None]) / (k - j + 1.0)  # mean j..k
    big = jnp.asarray(jnp.finfo(x.dtype).max, x.dtype)
    # inner_min[j, i] = min_{k >= i} avg(j, k)   (valid for j <= i)
    masked = jnp.where(k >= j, avg, big)
    inner_min = jax.lax.cummin(masked[:, ::-1], axis=1)[:, ::-1]
    # w_i = max_{j <= i} inner_min[j, i]
    w = jax.lax.cummax(jnp.where(j <= k, inner_min, -big), axis=0)
    return jnp.diagonal(w)[::-1]


def isotonic_nonincreasing_pava(z):
    """Euclidean projection onto the nonincreasing cone by PARALLEL
    pool-adjacent-violators: O(p) memory, O(p) work per pass — the
    large-p alternative to the dense (p, p) minimax (which is O(p^2)
    in time AND memory, >1 GB of temporaries per prox call at p=16k).

    Each pass merges EVERY chain of order-violating adjacent blocks at
    once.  Safety: if adjacent blocks (B1, B2) violate (mean B1 <
    mean B2 for the nonincreasing fit), merging any pair in the chain
    moves the merged mean strictly BETWEEN the two — so every other
    violation in the chain still violates afterwards, and simultaneous
    chain pooling equals some sequential PAVA merge order (PAVA is
    merge-order-independent).  Blocks are per-position head flags;
    block means come from cumsum/cummax/cummin segment reductions —
    no data-dependent shapes, vmappable, while_loop until no
    violation (data-dependent pass count; near-sorted prox inputs
    take 1-5 passes)."""
    p = z.shape[0]
    idx = jnp.arange(p)
    C = jnp.concatenate([jnp.zeros((1,), z.dtype), jnp.cumsum(z)])

    def compute(head):
        # Block start per position: latest head index <= i (head[0] is
        # always True); block end: (first head index > i) - 1.
        bstart = jax.lax.cummax(jnp.where(head, idx, 0))
        h2 = jnp.where(head, idx, p)
        nxthead = jax.lax.cummin(h2[::-1])[::-1]       # first head >= i
        bend = jnp.concatenate([nxthead[1:],
                                jnp.full((1,), p, idx.dtype)]) - 1
        mean = (C[bend + 1] - C[bstart]) / (bend - bstart + 1.0)
        shifted = jnp.concatenate([mean[:1], mean[:-1]])
        viol = head & (shifted < mean) & (idx > 0)
        return mean, viol

    head0 = jnp.ones((p,), bool)
    mean0, viol0 = compute(head0)

    def cond(c):
        return jnp.any(c[2])

    def body(c):
        head, _, viol = c
        head = head & jnp.logical_not(viol)
        mean, viol = compute(head)
        return head, mean, viol

    _, mean, _ = jax.lax.while_loop(cond, body, (head0, mean0, viol0))
    return mean


# Dense-minimax / parallel-PAVA crossover (DESIGN.md "SLOPE isotonic
# crossover"): the (p, p) tables win below this p, the O(p)-memory
# passes above — and are the only option past p ~ 16k, where the dense
# temporaries exceed device memory.  Tuned before the GPU port; not yet
# measured on the H100 (ROADMAP A5).
_ISOTONIC_DENSE_MAX_P = 3072


def prox_sorted_l1(v, lam_sorted, method: str = "auto"):
    """Prox of the sorted-l1 norm ``sum_i lam_i |v|_(i)`` (paper
    Alg. 4): sort |v| decreasing, subtract the sorted penalties,
    project onto the nonincreasing nonnegative cone, undo the sort and
    signs.  ``method``: 'dense' (the (p, p) minimax), 'pava' (the
    O(p)-memory parallel passes), or 'auto' (measured crossover on
    the static p)."""
    a = jnp.abs(v)
    order = jnp.argsort(-a)
    u = a[order]
    if method == "auto":
        method = ("dense" if v.shape[-1] <= _ISOTONIC_DENSE_MAX_P
                  else "pava")
    iso = (isotonic_nonincreasing if method == "dense"
           else isotonic_nonincreasing_pava)
    w = jnp.maximum(iso(u - lam_sorted), 0.0)
    out = jnp.zeros_like(v).at[order].set(w)
    return jnp.sign(v) * out


def _slope_tall_ops(Minv, Xty, lam_seq, p):
    ops = _tall_ops(Minv, Xty, 1.0, p)

    def next_z(st, x_new):
        v = x_new + st.adj_y / st.rho
        return prox_sorted_l1(v, (st.lam / st.rho) * lam_seq), None

    return ops._replace(next_z=next_z)


def _slope_wide_ops(Xs, ys, sprad, t0, lam_seq, n, p):
    ops = _wide_ops(Xs, ys, sprad, t0, 1.0, n, p)

    def next_x(st):
        gamma = sprad
        tmp = st.aux + st.z + st.y / st.rho
        v = st.x - dot(Xs.T, tmp) / gamma
        x_new = prox_sorted_l1(v, (st.lam / (st.rho * gamma)) * lam_seq)
        return jnp.where(st.lam > t0 * (1.0 - 1e-5),
                         jnp.zeros_like(x_new), x_new)

    return ops._replace(next_x=next_x)


def _slope_engine(Xs, ys, lam_seq, t_first, rho0):
    n, p = Xs.shape
    dtype = Xs.dtype
    if n > p:
        Minv, Xty, rho = _tall_setup(Xs, ys, t_first * lam_seq[0], rho0)
        ops = _slope_tall_ops(Minv, Xty, lam_seq, p)
        solve = make_fadmm_solver(ops, adapt_rho=False)
        zp = jnp.zeros((p,), dtype)
        st0 = make_state(zp, zp, zp, rho, t_first, dtype=dtype)
        # Tall reports the sparse prox iterate z (exact zeros), wide
        # reports x — the Lasso's conventions.
        return st0, solve, (lambda st: st.z), None
    t0, sprad, rho = _wide_setup(Xs, ys, t_first * lam_seq[0], rho0,
                                 1.0, False)
    # Wide all-zero threshold on the t scale (exact dual sorted-l1
    # norm; _slope_t0 computes it): recomputed by the caller.
    t0_slope = _slope_t0(Xs, ys, lam_seq)
    ops = _slope_wide_ops(Xs, ys, sprad, t0_slope, lam_seq, n, p)
    # Wide regime: plain ADMM with the adaptive ladder, exactly the
    # wide-Lasso engine (no factorization depends on rho there).
    solve = make_admm_solver(ops, adapt_rho=True)
    zp = jnp.zeros((p,), dtype)
    zn = jnp.zeros((n,), dtype)
    st0 = make_state(zp, zn, zn, rho, t_first, aux=zn, dtype=dtype)
    return st0, solve, (lambda st: st.x), None


def _slope_t0(Xs, ys, lam_seq):
    """Exact null threshold: b = 0 is optimal iff the dual sorted-l1
    norm of X'y/n is <= t, i.e. t0 = max_k cumsum(sorted |X'y|/n)_k /
    cumsum(lam)_k (Bogdan et al. sec. 2.2)."""
    g = jnp.sort(jnp.abs(dot(Xs.T, ys)))[::-1]
    return jnp.max(jnp.cumsum(g) / jnp.cumsum(lam_seq))


def bh_sequence(p: int, q: float = 0.1) -> np.ndarray:
    """The Benjamini-Hochberg penalty sequence
    ``lam_i = Phi^{-1}(1 - q i / (2 p))`` (paper eq. 1.7)."""
    from scipy.stats import norm

    i = np.arange(1, p + 1)
    return norm.ppf(1.0 - q * i / (2.0 * p))


@partial(jax.jit, static_argnames=("nlambda", "standardize_x",
                                   "intercept", "path_mode",
                                   "trace_len"))
def _slope_path_dev(X, y, lam_seq, nlambda, lambda_min_ratio, user_ts,
                    rho0, maxit, eps_abs, eps_rel, weights=None, *,
                    standardize_x, intercept, path_mode,
                    trace_len=None):
    n, p = X.shape
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    if user_ts is None:
        # Internal scale: the engines consume ilam = t * n / scale_y
        # (the Lasso's glmnet convention, reference: src/Lasso.cpp:99).
        # The 1e-4 nudge puts the grid top STRICTLY above the null
        # threshold: the sorted-l1 dual constraint is tight (equality)
        # at t0 itself, which leaves one boundary coefficient at
        # machine scale.
        t0 = (_slope_t0(Xs, ys, lam_seq) / n * stats.scale_y
              * (1.0 + 1e-4))
        ts = jnp.exp(jnp.linspace(
            jnp.log(t0), jnp.log(lambda_min_ratio * t0), nlambda))
    else:
        ts = user_ts
    its = ts * n / stats.scale_y

    if path_mode == "batch":
        dtype = Xs.dtype
        if n > p:
            Minv, Xty, rho = _tall_setup(Xs, ys, its[0] * lam_seq[0],
                                         rho0)
            ops = _slope_tall_ops(Minv, Xty, lam_seq, p)
            st = _batched_cold_states(its.shape[0], p, rho, its, dtype)
            solve = make_batched_solver(
                make_fadmm_solver(ops, adapt_rho=False))
        else:
            _, sprad, rho = _wide_setup(Xs, ys, its[0] * lam_seq[0],
                                        rho0, 1.0, False)
            t0s = _slope_t0(Xs, ys, lam_seq)
            ops = _slope_wide_ops(Xs, ys, sprad, t0s, lam_seq, n, p)
            st = _batched_cold_states(its.shape[0], p, rho, its, dtype,
                                      aux_dim=n)
            zn = jnp.zeros((its.shape[0], n), dtype)
            st = st._replace(z=zn, y=zn, adj_z=zn, adj_y=zn)
            solve = make_batched_solver(
                make_admm_solver(ops, adapt_rho=True))
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs = st.z if n > p else st.x
        niter, traces = st.it, None
    else:
        st0, solve, report, _ = _slope_engine(Xs, ys, lam_seq, its[0],
                                              rho0)
        _, coefs, niter, traces = _scan_path(st0, solve, report, its,
                                             maxit, eps_abs, eps_rel,
                                             trace_len)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=ts, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def slope_path(X, y, *, lam_seq=None, q: float = 0.1,
               lambdas: Optional[jnp.ndarray] = None, nlambda: int = 30,
               lambda_min_ratio: float = 1e-2,
               standardize: bool = True, intercept: bool = True,
               weights=None, maxit: int = 10000, eps_abs: float = 1e-5,
               eps_rel: float = 1e-5, rho: float = -1.0,
               path_mode: str = "auto",
               trace_len: Optional[int] = None,
               dtype=jnp.float32) -> PathResult:
    """Solve the SLOPE path on device.

    ``lam_seq`` is the decreasing (p,) penalty sequence (default: the
    Benjamini-Hochberg sequence at FDR level ``q``); ``lambdas`` are
    the SCALE values t of the path (auto grid from the exact null
    threshold).  All other keywords as in
    :func:`admm_tpu.models.lasso.lasso_path`; a constant ``lam_seq``
    reduces exactly to the lasso (tested)."""
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    n, p = X.shape
    if lam_seq is None:
        lam_seq = bh_sequence(p, q)
    lam_np = np.asarray(lam_seq, np.float64).ravel()
    if lam_np.shape != (p,):
        raise ValueError("lam_seq must have one entry per column of x")
    if np.any(np.diff(lam_np) > 1e-12) or lam_np[-1] < 0:
        raise ValueError("lam_seq must be nonincreasing and >= 0")
    if not lam_np[0] > 0:
        raise ValueError("lam_seq must have a positive largest entry")
    if path_mode not in ("auto", "batch", "scan"):
        raise ValueError("path_mode must be 'auto', 'batch' or 'scan'")
    if path_mode == "auto":
        # Crossover (DESIGN.md "SLOPE protocol"): the O(p^2) isotonic
        # prox runs per LANE, so batch lanes stop amortizing once the
        # prox dominates the matvec.  Tuned before the GPU port; not yet
        # measured on the H100 (ROADMAP A5).
        path_mode = "batch" if p < 100 else "scan"
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    ts = (None if lambdas is None
          else jnp.sort(jnp.atleast_1d(jnp.asarray(lambdas, dtype)))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    return _slope_path_dev(X, y, jnp.asarray(lam_np, dtype),
                           int(nlambda), lambda_min_ratio, ts, rho,
                           maxit, eps_abs, eps_rel, w,
                           standardize_x=standardize,
                           intercept=intercept, path_mode=path_mode,
                           trace_len=trace_len)


@partial(jax.jit, static_argnames=("standardize_x", "intercept"))
def _slope_fold_etas(X, y, lam_seq, lams, masks, fid, rho, maxit,
                     eps_abs, eps_rel, *, standardize_x, intercept):
    """Jitted core of the SLOPE one-pass fold sweep (the
    cv.py::_gaussian_fold_etas pattern): fold f = the weighted path
    with weight 0 on held-out rows, vmapped over the fold-mask axis;
    returns the (n, nlambda) own-fold linear predictors selected on
    device."""
    def one(mask):
        res = _slope_path_dev(X, y, lam_seq, 2, 1e-2, lams, rho, maxit,
                              eps_abs, eps_rel, mask,
                              standardize_x=standardize_x,
                              intercept=intercept, path_mode="batch")
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)                # (nfolds, nlambda, n)
    return etas[fid, :, jnp.arange(fid.shape[0])]
