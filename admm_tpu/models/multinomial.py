"""Sparse multinomial (softmax) logistic regression paths by ADMM.

Extension beyond the reference (gaussian-only) — glmnet's
``family="multinomial"`` ::

    minimize  1/n sum_i [log sum_c exp(eta_ic) - eta_{i, y_i}]
              + lambda * P(B),      eta = b0 + X B,  B (p, C)

with either the UNGROUPED penalty ``P = alpha ||B||_1 + (1-alpha)/2
||B||_F^2`` (glmnet's default: classes select features independently)
or the GROUPED one ``P = sum_j ||B_j.||_2`` (glmnet's
``type.multinomial = "grouped"``: a feature enters for all classes at
once, as in models/multitask.py).

structure — the multinomial instance of the fixed-majorizer
design (models/glm.py, DESIGN.md "GLM tier"): the softmax Hessian in
eta satisfies ``diag(pi) - pi pi' <= 1/2 I`` in the PSD order, so the
loss Hessian over vec(B) is dominated by ``(X'X/(2n)) (x) I_C`` —
BLOCK-DIAGONAL across classes with ONE shared (q, q) matrix.  The
majorize-minimize x-update is therefore a single
``(q, q) x (q, C)`` matmul per inner step against a
once-factorized inverse, for ANY number of classes; the whole lambda
path runs as batched (k, q, C) lanes sharing that matrix.

Like glmnet and sklearn we keep the symmetric over-parameterized
softmax (C columns, not C-1): the penalty makes the SLOPES unique,
while the unpenalized intercepts keep a free additive constant — they
are reported sum-to-zero normalized (glmnet's convention; compare
against other solvers after centering theirs too).

Oracle: sklearn LogisticRegression(multinomial saga, penalty="l1")
(tests/test_multinomial.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.engine import (ADMMState, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import dot, ridge_inverse


class MNPathResult(NamedTuple):
    """Multinomial path result (original data scale)."""
    lambdas: jnp.ndarray  # (nlambda,)
    beta0: jnp.ndarray    # (nlambda, C) sum-to-zero intercepts
    coef: jnp.ndarray     # (nlambda, p, C)
    niter: jnp.ndarray    # (nlambda,) int32
    # (nlambda, trace_len, 5) per-iteration residual trace when
    # requested (admm_tpu.diag.trace).
    trace: Optional[jnp.ndarray] = None


def _softmax_grad(Xa, B, Yoh, n, obs_w=None, off=None):
    """(q, C) gradient of the mean NLL at B: Xa'(w o (softmax - Y))/n
    (``obs_w`` = normalized observation weights, ``off`` = (n, C)
    fixed linear-predictor offset, either None)."""
    eta = dot(Xa, B)
    if off is not None:
        eta = eta + off
    g = jax.nn.softmax(eta, axis=1) - Yoh
    if obs_w is not None:
        g = obs_w[:, None] * g
    return dot(Xa.T, g) / n


def _mn_ops(Xa, Yoh, n, q, C, pen_mask, alpha, grouped, newton_steps,
            fixed_minv, obs_w=None, keep=None, off=None):
    """``pen_mask`` (q,) carries 0 on the intercept row and the
    per-row penalty factors on the slopes (glmnet's ``penalty.factor``
    for family='multinomial' rides the existing mask); ``keep``:
    optional (q,) 0/1 mask zeroing EXCLUDED rows after the prox
    (glmnet's ``exclude`` — exact for both the l1 and the grouped
    row-norm penalty, all row-separable)."""
    from ..core.engine import ProblemOps

    mask = pen_mask[:, None]  # (q, 1): 0 on the intercept row

    def next_x(st):
        v = st.z - st.y / st.rho

        def step(_, B):
            grad = (_softmax_grad(Xa, B, Yoh, n, obs_w, off)
                    + st.rho * (B - v))
            return B - dot(fixed_minv, grad)

        return lax.fori_loop(0, newton_steps, step, st.x)

    def next_z(st, x_new):
        v = x_new + st.y / st.rho
        pen = st.lam / st.rho * mask
        if grouped:
            rn = jnp.sqrt(jnp.sum(v * v, axis=1, keepdims=True))
            z = v * jnp.maximum(0.0, 1.0 - pen / jnp.maximum(rn, 1e-30))
        else:
            zl1 = soft_threshold(v, alpha * pen)
            z = zl1 / (1.0 + pen * (1.0 - alpha))
        if keep is not None:
            z = z * keep[:, None]
        return z, st.aux

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.x),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=q * C, dim_dual=q * C,
    )


def _mn_engine(Xa, Yoh, lam_first, rho0, pen_mask, alpha, grouped,
               newton_steps, obs_w=None, keep=None, off=None):
    """Engine triple (cold state, solver, reported iterate) — shared by
    the path driver and the checkpointed driver.

    Fixed majorizer: softmax curvature bound 1/2 (PSD order), shared
    across classes.  Auto-rho = 1/(4C) — the PER-CLASS curvature scale
    (pi(1-pi) at near-uniform probabilities ~ 1/C, and the binomial
    C=1 case recovers the measured 1/4 of DESIGN.md "GLM rho").
    Iteration-count sweep (2000x200 C=5, 30 lambdas): the
    iteration minimum sits at rho ~ 0.05 = 1/(4*5) — 7x fewer
    iterations than the earlier rho = 1/2 guess — and at rho ~ 0.1 =
    1/(4*3) on a 400x12 C=3 problem, with sklearn-saga agreement
    unchanged at every point."""
    n, q = Xa.shape
    C = Yoh.shape[1]
    dtype = Xa.dtype
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.asarray(1.0 / (4.0 * C), dtype))
    Xw = Xa if obs_w is None else Xa * jnp.sqrt(obs_w)[:, None]
    H_fix = dot(Xw.T, Xw) / (2.0 * n)
    Minv = ridge_inverse(H_fix, rho)
    ops = _mn_ops(Xa, Yoh, n, q, C, pen_mask, alpha, grouped,
                  newton_steps, Minv, obs_w, keep, off)
    solve = make_admm_solver(ops, adapt_rho=False)
    zeros = jnp.zeros((q, C), dtype)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, dtype=dtype)
    return st0, solve, (lambda st: st.z)


@partial(jax.jit, static_argnames=("nclass", "standardize_x",
                                   "intercept", "nlambda", "path_mode",
                                   "grouped", "newton_steps",
                                   "trace_len"))
def _mn_path(X, y, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
             eps_abs, eps_rel, alpha, weights=None, pf=None, keep_p=None,
             off=None, *, nclass, standardize_x, intercept, path_mode,
             grouped, newton_steps, trace_len=None):
    from .glm import prep_design

    n, p = X.shape
    C = nclass
    dtype = X.dtype
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))  # glmnet: weights sum to n
    Yoh = jax.nn.one_hot(y.astype(jnp.int32), C, dtype=dtype)
    Xa, pen_mask, mean_x, sd_x = prep_design(X, standardize_x, intercept,
                                             weights=w)
    Xs = Xa[:, 1:] if intercept else Xa
    q = Xa.shape[1]
    keep = None
    if pf is not None or keep_p is not None:
        one1 = jnp.ones((1,), dtype)
        if pf is not None:
            pfq = jnp.concatenate([one1, pf]) if intercept else pf
            pen_mask = pen_mask * pfq
        if keep_p is not None:
            keep = (jnp.concatenate([one1, keep_p]) if intercept
                    else keep_p)

    # glmnet lambda_max: the (weighted) null model's score.  Null
    # probabilities = (weighted) class frequencies (the intercept-only
    # optimum) or uniform; with an OFFSET the null intercepts solve the
    # offset-shifted score by majorize-minimize steps (softmax
    # curvature bound 1/2 -> step 2/n on the summed gradient; 100
    # steps is far past convergence for a C-vector).
    if off is None:
        if intercept:
            pi0 = (jnp.mean(Yoh, axis=0) if w is None
                   else jnp.sum(w[:, None] * Yoh, axis=0) / n)
        else:
            pi0 = jnp.full((C,), 1.0 / C, dtype)
        P0 = jnp.broadcast_to(pi0[None, :], (n, C))
    else:
        if intercept:
            def b0_step(_, b0):
                g = jax.nn.softmax(b0[None, :] + off, axis=1) - Yoh
                if w is not None:
                    g = w[:, None] * g
                return b0 - (2.0 / n) * jnp.sum(g, axis=0)

            b0 = jax.lax.fori_loop(0, 100, b0_step,
                                   jnp.zeros((C,), dtype))
            P0 = jax.nn.softmax(b0[None, :] + off, axis=1)
        else:
            P0 = jax.nn.softmax(off, axis=1)
    G0 = P0 - Yoh
    if w is not None:
        G0 = w[:, None] * G0
    G0 = dot(Xs.T, G0) / n  # (p, C)
    if grouped:
        # 1.001 nudge past the exact row-norm boundary: the l2 group
        # prox (unlike the soft-threshold) only reaches exact zero when
        # the threshold strictly exceeds the row norm, so the marginal
        # row would otherwise hover at ~eps instead of 0 at the top.
        scores = jnp.sqrt(jnp.sum(G0 * G0, axis=1))
    else:
        scores = jnp.max(jnp.abs(G0), axis=1)
    if keep_p is not None:
        scores = scores * keep_p
    if pf is not None:
        # Factor-aware boundary over PENALIZED rows (the gaussian/GLM
        # paths' rule).
        scores = jnp.where(pf > 0, scores / jnp.maximum(pf, 1e-12), 0.0)
    lam0 = jnp.max(scores)
    lam0 = (1.001 * lam0 if grouped
            else lam0 / jnp.maximum(alpha, 1e-3))
    if user_lams is None:
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams

    st0, solve, report = _mn_engine(Xa, Yoh, lams[0], rho0, pen_mask,
                                    alpha, grouped, newton_steps,
                                    obs_w=w, keep=keep, off=off)

    if path_mode == "batch":
        k = lams.shape[0]
        bc = lambda a: jnp.broadcast_to(a, (k,) + a.shape).astype(dtype)
        st = ADMMState(
            x=bc(st0.x), z=bc(st0.z), y=bc(st0.y),
            adj_z=bc(st0.adj_z), adj_y=bc(st0.adj_y), aux=None,
            adj_a=jnp.ones((k,), dtype),
            adj_c=9999.0 * jnp.ones((k,), dtype),
            rho=jnp.broadcast_to(st0.rho, (k,)).astype(dtype),
            lam=jnp.asarray(lams, dtype),
            eps_pri=jnp.zeros((k,), dtype),
            eps_dua=jnp.zeros((k,), dtype),
            r_pri=9999.0 * jnp.ones((k,), dtype),
            r_dua=9999.0 * jnp.ones((k,), dtype),
            it=jnp.zeros((k,), jnp.int32),
            done=jnp.zeros((k,), bool),
        )
        st = make_batched_solver(solve)(st, maxit, eps_abs, eps_rel)
        coefs_a, niter, traces = st.z, st.it, None
    else:
        from .lasso import _scan_path

        _, coefs_a, niter, traces = _scan_path(st0, solve, report,
                                               lams, maxit, eps_abs,
                                               eps_rel, trace_len)

    beta0, coef = mn_recover(coefs_a, sd_x, mean_x, C, intercept)
    return MNPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter, trace=traces)


def mn_recover(coefs_a, sd_x, mean_x, C, intercept):
    """Original-scale recovery for the softmax coefficient block, with
    the intercepts sum-to-zero normalized (the softmax shift gauge) —
    SHARED by the serial path, the checkpointed driver and the
    consensus driver so the three agree bit for bit."""
    dtype = coefs_a.dtype
    if intercept:
        b0_std, slopes_std = coefs_a[:, 0, :], coefs_a[:, 1:, :]
    else:
        b0_std = jnp.zeros((coefs_a.shape[0], C), dtype)
        slopes_std = coefs_a
    coef = slopes_std / sd_x[None, :, None]
    beta0 = b0_std - jnp.einsum("kpc,p->kc", coef, mean_x)
    beta0 = beta0 - jnp.mean(beta0, axis=1, keepdims=True)
    return beta0, coef


def multinomial_lasso_path(X, y, *, nclass: Optional[int] = None,
                           lambdas: Optional[jnp.ndarray] = None,
                           nlambda: int = 50,
                           lambda_min_ratio: float = 1e-2,
                           alpha: float = 1.0, grouped: bool = False,
                           standardize: bool = True,
                           intercept: bool = True, maxit: int = 10000,
                           eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                           rho: float = -1.0, path_mode: str = "batch",
                           newton_steps: int = 2,
                           trace_len: Optional[int] = None,
                           data_mesh=None,
                           weights: Optional[jnp.ndarray] = None,
                           penalty_factor: Optional[jnp.ndarray] = None,
                           exclude=None,
                           offset: Optional[jnp.ndarray] = None,
                           dtype=jnp.float32) -> MNPathResult:
    """Solve the sparse multinomial (softmax) regression lambda path.

    ``y``: integer class labels in ``[0, C)``; ``nclass`` defaults to
    ``max(y) + 1``.  ``grouped=True`` uses the row-wise group penalty
    (glmnet's ``type.multinomial="grouped"``: one shared support across
    classes); the default penalizes every coefficient independently
    with the elastic-net mix ``alpha``.  ``weights`` are glmnet-style
    observation weights (weighted NLL, majorizer, standardization and
    grid; integer weight k == repeating the row k times, tested).
    Oracle: sklearn saga (tests/test_multinomial.py).

    ``penalty_factor`` (glmnet's ``penalty.factor``): (p,) nonnegative
    per-VARIABLE factors, rescaled to sum p — variable j's threshold
    becomes ``lambda * pf_j`` across all classes (both penalty types),
    with the factor-aware grid top.  ``exclude`` forces variables out
    of the model for every class (mask-after-shrink, exact for both
    penalties).  ``offset`` (glmnet's multinomial offset): an (n, C)
    fixed term in the linear predictor; the auto grid's null
    intercepts solve the offset-shifted score.
    """
    X = jnp.asarray(X, dtype)
    y_np = jnp.asarray(y).ravel()
    if nclass is None:
        import numpy as np

        nclass = int(np.asarray(y_np).max()) + 1
    if nclass < 2:
        raise ValueError("need at least 2 classes")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
    lams = (None if lambdas is None
            else jnp.sort(jnp.asarray(lambdas, dtype))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    from .lasso import validate_pf_limits
    from .multitask import _keep_mask

    pf, _ = validate_pf_limits(penalty_factor, None, None, None,
                               X.shape[1], dtype)
    keep_p = _keep_mask(exclude, X.shape[1], dtype)
    off = None
    if offset is not None:
        off = jnp.asarray(offset, dtype)
        if off.shape != (X.shape[0], int(nclass)):
            raise ValueError("offset must be (n, nclass)")
    return _mn_path(X, y_np, int(nlambda), lambda_min_ratio, lams, rho,
                    maxit, eps_abs, eps_rel, alpha, w, pf, keep_p, off,
                    nclass=int(nclass),
                    standardize_x=standardize, intercept=intercept,
                    path_mode=path_mode, grouped=bool(grouped),
                    newton_steps=int(newton_steps),
                    trace_len=trace_len)
