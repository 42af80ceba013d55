"""Multi-task (multi-response) Lasso: joint row sparsity across tasks.

Extension beyond the reference (single-response only): K responses share
one design matrix and one support ::

    minimize  1/(2n) ||Y - X B||_F^2 + lambda * sum_j ||B_j.||_2

with ``Y`` (n, K), ``B`` (p, K) and the l2/l1 mixed norm over COEFFICIENT
ROWS — a feature enters or leaves the model for ALL tasks at once
(sklearn's ``MultiTaskLasso`` objective, the exact oracle in
tests/test_multitask.py).

structure: the solver state is the (p, K) coefficient MATRIX
— every engine op is already matrix-shaped, so the tall x-update is one
``(p, p) x (p, K)`` matmul against the same cached ridge inverse the
single-response Lasso uses (reference: src/ADMMLassoTall.h:70-80), the
row prox is a row-norm broadcast, and the batched path mode stacks
lambdas as a leading lane axis of (k, p, K) states.  The wide regime is
the linearized engine with matrix iterates
(reference: src/ADMMLassoWide.h:129-165 with K columns at once).

Standardization: X follows the glmnet modes; Y columns are centered when
an intercept is fitted (one intercept per task) but NOT scaled — tasks
keep their native scales, as in sklearn (glmnet's family="mgaussian"
standardize.response=FALSE default).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.engine import (ADMMState, make_admm_solver,
                           make_batched_solver, make_fadmm_solver,
                           make_state)
from ..core.prox import l2norm, sqnorm
from ..linalg import dot, gram, spectral_radius_gram, spectral_radius_sym
from ..linalg import ridge_inverse


class MTPathResult(NamedTuple):
    """Multi-task lambda-path result (original data scale)."""
    lambdas: jnp.ndarray  # (nlambda,)
    beta0: jnp.ndarray    # (nlambda, K) per-task intercepts
    coef: jnp.ndarray     # (nlambda, p, K)
    niter: jnp.ndarray    # (nlambda,) int32
    # (nlambda, trace_len, 5) per-iteration residual trace when
    # requested (admm_tpu.diag.trace).
    trace: Optional[jnp.ndarray] = None


def _row_prox(v, t):
    """Row-wise group soft-threshold: z_j = (1 - t/||v_j||)_+ v_j."""
    rn = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v * jnp.maximum(0.0, 1.0 - t / jnp.maximum(rn, 1e-30))


def _row_prox_enet(v, t, alpha):
    """Elastic-net row prox (glmnet's mgaussian penalty
    ``alpha ||B_j||_2 + (1-alpha)/2 ||B_j||_2^2`` at step ``t``): group
    soft-threshold at ``alpha t`` then the ridge shrink — both terms
    are row-separable, so the composition is exact (the row analog of
    the gaussian enet prox, core/prox.py)."""
    return _row_prox(v, alpha * t) / (1.0 + t * (1.0 - alpha))


def _mt_coef_prox(v, t, pf, keep, alpha, penalty):
    """The multitask coefficient prox: row-separable group/enet
    shrinkage (``penalty="rows"``) or SINGULAR-VALUE THRESHOLDING
    (``penalty="nuclear"`` — the trace-norm prox of reduced-rank
    regression; rpca.py's svt on the (p, K) coefficient matrix).
    pf/keep/alpha are row concepts and validated away for nuclear."""
    if penalty == "nuclear":
        from .rpca import svt

        return svt(v, t)
    z = _row_prox_enet(v, t * pf[:, None] if pf is not None else t,
                       alpha)
    if keep is not None:
        z = z * keep[:, None]
    return z


def _mt_tall_ops(Minv, XtY, p, K, pf=None, keep=None, alpha=1.0,
                 penalty="rows"):
    """``pf``: optional (p,) per-row penalty factors (glmnet's
    ``penalty.factor`` for family='mgaussian' — the group threshold
    becomes ``lam * pf_j``); ``keep``: optional (p,) 0/1 mask zeroing
    EXCLUDED rows after the prox (glmnet's ``exclude`` — the prox of
    group penalty + indicator(B_j = 0) is exactly mask-after-shrink,
    both terms row-separable)."""
    from ..core.engine import ProblemOps

    def next_x(st):
        return dot(Minv, XtY - st.adj_y + st.rho * st.adj_z)

    def next_z(st, x_new):
        v = x_new + st.adj_y / st.rho
        z = _mt_coef_prox(v, st.lam / st.rho, pf, keep, alpha, penalty)
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
        dim_main=p * K, dim_dual=p * K,
    )


def _mt_wide_ops(Xs, Ys, sprad, lambda0, n, p, K, pf=None, keep=None,
                 alpha=1.0, penalty="rows"):
    from ..core.engine import ProblemOps

    sqrt_sprad = jnp.sqrt(sprad)

    def next_x(st):
        tmp = st.aux + st.z + st.y / st.rho
        v = st.x - dot(Xs.T, tmp) / sprad
        x_new = _mt_coef_prox(v, st.lam / (st.rho * sprad), pf, keep,
                              alpha, penalty)
        return jnp.where(st.lam > lambda0 * (1.0 - 1e-5),
                         jnp.zeros_like(x_new), x_new)

    def next_z(st, x_new):
        cache_Ax = dot(Xs, x_new)
        z = -(Ys + st.y + st.rho * cache_Ax) / (1.0 + st.rho)
        return z, cache_Ax

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: aux + z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.aux),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: sqrt_sprad * l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * sqrt_sprad
        * l2norm(z_new - st.z),
        combined_extra=None,
        dim_main=p * K, dim_dual=n * K,
    )


def _mt_lambda0(Xs, Ys, pf=None, keep=None, alpha=1.0,
                penalty="rows"):
    """B = 0 KKT boundary.  Rows: max_j ||X_j' Y||_2 / alpha (the
    row-norm analog of the Lasso's infinity-norm rule; only the l1
    part sets the boundary, with glmnet's max(alpha, 1e-3) cap); with
    penalty factors the factor-aware boundary over PENALIZED,
    non-excluded rows.  Nuclear: the SPECTRAL norm ||X'Y||_2 (the dual
    of the trace norm) — exact."""
    XtY = dot(Xs.T, Ys)
    if penalty == "nuclear":
        return jnp.linalg.svd(XtY, compute_uv=False)[0]
    rn = jnp.sqrt(jnp.sum(XtY * XtY, axis=1))
    if keep is not None:
        rn = rn * keep
    if pf is not None:
        rn = jnp.where(pf > 0, rn / jnp.maximum(pf, 1e-12), 0.0)
    return jnp.max(rn) / jnp.maximum(alpha, 1e-3)


def _mt_engine(Xs, Ys, ilam_first, rho0, pf=None, keep=None,
               alpha=1.0, penalty="rows"):
    """Engine triple (cold state, solver, reported iterate) — shared by
    the path driver and the checkpointed driver
    (admm_tpu.diag.checkpoint.checkpointed_multitask_lasso_path)."""
    n, p = Xs.shape
    K = Ys.shape[1]
    dtype = Xs.dtype
    if n > p:
        XtX = gram(Xs)
        sprad = spectral_radius_sym(XtX)
        rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                        jnp.cbrt(sprad) * ilam_first ** (2.0 / 3.0))
        Minv = ridge_inverse(XtX, rho)
        XtY = dot(Xs.T, Ys)
        ops = _mt_tall_ops(Minv, XtY, p, K, pf, keep, alpha, penalty)
        solve = make_fadmm_solver(ops, adapt_rho=False)
        zeros = jnp.zeros((p, K), dtype)
        st0 = make_state(zeros, zeros, zeros, rho, ilam_first,
                         dtype=dtype)
        return st0, solve, (lambda st: st.z)
    sprad = spectral_radius_gram(Xs)
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.cbrt(ilam_first / sprad))
    # All-zero early-exit gate: the factor-aware boundary when every
    # row is penalized, +inf (gate disabled) when any row is
    # unpenalized — B never becomes all-zero then (the gaussian wide
    # path's lambda0_pf rule).
    lambda0_int = _mt_lambda0(Xs, Ys, pf, keep, alpha, penalty)
    if pf is not None:
        lambda0_int = jnp.where(jnp.all(pf > 0), lambda0_int, jnp.inf)
    ops = _mt_wide_ops(Xs, Ys, sprad, lambda0_int, n, p, K, pf, keep,
                       alpha, penalty)
    solve = make_admm_solver(ops, adapt_rho=True)
    st0 = make_state(jnp.zeros((p, K), dtype),
                     jnp.zeros((n, K), dtype),
                     jnp.zeros((n, K), dtype), rho, ilam_first,
                     aux=jnp.zeros((n, K), dtype), dtype=dtype)
    return st0, solve, (lambda st: st.x)


def mt_standardize(X, Y, *, standardize_x, intercept, weights=None,
                   standardize_y=False):
    """Weighted centering/scaling for the multi-task design — SHARED by
    the serial path, the checkpointed driver and the consensus driver
    so the three agree bit for bit (the cox _cox_standardize pattern).
    Returns ``(Xs, Ys, sd_x, sd_y, mean_x, mean_y, w)`` with weights
    normalized to sum n and folded into the rows (sqrt(w) scaling)."""
    from ..data.standardize import _guard

    n, p = X.shape
    K = Y.shape[1]
    dtype = X.dtype
    w = None
    if weights is not None:
        w = jnp.asarray(weights, dtype).ravel()
        w = w * (n / jnp.sum(w))  # glmnet: weights sum to n
    wcol = jnp.ones((n,), dtype) if w is None else w

    def wmean(v, axis=None):
        ww = wcol if v.ndim == 1 else wcol[:, None]
        return jnp.sum(ww * v, axis=axis) / n

    mean_x = jnp.zeros((p,), dtype)
    sd_x = jnp.ones((p,), dtype)
    mean_y = jnp.zeros((K,), dtype)
    col_mean = wmean(X, axis=0)
    Xs = X
    if intercept:
        mean_y = wmean(Y, axis=0)
        Xs = X - col_mean[None, :]
        Ys = Y - mean_y[None, :]
        mean_x = col_mean
    else:
        Ys = Y
    if standardize_x:
        # glmnet 1/n sd (weighted centered two-pass) with the relative
        # zero-variance guard, as data/standardize.py.
        c = X - col_mean[None, :]
        sd_x = _guard(jnp.sqrt(jnp.sum(wcol[:, None] * c * c, axis=0)
                               / n), col_mean)
        Xs = Xs / sd_x[None, :]
    sd_y = jnp.ones((K,), dtype)
    if standardize_y:
        # glmnet's standardize.response=TRUE for family='mgaussian':
        # each task's response scaled to unit (weighted, 1/n) sd so the
        # shared row penalty weighs tasks equally; coefficients are
        # mapped back by mt_recover.
        cmy = wmean(Y, axis=0)
        cy = Y - cmy[None, :]
        sd_y = _guard(jnp.sqrt(jnp.sum(wcol[:, None] * cy * cy, axis=0)
                               / n), cmy)
        Ys = Ys / sd_y[None, :]
    if w is not None:
        # sqrt(w) row scaling: the quadratic loss becomes weighted and
        # everything downstream (Gram, lambda grid, solves) follows.
        sw = jnp.sqrt(w)
        Xs = Xs * sw[:, None]
        Ys = Ys * sw[:, None]
    return Xs, Ys, sd_x, sd_y, mean_x, mean_y, w


def mt_recover(coefs, sd_x, sd_y, mean_x, mean_y):
    """Original-scale (L, p, K) coefficients + per-task intercepts."""
    coef = coefs / sd_x[None, :, None] * sd_y[None, None, :]
    beta0 = mean_y[None, :] - jnp.einsum("kpt,p->kt", coef, mean_x)
    return beta0, coef


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "nlambda", "path_mode", "trace_len",
                                   "standardize_y", "penalty"))
def _mt_path(X, Y, nlambda, lambda_min_ratio, user_lams, rho0, maxit,
             eps_abs, eps_rel, weights=None, pf=None, keep=None,
             alpha=1.0, *,
             standardize_x, intercept, path_mode, trace_len=None,
             standardize_y=False, penalty="rows"):
    n, p = X.shape
    K = Y.shape[1]
    dtype = X.dtype
    Xs, Ys, sd_x, sd_y, mean_x, mean_y, w = mt_standardize(
        X, Y, standardize_x=standardize_x, intercept=intercept,
        weights=weights, standardize_y=standardize_y)

    lam0 = _mt_lambda0(Xs, Ys, pf, keep, alpha, penalty) / n
    if user_lams is None:
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams
    ilams = lams * n

    st0, solve, report = _mt_engine(Xs, Ys, ilams[0], rho0, pf, keep,
                                    alpha, penalty)

    if path_mode == "batch":
        k = ilams.shape[0]
        bsolve = make_batched_solver(solve)

        def bc(a):
            return jnp.broadcast_to(a, (k,) + a.shape).astype(dtype)

        st = ADMMState(
            x=bc(st0.x), z=bc(st0.z), y=bc(st0.y),
            adj_z=bc(st0.adj_z), adj_y=bc(st0.adj_y),
            aux=None if st0.aux is None else bc(st0.aux),
            adj_a=jnp.ones((k,), dtype),
            adj_c=9999.0 * jnp.ones((k,), dtype),
            rho=jnp.broadcast_to(st0.rho, (k,)).astype(dtype),
            lam=jnp.asarray(ilams, dtype),
            eps_pri=jnp.zeros((k,), dtype),
            eps_dua=jnp.zeros((k,), dtype),
            r_pri=9999.0 * jnp.ones((k,), dtype),
            r_dua=9999.0 * jnp.ones((k,), dtype),
            it=jnp.zeros((k,), jnp.int32),
            done=jnp.zeros((k,), bool),
        )
        st = bsolve(st, maxit, eps_abs, eps_rel)
        coefs, niter, traces = report(st), st.it, None
    else:
        from .lasso import _scan_path

        _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                             maxit, eps_abs, eps_rel,
                                             trace_len)

    beta0, coef = mt_recover(coefs, sd_x, sd_y, mean_x, mean_y)
    return MTPathResult(lambdas=lams, beta0=beta0, coef=coef,
                        niter=niter, trace=traces)


def multitask_lasso_path(X, Y, *, lambdas: Optional[jnp.ndarray] = None,
                         nlambda: int = 50,
                         lambda_min_ratio: float = 1e-2,
                         alpha: float = 1.0,
                         standardize: bool = True, intercept: bool = True,
                         standardize_response: bool = False,
                         maxit: int = 10000, eps_abs: float = 1e-5,
                         eps_rel: float = 1e-5, rho: float = -1.0,
                         path_mode: str = "batch",
                         trace_len: Optional[int] = None,
                         data_mesh=None,
                         weights: Optional[jnp.ndarray] = None,
                         penalty_factor: Optional[jnp.ndarray] = None,
                         exclude=None,
                         offset: Optional[jnp.ndarray] = None,
                         penalty: str = "rows",
                         dtype=jnp.float32) -> MTPathResult:
    """Solve the multi-task Lasso lambda path on device.

    ``Y`` is (n, K) — one column per task; coefficient rows are jointly
    penalized (``sum_j ||B_j.||_2``), so the support is shared across
    tasks.  ``path_mode``: "batch" (default, lambdas as lanes) or
    "scan" (warm-started sequential).  ``trace_len`` records the
    per-iteration residual trace (implies scan, as in the Lasso path);
    ``data_mesh`` row-shards X/Y for operator parallelism (the same
    pattern as ``lasso_path(data_mesh=...)``).  Oracle: sklearn
    ``MultiTaskLasso`` (tests/test_multitask.py); ``weights`` are
    glmnet-style observation weights (integer weight k == repeating the
    row k times, tested).

    ``penalty_factor`` (glmnet's ``penalty.factor`` for
    family='mgaussian'): (p,) nonnegative per-ROW factors, rescaled to
    sum p — row j's group threshold becomes ``lambda * pf_j`` (0 =
    always in), with the factor-aware grid top.  ``exclude`` forces
    whole coefficient rows out of the model (the prox of group penalty
    + row indicator is exactly mask-after-shrink).

    ``standardize_response`` (glmnet's ``standardize.response``,
    default FALSE as there): scale each task's response to unit sd
    before fitting so the shared row penalty weighs tasks equally;
    coefficients and intercepts are returned on the ORIGINAL response
    scales (pinned: invariant to per-task response rescaling when on).

    ``offset`` (glmnet's ``offset`` for family='mgaussian'): an (n, K)
    fixed term in the linear predictor — the gaussian loss makes it an
    exact response shift (``eta = b0 + X b + offset``); supply the
    same ``newoffset`` at prediction time.

    ``alpha`` (glmnet's elastic net for family='mgaussian'): row
    penalty ``lambda (alpha ||B_j||_2 + (1-alpha)/2 ||B_j||_2^2)`` —
    the exact compound row prox (group soft-threshold then ridge
    shrink) with the alpha-aware grid top.  Oracle: sklearn
    ``MultiTaskElasticNet`` (tests/test_multitask.py).

    ``penalty="nuclear"`` (extension — REDUCED-RANK regression, Yuan
    et al. 2007): swap the row penalty for the TRACE NORM
    ``lambda ||B||_*`` — the convex surrogate for rank(B), so tasks
    share a low-dimensional predictive subspace instead of a sparse
    support.  One prox swap: the z-update becomes singular-value
    thresholding of the (p, K) coefficient matrix (rpca.py's svt), and
    the exact grid top is the SPECTRAL norm ||X'Y||_2 (the trace
    norm's dual).  K=1 reduces exactly to the all-features single
    group lasso (a (p, 1) matrix's only singular value is ||b||_2 —
    tested); penalty_factor/exclude/alpha are row concepts and
    rejected.  See :func:`multitask_nuclear_path`.
    """
    if penalty not in ("rows", "nuclear"):
        raise ValueError("penalty must be 'rows' or 'nuclear'")
    if penalty == "nuclear" and (penalty_factor is not None
                                 or exclude is not None or alpha != 1.0):
        raise ValueError("penalty_factor/exclude/alpha are "
                         "row-separable concepts; the nuclear penalty "
                         "does not support them")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")
    X = jnp.asarray(X, dtype)
    Y = jnp.asarray(Y, dtype)
    if Y.ndim != 2:
        raise ValueError("Y must be (n, K) — use lasso_path for a "
                         "single response")
    if offset is not None:
        off = jnp.asarray(offset, dtype)
        if off.shape != Y.shape:
            raise ValueError("offset must match Y's (n, K) shape")
        Y = Y - off
    if X.shape[0] != Y.shape[0]:
        raise ValueError("nrow(x) should be equal to nrow(y)")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    if data_mesh is not None:
        from ..parallel.mesh import put_dim_sharded

        X = put_dim_sharded(X, data_mesh, 0)
        Y = put_dim_sharded(Y, data_mesh, 0)
    lams = (None if lambdas is None
            else jnp.sort(jnp.asarray(lambdas, dtype))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    from .lasso import validate_pf_limits

    pf, _ = validate_pf_limits(penalty_factor, None, None, None,
                               X.shape[1], dtype)
    keep = _keep_mask(exclude, X.shape[1], dtype)
    return _mt_path(X, Y, int(nlambda), lambda_min_ratio, lams, rho,
                    maxit, eps_abs, eps_rel, w, pf, keep, float(alpha),
                    standardize_x=standardize,
                    intercept=intercept, path_mode=path_mode,
                    trace_len=trace_len,
                    standardize_y=bool(standardize_response),
                    penalty=penalty)


def multitask_nuclear_path(X, Y, **kw) -> MTPathResult:
    """REDUCED-RANK (trace-norm) multi-task regression path::

        minimize  1/(2n) ||Y - X B||_F^2 + lambda ||B||_*

    — :func:`multitask_lasso_path` with ``penalty="nuclear"`` (see its
    docstring): the convex relaxation of rank-constrained multivariate
    regression, solved by an SVT prox swap on the same engines.
    Oracles: the K=1 == all-features group lasso reduction, the
    spectral-norm KKT subgradient certificate, and rank monotonicity
    along the path (tests/test_multitask.py)."""
    return multitask_lasso_path(X, Y, penalty="nuclear", **kw)


def _keep_mask(exclude, p, dtype):
    """(p,) 0/1 mask from glmnet's ``exclude`` indices (None if no
    exclusions) — the row-group analog of the lower=upper=0 box."""
    if exclude is None:
        return None
    idx = np.asarray(exclude, np.int64).ravel()
    if idx.size and (idx.min() < 0 or idx.max() >= p):
        raise ValueError("exclude indices must be in [0, p)")
    keep = np.ones(p)
    keep[idx] = 0.0
    return jnp.asarray(keep, dtype)
