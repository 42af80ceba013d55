"""Equality-CONSTRAINED Lasso: ``min 1/(2n)||y - Xb||^2 + lam ||b||_1
s.t. C b = d``.

Extension beyond the reference: the constrained lasso (Gaines, Kim &
Zhou 2018, JCGS; James et al. 2020) — linear equality constraints on
the coefficients, whose flagship case is the ZERO-SUM lasso
(``sum_j b_j = 0``) for compositional/log-ratio data (microbiome,
portfolio weights).  ADMM handles the constraint exactly where
coordinate descent cannot: the splitting is the tall Lasso's
(``f = quadratic + affine indicator``, ``g = lam||z||_1``, b - z = 0)
and the x-update is an equality-constrained ridge solve by BLOCK
ELIMINATION on the KKT system::

    [X'X + rho I  C'] [b ]   [X'y + rho(z - u)]
    [C            0 ] [nu] = [d               ]

with both cached inverses SPD — ``M = (X'X + rho I)^{-1}`` and the
m x m dual Schur complement ``(C M C')^{-1}`` — so each iteration is
two p x p matvecs plus an m-dimensional correction (the one-time-
explicit-inverse pattern of the tall Lasso, reference:
src/ADMMLassoTall.h:70-80); accelerated FADMM with fixed rho.

Constraints live in ORIGINAL coordinates, so (as for the generalized
Lasso) there is no ``standardize`` option; ``intercept=True``
mean-centers X and y (centering preserves C's meaning on the slopes).

Oracles: KKT certificates with the dual multiplier recovered by least
squares, the exact ``C = e_j`` == drop-column reduction, and the
lam -> 0 limit against a direct numpy equality-constrained LS solve
(tests/test_conlasso.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.engine import (make_batched_solver, make_fadmm_solver,
                           make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import chol_inverse, dot, gram
from .lasso import PathResult, _batched_cold_states, _scan_path


def _conlasso_ops(Minv, Xty, C, Sinv, d, p):
    """x-update by block elimination: b = M r - M C' nu with
    nu = Sinv (C M r - d), r = X'y + rho(z - u)."""
    MCt = dot(Minv, C.T)          # (p, m) cached

    def next_x(st):
        r = Xty + st.rho * st.adj_z - st.adj_y
        Mr = dot(Minv, r)
        nu = dot(Sinv, dot(C, Mr) - d)
        return Mr - dot(MCt, nu)

    def next_z(st, x_new):
        v = x_new + st.adj_y / st.rho
        return soft_threshold(v, st.lam / st.rho), None

    from ..core.engine import ProblemOps

    return ProblemOps(
        next_x=next_x,
        next_z=next_z,
        primal_residual=lambda st, x, z, aux: x - z,
        eps_primal_scale=lambda st: jnp.maximum(l2norm(st.x),
                                                l2norm(st.z)),
        eps_dual_scale=lambda st: l2norm(st.y),
        dual_residual=lambda st, z_new: st.rho * l2norm(z_new - st.z),
        combined_extra=lambda st, z_new: sqnorm(z_new - st.adj_z),
        dim_main=p, dim_dual=p,
    )


def _conlasso_setup(Xs, ys, C, d, lam_first, rho0):
    dtype = Xs.dtype
    Xty = dot(Xs.T, ys)
    XtX = gram(Xs)
    from ..linalg import spectral_radius_sym

    sprad = spectral_radius_sym(XtX)
    # Tall-Lasso auto-rho power law (reference: src/ADMMLassoTall.h:
    # 194-202).
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.cbrt(sprad) * lam_first ** (2.0 / 3.0))
    jit = 1e-6 if dtype == jnp.float32 else 0.0
    Minv = chol_inverse(XtX + rho * jnp.eye(Xs.shape[1], dtype=dtype),
                        jitter=jit)
    # Dual Schur complement C M C' (SPD when C has full row rank).
    Sinv = chol_inverse(dot(C, dot(Minv, C.T)), jitter=jit)
    return Minv, Sinv, Xty, rho


def _conlasso_engine(Xs, ys, C, d, lam_first, rho0):
    p = Xs.shape[1]
    dtype = Xs.dtype
    Minv, Sinv, Xty, rho = _conlasso_setup(Xs, ys, C, d, lam_first, rho0)
    ops = _conlasso_ops(Minv, Xty, C, Sinv, d, p)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    zp = jnp.zeros((p,), dtype)
    st0 = make_state(zp, zp, zp, rho, lam_first, dtype=dtype)
    # Report the SUPPORT of z (exact zeros — the package-wide sparsity
    # contract that Df/nonzero accessors rely on) with VALUES from x
    # (the constraint-feasible iterate): the zeroed entries are
    # O(solver tolerance), so C b = d holds to tolerance at finite eps
    # and exactly in the eps -> 0 limit.
    return st0, solve, (lambda st: jnp.where(st.z != 0, st.x, 0.0))


@partial(jax.jit, static_argnames=("nlambda", "intercept", "path_mode",
                                   "trace_len"))
def _conlasso_path_dev(X, y, C, d, nlambda, lambda_min_ratio, user_lams,
                       rho0, maxit, eps_abs, eps_rel, weights=None, *,
                       intercept, path_mode, trace_len=None):
    n, p = X.shape
    dtype = X.dtype
    # Shared with the generalized Lasso: constraints/penalties live in
    # ORIGINAL coordinates, so center (meaning-preserving) but never
    # rescale columns (models/genlasso.py::center_weight).
    from .genlasso import center_weight

    Xs, ys, mean_x, mean_y = center_weight(X, y, weights, intercept)

    if user_lams is None:
        # Grid top: b = 0 is optimal (when d = 0 makes it feasible) iff
        # exists nu with ||X'y/n - C'nu||_inf <= lam.  The least-squares
        # nu gives a FEASIBLE certificate, hence an upper bound on the
        # exact threshold — a safe grid top (the genlasso heuristic).
        g = dot(Xs.T, ys)
        nu_ls = dot(chol_inverse(
            gram(C.T), jitter=1e-6 if dtype == jnp.float32 else 1e-12),
            dot(C, g))
        lam0 = jnp.max(jnp.abs(g - dot(C.T, nu_ls))) / n
        lam0 = jnp.where(jnp.isfinite(lam0) & (lam0 > 0), lam0,
                         jnp.max(jnp.abs(g)) / n)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams
    ilams = lams * n

    if path_mode == "batch":
        Minv, Sinv, Xty, rho = _conlasso_setup(Xs, ys, C, d, ilams[0],
                                               rho0)
        ops = _conlasso_ops(Minv, Xty, C, Sinv, d, p)
        solve = make_batched_solver(make_fadmm_solver(ops,
                                                      adapt_rho=False))
        st = _batched_cold_states(ilams.shape[0], p, rho, ilams, dtype)
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs = jnp.where(st.z != 0, st.x, 0.0)
        niter, traces = st.it, None
    else:
        st0, solve, report = _conlasso_engine(Xs, ys, C, d, ilams[0],
                                              rho0)
        _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                             maxit, eps_abs, eps_rel,
                                             trace_len)
    beta0 = mean_y - coefs @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coefs,
                      niter=niter, trace=traces)


def constrained_lasso_path(X, y, C, d=None, *,
                           lambdas: Optional[jnp.ndarray] = None,
                           nlambda: int = 50,
                           lambda_min_ratio: float = 1e-3,
                           intercept: bool = True, maxit: int = 10000,
                           eps_abs: float = 1e-5, eps_rel: float = 1e-5,
                           rho: float = -1.0, path_mode: str = "batch",
                           trace_len: Optional[int] = None,
                           weights: Optional[jnp.ndarray] = None,
                           dtype=jnp.float32) -> PathResult:
    """Solve the equality-constrained Lasso path on device.

    ``C`` is the (m, p) constraint matrix (full row rank), ``d`` the
    (m,) right-hand side (default 0).  The returned coefficients carry
    EXACT zeros (the prox iterate's support, as every family here) with
    the constraint-feasible x values on the support, so ``C b = d``
    holds to solver tolerance at every path point (exactly as
    eps -> 0; tighten ``eps_abs``/``eps_rel`` to tighten it).  ``weights``/`path_mode``/``trace_len`` as in the
    generalized Lasso; ``intercept`` mean-centers (constraints keep
    their meaning on the slopes)."""
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    C = jnp.atleast_2d(jnp.asarray(C, dtype))
    if C.shape[1] != X.shape[1]:
        raise ValueError("C must be (m, ncol(x))")
    if C.shape[0] >= X.shape[1]:
        raise ValueError("need fewer constraints than coefficients")
    d = (jnp.zeros((C.shape[0],), dtype) if d is None
         else jnp.asarray(d, dtype).ravel())
    if d.shape != (C.shape[0],):
        raise ValueError("d must have one entry per constraint row")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if trace_len is not None:
        path_mode = "scan"
        trace_len = int(trace_len)
    lams = (None if lambdas is None
            else jnp.sort(jnp.atleast_1d(
                jnp.asarray(lambdas, dtype)))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    return _conlasso_path_dev(X, y, C, d, int(nlambda),
                              lambda_min_ratio, lams, rho, maxit,
                              eps_abs, eps_rel, w, intercept=intercept,
                              path_mode=path_mode, trace_len=trace_len)


def zerosum_lasso_path(X, y, **kw) -> PathResult:
    """The ZERO-SUM lasso (``sum_j b_j = 0``): the constrained lasso
    for compositional / log-ratio designs, where predictions are
    invariant to per-sample rescaling of the raw composition."""
    p = np.asarray(X).shape[1]
    return constrained_lasso_path(X, y, np.ones((1, p)), **kw)


@partial(jax.jit, static_argnames=("intercept",))
def _conlasso_fold_etas(X, y, C, d, lams, masks, fid, rho, maxit,
                        eps_abs, eps_rel, *, intercept):
    """Jitted core of the constrained-lasso one-pass fold sweep."""
    def one(mask):
        res = _conlasso_path_dev(X, y, C, d, 2, 1e-3, lams, rho, maxit,
                                 eps_abs, eps_rel, mask,
                                 intercept=intercept,
                                 path_mode="batch")
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]
