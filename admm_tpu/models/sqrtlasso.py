"""Square-root LASSO: ``min ||y - X b||_2 / sqrt(n) + lam ||b||_1``.

Extension beyond the reference: the PIVOTAL lasso of Belloni,
Chernozhukov & Wang (2011) — replacing the squared loss by its square
root makes the optimal lam independent of the noise level sigma (the
lasso's lam must scale with sigma, which is unknown), so a single
universal grid tunes every noise regime.  Two properties fall out and
are tested: scale EQUIVARIANCE (``bhat(c y) = c bhat(y)`` at fixed
lam — false for the lasso) and an EXACT reduction to the lasso at the
data-dependent penalty ``lam_lasso = lam * ||rhat|| / sqrt(n)``
(matching KKT systems), which is the self-oracle.

Two solvers, both on the shared engines:

* **concomitant** (default) — the scaled-lasso alternation of Sun &
  Zhang (2012), via Huber's concomitant formulation::

      ||y - X b|| / sqrt(n)  =  min_{sigma>0}  ||y - X b||^2 / (2 n sigma)
                                               + sigma / 2

  Alternate (a) a WARM-STARTED lasso solve on the cached tall engine
  at penalty ``lam * sigma`` (one ridge inverse for the whole path,
  iterations are p x p matvecs — the cached-solve pattern of
  reference: src/ADMMLassoTall.h:70-80) with (b) the closed-form
  ``sigma = ||y - X b|| / sqrt(n)``.  The fixed point IS the
  sqrt-lasso KKT system (b solves the lasso at ``lam * sigma`` with
  sigma the residual scale — exactly the lasso-reduction oracle), and
  each outer step after the first re-enters an almost-converged
  solver.  Chosen over the stacked splitting by a race before the GPU
  port (DESIGN.md "sqrt-lasso algorithm race"); not yet measured on
  the H100.

* **stacked** (``algorithm="stacked"``; also the traced path) — one
  ADMM on the stacked splitting::

      A = [-X; I],  z = [r; w],  c = [-y; 0]
      f(b) = 0,     g(z) = ||r||_2 + lam_int ||w||_1

  (internal objective = user's times sqrt(n): ``lam_int = lam *
  sqrt(n)``); x-update by a cached ``(X'X + I)^{-1}``, z-update by
  BLOCK SHRINKAGE on r (the l2-norm prox) and soft threshold on w,
  accelerated FADMM with fixed rho.  Kept as the single-program
  cross-check: the nonsmooth norm couples the whole residual block and
  converges ~20x slower per unit work.

The exact null threshold ``lam0 = ||X'y||_inf / (sqrt(n) ||y||)`` tops
the auto grid for both.

Wide-regime caveat (p >= n): below a data-dependent threshold the
sqrt-lasso INTERPOLATES — the optimal residual is exactly zero (the
l2-norm loss's subgradient at 0 is the whole unit ball, so any
min-type interpolator with a dual certificate is optimal), sigma
collapses to its floor, and the solution set degenerates.  The
alternation still terminates (sigma fixed point at the floor), but
path points in that regime are interpolators whose identity depends
on the warm-start route; choose ``lambda_min_ratio`` (or explicit
lambdas) above the breakdown if a unique estimate matters.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.engine import (ProblemOps, make_admm_solver,
                           make_batched_solver, make_fadmm_solver,
                           make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..data.standardize import _guard, _sd_n
from ..linalg import chol_inverse, dot, gram
from .lasso import (PathResult, _batched_cold_states, _scan_path,
                    _tall_ops, _tall_setup, _wide_ops, _wide_setup)


def l2_prox(v, tau):
    """Prox of ``tau * ||.||_2`` (block shrinkage): shrink the norm by
    tau, zero inside the ball."""
    nv = jnp.sqrt(jnp.sum(v * v))
    scale = jnp.maximum(1.0 - tau / jnp.maximum(nv, 1e-30), 0.0)
    return scale * v


def _stacked_ops(Xs, ys, Minv, n, p, prox_r, prox_w) -> ProblemOps:
    """Generic stacked-splitting ops — ``A = [-X; I]``, ``z = [r; w]``,
    ``c = [-y; 0]``, ``f(b) = 0``, ``g(z) = loss(r) + penalty(w)`` —
    shared by the sqrt-lasso (l2-norm loss) and the penalized quantile
    regression (check loss, models/quantile.py).  z and the dual are
    single (n + p,) vectors: the residual block z[:n] and the
    coefficient block z[n:] (the engine's dual ascent adds rho * r
    elementwise, so the stacked representation is the natural one).

    ``prox_r(st, vr)`` / ``prox_w(st, vw)`` are the two block proxes at
    penalty parameter ``st.rho`` (they read st.lam / st.aux for their
    scales)."""
    def next_x(st):
        # argmin rho/2 || A b - z - c + y/rho ||^2 with A = [-X; I],
        # c = [-y; 0]: stationarity A'(A b - z - c + y/rho) = 0 gives
        # (X'X + I) b = X'(y - z_r + u_r/rho) + z_w - u_w/rho
        # (adj iterates: the FADMM engine extrapolates z and y).
        zr, zw = st.adj_z[:n], st.adj_z[n:]
        ur, uw = st.adj_y[:n], st.adj_y[n:]
        rhs = dot(Xs.T, ys - zr + ur / st.rho) + zw - uw / st.rho
        return dot(Minv, rhs)

    def next_z(st, x_new):
        Ax = dot(Xs, x_new)
        ur, uw = st.adj_y[:n], st.adj_y[n:]
        vr = ys - Ax + ur / st.rho          # prox target for r
        vw = x_new + uw / st.rho
        return jnp.concatenate([prox_r(st, vr), prox_w(st, vw)]), Ax

    def primal_residual(st, x, z, aux):
        # A x - z - c with A = [-X; I], c = [-y; 0]:
        return jnp.concatenate([ys - aux - z[:n], x - z[n:]])

    def eps_primal_scale(st):
        ax = jnp.sqrt(sqnorm(st.aux) + sqnorm(st.x))
        return jnp.maximum(jnp.maximum(ax, l2norm(st.z)), l2norm(ys))

    def eps_dual_scale(st):
        # A' y = -X' u_r + u_w  (a p-vector: the blocks ADD).
        return l2norm(st.y[n:] - dot(Xs.T, st.y[:n]))

    def dual_residual(st, z_new):
        # rho ||A' B dz|| with B = -I: A'B dz = X' dz_r - dz_w.
        dz = z_new - st.z
        return st.rho * l2norm(dot(Xs.T, dz[:n]) - dz[n:])

    def combined_extra(st, z_new):
        return sqnorm(z_new - st.adj_z)

    return ProblemOps(
        next_x=next_x, next_z=next_z,
        primal_residual=primal_residual,
        eps_primal_scale=eps_primal_scale,
        eps_dual_scale=eps_dual_scale,
        dual_residual=dual_residual,
        combined_extra=combined_extra,
        dim_main=p, dim_dual=n + p,
    )


def _sqrt_ops(Xs, ys, Minv, n, p) -> ProblemOps:
    """The sqrt-lasso's stacked ops: block shrinkage (the l2-norm prox)
    on the residual, soft threshold on the coefficients."""
    return _stacked_ops(
        Xs, ys, Minv, n, p,
        prox_r=lambda st, vr: l2_prox(vr, 1.0 / st.rho),
        prox_w=lambda st, vw: soft_threshold(vw, st.lam / st.rho))


def _sqrt_auto_rho(ys, n, dtype):
    """Auto-rho = sqrt(n)/||ys|| = 1/sigma_hat(y): the iterate path is
    then EQUIVARIANT under y-scaling (the solution itself is — module
    docstring — so any fixed rho breaks iteration-count invariance),
    and a 4-shape iteration-count sweep puts the optimum at c * sqrt(n)/||ys||
    with c in [0.3, 1.7] (DESIGN.md "sqrt-lasso rho"); c = 1."""
    return (jnp.sqrt(jnp.asarray(float(n), dtype))
            / jnp.maximum(l2norm(ys), 1e-30))


def _sqrt_engine(Xs, ys, lam_first, rho0):
    n, p = Xs.shape
    dtype = Xs.dtype
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    _sqrt_auto_rho(ys, n, dtype))
    Minv = chol_inverse(gram(Xs) + jnp.eye(p, dtype=dtype),
                        jitter=1e-7 if dtype == jnp.float32 else 0.0)
    ops = _sqrt_ops(Xs, ys, Minv, n, p)
    solve = make_fadmm_solver(ops, adapt_rho=False)
    zp = jnp.zeros((p,), dtype)
    znp = jnp.zeros((n + p,), dtype)
    st0 = make_state(zp, znp, znp, rho, lam_first,
                     aux=jnp.zeros((n,), dtype), dtype=dtype)
    # Report the soft-thresholded w block (exact zeros).
    return st0, solve, (lambda st: st.z[n:])


# ---------------------------------------------------------------------------
# Concomitant (scaled-lasso) alternation — the default, fast solver
# ---------------------------------------------------------------------------

_OUTER_MAXIT = 100  # sigma alternation cap (typical convergence: 3-8)


def _rearm_lanes(st, ilams, outer_done):
    """Re-arm batched lanes for the next sigma step: keep the iterates,
    rho and the ACCUMULATED iteration counter (maxit budgets the lane's
    TOTAL inner iterations); resync the momentum (warm_start's
    restart-pathology fix, core/engine.py:125-157) and reset the
    sentinels.  sigma-converged lanes stay done (frozen)."""
    dtype = st.rho.dtype
    k = st.rho.shape[0]
    ones = jnp.ones((k,), dtype)
    return st._replace(
        lam=ilams.astype(dtype), adj_z=st.z, adj_y=st.y,
        adj_a=ones, adj_c=9999.0 * ones,
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        done=outer_done,
    )


def _sqrt_inner_engine(Xs, ys, ilam0, rho0):
    """The concomitant alternation's INNER lasso engine, regime-
    dispatched exactly as the plain lasso (reference:
    src/Lasso.cpp:73-76): tall = cached-ridge FADMM at fixed rho
    (report z), wide = linearized plain ADMM with the adaptive ladder
    and the exact all-zero early exit (report x).  The wide lambda0
    early exit is EXACT for the sqrt problem too: at b = 0 the inner
    penalty is n*lam*sigma0 = lam*sqrt(n)*||ys||, which crosses
    lambda0 = ||X'y||_inf precisely at the sqrt-lasso's own null
    threshold.  Returns ``(solve, st0_maker, report, rho)`` with
    ``st0_maker(k_or_None, ilams)`` building cold state(s)."""
    n, p = Xs.shape
    dtype = Xs.dtype
    if n > p:
        Minv, Xty, rho = _tall_setup(Xs, ys, ilam0, rho0)
        ops = _tall_ops(Minv, Xty, 1.0, p)
        solve = make_fadmm_solver(ops, adapt_rho=False)

        def st0_maker(k, ilams):
            if k is None:
                zp = jnp.zeros((p,), dtype)
                return make_state(zp, zp, zp, rho, ilams, dtype=dtype)
            return _batched_cold_states(k, p, rho, ilams, dtype)

        return solve, st0_maker, (lambda st: st.z), rho
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilam0, rho0, 1.0, False)
    ops = _wide_ops(Xs, ys, sprad, lambda0, 1.0, n, p)
    solve = make_admm_solver(ops, adapt_rho=True)

    def st0_maker(k, ilams):
        if k is None:
            zn = jnp.zeros((n,), dtype)
            return make_state(jnp.zeros((p,), dtype), zn, zn, rho,
                              ilams, aux=zn, dtype=dtype)
        st = _batched_cold_states(k, p, 1.0, ilams, dtype, aux_dim=n)
        zn = jnp.zeros((k, n), dtype)
        return st._replace(rho=jnp.broadcast_to(rho, (k,)).astype(dtype),
                           z=zn, y=zn, adj_z=zn, adj_y=zn)

    return solve, st0_maker, (lambda st: st.x), rho


def _sqrt_concomitant_batch(Xs, ys, lams, rho0, maxit, eps_abs,
                            eps_rel):
    """All lambdas as cold-start batched lanes, each alternating warm
    inner lasso solves with its own sigma update.  The outer loop runs
    until every lane's sigma is a fixed point; converged lanes freeze
    exactly as in make_batched_solver."""
    n, p = Xs.shape
    dtype = Xs.dtype
    k = lams.shape[0]
    sqrt_n = jnp.sqrt(jnp.asarray(float(n), dtype))
    sigma0 = l2norm(ys) / sqrt_n
    # Inner lasso at sigma: 1/2||ys - Xs b||^2 + (n lam sigma)||b||_1.
    inner, st0_maker, report, _ = _sqrt_inner_engine(
        Xs, ys, n * lams[0] * sigma0, rho0)
    solve = make_batched_solver(inner)
    st = st0_maker(k, n * lams * sigma0)
    sigma = sigma0 * jnp.ones((k,), dtype)
    # Interpolation guard: sigma -> 0 would drive the penalty to 0.
    sig_floor = 1e-10 * sigma0
    ea = jnp.asarray(eps_abs, dtype)
    er = jnp.asarray(eps_rel, dtype)

    def cond(c):
        _, _, odone, oit = c
        return jnp.any(jnp.logical_not(odone)) & (oit < _OUTER_MAXIT)

    def body(c):
        st, sigma, odone, oit = c
        st = _rearm_lanes(st, n * lams * sigma, odone)
        st = solve(st, maxit, eps_abs, eps_rel)
        R = ys[None, :] - dot(report(st), Xs.T)
        sig_new = jnp.maximum(
            jnp.sqrt(jnp.sum(R * R, axis=1)) / sqrt_n, sig_floor)
        # sigma fixed point <=> the sqrt-lasso KKT system holds.
        conv = (jnp.abs(sig_new - sigma) <= er * sig_new + ea) \
            | (st.it >= maxit)
        sigma = jnp.where(odone, sigma, sig_new)
        return st, sigma, odone | conv, oit + 1

    st, _, _, _ = lax.while_loop(
        cond, body, (st, sigma, jnp.zeros((k,), bool),
                     jnp.asarray(0, jnp.int32)))
    return report(st), st.it


def _sqrt_concomitant_scan_setup(Xs, ys, lam_top, rho0):
    """Shared by the one-shot scan and the checkpointed driver:
    returns ``(carry0, make_step)`` where carry = (ADMMState, sigma)
    and ``make_step(maxit, eps_abs, eps_rel)`` is the per-lambda scan
    step advancing the warm-start chain."""
    n, p = Xs.shape
    dtype = Xs.dtype
    sqrt_n = jnp.sqrt(jnp.asarray(float(n), dtype))
    sigma0 = l2norm(ys) / sqrt_n
    solve, st0_maker, report, rho = _sqrt_inner_engine(
        Xs, ys, n * lam_top * sigma0, rho0)
    st0 = st0_maker(None, n * lam_top * sigma0)
    sig_floor = 1e-10 * sigma0

    def rearm1(st, ilam):
        return st._replace(
            lam=jnp.asarray(ilam, dtype), adj_z=st.z, adj_y=st.y,
            adj_a=jnp.asarray(1.0, dtype), adj_c=jnp.asarray(9999.0, dtype),
            eps_pri=jnp.asarray(0.0, dtype), eps_dua=jnp.asarray(0.0, dtype),
            r_pri=jnp.asarray(9999.0, dtype),
            r_dua=jnp.asarray(9999.0, dtype),
            done=jnp.asarray(False))

    def make_step(maxit, eps_abs, eps_rel):
        ea = jnp.asarray(eps_abs, dtype)
        er = jnp.asarray(eps_rel, dtype)

        def step(carry, lam):
            st, sigma = carry
            st = st._replace(it=jnp.asarray(0, jnp.int32))

            def ocond(c):
                _, _, odone, oit = c
                return jnp.logical_not(odone) & (oit < _OUTER_MAXIT)

            def obody(c):
                st, sigma, _, oit = c
                st = rearm1(st, n * lam * sigma)
                st = solve(st, maxit, eps_abs, eps_rel)
                r = ys - dot(Xs, report(st))
                sn = jnp.maximum(l2norm(r) / sqrt_n, sig_floor)
                conv = (jnp.abs(sn - sigma) <= er * sn + ea) \
                    | (st.it >= maxit)
                return st, sn, conv, oit + 1

            st, sigma, _, _ = lax.while_loop(
                ocond, obody,
                (st, sigma, jnp.asarray(False),
                 jnp.asarray(0, jnp.int32)))
            return (st, sigma), (report(st), st.it)

        return step

    return (st0, sigma0), make_step


def _sqrt_concomitant_scan(Xs, ys, lams, rho0, maxit, eps_abs,
                           eps_rel):
    """Sequential warm-started path: sigma AND the solver state carry
    across lambdas (the reference's path protocol,
    reference: src/Lasso.cpp:97-124); per-lambda niter is the total
    inner-iteration count over that lambda's sigma steps."""
    carry0, make_step = _sqrt_concomitant_scan_setup(Xs, ys, lams[0],
                                                     rho0)
    _, (coefs, niter) = lax.scan(make_step(maxit, eps_abs, eps_rel),
                                 carry0, lams)
    return coefs, niter


def _sqrt_prepare(X, y, weights, *, standardize_x, intercept):
    """Standardize/weight for the sqrt-lasso objective (shared by the
    path driver and the checkpointed driver): weighted moments, sd
    scaling, then sqrt(w) row scaling — the l2-norm loss becomes the
    WEIGHTED norm ``||diag(sqrt w)(y - Xb)||`` (integer weight k is
    exactly row repetition inside the squared sum — tested)."""
    n, p = X.shape
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
    mean_y = jnp.asarray(0.0, dtype)
    sd_x = jnp.ones((p,), dtype)
    Xs, ys = X, y
    if intercept:
        col_mean = wmean(X, axis=0)
        mean_y = wmean(y)
        Xs = X - col_mean[None, :]
        ys = y - mean_y
        mean_x = col_mean
    if standardize_x:
        c = X - wmean(X, axis=0)[None, :]
        sd_x = _guard(jnp.sqrt(jnp.sum(wcol[:, None] * c * c, axis=0)
                               / n), wmean(X, axis=0))
        Xs = Xs / sd_x[None, :]
    if w is not None:
        sw = jnp.sqrt(w)
        Xs = Xs * sw[:, None]
        ys = ys * sw
    return Xs, ys, sd_x, mean_x, mean_y


@partial(jax.jit, static_argnames=("nlambda", "standardize_x",
                                   "intercept", "path_mode",
                                   "trace_len", "algorithm"))
def _sqrt_path_dev(X, y, nlambda, lambda_min_ratio, user_lams, rho0,
                   maxit, eps_abs, eps_rel, weights=None, *,
                   standardize_x, intercept, path_mode, trace_len=None,
                   algorithm="concomitant"):
    n, p = X.shape
    dtype = X.dtype
    Xs, ys, sd_x, mean_x, mean_y = _sqrt_prepare(
        X, y, weights, standardize_x=standardize_x, intercept=intercept)

    if user_lams is None:
        # Exact null threshold: b = 0 optimal iff
        # ||X'y||_inf / (sqrt(n) ||y||) <= lam.
        # 1e-4 nudge: at the boundary equality one coefficient sits at
        # machine scale and the cold solve crawls (the SLOPE grid-top
        # pattern).
        lam0 = (jnp.max(jnp.abs(dot(Xs.T, ys)))
                / (jnp.sqrt(jnp.asarray(float(n), dtype)) * l2norm(ys))
                * (1.0 + 1e-4))
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams
    if algorithm == "concomitant" and trace_len is None:
        if path_mode == "batch":
            coefs, niter = _sqrt_concomitant_batch(
                Xs, ys, lams, rho0, maxit, eps_abs, eps_rel)
        else:
            coefs, niter = _sqrt_concomitant_scan(
                Xs, ys, lams, rho0, maxit, eps_abs, eps_rel)
        coef = coefs / sd_x[None, :]
        beta0 = mean_y - coef @ mean_x
        return PathResult(lambdas=lams, beta0=beta0, coef=coef,
                          niter=niter, trace=None)

    # Internal objective = user's * sqrt(n): lam_int = lam * sqrt(n).
    ilams = lams * jnp.sqrt(jnp.asarray(float(n), dtype))

    if path_mode == "batch":
        rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                        _sqrt_auto_rho(ys, n, dtype))
        Minv = chol_inverse(
            gram(Xs) + jnp.eye(p, dtype=dtype),
            jitter=1e-7 if dtype == jnp.float32 else 0.0)
        ops = _sqrt_ops(Xs, ys, Minv, n, p)
        solve = make_batched_solver(make_fadmm_solver(ops,
                                                      adapt_rho=False))
        from .lasso import _batched_cold_states

        k = ilams.shape[0]
        st = _batched_cold_states(k, p, rho, ilams, dtype, aux_dim=n)
        Znp = jnp.zeros((k, n + p), dtype)
        st = st._replace(z=Znp, y=Znp, adj_z=Znp, adj_y=Znp)
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs, niter, traces = st.z[:, n:], st.it, None
    else:
        st0, solve, report = _sqrt_engine(Xs, ys, ilams[0], rho0)
        _, coefs, niter, traces = _scan_path(st0, solve, report, ilams,
                                             maxit, eps_abs, eps_rel,
                                             trace_len)
    coef = coefs / sd_x[None, :]
    beta0 = mean_y - coef @ mean_x
    return PathResult(lambdas=lams, beta0=beta0, coef=coef,
                      niter=niter, trace=traces)


def sqrt_lasso_path(X, y, *, lambdas: Optional[jnp.ndarray] = None,
                    nlambda: int = 30, lambda_min_ratio: float = 1e-2,
                    standardize: bool = True, intercept: bool = True,
                    maxit: int = 10000, eps_abs: float = 1e-6,
                    eps_rel: float = 1e-6, rho: float = -1.0,
                    path_mode: str = "batch",
                    algorithm: str = "concomitant", data_mesh=None,
                    trace_len: Optional[int] = None, weights=None,
                    dtype=jnp.float32) -> PathResult:
    """Solve the square-root-lasso path on device.

    The penalty scale is PIVOTAL: lam does not depend on the noise
    level (Belloni et al. recommend ``lam ~ c * Phi^{-1}(1 - a/(2p)) /
    sqrt(n)``); the auto grid tops at the exact null threshold.
    Tolerances default tighter than the lasso's (the nonsmooth loss
    flattens near the optimum).

    ``algorithm``: "concomitant" (default — the scaled-lasso
    alternation; the inner lasso engine is regime-dispatched like the
    plain lasso: cached-ridge FADMM for n > p, linearized wide ADMM
    for p >= n; see the module docstring)
    or "stacked" (one ADMM on the stacked splitting; the cross-check
    solver, ~20x slower per unit work, and the solver a ``trace_len``
    request traces).  ``data_mesh``: a ``jax.sharding.Mesh`` over which
    the data is sharded along its ROW axis — the concomitant
    alternation's data-touching reductions (moments, the Gram, X'y,
    the residual-norm sigma update) become per-shard partials plus
    psums under XLA's partitioner, exactly the ``lasso_path``
    protocol."""
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if algorithm not in ("concomitant", "stacked"):
        raise ValueError("algorithm must be 'concomitant' or 'stacked'")
    if trace_len is not None:
        # The traced solver is the stacked single-program ADMM: its
        # per-iteration Boyd residuals are the meaningful trace (the
        # alternation's inner counters restart at every sigma step).
        path_mode = "scan"
        algorithm = "stacked"
        trace_len = int(trace_len)
    if data_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axes = tuple(data_mesh.axis_names)
        X = jax.device_put(X, NamedSharding(data_mesh,
                                            PartitionSpec(axes, None)))
        y = jax.device_put(y, NamedSharding(data_mesh,
                                            PartitionSpec(axes)))
    lams = (None if lambdas is None
            else jnp.sort(jnp.atleast_1d(
                jnp.asarray(lambdas, dtype)))[::-1])
    w = None if weights is None else jnp.asarray(weights, dtype)
    return _sqrt_path_dev(X, y, int(nlambda), lambda_min_ratio, lams,
                          rho, maxit, eps_abs, eps_rel, w,
                          standardize_x=standardize,
                          intercept=intercept, path_mode=path_mode,
                          trace_len=trace_len, algorithm=algorithm)


@partial(jax.jit, static_argnames=("standardize_x", "intercept"))
def _sqrt_fold_etas(X, y, lams, masks, fid, rho, maxit, eps_abs,
                    eps_rel, *, standardize_x, intercept):
    """Jitted core of the sqrt-lasso one-pass fold sweep (the cv.py
    _gaussian_fold_etas pattern): weight-0 held-out rows drop out of
    the weighted l2-norm loss exactly."""
    def one(mask):
        res = _sqrt_path_dev(X, y, 2, 1e-2, lams, rho, maxit, eps_abs,
                             eps_rel, mask, standardize_x=standardize_x,
                             intercept=intercept, path_mode="batch")
        return res.beta0[:, None] + dot(res.coef, X.T)

    etas = jax.vmap(one)(masks)
    return etas[fid, :, jnp.arange(fid.shape[0])]
