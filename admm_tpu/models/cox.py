"""L1/elastic-net Cox proportional hazards paths (glmnet's
``family = "cox"``).

Extension beyond the reference (gaussian-only): right-censored survival
regression by the Breslow partial likelihood ::

    minimize  1/n [ - sum_{i: d_i = 1} (eta_i - log sum_{j in R_i} e^{eta_j}) ]
              + lambda (alpha ||b||_1 + (1 - alpha)/2 ||b||_2^2),
    eta = X b,   R_i = { j : t_j >= t_i }  (the risk set; Breslow ties)

No intercept — it is absorbed by the baseline hazard, exactly as in
glmnet's cox family.

No consensus (row-block) variant is offered DELIBERATELY: the partial
likelihood couples every row through the risk sets, so the objective
is not separable across row blocks — splitting it would silently
change the model (each block would see truncated risk sets).  Use
``data_mesh``-style sharding of the matvecs if the data outgrows a
device; the risk-set cumsums stay global.

Structure: rows are sorted by time DESCENDING once on the
host, after which every risk-set quantity is a CUMSUM —
``S_i = sum_{t_j >= t_i} e^{eta_j}`` is a prefix sum read at each tie
group's end, and the gradient's inner sum over events is a suffix sum
of ``d_k / S_k`` read at each tie group's start (two static gathers
from host-precomputed tie-group indices; no dynamic risk-set shapes
anywhere).  The partial-likelihood Hessian in eta is
``sum_k [diag(pi_k) - pi_k pi_k']`` over events — each term is a
softmax curvature bounded by I/2 — so the loss Hessian is dominated by
``(d / 2n) X'X`` with ``d`` the event count: the same FIXED-MAJORIZER
design as the other bounded families (DESIGN.md "GLM tier"), one
factorized (p, p) matrix per path, batched lambda lanes sharing it.

Oracle: an independent numpy Newton solver over explicit risk-set
loops (tests/test_cox.py), plus KKT subgradient checks and the
invariances (time monotone-transform, all-censored => zero fit).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.engine import (ADMMState, make_admm_solver,
                           make_batched_solver, make_state)
from ..core.prox import l2norm, soft_threshold, sqnorm
from ..linalg import dot, ridge_inverse


class CoxPathResult(NamedTuple):
    """Cox path result (original data scale; no intercept)."""
    lambdas: jnp.ndarray  # (nlambda,)
    coef: jnp.ndarray     # (nlambda, p)
    niter: jnp.ndarray    # (nlambda,) int32


def _tie_groups(times_sorted_desc: np.ndarray, strata_sorted=None):
    """Host precompute: for each sorted position i, the FIRST and LAST
    positions of its tie group (equal times — and, when stratified,
    the same stratum: ties never merge across a stratum boundary).
    Risk-set membership is ``t_j >= t_i``  <=>  ``pos(j) <= last[i]``
    in descending order (within the stratum block)."""
    n = times_sorted_desc.shape[0]
    first = np.zeros(n, np.int32)
    last = np.zeros(n, np.int32)
    i = 0
    while i < n:
        j = i
        while (j + 1 < n
               and times_sorted_desc[j + 1] == times_sorted_desc[i]
               and (strata_sorted is None
                    or strata_sorted[j + 1] == strata_sorted[i])):
            j += 1
        first[i:j + 1] = i
        last[i:j + 1] = j
        i = j + 1
    return jnp.asarray(first), jnp.asarray(last)


def _strata_prep(t_np, strata):
    """Host prep for the stratified sort (glmnet's ``stratifySurv``):
    returns (order, codes_sorted) with rows STRATUM-MAJOR and time
    DESCENDING within each stratum, plus the per-row stratum block
    edges (seg_first, seg_last) in sorted order."""
    s_np = np.asarray(strata).ravel()
    if s_np.shape != t_np.shape:
        raise ValueError("strata must have one entry per row")
    _, codes = np.unique(s_np, return_inverse=True)
    order = np.lexsort((-t_np, codes))
    ss = codes[order]
    n = ss.shape[0]
    seg_first = np.zeros(n, np.int32)
    seg_last = np.zeros(n, np.int32)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and ss[j + 1] == ss[i]:
            j += 1
        seg_first[i:j + 1] = i
        seg_last[i:j + 1] = j
        i = j + 1
    return order, ss, jnp.asarray(seg_first), jnp.asarray(seg_last)


def _startstop_prep(stops_sorted, starts_sorted):
    """Host prep for the START-STOP risk sets (rows already sorted
    stop-DESCENDING): the three static index arrays of
    ``_cox_grad_eta``'s ``ext`` —

    * ``perm_s``: the start-descending permutation (for the second
      prefix sum),
    * ``b_idx[i] = #{j: start_j >= stop_i}`` (rows not yet entered at
      t_i — subtracted from the risk-set sum),
    * ``sidx[i]`` = first stop-desc position k with
      ``stop_k <= start_i`` (events at or before row i's entry —
      subtracted from its event sum).
    """
    n = stops_sorted.shape[0]
    perm_s = np.argsort(-starts_sorted, kind="stable")
    asc = np.sort(starts_sorted)
    b_idx = n - np.searchsorted(asc, stops_sorted, side="left")
    sidx = np.searchsorted(-stops_sorted, -starts_sorted, side="left")
    return (jnp.asarray(perm_s.astype(np.int32)),
            jnp.asarray(b_idx.astype(np.int32)),
            jnp.asarray(sidx.astype(np.int32)))


def _startstop_prep_strata(stops_sorted, starts_sorted, ss):
    """The stratified start-stop indices (rows sorted stratum-major,
    stop-descending; ``ss`` = sorted stratum codes): every quantity of
    :func:`_startstop_prep` computed WITHIN each stratum block —
    ``perm_s`` stays stratum-major (so the second cumsum can be
    de-segmented by subtracting its value at the block start, read at
    ``seg_first``), ``b_idx`` is block-local + block offset, and
    ``sidx`` points past the block when no within-stratum event is at
    or before the row's entry."""
    n = stops_sorted.shape[0]
    perm_s = np.empty(n, np.int64)
    b_idx = np.empty(n, np.int64)
    sidx = np.empty(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and ss[j + 1] == ss[i]:
            j += 1
        sl = slice(i, j + 1)
        st_b, sp_b = starts_sorted[sl], stops_sorted[sl]
        perm_s[sl] = i + np.argsort(-st_b, kind="stable")
        asc = np.sort(st_b)
        b_idx[sl] = i + (st_b.size
                         - np.searchsorted(asc, sp_b, side="left"))
        sidx[sl] = i + np.searchsorted(-sp_b, -st_b, side="left")
        i = j + 1
    return (jnp.asarray(perm_s.astype(np.int32)),
            jnp.asarray(b_idx.astype(np.int32)),
            jnp.asarray(sidx.astype(np.int32)))


def _cox_risk_terms(eta, d, first, last, w=None, seg=None, ext=None):
    """The shared Breslow risk-set computation behind the gradient AND
    the adaptive majorizer (they must stay bit-identical for the MM
    step to bound the true curvature): returns ``(ee, dd, G)`` with
    ``ee = w e^eta``, ``dd = w d`` and ``G_i = sum over the events row
    i is at risk for of dd_k / S_k`` — plain, segmented (strata) or
    interval (start-stop) risk sets per ``seg``/``ext`` (see
    :func:`_cox_grad_eta`).

    Guard: for a dd>0 row the true S is >= its own term ee (the row is
    at risk at its own event time), so S is floored at ee elementwise —
    this also caps the f32 cancellation of the start-stop A - B
    difference (two large cumsums) which could otherwise drive a
    computed S to <= 0 and q to ~1e30."""
    ee = jnp.exp(jnp.minimum(eta, 30.0))
    dd = d
    if w is not None:
        ee = w * ee
        dd = w * d
    cs = jnp.cumsum(ee)
    if seg is None:
        S = cs[last]                         # risk-set sums, tie-aware
    else:
        cs0 = jnp.concatenate([jnp.zeros((1,), cs.dtype), cs])
        S = cs0[last + 1] - cs0[seg[0]]
    if ext is not None:
        cs_s = jnp.cumsum(ee[ext[0]])        # start-descending order
        cs_s0 = jnp.concatenate([jnp.zeros((1,), cs_s.dtype), cs_s])
        B = cs_s0[ext[1]]                    # not-yet-entered rows
        if seg is not None:
            # perm_s is stratum-major, so the block-local sum is the
            # cumsum minus its value at the block start.
            B = B - cs_s0[seg[0]]
        S = S - B
    q = jnp.where(dd > 0,
                  dd / jnp.maximum(S, jnp.maximum(ee, 1e-30)), 0.0)
    rc = jnp.cumsum(q[::-1])[::-1]           # suffix sum of w_k d_k/S_k
    rc0 = jnp.concatenate([rc, jnp.zeros((1,), rc.dtype)])
    if ext is not None:
        G = rc0[first] - rc0[ext[2]]         # events in (start_j, stop_j]
    elif seg is None:
        G = rc[first]
    else:
        G = rc0[first] - rc0[seg[1] + 1]
    return ee, dd, G


def _cox_grad_eta(eta, d, first, last, n, w=None, seg=None, ext=None):
    """Breslow partial-likelihood gradient in eta (sorted-desc order),
    scaled 1/n: ``(e^{eta_i} G_i - d_i)/n`` with
    ``G_i = sum_{events k: t_k <= t_i} d_k / S_k`` via one prefix and
    one suffix cumsum + two static tie-group gathers.

    ``w``: optional observation weights (glmnet's ``weights`` for
    family='cox' — case weights): the weighted Breslow likelihood
    ``sum_i w_i d_i [eta_i - log S_i]`` with ``S_i = sum_{t_j >= t_i}
    w_j e^{eta_j}`` — both the risk-set sums and the event terms carry
    w, so an integer weight k is exactly row repetition (tested).

    ``seg`` (STRATIFIED cox, glmnet's ``stratifySurv``): a
    ``(seg_first, seg_last)`` pair of (n,) index arrays marking each
    row's stratum block in the (stratum-major, time-descending) sort —
    the cumsums become SEGMENTED (risk sets never cross a stratum
    boundary) by subtracting the running sum at the block edge; the
    unstratified case is exactly ``seg=None`` (one block).

    ``ext`` (START-STOP / counting-process cox, glmnet's
    ``Surv(start, stop, event)``): a ``(perm_s, b_idx, sidx)`` triple
    of host-precomputed STATIC index arrays making the interval risk
    set ``R(t) = {j: start_j < t <= stop_j}`` two extra gathers:
    ``S(t_i) = A(t_i) - B(t_i)`` where A is the usual stop-descending
    prefix sum and ``B(t_i) = sum_{start_j >= t_i} w_j e^{eta_j}``
    reads a second cumsum (rows permuted start-descending by
    ``perm_s``) at ``b_idx[i]``; the gradient's event sum subtracts
    the events at or before each row's entry,
    ``G_j = C(stop_j) - C(start_j)`` with ``C(start_j)`` the suffix
    sum read at ``sidx[j]``.  Mutually exclusive with ``seg``."""
    ee, dd, G = _cox_risk_terms(eta, d, first, last, w, seg, ext)
    return (ee * G - dd) / n


def _cox_standardize(X, wc, n, standardize_x):
    """The cox prep's (weighted) centering + 1/n-sd scaling — shared
    by the jitted path and the checkpointed driver so the two agree
    bit for bit."""
    from ..data.standardize import _guard

    col_mean = jnp.sum(wc[:, None] * X, axis=0) / n
    Xs = X - col_mean[None, :]
    sd_x = jnp.ones((X.shape[1],), X.dtype)
    if standardize_x:
        c = X - col_mean[None, :]
        sd_x = _guard(jnp.sqrt(jnp.sum(wc[:, None] * c * c, axis=0)
                               / n), col_mean)
        Xs = Xs / sd_x[None, :]
    return Xs, sd_x


def _cox_majorizer_inv(b, Xs, d, first, last, n, rho, w=None, off=None,
                       seg=None, ext=None):
    """The per-lambda ADAPTIVE majorizer (factored out of _cox_path —
    docstring there): ridge_inverse of the tight diagonal bound
    ``X' diag(e^eta G) X / n`` at the iterate ``b``."""
    eta = dot(Xs, b)
    if off is not None:
        eta = eta + off
    ee, _, G = _cox_risk_terms(eta, d, first, last, w, seg, ext)
    wm = ee * G
    H = dot(Xs.T * wm[None, :], Xs) / n
    return ridge_inverse(H, rho)


def _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps,
             fixed_minv=None, pf=None, bounds=None, off=None, w=None,
             seg=None, ext=None):
    """``fixed_minv`` None => the ADAPTIVE majorizer: the (p, p)
    inverse rides ``st.aux`` and is refreshed once per lambda from the
    warm-start iterate (see _cox_path) — ``V_k <= diag(pi_k)`` gives
    the tight diagonal bound ``H <= X'diag(w)X/n`` with
    ``w_i = e^{eta_i} G_i`` (the gradient's positive part), ~100x
    tighter than the global d/2 bound on spread-out risk sets."""
    from ..core.engine import ProblemOps

    def next_x(st):
        v = st.z - st.y / st.rho
        Minv = fixed_minv if fixed_minv is not None else st.aux

        def step(_, b):
            eta = dot(Xs, b)
            if off is not None:
                eta = eta + off
            g = _cox_grad_eta(eta, d, first, last, n, w, seg, ext)
            grad = dot(Xs.T, g) + st.rho * (b - v)
            return b - dot(Minv, grad)

        return lax.fori_loop(0, newton_steps, step, st.x)

    def next_z(st, x_new):
        v = x_new + st.y / st.rho
        pen = st.lam / st.rho
        if pf is not None:
            pen = pen * pf
        zl1 = soft_threshold(v, alpha * pen)
        z = zl1 / (1.0 + pen * (1.0 - alpha))
        if bounds is not None:
            # glmnet's coefficient box: clip-after-shrink is the exact
            # prox of penalty + box (both separable).
            z = jnp.clip(z, bounds[0], bounds[1])
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
        dim_main=p, dim_dual=p,
    )


@partial(jax.jit, static_argnames=("standardize_x", "nlambda",
                                   "path_mode", "newton_steps"))
def _cox_path(X, d, first, last, nlambda, lambda_min_ratio, user_lams,
              rho0, maxit, eps_abs, eps_rel, alpha, pf=None, limits=None,
              w=None, off=None, seg=None, ext=None, *, standardize_x,
              path_mode, newton_steps):
    n, p = X.shape
    dtype = X.dtype
    if w is not None:
        w = w * (n / jnp.sum(w))   # glmnet: weights sum to n
    wc = jnp.ones((n,), dtype) if w is None else w
    d_total = jnp.sum(wc * d)
    # Center + optionally scale (no intercept: centering is free here —
    # the partial likelihood is invariant to column shifts, since a
    # shift adds a constant to every eta that cancels inside each
    # risk-set softmax — and it conditions the Gram).  Weighted moments
    # when case weights are given (glmnet convention).
    Xs, sd_x = _cox_standardize(X, wc, n, standardize_x)

    # Original-scale coefficient box -> standardized scale (coef_orig
    # = z / sd_x, so the box maps by sd_x; cox has no intercept row).
    bounds = None
    if limits is not None:
        bounds = (limits[0] * sd_x, limits[1] * sd_x)

    # Grid top: gradient of the null model (eta = offset, or 0).
    eta0 = jnp.zeros((n,), dtype) if off is None else off
    g0 = _cox_grad_eta(eta0, d, first, last, n, w, seg, ext)
    if user_lams is None:
        scores = jnp.abs(dot(Xs.T, g0))
        if pf is not None:
            # Factor-aware boundary over PENALIZED coordinates (the
            # gaussian/GLM paths' rule).
            scores = jnp.where(pf > 0,
                               scores / jnp.maximum(pf, 1e-12), 0.0)
        lam0 = jnp.max(scores) / jnp.maximum(alpha, 1e-3)
        lams = jnp.exp(jnp.linspace(
            jnp.log(lam0), jnp.log(lambda_min_ratio * lam0), nlambda))
    else:
        lams = user_lams

    # Auto-rho = 1/2, the per-event softmax curvature bound (the same
    # family-bound principle as binomial's measured 1/4; the cox sweep
    # over [0.125, 125] at 2000x200 has its minimum at 0.5 in both
    # protocols, and the small-problem sweep is flat).
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.asarray(0.5, dtype))

    def majorizer_inv(b):
        # Tight diagonal bound at the current iterate (see
        # _cox_majorizer_inv): V_k <= diag(pi_k) => H <= X'diag(wm)X/n
        # with wm = e^eta G, ~100x tighter than the global d/2 bound on
        # spread-out risk sets.
        return _cox_majorizer_inv(b, Xs, d, first, last, n, rho, w,
                                  off, seg, ext)

    zeros = jnp.zeros((p,), dtype)

    if path_mode == "batch":
        # Batch lanes share one GLOBAL-bound factorization (the lanes
        # hold different iterates, so a shared adaptive refresh has no
        # single anchor).  Measured: the warm-started adaptive scan
        # dominates for cox (DESIGN.md "cox protocol") — scan is the
        # shipped default.
        from .lasso import _batched_cold_states

        H_fix = (d_total / (2.0 * n)) * dot(Xs.T, Xs)
        Minv = ridge_inverse(H_fix, rho)
        ops = _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps,
                       Minv, pf, bounds, off, w, seg, ext)
        solve = make_batched_solver(make_admm_solver(ops,
                                                     adapt_rho=False))
        st = _batched_cold_states(lams.shape[0], p, rho, lams, dtype)
        st = solve(st, maxit, eps_abs, eps_rel)
        coefs_s, niter = st.z, st.it
    else:
        # Warm-started scan with the PER-LAMBDA adaptive majorizer:
        # the factorized inverse rides st.aux, refreshed at each
        # lambda's warm start (a valid local majorizer; the ADMM prox
        # term guards the inexact inner steps, and the independent
        # oracle/KKT tests certify the solutions).
        from ..core.engine import warm_start

        ops = _cox_ops(Xs, d, first, last, n, p, alpha, newton_steps,
                       None, pf, bounds, off, w, seg, ext)
        solve = make_admm_solver(ops, adapt_rho=False)
        st0 = make_state(zeros, zeros, zeros, rho, lams[0],
                         aux=majorizer_inv(zeros), dtype=dtype)

        def step(st, lam):
            st = warm_start(st, lam)
            st = st._replace(aux=majorizer_inv(st.x))
            st = solve(st, maxit, eps_abs, eps_rel)
            return st, (st.z, st.it)

        _, (coefs_s, niter) = lax.scan(step, st0, lams)

    coef = coefs_s / sd_x[None, :]
    return CoxPathResult(lambdas=lams, coef=coef, niter=niter)


@partial(jax.jit, static_argnames=("standardize_x", "path_mode",
                                   "newton_steps"))
def _cox_fold_coefs(X, d, first, last, lams, masks, rho, maxit,
                    eps_abs, eps_rel, alpha, pf=None, limits=None,
                    w=None, off=None, seg=None, ext=None, *,
                    standardize_x, path_mode, newton_steps):
    """Jitted ONE-PROGRAM CV fold sweep (the cox analog of
    models/cv.py::_glm_fold_etas): fold f is the weighted path with
    weight 0 on its held-out rows — zero-weight rows drop out of the
    Breslow risk sets and event terms EXACTLY (``_cox_grad_eta``'s
    guard), so each lane equals the training-subset fit — vmapped over
    the (nfolds, n) mask matrix.  Returns (nfolds, L, p) original-scale
    coefficients (rows in the caller's time-sorted order)."""
    def one(mask):
        wf = mask if w is None else mask * w
        res = _cox_path(X, d, first, last, 2, 1e-2, lams, rho, maxit,
                        eps_abs, eps_rel, alpha, pf, limits, wf, off,
                        seg, ext,
                        standardize_x=standardize_x,
                        path_mode=path_mode, newton_steps=newton_steps)
        return res.coef

    return jax.vmap(one)(masks)


def cox_lasso_path(X, time, event, *,
                   lambdas: Optional[jnp.ndarray] = None,
                   nlambda: int = 50, lambda_min_ratio: float = 1e-2,
                   alpha: float = 1.0, standardize: bool = True,
                   maxit: int = 10000, eps_abs: float = 1e-5,
                   eps_rel: float = 1e-5, rho: float = -1.0,
                   path_mode: str = "scan", newton_steps: int = 2,
                   penalty_factor: Optional[jnp.ndarray] = None,
                   lower_limits=None, upper_limits=None, exclude=None,
                   weights: Optional[jnp.ndarray] = None,
                   offset: Optional[jnp.ndarray] = None,
                   strata: Optional[np.ndarray] = None,
                   start: Optional[np.ndarray] = None,
                   dtype=jnp.float32) -> CoxPathResult:
    """Solve the L1/elastic-net Cox partial-likelihood path.

    ``time``: (n,) observed/censoring times; ``event``: (n,) 1 = event
    observed, 0 = right-censored.  Ties handled by Breslow's
    approximation (glmnet's convention).  No intercept (absorbed by the
    baseline hazard).  ``path_mode="scan"`` (default, MEASURED: the
    warm-started sequential path with the per-lambda adaptive majorizer
    converges in ~8x fewer step-units than cold batch lanes under the
    global d/2 bound — cox solutions move smoothly along the path);
    "batch" solves lambdas as lanes with the shared global-bound
    factorization.  Returns coefficients on the original scale.

    ``penalty_factor`` / ``lower_limits`` / ``upper_limits`` /
    ``exclude`` (glmnet's per-coefficient arguments for family='cox',
    same semantics as :func:`admm_tpu.lasso_path`): per-coordinate
    thresholds with the factor-aware grid top, an exact
    clip-after-shrink box on the original scale, and exclusion via the
    zero box.

    ``weights`` (glmnet's ``weights`` for family='cox'): case weights
    — the weighted Breslow likelihood (risk-set sums AND event terms
    carry w, normalized to sum n); an integer weight k is exactly
    repeating the row k times (tested).  ``offset``: a fixed (n,) term
    added to the linear predictor (``eta = X b + offset``); a CONSTANT
    offset leaves the fit invariant (the partial likelihood's shift
    gauge — tested).

    ``strata`` (glmnet's ``stratifySurv``): a length-n array of
    stratum labels — the STRATIFIED Cox model, one shared coefficient
    vector but separate baseline hazards: the partial likelihood is
    the sum of per-stratum Breslow terms, so risk sets never cross a
    stratum boundary.  realization: rows sort
    stratum-major/time-descending once on the host and every risk-set
    cumsum becomes SEGMENTED (two extra gathers — same compiled
    structure as the unstratified path).  One stratum reduces exactly
    to the unstratified fit (tested); ``cv_cox_path`` and
    :func:`admm_tpu.survfit_cox` accept the same argument.

    ``start`` (glmnet's ``Surv(start, stop, event)`` — the START-STOP
    / counting-process model, e.g. left truncation or time-varying
    covariates as row episodes): ``time`` becomes the interval END and
    the risk set at an event time t is ``{j: start_j < t <= stop_j}``.
    realization: the interval membership decomposes as
    ``S(t) = sum_{stop_j >= t} - sum_{start_j >= t}`` — one extra
    prefix sum (rows permuted start-descending) plus two
    host-precomputed static gathers; ``start=None`` (all rows at risk
    from the origin) is exactly the right-censored model (tested).
    Combines with ``strata`` (per-stratum interval risk sets via
    block-local indices — KKT-pinned).
    """
    X_np = np.asarray(X)
    t_np = np.asarray(time, np.float64).ravel()
    d_np = np.asarray(event, np.float64).ravel()
    n, p = X_np.shape
    if t_np.shape != (n,) or d_np.shape != (n,):
        raise ValueError("time and event must have one entry per row")
    if not np.all((d_np == 0) | (d_np == 1)):
        raise ValueError("event must be 0/1")
    if d_np.sum() == 0:
        raise ValueError("no events observed — the partial likelihood "
                         "is constant")
    if path_mode not in ("batch", "scan"):
        raise ValueError("path_mode must be 'batch' or 'scan'")
    if not (0.0 < alpha <= 1.0):
        raise ValueError("alpha must be in (0, 1]")

    # Sort by time DESCENDING once on the host (coefficients are
    # per-feature, so no unsort is needed); tie groups precomputed.
    # With strata (glmnet's stratifySurv): stratum-major sort, tie
    # groups and risk sets confined to each stratum block (segmented
    # cumsums in _cox_grad_eta).
    seg = ext = None
    if start is not None:
        st_np = np.asarray(start, np.float64).ravel()
        if st_np.shape != (n,):
            raise ValueError("start must have one entry per row")
        if np.any(st_np >= t_np):
            raise ValueError("start must be < time (the interval "
                             "(start, stop] must be nonempty)")
    if strata is None:
        order = np.argsort(-t_np, kind="stable")
        first, last = _tie_groups(t_np[order])
        if start is not None:
            ext = _startstop_prep(t_np[order], st_np[order])
    else:
        order, ss, seg_first, seg_last = _strata_prep(t_np, strata)
        first, last = _tie_groups(t_np[order], ss)
        seg = (seg_first, seg_last)
        if start is not None:
            ext = _startstop_prep_strata(t_np[order], st_np[order],
                                         np.asarray(ss))
    Xj = jnp.asarray(X_np[order], dtype)
    dj = jnp.asarray(d_np[order], dtype)
    wj = offj = None
    if weights is not None:
        w_np = np.asarray(weights, np.float64).ravel()
        if w_np.shape != (n,):
            raise ValueError("weights must have one entry per row")
        if np.any(w_np <= 0):
            raise ValueError("cox weights must be positive (a zero "
                             "weight: drop the row)")
        wj = jnp.asarray(w_np[order], dtype)
    if offset is not None:
        o_np = np.asarray(offset, np.float64).ravel()
        if o_np.shape != (n,):
            raise ValueError("offset must have one entry per row")
        offj = jnp.asarray(o_np[order], dtype)
    lams = (None if lambdas is None
            else jnp.sort(jnp.asarray(lambdas, dtype))[::-1])
    from .lasso import validate_pf_limits

    pf, limits = validate_pf_limits(penalty_factor, exclude,
                                    lower_limits, upper_limits, p,
                                    dtype)
    return _cox_path(Xj, dj, first, last, int(nlambda),
                     lambda_min_ratio, lams, rho, maxit, eps_abs,
                     eps_rel, alpha, pf, limits, wj, offj, seg, ext,
                     standardize_x=standardize,
                     path_mode=path_mode,
                     newton_steps=int(newton_steps))


def _breslow_pl(X, t, d, coefs, w=None, off=None, strata=None,
                start=None):
    """Breslow log partial likelihood per path point ((L,) numpy):
    ``sum_{events i} w_i [eta_i - log sum_{t_j >= t_i} w_j e^{eta_j}]``
    (weights/offset optional, matching the solver's weighted
    likelihood).  With ``strata`` the stratified PL is the SUM of the
    per-stratum PLs at the shared coefficients.  With ``start`` the
    risk sets are the intervals ``start_j < t_i <= stop_j`` (an O(n^2)
    mask — this is the host-side CV scorer, not the solver)."""
    if strata is not None:
        s_np = np.asarray(strata).ravel()
        out = 0.0
        for sv in np.unique(s_np):
            m = s_np == sv
            out = out + _breslow_pl(
                np.asarray(X)[m], np.asarray(t).ravel()[m],
                np.asarray(d).ravel()[m], coefs,
                None if w is None else np.asarray(w).ravel()[m],
                None if off is None else np.asarray(off).ravel()[m],
                start=(None if start is None
                       else np.asarray(start).ravel()[m]))
        return out
    if start is not None:
        X = np.asarray(X, np.float64)
        t = np.asarray(t, np.float64).ravel()
        d = np.asarray(d, np.float64).ravel()
        st = np.asarray(start, np.float64).ravel()
        C = np.asarray(coefs, np.float64)
        ws = np.ones_like(d) if w is None \
            else np.asarray(w, np.float64).ravel()
        eta = C @ X.T                               # (L, n)
        if off is not None:
            eta = eta + np.asarray(off, np.float64).ravel()[None, :]
        m = eta.max(axis=1, keepdims=True)
        ee = ws[None, :] * np.exp(eta - m)          # (L, n)
        ev = d > 0
        # R[i, j] = row j at risk at event time t_i.
        R = (st[None, :] < t[ev][:, None]) & (t[None, :] >= t[ev][:, None])
        S = ee @ R.T                                # (L, n_ev)
        logS = np.log(S) + m
        return ((ws * d)[ev][None, :]
                * (eta[:, ev] - logS)).sum(axis=1)
    X = np.asarray(X, np.float64)
    t = np.asarray(t, np.float64).ravel()
    d = np.asarray(d, np.float64).ravel()
    C = np.asarray(coefs, np.float64)           # (L, p)
    order = np.argsort(-t, kind="stable")
    Xs, ts, ds = X[order], t[order], d[order]
    ws = (np.ones_like(ds) if w is None
          else np.asarray(w, np.float64).ravel()[order])
    eta = C @ Xs.T                               # (L, n)
    if off is not None:
        eta = eta + np.asarray(off, np.float64).ravel()[order][None, :]
    m = eta.max(axis=1, keepdims=True)
    ee = ws[None, :] * np.exp(eta - m)
    cum = np.cumsum(ee, axis=1)
    # Tie-aware risk sums: read each tie group's end.
    n = ts.shape[0]
    last = np.zeros(n, np.int64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and ts[j + 1] == ts[i]:
            j += 1
        last[i:j + 1] = j
        i = j + 1
    logS = np.log(cum[:, last]) + m              # (L, n)
    # eta - logS = (eta - m) - log(cum): the max-shift m cancels.
    return ((eta - logS) * (ws * ds)[None, :]).sum(axis=1)


def cv_cox_path(X, time, event, *, nfolds: int = 10, seed: int = 0,
                foldid: Optional[np.ndarray] = None, nlambda: int = 50,
                type_measure: str = "deviance", cv_mode: str = "auto",
                keep: bool = False, **path_kw):
    """Cross-validated Cox path, scored by the Verweij-van Houwelingen
    partial-likelihood deviance (glmnet's type.measure="deviance" for
    family="cox"): per fold k, ``PL_full(b_{-k}) - PL_{-k}(b_{-k})`` —
    the held-out rows' contribution to the partial likelihood, which
    (unlike a naive per-row split) respects the risk-set coupling.
    Returns a :class:`~admm_tpu.models.cv.CVResult`-shaped object with
    per-fold (not per-observation) aggregation.

    ``type_measure="C"`` (glmnet's other cox measure): per-fold
    Harrell C-index of the HELD-OUT rows' risk scores, folds weighted
    by their (weighted) event counts, ``lambda_min`` MAXIMISING the
    curve; folds with no comparable pair get weight 0 (glmnet returns
    NA there and recommends small nfolds).

    ``cv_mode``: "onepass" (the default via "auto") runs EVERY fold's
    whole path as one compiled program — fold f is the weighted cox
    path with weight 0 on held-out rows (exactly the training-subset
    fit: zero-weight rows drop out of the Breslow risk sets), vmapped
    over the fold-mask axis; only the cheap deviance/C-index scoring
    stays on the host.  "loop" is the host-side per-fold refit (the two
    agree to solver tolerance — tested).
    """
    from .cv import CVResult, _cv_foldid

    if type_measure not in ("deviance", "default", "C"):
        raise ValueError("cox type_measure must be 'deviance' or 'C'")
    if cv_mode not in ("auto", "onepass", "loop"):
        raise ValueError("cv_mode must be 'auto', 'onepass' or 'loop'")
    X = np.asarray(X, np.float64)
    t = np.asarray(time, np.float64).ravel()
    d = np.asarray(event, np.float64).ravel()
    n = X.shape[0]
    w = path_kw.pop("weights", None)
    off = path_kw.pop("offset", None)
    strata = path_kw.pop("strata", None)
    start = path_kw.pop("start", None)
    fold_mesh = path_kw.pop("fold_mesh", None)
    w = None if w is None else np.asarray(w, np.float64).ravel()
    off = None if off is None else np.asarray(off, np.float64).ravel()
    strata = None if strata is None else np.asarray(strata).ravel()
    start = None if start is None else np.asarray(start,
                                                  np.float64).ravel()
    if start is not None and type_measure == "C":
        raise ValueError("type_measure='C' is not defined for "
                         "start-stop data; use 'deviance'")

    def sub(v, m):
        return None if v is None else v[m]

    full = cox_lasso_path(X, t, d, nlambda=nlambda, weights=w,
                          offset=off, strata=strata, start=start,
                          **path_kw)
    # The full fit consumed any user grid; the fold refits get the
    # SHARED grid explicitly (a lambdas= left in path_kw would collide).
    path_kw.pop("lambdas", None)
    lams = np.asarray(full.lambdas, np.float64)
    foldid, nfolds = _cv_foldid(n, nfolds, seed, foldid)

    fold_coefs = None
    if cv_mode != "loop":
        # One-program fold sweep: replicate the driver's host prep
        # (time-descending sort + tie groups) once, mask per fold.
        dtype = path_kw.get("dtype", jnp.float32)
        seg = ext = None
        if strata is None:
            order = np.argsort(-t, kind="stable")
            first, last = _tie_groups(t[order])
            if start is not None:
                ext = _startstop_prep(t[order], start[order])
        else:
            order, ss, seg_first, seg_last = _strata_prep(t, strata)
            first, last = _tie_groups(t[order], ss)
            seg = (seg_first, seg_last)
            if start is not None:
                ext = _startstop_prep_strata(t[order], start[order],
                                             np.asarray(ss))
        from .lasso import validate_pf_limits

        pf, limits = validate_pf_limits(
            path_kw.get("penalty_factor"), path_kw.get("exclude"),
            path_kw.get("lower_limits"), path_kw.get("upper_limits"),
            X.shape[1], dtype)
        from .cv import _shard_folds

        masks = (foldid[order][None, :]
                 != np.arange(nfolds)[:, None]).astype(np.float64)
        fold_coefs = np.asarray(_cox_fold_coefs(
            jnp.asarray(X[order], dtype), jnp.asarray(d[order], dtype),
            first, last, jnp.asarray(lams, dtype),
            _shard_folds(jnp.asarray(masks, dtype), fold_mesh),
            path_kw.get("rho", -1.0), path_kw.get("maxit", 10000),
            path_kw.get("eps_abs", 1e-5), path_kw.get("eps_rel", 1e-5),
            path_kw.get("alpha", 1.0), pf, limits,
            None if w is None else jnp.asarray(w[order], dtype),
            None if off is None else jnp.asarray(off[order], dtype),
            seg, ext,
            standardize_x=path_kw.get("standardize", True),
            path_mode=path_kw.get("path_mode", "scan"),
            newton_steps=int(path_kw.get("newton_steps", 2))),
            np.float64)                          # (nfolds, L, p)

    cvraw = np.zeros((nfolds, lams.shape[0]))
    fold_w = np.ones(nfolds)
    # glmnet's keep=TRUE: prevalidated (n, L) linear predictors (each
    # row from the fold fit that excluded it).
    preval = np.full((n, lams.shape[0]), np.nan) if keep else None
    for f in range(nfolds):
        tr = foldid != f
        va = foldid == f
        if fold_coefs is not None:
            rf = CoxPathResult(lambdas=lams, coef=fold_coefs[f],
                               niter=None)
        else:
            rf = cox_lasso_path(X[tr], t[tr], d[tr], lambdas=lams,
                                weights=sub(w, tr), offset=sub(off, tr),
                                strata=sub(strata, tr),
                                start=sub(start, tr), **path_kw)
        if preval is not None:
            ev = X[va] @ np.asarray(rf.coef).T           # (n_va, L)
            if off is not None:
                ev = ev + off[va][:, None]
            preval[va] = ev
        if type_measure == "C":
            from ..assess import c_index

            eta = np.asarray(rf.coef) @ X[va].T          # (L, n_va)
            if off is not None:
                eta = eta + off[va][None, :]
            try:
                cvraw[f] = c_index(eta, t[va], d[va],
                                   weights=sub(w, va))
            except ValueError:           # no comparable pair this fold
                fold_w[f] = 0.0
                continue
            # glmnet: folds weighted by their weighted event count.
            fold_w[f] = float(d[va].sum() if w is None
                              else (w[va] * d[va]).sum())
        else:
            pl_full = _breslow_pl(X, t, d, np.asarray(rf.coef), w, off,
                                  strata, start)
            pl_tr = _breslow_pl(X[tr], t[tr], d[tr],
                                np.asarray(rf.coef),
                                sub(w, tr), sub(off, tr),
                                sub(strata, tr), sub(start, tr))
            cvraw[f] = -2.0 * (pl_full - pl_tr)

    if type_measure == "C":
        if fold_w.sum() == 0:
            raise ValueError("the C-index is undefined in every fold "
                             "(no comparable pairs); use fewer folds")
        fw = fold_w / fold_w.sum()
        cvm = fw @ cvraw
        nf_eff = int((fold_w > 0).sum())
        cvsd = np.sqrt((fw @ (cvraw - cvm) ** 2) / max(nf_eff - 1, 1))
        i_min = int(np.argmax(cvm))
        within = cvm >= cvm[i_min] - cvsd[i_min]
    else:
        cvm = cvraw.mean(axis=0)
        cvsd = cvraw.std(axis=0, ddof=1) / np.sqrt(nfolds)
        i_min = int(np.argmin(cvm))
        within = cvm <= cvm[i_min] + cvsd[i_min]
    return CVResult(lambdas=lams, cvm=cvm, cvsd=cvsd,
                    lambda_min=float(lams[i_min]),
                    lambda_1se=float(lams[np.flatnonzero(within)[0]]),
                    fit=full, foldid=foldid, fit_preval=preval)


class SurvFit(NamedTuple):
    """Breslow baseline-hazard survival curves (survfit_cox)."""
    time: np.ndarray     # (T,) unique event times, ascending
    cumhaz: np.ndarray   # (T,) baseline cumulative hazard H0(t)
    surv: np.ndarray     # (T, m) S(t | x_new) = exp(-H0(t) e^eta_new)


def survfit_cox(result, X, time, event, *, Xnew=None, lam=None,
                weights=None, offset=None, newoffset=None,
                strata=None, newstrata=None, start=None):
    """Survival curves from a fitted Cox path (glmnet's
    ``survfit.coxnet``): the Breslow baseline cumulative hazard is
    estimated from the TRAINING data (``X``/``time``/``event`` — the
    data the model was fit on, with the same ``weights``/``offset``),

        H0(t) = sum_{event times t_k <= t}
                (sum of weighted events at t_k) / S(t_k),
        S(t_k) = sum_{t_j >= t_k} w_j e^{eta_j},

    and each row of ``Xnew`` (default: the training ``X``) gets
    ``S(t | x) = exp(-H0(t) e^{eta_x})`` evaluated at every event time.

    ``lam`` selects the path point (interpolated off-grid, as
    ``predict``); a CV result defaults to its ``lambda.1se`` like
    ``predict``.  A plain path result requires an explicit ``lam``
    unless the path has exactly one point.
    """
    from ..predict import _at_lam, _resolve_cv

    result, lam = _resolve_cv(result, lam)
    if lam is not None:
        result = _at_lam(result, lam)
    elif np.asarray(result.lambdas).shape[0] != 1:
        raise ValueError("pass lam= to select the path point (or use "
                         "a CV result, which defaults to lambda.1se)")
    beta = np.asarray(result.coef, np.float64)[0]    # (p,)

    if strata is not None:
        # Stratified baselines (glmnet's survfit on a stratifySurv
        # fit): each stratum gets its own Breslow H0; returns a dict
        # stratum-label -> SurvFit whose surv columns are the Xnew
        # rows of that stratum (np.flatnonzero(newstrata == label)).
        s_np = np.asarray(strata).ravel()
        if Xnew is None:
            ns = s_np
        else:
            if newstrata is None:
                raise ValueError("pass newstrata= with Xnew for a "
                                 "stratified fit")
            ns = np.asarray(newstrata).ravel()

        def subv(v, m):
            return None if v is None else np.asarray(v).ravel()[m]

        out = {}
        Xn_all = X if Xnew is None else np.asarray(Xnew, np.float64)
        for sv in np.unique(s_np):
            m = s_np == sv
            mn = ns == sv
            if not mn.any():
                continue
            out[sv] = survfit_cox(
                result, np.asarray(X, np.float64)[m],
                np.asarray(time, np.float64).ravel()[m],
                np.asarray(event, np.float64).ravel()[m],
                Xnew=Xn_all[mn], weights=subv(weights, m),
                offset=subv(offset, m), start=subv(start, m),
                newoffset=(subv(newoffset, mn) if Xnew is not None
                           else subv(offset, m)))
        return out

    X = np.asarray(X, np.float64)
    t = np.asarray(time, np.float64).ravel()
    d = np.asarray(event, np.float64).ravel()
    n = t.shape[0]
    w = (np.ones(n) if weights is None
         else np.asarray(weights, np.float64).ravel())
    eta = X @ beta
    if offset is not None:
        eta = eta + np.asarray(offset, np.float64).ravel()

    if start is not None:
        st = np.asarray(start, np.float64).ravel()
        t_ev, H0 = _survfit_baseline_startstop(t, d, w, eta, st)
        Xn = X if Xnew is None else np.asarray(Xnew, np.float64)
        eta_new = Xn @ beta
        if newoffset is not None:
            eta_new = eta_new + np.asarray(newoffset,
                                           np.float64).ravel()
        elif Xnew is None and offset is not None:
            eta_new = eta_new + np.asarray(offset, np.float64).ravel()
        return SurvFit(time=t_ev, cumhaz=H0,
                       surv=np.exp(-np.outer(H0, np.exp(eta_new))))

    order = np.argsort(t, kind="stable")             # ASCENDING
    ts, ds, ws = t[order], d[order], w[order]
    ee = ws * np.exp(eta[order])
    # Risk set of t_k = everyone with t_j >= t_k: a suffix sum; ties
    # share the risk set of their group's FIRST (ascending) position.
    suffix = np.cumsum(ee[::-1])[::-1]
    uniq, first_idx = np.unique(ts, return_index=True)
    S = suffix[first_idx]                            # (U,)
    dsum = np.add.reduceat(ws * ds, first_idx)       # weighted events/time
    has_event = dsum > 0
    t_ev = uniq[has_event]
    dH = dsum[has_event] / S[has_event]
    if t_ev.size == 0:
        raise ValueError("no events in the training data")
    H0 = np.cumsum(dH)

    Xn = X if Xnew is None else np.asarray(Xnew, np.float64)
    eta_new = Xn @ beta
    if newoffset is not None:
        eta_new = eta_new + np.asarray(newoffset, np.float64).ravel()
    elif Xnew is None and offset is not None:
        eta_new = eta_new + np.asarray(offset, np.float64).ravel()
    surv = np.exp(-np.outer(H0, np.exp(eta_new)))
    return SurvFit(time=t_ev, cumhaz=H0, surv=surv)


def _survfit_baseline_startstop(t, d, w, eta, start):
    """Breslow baseline cumulative hazard under START-STOP risk sets
    (left truncation): H0 over ascending event times with
    ``S(t) = sum_{start_j < t <= stop_j} w_j e^{eta_j}`` (host O(n^2)
    mask — estimation-time only)."""
    ee = w * np.exp(eta)
    ev = d > 0
    t_ev = np.unique(t[ev])
    if t_ev.size == 0:
        raise ValueError("no events in the training data")
    R = (start[None, :] < t_ev[:, None]) & (t[None, :] >= t_ev[:, None])
    S = R @ ee                                      # (T,)
    dsum = np.array([(w * d)[t == tk].sum() for tk in t_ev])
    return t_ev, np.cumsum(dsum / S)
