"""Lasso / Elastic-Net lambda-path solvers (tall and wide regimes).

Model (glmnet objective; reference: src/Lasso.cpp:52-55)::

    minimize  1/(2n) ||y - X beta||^2
              + lambda * (alpha ||beta||_1 + (1-alpha)/2 ||beta||_2^2)

Internally the penalty is rescaled to ``ilambda = lambda * n / scale_y``
and the solver works on standardized data, exactly as the reference
driver does (reference: src/Lasso.cpp:67-99).

Two formulations, dispatched on the data shape as in the reference
(reference: src/Lasso.cpp:73-76):

* **tall** (n > p): accelerated FADMM on the splitting ``x - z = 0`` with
  ``f = 1/2||Xb - y||^2``; the x-update is a cached ridge solve of
  ``(X'X + rho I) x = X'y - adj_y + rho adj_z``
  (reference: src/ADMMLassoTall.h:9-20, :70-80).  Here the cached
  Cholesky becomes a one-time explicit inverse so each iteration is a
  single p x p matvec.  rho is auto-set to
  ``eigmax(X'X)^(1/3) * lambda^(2/3)`` and deliberately kept fixed over
  the warm-started path (reference: src/ADMMLassoTall.h:96-97, :194-202).

* **wide** (p >= n): plain ADMM with linearized x-update (no
  factorization): ``v = x - X'(Ax + z + y/rho)/gamma``,
  ``x = prox(v, lambda/(rho gamma))`` with ``gamma = eigmax(XX')``
  (reference: src/ADMMLassoWide.h:13-25, :129-155).  The closed-form
  z-update caches ``Ax`` (reference: src/ADMMLassoWide.h:156-165) and the
  adaptive-rho ladder is active.  The reference's 4^k-1 active-set
  cadence is a CPU work-saving trick (sparse column dots, reference:
  src/ADMMLassoWide.h:86-127); on an accelerator a dense X' matvec per
  iteration is one gemv and needs no bookkeeping, so every update is a
  "regular" update.  Trajectories differ slightly but converge to the same
  solution under the same Boyd stopping rule.

The whole lambda path — warm starts included — runs inside ONE jitted XLA
program: ``lax.scan`` over lambdas around ``lax.while_loop`` over ADMM
iterations (the reference's per-lambda loop is host-side C++,
reference: src/Lasso.cpp:97-124).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.engine import (ADMMState, ProblemOps, make_admm_solver,
                           make_batched_solver, make_batched_traced_solve,
                           make_fadmm_solver, make_state,
                           make_traced_solve, warm_start)
from ..core.prox import enet_prox, l2norm, sqnorm
from ..data.standardize import StdStats, recover, standardize
from ..linalg import dot, gram, ridge_inverse, spectral_radius_gram, spectral_radius_sym


class PathResult(NamedTuple):
    """Device-side lambda-path result (original data scale)."""
    lambdas: jnp.ndarray  # (nlambda,) user-scale penalty grid
    beta0: jnp.ndarray    # (nlambda,) intercepts
    coef: jnp.ndarray     # (nlambda, p) coefficients
    niter: jnp.ndarray    # (nlambda,) int32 ADMM iteration counts
    # (nlambda, trace_len, 5) per-iteration (eps_pri, r_pri, eps_dua,
    # r_dua, rho) when tracing was requested (admm_tpu.diag.trace).
    trace: Optional[jnp.ndarray] = None


def _truncate_path(res, dfmax, pmax):
    """glmnet's ``dfmax``/``pmax``: return the longest path PREFIX on
    which every point has <= dfmax nonzero coefficients (and the
    ever-active union stays <= pmax) — glmnet shortens the returned
    path rather than erroring.  Host-side trim of a finished result
    (the device program keeps its static shapes)."""
    import numpy as np

    coef = np.asarray(res.coef)
    nz = coef != 0 if coef.ndim == 2 else np.any(coef != 0, axis=-1)
    ok = np.ones(nz.shape[0], bool)
    if dfmax is not None:
        ok &= nz.sum(axis=1) <= int(dfmax)
    if pmax is not None:
        ever = np.logical_or.accumulate(nz, axis=0)
        ok &= ever.sum(axis=1) <= int(pmax)
    bad = np.flatnonzero(~ok)
    k = int(bad[0]) if bad.size else ok.size
    if k == 0:
        raise ValueError("dfmax/pmax exclude even the largest-lambda "
                         "model; raise the limit")
    if k == ok.size:
        return res
    upd = {f: getattr(res, f)[:k]
           for f in ("lambdas", "beta0", "coef", "niter")}
    if getattr(res, "trace", None) is not None:
        upd["trace"] = res.trace[:k]
    return res._replace(**upd)


def validate_pf_limits(penalty_factor, exclude, lower_limits,
                       upper_limits, p, dtype):
    """Normalize glmnet's ``penalty.factor`` / ``exclude`` /
    ``lower.limits`` / ``upper.limits`` into ``(pf, limits)`` —
    shared by the gaussian and GLM path drivers.

    ``pf``: (p,) factors rescaled to sum p (glmnet convention), or
    None.  ``limits``: ((p,) lo, (p,) up) ORIGINAL-scale box (each
    driver maps it to its standardized scale), or None; ``exclude``
    indices are merged in as the lower=upper=0 box (exactly
    equivalent: the prox clips those coordinates to 0 every
    iteration)."""
    pf = None
    if penalty_factor is not None:
        pf = jnp.asarray(penalty_factor, dtype).ravel()
        if pf.shape != (p,):
            raise ValueError("penalty_factor must have one entry per "
                             "column of x")
        pf_np = np.asarray(pf)
        if np.any(pf_np < 0) or not np.any(pf_np > 0):
            raise ValueError("penalty_factor entries must be >= 0 with "
                             "at least one positive")
        pf = pf * (p / jnp.sum(pf))  # glmnet: factors sum to nvars
    if exclude is not None:
        idx = np.asarray(exclude, np.int64).ravel()
        if idx.size and (idx.min() < 0 or idx.max() >= p):
            raise ValueError("exclude indices must be in [0, p)")
        lo = np.broadcast_to(np.asarray(
            -np.inf if lower_limits is None else lower_limits,
            np.float64), (p,)).copy()
        up = np.broadcast_to(np.asarray(
            np.inf if upper_limits is None else upper_limits,
            np.float64), (p,)).copy()
        lo[idx] = 0.0
        up[idx] = 0.0
        lower_limits, upper_limits = lo, up
    limits = None
    if lower_limits is not None or upper_limits is not None:
        lo = (-jnp.inf if lower_limits is None else lower_limits)
        up = (jnp.inf if upper_limits is None else upper_limits)
        lo = jnp.broadcast_to(jnp.asarray(lo, dtype), (p,))
        up = jnp.broadcast_to(jnp.asarray(up, dtype), (p,))
        if bool(jnp.any(lo > 0)) or bool(jnp.any(up < 0)):
            raise ValueError("limits must satisfy lower <= 0 <= upper "
                             "(glmnet convention: 0 stays feasible)")
        limits = (lo, up)
    return pf, limits


# ---------------------------------------------------------------------------
# Tall regime (n > p): FADMM with cached ridge inverse
# ---------------------------------------------------------------------------

def _tall_ops(Minv, Xty, alpha, p, pf=None, bounds=None) -> ProblemOps:
    """``pf``: optional (p,) per-coefficient penalty factors (glmnet's
    ``penalty.factor``, rescaled to sum p) — the prox threshold becomes
    per-coordinate ``lam * pf_j``; ``pf_j = 0`` leaves coordinate j
    unpenalized.  ``bounds``: optional (lo, up) coefficient box on the
    STANDARDIZED scale (glmnet's lower/upper.limits) — both intervals
    contain 0, so the prox of penalty + box indicator is exactly
    clip-after-shrink (both terms separable)."""
    def next_x(st):
        rhs = Xty - st.adj_y + st.rho * st.adj_z
        return dot(Minv, rhs)

    def next_z(st, x_new):
        v = x_new + st.adj_y / st.rho
        pen = st.lam / st.rho
        if pf is not None:
            pen = pen * pf
        z = enet_prox(v, pen, alpha)
        if bounds is not None:
            z = jnp.clip(z, bounds[0], bounds[1])
        return z, st.aux

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


def _tall_setup(Xs, ys, lam_first, rho0):
    """Shared tall-regime caches: ridge inverse, X'y, auto-rho.

    Deterministic functions of (data, options), so a resumed/checkpointed
    path rebuilds them exactly (admm_tpu.diag.checkpoint)."""
    dtype = Xs.dtype
    XtX = gram(Xs)
    Xty = dot(Xs.T, ys)
    sprad = spectral_radius_sym(XtX)
    # Auto-rho power law (reference: src/ADMMLassoTall.h:194-202).
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.cbrt(sprad) * lam_first ** (2.0 / 3.0))
    Minv = ridge_inverse(XtX, rho)
    return Minv, Xty, rho


def _tall_engine(Xs, ys, lam_first, rho0, alpha, pf=None, bounds=None):
    """Build the tall-regime engine: cold state, solver, reported iterate."""
    n, p = Xs.shape
    dtype = Xs.dtype
    Minv, Xty, rho = _tall_setup(Xs, ys, lam_first, rho0)

    ops = _tall_ops(Minv, Xty, alpha, p, pf, bounds)
    solve = make_fadmm_solver(ops, adapt_rho=False)

    zeros = jnp.zeros((p,), dtype)
    st0 = make_state(zeros, zeros, zeros, rho, lam_first, dtype=dtype)
    # The tall solver's reported coefficients are the sparse iterate z
    # (reference: src/Lasso.cpp:108).
    return st0, solve, (lambda st: st.z)


def _scan_path(st0, solve, report, ilams, maxit, eps_abs, eps_rel,
               trace_len=None, refresh=None):
    """Warm-started scan over the lambda grid (any engine).

    With ``trace_len`` set, a per-iteration residual trace rides the
    while_loop carry (core.engine.make_traced_solve) and is returned per
    lambda; otherwise ``traces`` is None.  ``refresh`` (optional) maps
    the warm-start iterate to a new ``st.aux`` at each lambda — the
    per-lambda adaptive-majorizer hook (glm hessian='adaptive').
    """
    solve_t = None if trace_len is None else make_traced_solve(solve,
                                                               trace_len)

    def step(st, lam):
        st = warm_start(st, lam)
        if refresh is not None:
            st = st._replace(aux=refresh(st.x))
        if trace_len is None:
            st = solve(st, maxit, eps_abs, eps_rel)
            buf = None
        else:
            st, buf = solve_t(st, maxit, eps_abs, eps_rel)
        return st, (report(st), st.it, buf)

    st, (coefs, niter, traces) = lax.scan(step, st0, ilams)
    return st, coefs, niter, traces


def _solve_path_tall(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel, alpha,
                     trace_len=None, pf=None, bounds=None):
    st0, solve, report = _tall_engine(Xs, ys, ilams[0], rho0, alpha, pf,
                                      bounds)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


def _batched_cold_states(k, dims, rho, ilams, dtype, aux_dim=None):
    """Stacked cold-start states, one lane per lambda."""
    zeros = jnp.zeros((k, dims), dtype)
    aux = None if aux_dim is None else jnp.zeros((k, aux_dim), dtype)
    ones = jnp.ones((k,), dtype)
    return ADMMState(
        x=zeros, z=zeros, y=zeros, adj_z=zeros, adj_y=zeros, aux=aux,
        adj_a=ones, adj_c=9999.0 * ones,
        rho=rho * jnp.ones((k,), dtype), lam=jnp.asarray(ilams, dtype),
        eps_pri=0.0 * ones, eps_dua=0.0 * ones,
        r_pri=9999.0 * ones, r_dua=9999.0 * ones,
        it=jnp.zeros((k,), jnp.int32),
        done=jnp.zeros((k,), bool),
    )


def _solve_path_tall_batch(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                           alpha, trace_len=None, pf=None, bounds=None):
    """All-lambdas-at-once tall solve (see make_batched_solver).

    Uses a single shared rho/factorization across lambdas — exactly the
    reference's own path protocol (rho is set at the first lambda and
    never changes, reference: src/ADMMLassoTall.h:96-97, :219-230).
    ``trace_len`` records a PER-LANE residual trace (cold-start lanes;
    make_batched_traced_solve)."""
    n, p = Xs.shape
    dtype = Xs.dtype
    Minv, Xty, rho = _tall_setup(Xs, ys, ilams[0], rho0)

    ops = _tall_ops(Minv, Xty, alpha, p, pf, bounds)
    engine = make_fadmm_solver(ops, adapt_rho=False)
    st = _batched_cold_states(ilams.shape[0], p, rho, ilams, dtype)
    if trace_len is None:
        st = make_batched_solver(engine)(st, maxit, eps_abs, eps_rel)
        return st.z, st.it, None
    st, buf = make_batched_traced_solve(engine, trace_len)(
        st, maxit, eps_abs, eps_rel)
    return st.z, st.it, buf


def _wide_setup(Xs, ys, rho_lams, rho0, alpha, enet_lambda0_scale):
    """Shared wide-regime caches: lambda0 (with the Enet inflation,
    reference: src/ADMMEnet.h:56), matrix-free spectral radius of XX'
    (== of X'X; materialising the n x n Gram only to feed power
    iteration would cost ~10x the estimate itself), and auto-rho
    (reference: src/ADMMLassoWide.h:227-228) — scalar for the scan path,
    per-lane for the batch path."""
    dtype = Xs.dtype
    lambda0 = jnp.max(jnp.abs(dot(Xs.T, ys)))
    # The all-zero threshold is the l1 part's KKT boundary, lambda0 /
    # alpha (inf for ridge); the Enet keeps the reference's 1e-4 offset.
    lambda0 = lambda0 / (alpha + 1e-4 if enet_lambda0_scale else alpha)
    sprad = spectral_radius_gram(Xs)
    rho = jnp.where(rho0 > 0, jnp.asarray(rho0, dtype),
                    jnp.cbrt(rho_lams / sprad))
    return lambda0, sprad, rho


def _solve_path_wide_batch(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel,
                           alpha, enet_lambda0_scale, trace_len=None,
                           pf=None, lambda0_pf=None, bounds=None):
    """All-lambdas-at-once wide solve; rho is per-lane (no factorization
    depends on it, so each lambda keeps its own auto-rho + ladder).
    ``trace_len`` records a per-lane residual trace."""
    n, p = Xs.shape
    dtype = Xs.dtype
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams, rho0, alpha,
                                      enet_lambda0_scale)

    if lambda0_pf is not None:
        lambda0 = lambda0_pf
    ops = _wide_ops(Xs, ys, sprad, lambda0, alpha, n, p, pf, bounds)
    engine = make_admm_solver(ops, adapt_rho=True)
    k = ilams.shape[0]
    st = _batched_cold_states(k, p, 1.0, ilams, dtype, aux_dim=n)
    st = st._replace(rho=jnp.broadcast_to(rho, (k,)).astype(dtype),
                     z=jnp.zeros((k, n), dtype),
                     y=jnp.zeros((k, n), dtype),
                     adj_z=jnp.zeros((k, n), dtype),
                     adj_y=jnp.zeros((k, n), dtype))
    if trace_len is None:
        st = make_batched_solver(engine)(st, maxit, eps_abs, eps_rel)
        return st.x, st.it, None
    st, buf = make_batched_traced_solve(engine, trace_len)(
        st, maxit, eps_abs, eps_rel)
    return st.x, st.it, buf


# ---------------------------------------------------------------------------
# Wide regime (p >= n): linearized ADMM, adaptive rho
# ---------------------------------------------------------------------------

def _wide_ops(Xs, ys, sprad, lambda0, alpha, n, p, pf=None,
              bounds=None) -> ProblemOps:
    sqrt_sprad = jnp.sqrt(sprad)

    def next_x(st):
        gamma = sprad
        tmp = st.aux + st.z + st.y / st.rho
        v = st.x - dot(Xs.T, tmp) / gamma
        pen = st.lam / (st.rho * gamma)
        if pf is not None:
            pen = pen * pf
        x_new = enet_prox(v, pen, alpha)
        if bounds is not None:
            x_new = jnp.clip(x_new, bounds[0], bounds[1])
        # Early exit: penalty at/above lambda0 keeps beta = 0.  The
        # reference subtracts an ABSOLUTE 1e-5 slack
        # (reference: src/ADMMLassoWide.h:131-135), which on problems
        # with lambda0 < 1e-5 makes the threshold negative and zeroes
        # every solution; a relative slack has the intended semantics.
        return jnp.where(st.lam > lambda0 * (1.0 - 1e-5),
                         jnp.zeros_like(x_new), x_new)

    def next_z(st, x_new):
        cache_Ax = dot(Xs, x_new)
        z = -(ys + st.y + st.rho * cache_Ax) / (1.0 + st.rho)
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
        dim_main=p, dim_dual=n,
    )


def _wide_engine(Xs, ys, lam_first, rho0, alpha, enet_lambda0_scale,
                 pf=None, lambda0=None, bounds=None):
    """Build the wide-regime engine: cold state, solver, reported
    iterate.  ``lambda0`` overrides the all-zero threshold (the
    penalty-factor-aware grid top when factors are in play)."""
    n, p = Xs.shape
    dtype = Xs.dtype
    lambda0_auto, sprad, rho = _wide_setup(Xs, ys, lam_first, rho0, alpha,
                                           enet_lambda0_scale)
    if lambda0 is None:
        lambda0 = lambda0_auto

    ops = _wide_ops(Xs, ys, sprad, lambda0, alpha, n, p, pf, bounds)
    solve = make_admm_solver(ops, adapt_rho=True)

    st0 = make_state(jnp.zeros((p,), dtype), jnp.zeros((n,), dtype),
                     jnp.zeros((n,), dtype), rho, lam_first,
                     aux=jnp.zeros((n,), dtype), dtype=dtype)
    # Wide solver reports x (reference: src/Lasso.cpp:119).
    return st0, solve, (lambda st: st.x)


# Within the sequential (scan) protocol the gathered active-set solver
# overtakes the dense scan once p crosses ~20k (DESIGN.md "wide-regime
# active-set question").  Scan-mode solves at or past the crossover
# auto-dispatch to it.  The crossover was tuned before the GPU port and
# is not yet measured on the H100 (ROADMAP A5).
_ACTIVESET_AUTO_P = 20000


def _solve_path_wide_activeset(Xs, ys, ilams, rho0, maxit, eps_abs,
                               eps_rel, alpha, enet_lambda0_scale,
                               s_max: Optional[int] = None):
    """Wide-regime scan path with the reference's 4^k-1 active-set
    cadence, realised as dense gathered blocks.  Public entry:
    ``lasso_path(..., path_mode="activeset")`` or any scan-mode wide
    solve at p >= _ACTIVESET_AUTO_P (auto-dispatch).

    The reference's trick (reference: src/ADMMLassoWide.h:86-127): a
    FULL linearized x-update only on iterations 4^k-1; in between,
    update only the current nonzeros, each via one column inner product.
    Its CPU realisation (sparse bookkeeping + per-column AVX dots) is
    hostile to dense matmul hardware, so here the active set is a
    COMPACT GATHERED column block: at each regular (4^k-1) iteration the top-``s_max``
    coordinates by |x| are gathered into a dense (n, S) matrix ``Xa``
    and the iterate is restricted to that support; the in-between
    iterations run the same linearized update against ``Xa`` — two
    (n, S) matvecs instead of two (n, p) — with residuals, tolerances,
    the adaptive-rho ladder and the Boyd test identical to the dense
    engine (admm_tpu/models/lasso.py::_wide_ops).

    Static-shape price: the reference's active set is unbounded; this
    one caps support at S = ``s_max`` (default max(256, p/4)), zeroing
    the smallest coordinates at refresh — exact whenever the solution
    support fits, which the benchmark checks (benchmarks/wide_activeset
    section of DESIGN.md records both timing and accuracy).
    """
    import math as _math

    n, p = Xs.shape
    dtype = Xs.dtype
    lambda0, sprad, rho = _wide_setup(Xs, ys, ilams[0], rho0, alpha,
                                      enet_lambda0_scale)
    S = int(s_max) if s_max else min(p, max(256, p // 4))
    sqrt_sprad = jnp.sqrt(sprad)
    sq_n = jnp.asarray(_math.sqrt(n), dtype)
    sq_p = jnp.asarray(_math.sqrt(p), dtype)

    def refresh(x):
        """Top-S support; returns (x_capped, idx, Xa)."""
        _, idx = lax.top_k(jnp.abs(x), S)
        idx = jnp.sort(idx)
        Xa = jnp.take(Xs, idx, axis=1)
        x_cap = jnp.zeros_like(x).at[idx].set(x[idx])
        return x_cap, idx, Xa

    def step(carry, lam):
        x, z, y, aux, idx, Xa, rho, _ = carry
        # Warm start: keep iterates + rho; schedule restarts at 0 so the
        # first iteration of every lambda is a regular (full) update
        # (reference: src/ADMMLassoWide.h:241-251 keeps iterates too).
        def cond(c):
            st = c
            return jnp.logical_not(st["done"]) & (st["it"] < maxit)

        def body(st):
            x, z, y, aux = st["x"], st["z"], st["y"], st["aux"]
            rho = st["rho"]
            eps_pri = (jnp.maximum(l2norm(aux), l2norm(z)) * eps_rel
                       + sq_n * eps_abs)
            eps_dua = sqrt_sprad * l2norm(y) * eps_rel + sq_p * eps_abs
            tmp = aux + z + y / rho
            pen = st["lam"] / (rho * sprad)
            is_reg = st["it"] == st["next_reg"]

            def regular(_):
                v = x - dot(Xs.T, tmp) / sprad
                x_new = enet_prox(v, pen, alpha)
                x_new = jnp.where(st["lam"] > lambda0 * (1.0 - 1e-5),
                                  jnp.zeros_like(x_new), x_new)
                x_new, idx, Xa = refresh(x_new)
                ax = dot(Xa, x_new[idx])
                return x_new, idx, Xa, ax

            def active(_):
                idx, Xa = st["idx"], st["Xa"]
                xa = x[idx]
                va = xa - dot(Xa.T, tmp) / sprad
                xa_new = enet_prox(va, pen, alpha)
                xa_new = jnp.where(st["lam"] > lambda0 * (1.0 - 1e-5),
                                   jnp.zeros_like(xa_new), xa_new)
                x_new = jnp.zeros_like(x).at[idx].set(xa_new)
                ax = dot(Xa, xa_new)
                return x_new, idx, Xa, ax

            x_new, idx, Xa, ax = lax.cond(is_reg, regular, active,
                                          operand=None)
            z_new = -(ys + y + rho * ax) / (1.0 + rho)
            r_dua = rho * sqrt_sprad * l2norm(z_new - z)
            r = ax + z_new
            r_pri = l2norm(r)
            y_new = y + rho * r
            done = (r_pri < eps_pri) & (r_dua < eps_dua)
            # Adaptive ladder, engine-identical gating
            # (core/engine.py::_adaptive_rho).
            from ..core.engine import _adaptive_rho
            rho_a = _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua)
            rho_new = jnp.where(done | (st["it"] <= 3), rho, rho_a)
            return dict(st, x=x_new, z=z_new, y=y_new, aux=ax, idx=idx,
                        Xa=Xa, rho=rho_new, it=st["it"] + 1, done=done,
                        next_reg=jnp.where(is_reg,
                                           st["next_reg"] * 4 + 3,
                                           st["next_reg"]))

        st = dict(x=x, z=z, y=y, aux=aux, idx=idx, Xa=Xa, rho=rho,
                  lam=lam, it=jnp.asarray(0, jnp.int32),
                  next_reg=jnp.asarray(0, jnp.int32),
                  done=jnp.asarray(False))
        st = lax.while_loop(cond, body, st)
        carry = (st["x"], st["z"], st["y"], st["aux"], st["idx"],
                 st["Xa"], st["rho"], st["it"])
        return carry, (st["x"], st["it"])

    zeros_p = jnp.zeros((p,), dtype)
    zeros_n = jnp.zeros((n,), dtype)
    x0, idx0, Xa0 = refresh(zeros_p)
    carry0 = (x0, zeros_n, zeros_n, zeros_n, idx0, Xa0,
              jnp.asarray(rho, dtype), jnp.asarray(0, jnp.int32))
    _, (coefs, niter) = lax.scan(step, carry0, ilams)
    return coefs, niter, None


def _solve_path_wide(Xs, ys, ilams, rho0, maxit, eps_abs, eps_rel, alpha,
                     enet_lambda0_scale, trace_len=None, pf=None,
                     lambda0_pf=None, bounds=None):
    st0, solve, report = _wide_engine(Xs, ys, ilams[0], rho0, alpha,
                                      enet_lambda0_scale, pf, lambda0_pf,
                                      bounds)
    _, coefs, niter, traces = _scan_path(st0, solve, report, ilams, maxit,
                                         eps_abs, eps_rel, trace_len)
    return coefs, niter, traces


# ---------------------------------------------------------------------------
# Path drivers (standardize -> lambda grid -> solve -> recover)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("standardize_x", "intercept", "nlambda",
                                   "enet_scale", "path_mode",
                                   "shard_data", "trace_len"))
def _path_auto(X, y, nlambda, lambda_min_ratio, rho, maxit, eps_abs,
               eps_rel, alpha, weights=None, pf=None, limits=None, *,
               standardize_x, intercept, enet_scale, path_mode,
               shard_data=False, trace_len=None):
    """Auto lambda grid: log-linear from lambda0 down to ratio*lambda0
    (reference: src/Lasso.cpp:78-89).  With penalty factors the grid top
    is the factor-aware KKT boundary max_j |x_j'y| / pf_j over PENALIZED
    coordinates (glmnet's rule; zero-factor coordinates never gate the
    grid)."""
    n = X.shape[0]
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    Xty = dot(Xs.T, ys)
    Xty_abs = jnp.abs(Xty)
    if limits is not None:
        # Bounds-aware KKT boundary for beta = 0: the gradient only
        # matters along FEASIBLE directions — positive movement needs
        # up_j > 0, negative needs lo_j < 0 (0 is always feasible,
        # validated by the driver).
        lo_std = limits[0] * stats.scale_x / stats.scale_y
        up_std = limits[1] * stats.scale_x / stats.scale_y
        dir_pos = jnp.where(up_std > 0, Xty, -jnp.inf)
        dir_neg = jnp.where(lo_std < 0, -Xty, -jnp.inf)
        Xty_abs = jnp.maximum(jnp.maximum(dir_pos, dir_neg), 0.0)
    if pf is None:
        lam0_int = jnp.max(Xty_abs)
    else:
        lam0_int = jnp.max(jnp.where(
            pf > 0, Xty_abs / jnp.maximum(pf, 1e-12), 0.0))
    if enet_scale:
        lam0_int = lam0_int / (alpha + 1e-4)
    lmax = lam0_int / n * stats.scale_y
    lmin = lambda_min_ratio * lmax
    lams = jnp.exp(jnp.linspace(jnp.log(lmax), jnp.log(lmin), nlambda))
    return _path_from_lams(Xs, ys, stats, lams, rho, maxit, eps_abs,
                           eps_rel, alpha, standardize_x, intercept,
                           enet_scale, path_mode, shard_data, trace_len,
                           pf, limits)


@partial(jax.jit, static_argnames=("standardize_x", "intercept",
                                   "enet_scale", "path_mode",
                                   "shard_data", "trace_len"))
def _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel, alpha,
               weights=None, pf=None, limits=None, *, standardize_x,
               intercept, enet_scale, path_mode, shard_data=False,
               trace_len=None):
    Xs, ys, stats = standardize(X, y, standardize_x=standardize_x,
                                intercept=intercept, weights=weights)
    return _path_from_lams(Xs, ys, stats, lams, rho, maxit, eps_abs,
                           eps_rel, alpha, standardize_x, intercept,
                           enet_scale, path_mode, shard_data, trace_len,
                           pf, limits)


def _path_from_lams(Xs, ys, stats: StdStats, lams, rho, maxit, eps_abs,
                    eps_rel, alpha, standardize_x, intercept, enet_scale,
                    path_mode="scan", shard_data=False, trace_len=None,
                    pf=None, limits=None):
    n, p = Xs.shape
    # Coefficient box on the STANDARDIZED scale: coef_orig =
    # coef_std * scale_y / scale_x, so the original-scale limits map by
    # the inverse factor (0 stays 0 — feasibility is scale-free).
    bounds = None
    if limits is not None:
        bounds = (limits[0] * stats.scale_x / stats.scale_y,
                  limits[1] * stats.scale_x / stats.scale_y)
    # Penalty-factor-aware all-zero threshold for the wide engines'
    # early exit: exact KKT boundary when every factor is positive; +inf
    # (exit disabled) when any coordinate is unpenalized — beta never
    # becomes all-zero then.
    lambda0_pf = None
    if pf is not None:
        Xty_abs = jnp.abs(dot(Xs.T, ys))
        kkt = jnp.max(jnp.where(pf > 0,
                                Xty_abs / jnp.maximum(pf, 1e-12), 0.0))
        kkt = kkt / (alpha + 1e-4 if enet_scale else alpha)
        lambda0_pf = jnp.where(jnp.all(pf > 0), kkt, jnp.inf)
    # Internal penalty scale (reference: src/Lasso.cpp:99).
    ilams = lams * n / stats.scale_y
    if n > p:
        if path_mode == "batch":
            coefs, niter, traces = _solve_path_tall_batch(
                Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha,
                trace_len, pf, bounds)
        else:
            coefs, niter, traces = _solve_path_tall(
                Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha,
                trace_len, pf, bounds)
    else:
        if path_mode == "batch":
            coefs, niter, traces = _solve_path_wide_batch(
                Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha,
                enet_scale, trace_len, pf, lambda0_pf, bounds)
        elif (path_mode == "activeset"
              or (path_mode == "scan" and trace_len is None and pf is None
                  and bounds is None
                  and not shard_data and p >= _ACTIVESET_AUTO_P)):
            # The reference's 4^k-1 cadence, gathered-column realisation
            # (reference: src/ADMMLassoWide.h:86-127); the measured
            # scan-protocol winner at very large p (DESIGN.md).
            coefs, niter, traces = _solve_path_wide_activeset(
                Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha,
                enet_scale)
        else:
            coefs, niter, traces = _solve_path_wide(
                Xs, ys, ilams, rho, maxit, eps_abs, eps_rel, alpha,
                enet_scale, trace_len, pf, lambda0_pf, bounds)
    beta0, coef = recover(stats, coefs, standardize_x=standardize_x,
                          intercept=intercept)
    return PathResult(lambdas=lams, beta0=beta0, coef=coef, niter=niter,
                      trace=traces)


def lasso_path(X, y, *, lambdas: Optional[jnp.ndarray] = None,
               nlambda: int = 100, lambda_min_ratio: Optional[float] = None,
               standardize: bool = True, intercept: bool = True,
               maxit: int = 10000, eps_abs: float = 1e-5,
               eps_rel: float = 1e-5, rho: float = -1.0,
               alpha: float = 1.0, _enet_scale: bool = False,
               path_mode: str = "scan", data_mesh=None,
               trace_len: Optional[int] = None,
               weights: Optional[jnp.ndarray] = None,
               penalty_factor: Optional[jnp.ndarray] = None,
               lower_limits=None, upper_limits=None, exclude=None,
               offset: Optional[jnp.ndarray] = None,
               dfmax: Optional[int] = None, pmax: Optional[int] = None,
               dtype=jnp.float32) -> PathResult:
    """Solve the full Lasso / Elastic-Net lambda path on device.

    ``alpha=1`` is the Lasso; ``alpha<1`` mixes in ridge (set
    ``_enet_scale=True`` to reproduce the reference Enet's lambda0
    inflation, reference: src/ADMMEnet.h:56).  Defaults mirror the
    reference R API (reference: R/30_admm_lasso.R:31-49).

    ``path_mode``: "scan" (default) solves lambdas sequentially with
    warm starts, matching the reference's protocol and iteration counts;
    "batch" solves all lambdas simultaneously as batched lanes (see
    make_batched_solver) — same solutions, usually much faster;
    "activeset" (wide regime only) is the reference's 4^k-1 active-set
    cadence as a gathered column block — the scan-protocol winner at
    very large p (DESIGN.md), to which scan-mode solves auto-dispatch
    at p >= 20000.

    ``data_mesh`` (extension — operator parallelism): a
    ``jax.sharding.Mesh`` over which the data matrix is sharded along
    its ROW axis.  The serial algorithm is unchanged; XLA's SPMD
    partitioner turns the data-touching reductions — standardization
    moments, the Gram ``X'X``, ``X'y``, and the wide path's per-iteration
    ``X v`` / ``X'r`` matvecs — into per-shard partial computations plus
    collectives, so an n too large for one device's memory streams
    through the mesh.  This is the mesh equivalent of the reference's
    implicit BLAS threading (reference: src/Makevars:3-4); the
    (p, p)-sized solve state stays replicated.  Results are identical to
    replicated execution up to reduction order.

    ``weights`` (extension — glmnet's ``weights`` argument):
    observation weights, normalized to sum to n; moments, the lambda
    grid and the quadratic loss all become weighted (an integer weight
    of k is exactly equivalent to repeating the row k times — tested).

    ``penalty_factor`` (extension — glmnet's ``penalty.factor``):
    per-coefficient nonnegative penalty multipliers, rescaled so they
    sum to p (glmnet convention; multiplying all factors by a constant
    changes nothing).  Coordinate j is penalized ``lambda * pf_j``
    (both the l1 and the ridge part for the Elastic Net); ``pf_j = 0``
    leaves it unpenalized (always in the model); the auto grid top is
    the factor-aware KKT boundary.  Exactly equivalent to the column
    rescaling x_j -> x_j / pf_j with a uniform penalty (tested).
    Not available on the active-set path (it carries scalar lane
    penalties).

    ``lower_limits`` / ``upper_limits`` (extension — glmnet's
    ``lower.limits``/``upper.limits``): coefficient box constraints on
    the ORIGINAL scale, scalar or (p,); must satisfy ``lower <= 0 <=
    upper`` (glmnet's requirement — 0 stays feasible).  The prox gains
    an exact clip (penalty and box are both separable), the auto grid
    top becomes the feasible-direction KKT boundary (e.g. the
    NONNEGATIVE lasso via ``lower_limits=0``), and the XLA engines are
    used.  Oracle: sklearn ``Lasso(positive=True)``
    (tests/test_lasso.py).

    ``exclude`` (glmnet's ``exclude``): indices of variables forced
    out of the model — exactly the lower=upper=0 box at those
    coordinates (merged into any user limits).

    ``offset`` (glmnet's ``offset``): a fixed per-row additive term in
    the linear predictor, ``eta = b0 + X b + offset``.  For the
    gaussian family this is an exact response shift (the fit runs on
    ``y - offset``); pass the same ``offset`` to :func:`admm_tpu.predict`
    as glmnet's ``newoffset``.

    ``dfmax`` / ``pmax`` (glmnet): stop the returned path at the first
    grid point with more than dfmax nonzero coefficients (pmax bounds
    the EVER-active union); the result simply has fewer lambdas, as in
    glmnet.

    ``trace_len``: record the first ``trace_len`` iterations'
    (eps_primal, resid_primal, eps_dual, resid_dual, rho) per lambda in
    ``result.trace`` — the reference's (dead) residual printers as
    arrays (reference: src/ADMMBase.h:111-146).  Tracing follows the
    active ``path_mode``: "scan" records the warm-started sequential
    protocol (the reference's counters), "batch" records each
    cold-start LANE's own iterations (frozen lanes stop recording);
    "activeset" has no trace and falls back to the traced scan.
    """
    if path_mode not in ("scan", "batch", "activeset"):
        raise ValueError(
            "path_mode must be 'scan', 'batch' or 'activeset'")
    if trace_len is not None:
        if path_mode != "batch":
            path_mode = "scan"
        trace_len = int(trace_len)
    X = jnp.asarray(X, dtype)
    y = jnp.asarray(y, dtype)
    if offset is not None:
        # glmnet's gaussian offset: an exact response shift (eta =
        # b0 + X b + offset); supply the same newoffset at prediction.
        off = jnp.asarray(offset, dtype).ravel()
        if off.shape != y.shape:
            raise ValueError("offset must have one entry per row")
        y = y - off
    n, p = X.shape
    if path_mode == "activeset" and n > p:
        raise ValueError("path_mode='activeset' is the wide-regime "
                         "(p >= n) solver; tall problems use the "
                         "factorized engines")
    if path_mode == "activeset":
        if penalty_factor is not None:
            raise ValueError("penalty_factor is not supported by the "
                             "active-set path (per-coordinate "
                             "thresholds); use 'batch' or 'scan'")
        if (lower_limits is not None or upper_limits is not None
                or exclude is not None):
            raise ValueError("coefficient limits are not supported by "
                             "the active-set path; use 'batch' or "
                             "'scan'")
    pf, limits = validate_pf_limits(penalty_factor, exclude,
                                    lower_limits, upper_limits, p, dtype)
    if data_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        axes = tuple(data_mesh.axis_names)
        X = jax.device_put(X, NamedSharding(data_mesh,
                                            PartitionSpec(axes, None)))
        y = jax.device_put(y, NamedSharding(data_mesh,
                                            PartitionSpec(axes)))
    shard = data_mesh is not None
    if lambda_min_ratio is None:
        lambda_min_ratio = 0.01 if n < p else 1e-4
    w = None if weights is None else jnp.asarray(weights, dtype)
    if lambdas is not None:
        lams = jnp.sort(jnp.asarray(lambdas, dtype))[::-1]
        res = _path_user(X, y, lams, rho, maxit, eps_abs, eps_rel, alpha,
                         w, pf, limits, standardize_x=standardize,
                         intercept=intercept,
                         enet_scale=_enet_scale, path_mode=path_mode,
                         shard_data=shard, trace_len=trace_len)
    else:
        res = _path_auto(X, y, int(nlambda), lambda_min_ratio, rho,
                         maxit, eps_abs, eps_rel, alpha, w, pf, limits,
                         standardize_x=standardize,
                         intercept=intercept, enet_scale=_enet_scale,
                         path_mode=path_mode, shard_data=shard,
                         trace_len=trace_len)
    if dfmax is not None or pmax is not None:
        res = _truncate_path(res, dfmax, pmax)
    return res


def enet_path(X, y, *, alpha: float = 1.0, **kw) -> PathResult:
    """Elastic-Net path (reference: src/Enet.cpp, R/40_admm_enet.R)."""
    return lasso_path(X, y, alpha=alpha, _enet_scale=True, **kw)


def adaptive_lasso_path(X, y, *, gamma: float = 1.0, init="auto",
                        init_ridge: float = 1e-3,
                        weights: Optional[jnp.ndarray] = None,
                        **kw) -> PathResult:
    """The ADAPTIVE lasso (Zou 2006): a two-stage path whose penalty is
    rescaled per coordinate by ``1/|b_init|^gamma`` — consistent
    variable selection (the oracle property) where the plain lasso
    over-shrinks strong signals.

    Stage 1 fits ``b_init``: OLS when n > p (Zou's choice), a ridge
    fit with penalty ``init_ridge * max|X'y|/n`` otherwise, or pass
    ``init=`` an explicit (p,) vector.  Stage 2 is exactly
    ``lasso_path(penalty_factor=1/|b_init|^gamma)`` — glmnet rescales
    factors to sum p, which only rescales the lambda axis (extension;
    reference has no adaptive weighting).  All ``lasso_path`` keywords
    pass through."""
    Xn = np.asarray(X, np.float64)
    yn = np.asarray(y, np.float64).ravel()
    n, p = Xn.shape
    if isinstance(init, str):
        if init not in ("auto", "ols", "ridge"):
            raise ValueError("init must be 'auto', 'ols', 'ridge' or "
                             "a coefficient vector")
        wn = (np.ones(n) if weights is None
              else np.asarray(weights, np.float64).ravel())
        sw = np.sqrt(wn * n / wn.sum())
        Xc = Xn - (wn @ Xn) / wn.sum()
        yc = yn - (wn @ yn) / wn.sum()
        Xw, yw = Xc * sw[:, None], yc * sw
        use_ols = init == "ols" or (init == "auto" and n > p)
        if use_ols and n <= p:
            raise ValueError("init='ols' needs n > p; use 'ridge'")
        lam_r = 0.0 if use_ols else (init_ridge
                                     * np.abs(Xw.T @ yw).max() / n)
        b_init = np.linalg.solve(Xw.T @ Xw + n * lam_r * np.eye(p),
                                 Xw.T @ yw)
    else:
        b_init = np.asarray(init, np.float64).ravel()
        if b_init.shape != (p,):
            raise ValueError("init must have one entry per column of x")
    # Zero init coordinates get an (effectively) infinite penalty —
    # implemented as a huge finite factor so the grid stays finite.
    a = np.abs(b_init) ** float(gamma)
    pf = np.where(a > 1e-12, 1.0 / np.maximum(a, 1e-12), 1e12)
    return lasso_path(X, y, penalty_factor=pf, weights=weights, **kw)
