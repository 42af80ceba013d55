"""Generic ADMM / accelerated (fast) ADMM iteration engines.

The reference implements two abstract C++ engines as template base classes
with virtual-method hooks (reference: src/ADMMBase.h:13-221 for vanilla
ADMM with adaptive rho, src/FADMMBase.h:17-270 for the Goldstein et al.
2014 accelerated variant with restart).  The design replaces
the class hierarchy with:

  * an immutable solver state pytree (:class:`ADMMState`),
  * a :class:`ProblemOps` bundle of pure functions describing one model
    (the x-update, z-update, residual and tolerance formulas), and
  * engine factories that return a jit-safe ``solve(state, maxit, ...)``
    built on ``lax.while_loop``.

Everything — including the Boyd stopping rule, the adaptive-rho ladder and
the Nesterov acceleration-with-restart logic — is expressed as pure
functions of the state so the entire lambda path can run inside a single
XLA program (``lax.scan`` over lambda around ``lax.while_loop`` over
iterations).

Problem template (as in reference: src/ADMMBase.h:7-11)::

    minimize f(x) + g(z)   s.t.  A x + B z = c

Stopping rule (Boyd et al. 2011, section 3.3; reference:
src/ADMMBase.h:49-83)::

    eps_primal = sqrt(dim_dual) * eps_abs + eps_rel * max(||Ax||,||Bz||,||c||)
    eps_dual   = sqrt(dim_main) * eps_abs + eps_rel * ||A'y||
    converged  = ||r_primal|| < eps_primal  and  rho*||A'B dz|| < eps_dual
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax


BIG_RESID = 9999.0  # sentinel used by the reference for "not yet computed"


class ADMMState(NamedTuple):
    """Immutable solver state; a pytree carried through scan/while_loop.

    ``x``/``z``/``y`` are the primal, auxiliary and dual iterates.  The
    accelerated engine additionally uses the extrapolated ``adj_z``/``adj_y``
    and the Nesterov coefficient ``adj_a`` plus combined-residual ``adj_c``
    (reference: src/FADMMBase.h:31-36).  ``aux`` carries model-specific
    cached quantities (e.g. the wide-Lasso ``cache_Ax``,
    reference: src/ADMMLassoWide.h:46).
    """

    x: Any
    z: Any
    y: Any
    adj_z: Any
    adj_y: Any
    aux: Any
    adj_a: jnp.ndarray
    adj_c: jnp.ndarray
    rho: jnp.ndarray
    lam: jnp.ndarray
    eps_pri: jnp.ndarray
    eps_dua: jnp.ndarray
    r_pri: jnp.ndarray
    r_dua: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


class ProblemOps(NamedTuple):
    """Pure-function hooks describing one ADMM model.

    The equivalents of the virtual methods of ``ADMMBase`` /
    ``FADMMBase`` (reference: src/ADMMBase.h:35-47).  Each callable takes
    the current :class:`ADMMState` (plus the freshly computed iterates
    where noted) and returns arrays; all must be jit-traceable.
    """

    # x_new = argmin_x L_rho(x, z, y)   -> new x iterate
    next_x: Callable[[ADMMState], Any]
    # (z_new, aux_new) given the fresh x
    next_z: Callable[[ADMMState, Any], Any]
    # r = A x_new + B z_new - c  (vector of dual dimension)
    primal_residual: Callable[[ADMMState, Any, Any, Any], jnp.ndarray]
    # max(||Ax||, ||Bz||, ||c||) with the *pre-update* iterates
    eps_primal_scale: Callable[[ADMMState], jnp.ndarray]
    # ||A'y|| with the pre-update dual
    eps_dual_scale: Callable[[ADMMState], jnp.ndarray]
    # rho * ||A'B (z_new - z_old)||
    dual_residual: Callable[[ADMMState, Any], jnp.ndarray]
    # ||B (z_new - adj_z)||^2  (accelerated engine only; may be None)
    combined_extra: Optional[Callable[[ADMMState, Any], jnp.ndarray]]
    dim_main: int
    dim_dual: int


def make_state(x, z, y, rho, lam, *, aux=None, adj_z=None, adj_y=None,
               dtype=None) -> ADMMState:
    """Build a cold-start state: zero iterates, sentinel residuals.

    Mirrors ``init()`` of the reference solvers
    (reference: src/ADMMLassoTall.h:179-216).
    """
    if dtype is None:
        dtype = jnp.asarray(x).dtype
    f = lambda s: jnp.asarray(s, dtype=dtype)
    return ADMMState(
        x=x, z=z, y=y,
        adj_z=z if adj_z is None else adj_z,
        adj_y=y if adj_y is None else adj_y,
        aux=aux,
        adj_a=f(1.0), adj_c=f(BIG_RESID),
        rho=f(rho), lam=f(lam),
        eps_pri=f(0.0), eps_dua=f(0.0),
        r_pri=f(BIG_RESID), r_dua=f(BIG_RESID),
        it=jnp.asarray(0, dtype=jnp.int32),
        done=jnp.asarray(False),
    )


def warm_start(state: ADMMState, lam) -> ADMMState:
    """Re-arm the solver for the next lambda, keeping iterates and rho.

    This is the lambda-path warm-start protocol (reference:
    src/ADMMLassoTall.h:219-230): the penalty and the residual sentinels
    are reset; x, z, y and rho carry over.

    Deliberate fix over the reference: the reference also carries the
    accelerated engine's momentum state (adj_a, adj_c, adj_z, adj_y)
    across lambdas.  A converged solve leaves ``adj_c ~ 0``, so at the
    next lambda the combined residual can never decrease below
    ``0.999*adj_c`` and the engine is stuck in permanent restart mode
    with one-step-stale extrapolation points — which can create a
    period-2 oscillation whose phase *falsely satisfies* the Boyd
    stopping test within a handful of iterations (observed: 1e-2
    coefficient error at interior path points).  Re-synchronising the
    momentum to the warm iterates (a standard Nesterov restart) removes
    the pathology while keeping all warm-start value in (x, z, y, rho).
    """
    dtype = state.rho.dtype
    return state._replace(
        lam=jnp.asarray(lam, dtype=dtype),
        adj_z=state.z,
        adj_y=state.y,
        adj_a=jnp.asarray(1.0, dtype=dtype),
        adj_c=jnp.asarray(BIG_RESID, dtype=dtype),
        eps_pri=jnp.asarray(0.0, dtype=dtype),
        eps_dua=jnp.asarray(0.0, dtype=dtype),
        r_pri=jnp.asarray(BIG_RESID, dtype=dtype),
        r_dua=jnp.asarray(BIG_RESID, dtype=dtype),
        it=jnp.asarray(0, dtype=jnp.int32),
        done=jnp.asarray(False),
    )


def _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua):
    """The reference's adaptive-rho ladder (reference: src/ADMMBase.h:85-109).

    x2 / :2 when one scaled residual dominates by 10x, then a 1.2 nudge
    toward whichever residual has already converged.  No factorization
    depends on rho in any engine where this is enabled, so the update is
    free (reference disables it exactly where a refactorization would be
    required, src/ADMMLassoTall.h:96-97).
    """
    ratio_p = r_pri / eps_pri
    ratio_d = r_dua / eps_dua
    rho = jnp.where(ratio_p > 10.0 * ratio_d, rho * 2.0, rho)
    rho = jnp.where(ratio_d > 10.0 * ratio_p, rho * 0.5, rho)
    rho = jnp.where(r_pri < eps_pri, rho / 1.2, rho)
    rho = jnp.where(r_dua < eps_dua, rho * 1.2, rho)
    return rho


def _tolerances(ops: ProblemOps, state: ADMMState, eps_abs, eps_rel):
    dtype = state.rho.dtype
    sq_dual = jnp.asarray(math.sqrt(ops.dim_dual), dtype)
    sq_main = jnp.asarray(math.sqrt(ops.dim_main), dtype)
    eps_pri = ops.eps_primal_scale(state) * eps_rel + sq_dual * eps_abs
    eps_dua = ops.eps_dual_scale(state) * eps_rel + sq_main * eps_abs
    return eps_pri, eps_dua


def make_admm_solver(ops: ProblemOps, *, adapt_rho: bool = True,
                     rho_start_iter: int = 3):
    """Vanilla ADMM engine (reference: src/ADMMBase.h:192-216).

    Iteration: x-update -> z-update -> dual ascent ``y += rho r`` ->
    convergence test -> adaptive rho (after ``rho_start_iter``).

    Returns ``solve(state, maxit, eps_abs, eps_rel) -> state`` where the
    returned ``state.it`` is the reference's ``niter`` (number of
    iterations run, counting the converging one).
    """

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        eps_pri, eps_dua = _tolerances(ops, state, eps_abs, eps_rel)
        x_new = ops.next_x(state)
        z_new, aux_new = ops.next_z(state, x_new)
        r_dua = ops.dual_residual(state, z_new)
        r = ops.primal_residual(state, x_new, z_new, aux_new)
        r_pri = jnp.sqrt(jnp.sum(r * r))
        y_new = state.y + state.rho * r
        done = (r_pri < eps_pri) & (r_dua < eps_dua)
        rho = state.rho
        if adapt_rho:
            rho_adapted = _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua)
            rho = jnp.where(done | (state.it <= rho_start_iter), rho,
                            rho_adapted)
        return state._replace(
            x=x_new, z=z_new, y=y_new, aux=aux_new, rho=rho,
            eps_pri=eps_pri, eps_dua=eps_dua, r_pri=r_pri, r_dua=r_dua,
            it=state.it + 1, done=done,
        )

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        eps_abs = jnp.asarray(eps_abs, state.rho.dtype)
        eps_rel = jnp.asarray(eps_rel, state.rho.dtype)

        def cond(s):
            return jnp.logical_not(s.done) & (s.it < maxit)

        return lax.while_loop(cond, lambda s: body(s, eps_abs, eps_rel),
                              state)

    # Expose the single-iteration body for the tracing harness
    # (admm_tpu.diag.trace).
    solve.body = lambda st, eps_abs, eps_rel: body(
        st, jnp.asarray(eps_abs, st.rho.dtype),
        jnp.asarray(eps_rel, st.rho.dtype))
    return solve


def make_traced_solve(solve, trace_len: int):
    """Wrap an engine's ``solve`` so a per-iteration residual trace rides
    the while_loop carry.

    The reference has residual-table printers wired into its engines but
    commented out of the loops (reference: src/ADMMBase.h:111-146,
    call sites :196,204,213).  Here the trace is first-class AND free of
    the printers' cost model: a preallocated ``(trace_len, 5)`` buffer of
    ``(eps_primal, resid_primal, eps_dual, resid_dual, rho)`` is updated
    in-place inside the SAME early-exiting ``lax.while_loop`` — no fixed
    iteration count, no host round-trips.  Rows beyond convergence stay
    NaN; iterations beyond ``trace_len`` overwrite the last row.

    Returns ``solve_traced(state, maxit, eps_abs, eps_rel) ->
    (state, buffer)``.
    """

    def solve_traced(state: ADMMState, maxit, eps_abs, eps_rel):
        dtype = state.rho.dtype
        eps_abs = jnp.asarray(eps_abs, dtype)
        eps_rel = jnp.asarray(eps_rel, dtype)
        buf0 = jnp.full((trace_len, 5), jnp.nan, dtype)

        def cond(carry):
            s, _ = carry
            return jnp.logical_not(s.done) & (s.it < maxit)

        def body(carry):
            s, buf = carry
            s2 = solve.body(s, eps_abs, eps_rel)
            row = jnp.stack([s2.eps_pri, s2.r_pri, s2.eps_dua, s2.r_dua,
                             s2.rho])
            idx = jnp.minimum(s.it, trace_len - 1)
            buf = lax.dynamic_update_slice(
                buf, row[None, :], (idx, jnp.zeros((), idx.dtype)))
            return (s2, buf)

        return lax.while_loop(cond, body, (state, buf0))

    return solve_traced


def make_batched_solver(solve):
    """Batched-lane variant of an engine: one lane per lambda.

    The reference solves the lambda path sequentially with warm starts
    (reference: src/Lasso.cpp:97-124) because on CPU each solve is a
    chain of BLAS-2 calls.  On an accelerator there is a second option:
    stack all lambdas as a leading lane axis and run ONE while_loop whose
    body is the single-lambda engine body ``vmap``-ed over lanes — the
    per-iteration p x p matvec becomes a (k, p) x (p, p) matmul with k
    times the arithmetic intensity, and the loop runs until every lane
    has converged (converged lanes are frozen, so their ``it`` is the
    per-lambda iteration count).  Cold starts need more iterations per
    lambda than warm starts, but the matmul absorbs the extra lanes.

    Works for any engine built by :func:`make_admm_solver` /
    :func:`make_fadmm_solver` whose ProblemOps are vmappable.
    """

    def solve_batched(states: ADMMState, maxit, eps_abs, eps_rel):
        eps_abs = jnp.asarray(eps_abs, states.rho.dtype)
        eps_rel = jnp.asarray(eps_rel, states.rho.dtype)
        body = jax.vmap(lambda s: solve.body(s, eps_abs, eps_rel))

        def freeze(old, new):
            def f(a, b):
                d = old.done.reshape(old.done.shape
                                     + (1,) * (b.ndim - old.done.ndim))
                return jnp.where(d, a, b)
            return jax.tree.map(f, old, new)

        def wl_body(st):
            return freeze(st, body(st))

        def cond(st):
            return jnp.any(jnp.logical_not(st.done) & (st.it < maxit))

        return lax.while_loop(cond, wl_body, states)

    return solve_batched


def make_batched_traced_solve(solve, trace_len: int):
    """Batched-lane engine with a PER-LANE residual trace riding the
    carry — the batch-mode counterpart of :func:`make_traced_solve`
    (the batched protocol was previously unobservable per-iteration).

    Each lane l records its own (eps_primal, resid_primal, eps_dual,
    resid_dual, rho) at row ``it_l`` of a preallocated (k, trace_len, 5)
    buffer; frozen (converged) lanes stop recording, exactly as they
    stop iterating, so the recorded row count equals the per-lane
    ``niter``.  Rows beyond convergence stay NaN.

    Returns ``solve_traced(states, maxit, eps_abs, eps_rel) ->
    (states, buffer)``.
    """

    def solve_batched_traced(states: ADMMState, maxit, eps_abs, eps_rel):
        dtype = states.rho.dtype
        eps_abs = jnp.asarray(eps_abs, dtype)
        eps_rel = jnp.asarray(eps_rel, dtype)
        k = states.rho.shape[0]
        body = jax.vmap(lambda s: solve.body(s, eps_abs, eps_rel))
        buf0 = jnp.full((k, trace_len, 5), jnp.nan, dtype)

        def freeze(old, new):
            def f(a, b):
                d = old.done.reshape(old.done.shape
                                     + (1,) * (b.ndim - old.done.ndim))
                return jnp.where(d, a, b)
            return jax.tree.map(f, old, new)

        def record(buf, row, idx, active):
            def one(b, r, i, w):
                upd = lax.dynamic_update_slice(b, r[None, :],
                                               (i, jnp.zeros((), i.dtype)))
                return jnp.where(w, upd, b)
            return jax.vmap(one)(buf, row, idx, active)

        def wl_body(carry):
            st, buf = carry
            st2 = freeze(st, body(st))
            rows = jnp.stack([st2.eps_pri, st2.r_pri, st2.eps_dua,
                              st2.r_dua, st2.rho], axis=-1)   # (k, 5)
            idx = jnp.minimum(st.it, trace_len - 1)
            buf = record(buf, rows, idx, jnp.logical_not(st.done))
            return (st2, buf)

        def cond(carry):
            st, _ = carry
            return jnp.any(jnp.logical_not(st.done) & (st.it < maxit))

        return lax.while_loop(cond, wl_body, (states, buf0))

    return solve_batched_traced


def make_fadmm_solver(ops: ProblemOps, *, adapt_rho: bool = False,
                      rho_start_iter: int = 5, restart_tol: float = 0.999):
    """Accelerated (fast) ADMM with restart, Goldstein et al. 2014.

    Reference: src/FADMMBase.h:219-265.  The combined residual
    ``c_k = rho ||r||^2 + rho ||B(z - adj_z)||^2`` gates Nesterov
    extrapolation of (z, y); when it fails to decrease by ``restart_tol``
    the momentum is reset (restart).  The dual ascent uses the
    extrapolated multiplier: ``y = adj_y + rho r``
    (reference: src/FADMMBase.h:203-211).
    """
    assert ops.combined_extra is not None, "FADMM needs combined_extra"

    def body(state: ADMMState, eps_abs, eps_rel) -> ADMMState:
        old_z, old_y = state.z, state.y
        eps_pri, eps_dua = _tolerances(ops, state, eps_abs, eps_rel)
        x_new = ops.next_x(state)
        z_new, aux_new = ops.next_z(state, x_new)
        r_dua = ops.dual_residual(state, z_new)  # vs old_z == state.z
        r = ops.primal_residual(state, x_new, z_new, aux_new)
        r_pri = jnp.sqrt(jnp.sum(r * r))
        y_new = state.adj_y + state.rho * r
        done = (r_pri < eps_pri) & (r_dua < eps_dua)

        # Acceleration / restart (reference: src/FADMMBase.h:240-256).
        c_new = state.rho * r_pri * r_pri \
            + state.rho * ops.combined_extra(state, z_new)
        accelerate = c_new < restart_tol * state.adj_c
        a_acc = 0.5 + 0.5 * jnp.sqrt(1.0 + 4.0 * state.adj_a * state.adj_a)
        ratio = (state.adj_a - 1.0) / a_acc
        lin = lambda new, old: (1.0 + ratio) * new - ratio * old
        adj_z = jax.tree.map(
            lambda zn, zo: jnp.where(accelerate, lin(zn, zo), zo),
            z_new, old_z)
        adj_y = jax.tree.map(
            lambda yn, yo: jnp.where(accelerate, lin(yn, yo), yo),
            y_new, old_y)
        adj_a = jnp.where(accelerate, a_acc, 1.0)
        adj_c = jnp.where(accelerate, c_new, state.adj_c / restart_tol)

        # The reference breaks out *before* applying acceleration on the
        # converging iteration; gate so warm starts see identical adj_*.
        keep = lambda new, old: jnp.where(done, old, new)
        adj_z = jax.tree.map(keep, adj_z, state.adj_z)
        adj_y = jax.tree.map(keep, adj_y, state.adj_y)
        adj_a = keep(adj_a, state.adj_a)
        adj_c = keep(adj_c, state.adj_c)

        rho = state.rho
        if adapt_rho:
            rho_adapted = _adaptive_rho(rho, r_pri, eps_pri, r_dua, eps_dua)
            rho = jnp.where(done | (state.it <= rho_start_iter), rho,
                            rho_adapted)
        return state._replace(
            x=x_new, z=z_new, y=y_new, aux=aux_new,
            adj_z=adj_z, adj_y=adj_y, adj_a=adj_a, adj_c=adj_c, rho=rho,
            eps_pri=eps_pri, eps_dua=eps_dua, r_pri=r_pri, r_dua=r_dua,
            it=state.it + 1, done=done,
        )

    def solve(state: ADMMState, maxit, eps_abs, eps_rel) -> ADMMState:
        eps_abs = jnp.asarray(eps_abs, state.rho.dtype)
        eps_rel = jnp.asarray(eps_rel, state.rho.dtype)

        def cond(s):
            return jnp.logical_not(s.done) & (s.it < maxit)

        return lax.while_loop(cond, lambda s: body(s, eps_abs, eps_rel),
                              state)

    solve.body = lambda st, eps_abs, eps_rel: body(
        st, jnp.asarray(eps_abs, st.rho.dtype),
        jnp.asarray(eps_rel, st.rho.dtype))
    return solve
