"""First-class per-iteration convergence tracing.

The reference has residual-trace table printers wired into both engines
but commented out of the solve loops (reference: src/ADMMBase.h:111-146
with dead call sites at :196,204,213 — SURVEY.md section 5).  The
rebuild makes tracing first-class: a fixed-length ``lax.scan``
records (eps_primal, resid_primal, eps_dual, resid_dual, rho) for every
iteration on device, with no host round-trips, and returns the arrays.

Because the trace runs a *fixed* number of iterations (scan, not
while_loop), iterations after convergence are frozen (the state stops
updating once ``done``), which keeps the trace jit-compatible.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.engine import ADMMState


class Trace(NamedTuple):
    eps_primal: jnp.ndarray
    resid_primal: jnp.ndarray
    eps_dual: jnp.ndarray
    resid_dual: jnp.ndarray
    rho: jnp.ndarray
    niter: jnp.ndarray


def traced_solve(body_fn, state: ADMMState, num_iters: int):
    """Run ``num_iters`` engine-body steps, recording residuals.

    ``body_fn(state) -> state`` is the single-iteration body of either
    engine (obtain it by building the engine's solve with maxit=1, or use
    :func:`admm_tpu.diag.make_traced_solver`).  Iterations after
    convergence hold the state fixed.
    """

    def step(st, _):
        new = body_fn(st)
        st = jax.tree.map(lambda a, b: jnp.where(st.done, a, b), st, new)
        rec = (st.eps_pri, st.r_pri, st.eps_dua, st.r_dua, st.rho)
        return st, rec

    final, recs = lax.scan(step, state, None, length=num_iters)
    return final, Trace(eps_primal=recs[0], resid_primal=recs[1],
                        eps_dual=recs[2], resid_dual=recs[3], rho=recs[4],
                        niter=final.it)


def trace_from_buffer(buf, niter=None) -> Trace:
    """Build a :class:`Trace` from a ``(trace_len, 5)`` buffer of
    (eps_pri, r_pri, eps_dua, r_dua, rho) rows as produced by
    ``core.engine.make_traced_solve`` / the ``trace_len`` option of the
    model drivers.  Rows past convergence are NaN; ``niter`` defaults to
    the number of recorded rows."""
    import numpy as np

    buf = np.asarray(buf)
    if niter is None:
        niter = int(np.sum(~np.isnan(buf[:, 0])))
    return Trace(eps_primal=buf[:, 0], resid_primal=buf[:, 1],
                 eps_dual=buf[:, 2], resid_dual=buf[:, 3], rho=buf[:, 4],
                 niter=niter)


def format_trace(trace: Trace, title: str = "ADMM iterations") -> str:
    """Render a trace as the reference's debug table
    (reference: src/ADMMBase.h:111-146)."""
    import numpy as np

    width = 80
    lines = ["=" * width, title.center(width), "-" * width,
             f"{'iter':<7}{'eps_primal':<13}{'resid_primal':<13}"
             f"{'eps_dual':<13}{'resid_dual':<13}{'rho':<13}",
             "-" * width]
    n = int(np.asarray(trace.niter))
    ep = np.asarray(trace.eps_primal)
    rp = np.asarray(trace.resid_primal)
    ed = np.asarray(trace.eps_dual)
    rd = np.asarray(trace.resid_dual)
    rho = np.asarray(trace.rho)
    for i in range(min(n, ep.shape[0])):
        lines.append(f"{i:<7}{ep[i]:<13.4g}{rp[i]:<13.4g}"
                     f"{ed[i]:<13.4g}{rd[i]:<13.4g}{rho[i]:<13.4g}")
    lines.append("=" * width)
    return "\n".join(lines)
