"""Per-iteration convergence tracing through the builder API.

The reference has residual-trace printers compiled into its engines but
commented out of the solve loops (reference: src/ADMMBase.h:111-146);
here ``.opts(trace=True)`` records (eps_primal, resid_primal, eps_dual,
resid_dual, rho) for every iteration of every solve ON DEVICE — the
buffer rides the early-exiting while_loop carry, so tracing costs one
device row-write per iteration and no host round-trips — and
``fit.format_trace(i)`` renders the reference's debug table.

Run: ``python examples/trace_demo.py``
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import admm_tpu  # noqa: E402

rng = np.random.default_rng(42)
n, p = 500, 40
beta = np.zeros(p)
beta[:6] = rng.uniform(1.0, 2.0, 6)
X = rng.normal(size=(n, p))
y = X @ beta + 0.5 * rng.normal(size=n)

# --- Lasso path with tracing -------------------------------------------
fit = admm_tpu.admm_lasso(X, y).penalty(nlambda=20).opts(trace=True).fit()
print(f"trace array: {fit.trace.shape}  (nlambda, trace_len, 5)")
print(fit.format_trace(10))           # the reference's table, lambda #10

# The dual residual drives the iteration count at small lambda:
i = 19
nrec = int((~np.isnan(fit.trace[i, :, 0])).sum())
print(f"lambda[{i}] converged in {int(fit.niter[i])} iterations; "
      f"final r_dua/eps_dua = "
      f"{fit.trace[i, nrec-1, 3] / fit.trace[i, nrec-1, 2]:.3f}")

# --- LAD single solve ---------------------------------------------------
lad = admm_tpu.admm_lad(X, y).opts(trace=128).fit()
print(f"\nLAD ran {lad.niter} iterations; first recorded rows:")
print("\n".join(lad.format_trace().splitlines()[:10]))

# --- Consensus (parallel) Lasso: the trace is psum-replicated ----------
par = (admm_tpu.admm_lasso(X, y).penalty(nlambda=5).parallel(4)
       .opts(trace=64).fit())
print(f"\nconsensus trace: {par.trace.shape}")
print(par.format_trace(0))
