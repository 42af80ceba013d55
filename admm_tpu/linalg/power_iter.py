"""On-device largest-eigenvalue estimation by power iteration.

The reference vendors the Spectra implicitly-restarted Lanczos solver
(~4k LoC, reference: src/Spectra/SymEigsSolver.h) but only ever asks it
for ONE eigenpair of X'X or XX' at 10% tolerance with a Krylov dimension
of 3 (reference: src/ADMMLassoTall.h:196-201, src/ADMMLassoWide.h:202-207).
That is exactly the regime where plain power iteration wins:
each step is one symmetric matvec, there is no re-orthogonalisation, no
host round-trips, and the whole estimate fuses into the surrounding jitted
program.

We run a fixed number of iterations (static trip count -> XLA unrolls or
loops without dynamic shapes) and return the final Rayleigh quotient.
Convergence is geometric in (lambda_2/lambda_1)^k; 50 iterations is far
tighter than the 10% tolerance the reference requests.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

# Full f32 products: the estimate sets the auto-rho.  The H100 ran these
# matvecs in full f32 even at default precision, but its default f32
# matmul is TF32, so the precision is pinned rather than left to XLA's
# choice of kernel.  Defined here because linalg/__init__ imports this
# module.
_dot = partial(jnp.dot, precision=lax.Precision.HIGHEST)


def power_iteration(matvec: Callable[[jnp.ndarray], jnp.ndarray], dim: int,
                    *, iters: int = 50, dtype=jnp.float32,
                    seed: int = 0) -> jnp.ndarray:
    """Estimate the largest eigenvalue of a symmetric PSD operator.

    ``matvec`` must be jit-traceable.  Deterministic: the start vector is
    derived from a fixed PRNG key (the reference's live solvers use an
    unseeded ``rand()`` and are nondeterministic across runs — SURVEY.md
    section 2.6 caveat 4 — which we deliberately fix).
    """
    key = jax.random.PRNGKey(seed)
    v0 = jax.random.normal(key, (dim,), dtype=dtype)
    v0 = v0 / jnp.sqrt(jnp.sum(v0 * v0))

    def step(_, v):
        w = matvec(v)
        return w / jnp.maximum(jnp.sqrt(jnp.sum(w * w)), 1e-30)

    v = lax.fori_loop(0, iters, step, v0)
    w = matvec(v)
    # Rayleigh quotient of the (near-)converged vector.
    return jnp.vdot(v, w) / jnp.maximum(jnp.vdot(v, v), 1e-30)


def spectral_radius_gram(X: jnp.ndarray, *, iters: int = 50) -> jnp.ndarray:
    """Largest eigenvalue of X'X (== of XX'), matrix-free.

    Replaces the reference's ``MatOpXX`` adapter + Spectra call
    (reference: src/ADMMMatOp.h:8-41).  Using the factored form keeps the
    cost at two skinny matmuls per step and avoids materialising the Gram
    matrix when it is not otherwise needed.
    """
    n, p = X.shape
    if n >= p:
        mv = lambda v: _dot(X.T, _dot(X, v))
        dim = p
    else:
        mv = lambda v: _dot(X, _dot(X.T, v))
        dim = n
    return power_iteration(mv, dim, iters=iters, dtype=X.dtype)


def spectral_radius_sym(S: jnp.ndarray, *, iters: int = 50) -> jnp.ndarray:
    """Largest eigenvalue of an explicit symmetric PSD matrix S."""
    return power_iteration(lambda v: _dot(S, v), S.shape[0], iters=iters,
                           dtype=S.dtype)
