"""SPD solve helpers: one-time explicit inverses so hot loops are matmuls.

The reference caches a Cholesky factorization and runs two triangular
solves per ADMM iteration (reference: src/ADMMLassoTall.h:70-80 with the
LLT at :191-205; src/ADMMBP.h:156-197; src/ADMMLAD.h:182-203).  Triangular
solves are inherently sequential and parallelize poorly on an accelerator,
so this design pays a one-time ``O(k^3)`` cost to build the explicit
inverse (or the projected operator) and turns every per-iteration solve
into a single dense matvec, which the matmul libraries run well.

Conditioning note: every system we invert is either ridge-regularised
(X'X + rho I) or comes from a full-rank Gram matrix with loose solver
tolerances (the reference itself runs float32 with 1e-5 tolerances for
Lasso/Enet — SURVEY.md section 2.6 caveat 2), so the explicit inverse is
numerically safe here.  A configurable jitter guards the unregularised
LAD/BP Gram matrices.
"""
from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsl


def chol_inverse(S: jnp.ndarray, *, jitter: float = 0.0) -> jnp.ndarray:
    """Explicit inverse of a symmetric positive-definite matrix.

    Computed via Cholesky (cho_factor + cho_solve against I): roughly 2x
    cheaper and more stable than LU for SPD inputs.  ``jitter`` adds
    ``jitter * mean(diag(S))`` to the diagonal before factorising — used
    for the unregularised Gram matrices of LAD/BP where the reference
    relies on float64 (reference: src/ADMMLAD.h:185-189).
    """
    k = S.shape[0]
    if jitter:
        S = S + (jitter * jnp.mean(jnp.diag(S))) * jnp.eye(k, dtype=S.dtype)
    c, lower = jsl.cho_factor(S)
    return jsl.cho_solve((c, lower), jnp.eye(k, dtype=S.dtype))


def ridge_inverse(S: jnp.ndarray, rho) -> jnp.ndarray:
    """Inverse of ``S + rho I`` for SPD ``S`` (the ADMM x-update system)."""
    k = S.shape[0]
    return chol_inverse(S + rho * jnp.eye(k, dtype=S.dtype))
