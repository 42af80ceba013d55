"""Proximal operators used by the ADMM solvers.

These are the equivalents of the scalar-loop soft-threshold /
elastic-net / box-projection kernels in the reference implementation
(reference: src/ADMMLassoTall.h:55-69, src/ADMMEnet.h:24-40,
src/TODO/ADMMDantzig.h:164-181).  The reference produces *sparse* vectors
from these operators; XLA has no efficient dynamic sparsity, so we keep
everything dense and rely on the accelerator's throughput (see SURVEY.md
section 7, "Hard parts").

All operators are pure functions of arrays and scalars, safe under jit,
vmap and shard_map.
"""
from __future__ import annotations

import jax.numpy as jnp


def soft_threshold(v: jnp.ndarray, penalty) -> jnp.ndarray:
    """Elementwise soft-thresholding prox of ``penalty * ||.||_1``.

    prox(v)_i = sign(v_i) * max(|v_i| - penalty, 0)
    """
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - penalty, 0.0)


def enet_prox(v: jnp.ndarray, penalty, alpha) -> jnp.ndarray:
    """Prox of the elastic-net penalty ``penalty * (alpha*||.||_1 + (1-alpha)/2*||.||_2^2)``.

    prox(v)_i = sign(v_i) * max(|v_i| - alpha*penalty, 0) / (1 + penalty*(1-alpha))

    Matches the reference's ``enet()`` kernel (reference: src/ADMMEnet.h:24-40).
    """
    thresh = alpha * penalty
    denom = 1.0 + penalty * (1.0 - alpha)
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - thresh, 0.0) / denom


def box_clamp_neg(v: jnp.ndarray, radius) -> jnp.ndarray:
    """z-update of the Dantzig selector: ``z = -clip(v, -radius, radius)``.

    This is the projection step of ``g(z) = indicator{||z||_inf <= radius}``
    applied to ``-v`` (reference: src/TODO/ADMMDantzig.h:164-181).
    """
    return -jnp.clip(v, -radius, radius)


def l2norm(v: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm as a 0-d array (dtype-preserving)."""
    return jnp.sqrt(jnp.sum(v * v))


def sqnorm(v: jnp.ndarray) -> jnp.ndarray:
    """Squared Euclidean norm as a 0-d array."""
    return jnp.sum(v * v)
