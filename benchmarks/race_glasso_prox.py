"""Chip race: eigh-based vs Newton-Schulz (matmul-only) glasso x-update.

The glasso prox has the closed matrix-function form

    Theta = (G + sqrt(G^2 + 4 rho I)) / (2 rho)

so the per-iteration eigendecomposition (the measured wall dominator,
DESIGN.md roofline: 141 iters x 1.15 ms/eigh = 64% of the p=200 path)
can be replaced by a coupled Newton-Schulz square-root iteration --
matmuls only, and batchable across lambda lanes.

This race measures, at several p:
  * one eigh x-update vs one NS x-update (serial and 20-lane batched)
  * NS accuracy vs an f64 eigh reference (relative Frobenius error)

Run from the repo root: ``python benchmarks/race_glasso_prox.py``.
"""
import json
import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.run_baselines import amortized_ms  # noqa: E402
from admm_tpu.linalg import dot  # noqa: E402


def xupdate_eigh(G, rho):
    w, Q = jnp.linalg.eigh(G)
    theta = (w + jnp.sqrt(w * w + 4.0 * rho)) / (2.0 * rho)
    xn = dot(Q * theta[None, :], Q.T)
    return 0.5 * (xn + xn.T)


def xupdate_ns(G, rho, iters=30):
    """Theta = (G + sqrt(G^2 + 4 rho I)) / (2 rho) via coupled
    Newton-Schulz on M = G^2 + 4 rho I (SPD, eigenvalues >= 4 rho)."""
    p = G.shape[-1]
    eye = jnp.eye(p, dtype=G.dtype)
    M = dot(G, G) + 4.0 * rho * eye
    c = jnp.sqrt(jnp.sum(M * M))          # ||M||_F >= lambda_max(M)
    A = M / c
    Y, Z = A, eye

    def body(i, YZ):
        Y, Z = YZ
        T = 0.5 * (3.0 * eye - dot(Z, Y))
        return dot(Y, T), dot(T, Z)

    Y, Z = jax.lax.fori_loop(0, iters, body, (Y, Z))
    sqrtM = jnp.sqrt(c) * Y
    xn = (G + sqrtM) / (2.0 * rho)
    return 0.5 * (xn + xn.T)


def main():
    rng = np.random.default_rng(0)
    out = {}
    for p in (100, 200, 400, 800):
        # Representative G = rho*z - y - S: symmetric, spectrum of a
        # covariance-ish scale.
        X = rng.normal(size=(5 * p, p)).astype(np.float64)
        S = (X.T @ X) / (5 * p)
        G64 = 1.0 * np.eye(p) - 0.3 * S - S   # rho*z - y - S shape
        G64 = 0.5 * (G64 + G64.T)
        rho = 1.0
        ref = None
        # f64 eigh reference
        w, Q = np.linalg.eigh(G64)
        th = (w + np.sqrt(w * w + 4.0 * rho)) / (2.0 * rho)
        ref = (Q * th[None, :]) @ Q.T

        G = jnp.asarray(G64, jnp.float32)
        Gb = jnp.asarray(np.stack([G64] * 20), jnp.float32)
        row = {"p": p}

        # accuracy at several NS iteration budgets
        for it in (16, 22, 30):
            got = np.asarray(xupdate_ns(G, rho, iters=it), np.float64)
            row[f"ns{it}_relerr"] = float(
                np.linalg.norm(got - ref) / np.linalg.norm(ref))
        got = np.asarray(xupdate_eigh(G, rho), np.float64)
        row["eigh_f32_relerr"] = float(
            np.linalg.norm(got - ref) / np.linalg.norm(ref))

        def one_eigh(i, G):
            GG = G * (1.0 + 1e-6 * (i + 1).astype(G.dtype))
            return jnp.sum(xupdate_eigh(GG, 1.0))

        def one_ns(i, G):
            GG = G * (1.0 + 1e-6 * (i + 1).astype(G.dtype))
            return jnp.sum(xupdate_ns(GG, 1.0, iters=22))

        def one_eigh_b(i, Gb):
            GG = Gb * (1.0 + 1e-6 * (i + 1).astype(Gb.dtype))
            return jnp.sum(jax.vmap(lambda g: xupdate_eigh(g, 1.0))(GG))

        def one_ns_b(i, Gb):
            GG = Gb * (1.0 + 1e-6 * (i + 1).astype(Gb.dtype))
            return jnp.sum(jax.vmap(
                lambda g: xupdate_ns(g, 1.0, iters=22))(GG))

        row["eigh_ms"] = amortized_ms(one_eigh, 20, 100, args=(G,))
        row["ns22_ms"] = amortized_ms(one_ns, 20, 100, args=(G,))
        row["eigh_batch20_ms"] = amortized_ms(one_eigh_b, 5, 25,
                                              args=(Gb,))
        row["ns22_batch20_ms"] = amortized_ms(one_ns_b, 5, 25,
                                              args=(Gb,))
        out[p] = row
        print(json.dumps(row), flush=True)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
