"""Chip race: exact-SVD vs warm-started partial-SVT PCP (DESIGN.md
"RPCA partial SVT"), including a 2000x2000 row.

Wall-clock protocol (not the amortized two-point one): each solve is
seconds-scale, so a single timed run after a compile/warm-up run is
free enough of dispatch noise.

Run from the repo root: ``python benchmarks/race_rpca_svt.py``.
"""
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from admm_tpu.models.rpca import rpca  # noqa: E402


def planted(n, r=5, frac=0.05, seed=0):
    rng = np.random.default_rng(seed)
    L0 = (rng.normal(size=(n, r)) @ rng.normal(size=(r, n))
          / np.sqrt(r)).astype(np.float32)
    S0 = np.zeros((n, n), np.float32)
    idx = rng.uniform(size=(n, n)) < frac
    S0[idx] = 10 * rng.choice([-1.0, 1.0], size=idx.sum())
    return L0, S0, jnp.asarray(L0 + S0)


def solve_ms(M, rank):
    kw = dict(maxit=2000, eps_abs=1e-6, eps_rel=1e-5)
    if rank is not None:
        kw.update(rank=rank)
    res = rpca(M, **kw)
    jax.block_until_ready(res.low_rank)       # compile + warm-up
    t0 = time.perf_counter()
    res = rpca(M * jnp.float32(1.0 + 1e-6), **kw)
    jax.block_until_ready(res.low_rank)
    return (time.perf_counter() - t0) * 1e3, res


def main():
    out = {}
    for n in (500, 1000, 2000):
        L0, S0, M = planted(n)
        row = {}
        for tag, rank in (("exact", None), ("partial_r5", 5)):
            ms, res = solve_ms(M, rank)
            err = float(jnp.max(jnp.abs(res.low_rank - L0))
                        / np.abs(L0).max())
            row[tag] = dict(ms=round(ms, 2), niter=int(res.niter),
                            rel_err=float(f"{err:.2e}"))
            print(n, tag, row[tag], flush=True)
        out[n] = row
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
