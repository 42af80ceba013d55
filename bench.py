"""Headline benchmark: full Lasso lambda path on the reference's flagship
problem (n=10000, p=1000, 100 lambdas, seed 123).

Baseline: the reference C++ solver's median wall time of 321.0 ms for the
same path (reference README.md:206-224; see BASELINE.md).  ``vs_baseline``
is the speedup factor (baseline_time / our_time, >1 means faster than the
reference).

Two path modes are measured (see admm_tpu/models/lasso.py):
  * batch — all 100 lambdas solved simultaneously as batched lanes
    (headline metric);
  * scan  — sequential warm-started lambdas, the reference's protocol.

Runs on the GPU only: any other backend is refused rather than reported
under the headline metric's name.  Prints ONE JSON line on stdout,
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": N}}
and the scan number and the batch/scan agreement on stderr.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_MS = 321.0


def make_problem(n=10000, p=1000, m=100, seed=123):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.uniform(-1, 1, m)
    X = rng.normal(size=(n, p))
    y = 5.0 + X @ b + rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def _time_mode(X, y, mode, *, k_small=4, k_large=36, repeats=3):
    """Per-path device time via a two-point amortized measurement.

    The full path solve runs K times inside ONE jitted ``fori_loop`` (the
    response is perturbed per repetition so no two solves are identical
    and nothing can be CSE'd/deduped), completion is forced with a scalar
    host read, and two K values are differenced:
    ``(wall(k_large) - wall(k_small)) / (k_large - k_small)`` cancels the
    constant dispatch + host read-back overhead, leaving device time per
    path solve (no host transfer of X, no result pull).
    """
    import jax
    import jax.numpy as jnp
    from functools import partial
    from admm_tpu.models.lasso import _path_auto

    @partial(jax.jit, static_argnames=("mode",))
    def run_k(X, y, K, mode):
        def body(i, acc):
            yy = y * (1.0 + 1e-6 * (i + 1).astype(y.dtype))
            res = _path_auto(X, yy, 100, 1e-4, -1.0, 10000, 1e-5, 1e-5,
                             1.0, standardize_x=True, intercept=True,
                             enet_scale=False, path_mode=mode)
            return acc + jnp.sum(res.coef) + jnp.sum(res.niter)
        return jax.lax.fori_loop(0, K, body, jnp.float32(0.0))

    def wall(K):
        t0 = time.perf_counter()
        float(run_k(X, y, K, mode))  # host read forces completion
        return (time.perf_counter() - t0) * 1e3

    wall(k_small)  # compile + warm-up (K is dynamic: one compile total)
    samples = []
    for _ in range(repeats):
        t_small = wall(k_small)
        t_large = wall(k_large)
        samples.append((t_large - t_small) / (k_large - k_small))
    per_path = float(np.median(samples))

    from admm_tpu.models.lasso import lasso_path
    res = lasso_path(X, y, nlambda=100, path_mode=mode)
    np.asarray(res.niter)
    return per_path, res


def main():
    from admm_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    X, y = make_problem()
    X = jax.device_put(X, dev)
    y = jax.device_put(y, dev)

    batch_ms, res_b = _time_mode(X, y, "batch")
    scan_ms, res_s = _time_mode(X, y, "scan")

    # Sanity: the two protocols must agree on the solution.
    gap = float(np.abs(np.asarray(res_b.coef) - np.asarray(res_s.coef)).max())

    print(json.dumps({
        "metric": "lasso_path_10000x1000_100lambdas_median_ms",
        "value": round(batch_ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / batch_ms, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    print(f"# device={dev.platform} ({dev.device_kind}) "
          f"batch_ms={batch_ms:.3f} "
          f"scan_ms={scan_ms:.3f} (scan vs_baseline="
          f"{BASELINE_MS / scan_ms:.1f}x) batch-vs-scan coef gap={gap:.2e} "
          f"iters: batch_total={int(np.asarray(res_b.niter).sum())} "
          f"batch_max={int(np.asarray(res_b.niter).max())} "
          f"scan_total={int(np.asarray(res_s.niter).sum())}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
