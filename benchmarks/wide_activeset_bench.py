"""Settle the wide-regime active-set question with data.

The reference's ADMMLassoWide runs a FULL linearized update only on
iterations 4^k-1 and cheap active-set updates in between
(reference: src/ADMMLassoWide.h:86-127).  Round 1 shipped dense-only
updates with an argued-but-unmeasured justification.  This benchmark
measures all three wide-path realisations at the three problem sizes the
verdict names, on the current accelerator:

  * dense batch  — all lambdas as batched lanes (the shipped default)
  * dense scan   — sequential warm starts, full (n, p) updates
  * active scan  — sequential warm starts, the 4^k-1 cadence with a
    compact gathered (n, S) active block (models/lasso.py::
    _solve_path_wide_activeset)

Timing: the batch solves are sub-ms, so they use the amortized two-point
protocol; the scan solves are multi-second (per-op overhead bound — the
finding this benchmark documents), so direct walls after warmup are
exact enough.

Writes benchmarks/wide_activeset.json and prints a table.  The outcome
and its analysis are recorded in DESIGN.md ("the active-set question").

Run on the GPU:  python benchmarks/wide_activeset_bench.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from run_baselines import amortized_ms  # noqa: E402


def problem(n, p, m, seed=123):
    rng = np.random.default_rng(seed)
    b = np.zeros(p)
    b[rng.choice(p, m, replace=False)] = rng.normal(size=m)
    X = rng.normal(size=(n, p))
    y = X @ b + 0.1 * rng.normal(size=n)
    return X, y


def wall_ms(fn, repeats=2):
    import jax
    jax.block_until_ready(fn())  # compile + warm
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def main():
    import jax
    import jax.numpy as jnp

    from admm_tpu.data.standardize import standardize
    from admm_tpu.models.lasso import (_path_user, _solve_path_wide,
                                       _solve_path_wide_activeset)

    results = {"backend": jax.default_backend(), "sizes": {}}
    sizes = [(1000, 2000, 100, 100), (1000, 10000, 200, 50),
             (5000, 20000, 400, 20)]
    for n, p, m, nlam in sizes:
        X, y = problem(n, p, m)
        Xj = jnp.asarray(X, jnp.float32)
        yj = jnp.asarray(y, jnp.float32)
        Xs, ys, stats = standardize(Xj, yj, standardize_x=True,
                                    intercept=True)
        lam0 = float(jnp.max(jnp.abs(Xs.T @ ys)) / n * stats.scale_y)
        lams = jnp.asarray(np.geomspace(lam0 * 0.99, lam0 * 0.01, nlam),
                           jnp.float32)
        ilams = lams * n / stats.scale_y
        row = {}

        # Big operands go through jit ARGUMENTS (closed-over arrays bake
        # into the HLO as constants: an 400 MB program at 5k x 20k).
        dense_jit = jax.jit(lambda Xs, ys: _solve_path_wide(
            Xs, ys, ilams, -1.0, 10000, 1e-5, 1e-5, 1.0, False)[:2])
        act_jit = jax.jit(lambda Xs, ys: _solve_path_wide_activeset(
            Xs, ys, ilams, -1.0, 10000, 1e-5, 1e-5, 1.0, False)[:2])
        dense_fn = lambda: dense_jit(Xs, ys)
        act_fn = lambda: act_jit(Xs, ys)

        def run_batch(i, Xs, ys):
            yy = ys * (1.0 + 1e-6 * (i + 1).astype(ys.dtype))
            r = _path_user(Xs, yy, lams, -1.0, 10000, 1e-5, 1e-5, 1.0,
                           standardize_x=False, intercept=False,
                           enet_scale=False, path_mode="batch")
            return jnp.sum(r.coef) + jnp.sum(r.niter)

        row["dense_batch_ms"] = amortized_ms(run_batch, 1, 3, repeats=2,
                                             args=(Xs, ys))
        d = dense_fn()
        a = act_fn()
        row["activeset_vs_dense_coef_gap"] = float(
            jnp.max(jnp.abs(d[0] - a[0])))
        row["dense_scan_total_niter"] = int(np.sum(np.asarray(d[1])))
        row["activeset_scan_total_niter"] = int(np.sum(np.asarray(a[1])))
        row["dense_scan_ms"] = wall_ms(dense_fn)
        row["activeset_scan_ms"] = wall_ms(act_fn)
        results["sizes"][f"{n}x{p}_nlam{nlam}"] = row
        print(f"{n}x{p} (nlam={nlam}): "
              f"batch={row['dense_batch_ms']:.2f}ms  "
              f"dense_scan={row['dense_scan_ms']:.0f}ms  "
              f"active_scan={row['activeset_scan_ms']:.0f}ms  "
              f"gap={row['activeset_vs_dense_coef_gap']:.2e}", flush=True)
        # Incremental write: a late-size failure keeps earlier rows.
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "wide_activeset.json")
        with open(out, "w") as f:
            json.dump(results, f, indent=2)
    print("wrote", out)


if __name__ == "__main__":
    main()
