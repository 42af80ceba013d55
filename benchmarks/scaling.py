"""Consensus-ADMM scaling-efficiency harness.

SURVEY.md's north star asks for >=80% consensus scaling efficiency at 2
hosts.  This harness measures strong scaling of one consensus Lasso
lambda-path job: a fixed problem with W workers is spread over D devices
(W/D worker blocks batched per device), for D = 1, 2, 4, ... up to the
visible device count.  Ideal strong scaling halves the time each time D
doubles; efficiency(D) = T(1) / (D * T(D)).

On real multi-GPU hardware each mesh element is a card and the
numbers are meaningful; under the CPU emulation
(``--xla_force_host_platform_device_count=N``) all "devices" share one
host's cores, so emulated efficiency mostly validates that the collective
schedule does not serialize — run on several cards for real numbers.

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/scaling.py [--n 16384] [--p 256] [--workers 8]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--p", type=int, default=256)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--nlambda", type=int, default=30)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (emulated mesh)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    from admm_tpu.parallel.consensus import parallel_lasso_path
    from admm_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    W = args.workers or ndev
    rng = np.random.default_rng(123)
    b = rng.uniform(size=args.p) * (rng.uniform(size=args.p) < 0.3)
    X = rng.normal(size=(args.n, args.p))
    y = 2.0 + X @ b + rng.normal(size=args.n)

    def run(D):
        mesh = make_mesh(D)
        # warm-up / compile
        res = parallel_lasso_path(X, y, nworkers=W, mesh=mesh,
                                  nlambda=args.nlambda)
        jax.block_until_ready(res.coef)
        ts = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            res = parallel_lasso_path(X, y, nworkers=W, mesh=mesh,
                                      nlambda=args.nlambda)
            jax.block_until_ready(res.coef)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), res

    Ds = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev and W % d == 0]
    print(f"# backend={jax.default_backend()} devices={ndev} workers={W} "
          f"problem={args.n}x{args.p} nlambda={args.nlambda}",
          file=sys.stderr)
    t1 = None
    rows = {}
    ref = None
    for D in Ds:
        t, res = run(D)
        if t1 is None:
            t1, ref = t, np.asarray(res.coef)
        else:
            gap = float(np.abs(np.asarray(res.coef) - ref).max())
            assert gap < 1e-4, f"decomposition changed the math: {gap}"
        eff = t1 / (D * t)
        rows[D] = dict(seconds=t, speedup=t1 / t, efficiency=eff)
        print(f"D={D:<3} t={t*1e3:9.1f} ms  speedup={t1/t:6.2f}x  "
              f"efficiency={eff:6.1%}")

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       f"scaling_{jax.default_backend()}.json")
    with open(out, "w") as f:
        json.dump({"backend": jax.default_backend(), "workers": W,
                   "problem": [args.n, args.p], "rows": rows}, f, indent=2)
    print(f"# wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
