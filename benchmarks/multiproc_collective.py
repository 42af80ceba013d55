"""Two-process consensus collective-cost sanity row (CPU emulation).

Spawns the same fixed consensus Lasso solve in two configurations over 8
virtual CPU devices — ONE process owning all 8, and TWO ``jax.distributed``
processes owning 4 each (Gloo collectives standing in for the
inter-host network) — and
reports the per-solve wall time of each plus the implied cross-process
collective overhead.  CPU emulation shares physical cores, so the
absolute ratio is pessimistic; the row exists to show the cross-process
path runs and to bound its overhead, not to claim accelerator scaling
(the on-chip worker scaling lives in run_baselines.py::
bench_consensus_scaling).

Run: python benchmarks/multiproc_collective.py
Writes benchmarks/multiproc_collective.json.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORKER = r'''
import os, sys, time
proc_id, nprocs, port, local_dev = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]))
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={local_dev}")
import jax
jax.config.update("jax_platforms", "cpu")
if nprocs > 1:
    jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs,
                               process_id=proc_id)
import numpy as np
sys.path.insert(0, %(repo)r)
from admm_tpu.models.lasso import lasso_path  # noqa: F401 (warm import)
from admm_tpu.parallel.consensus import parallel_lasso_path
from admm_tpu.parallel.mesh import make_mesh

rng = np.random.default_rng(123)
n, p = 4096, 64
b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
X = rng.normal(size=(n, p))
y = X @ b + 0.5 * rng.normal(size=n)
lams = np.array([0.3, 0.1, 0.03])
W = 8
mesh = make_mesh(W)

def solve():
    r = parallel_lasso_path(X, y, nworkers=W, mesh=mesh, lambdas=lams,
                            standardize=False, intercept=False,
                            eps_abs=1e-6, eps_rel=1e-6)
    jax.block_until_ready(r.coef)
    return r

solve()  # compile + warmup
times = []
for _ in range(5):
    t0 = time.perf_counter()
    solve()
    times.append((time.perf_counter() - t0) * 1e3)
print(f"MEDIAN_MS {np.median(times):.3f}", flush=True)
'''


def run_config(nprocs, port):
    script = WORKER % {"repo": REPO}
    procs = []
    for i in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(i), str(nprocs),
             str(port), str(8 // nprocs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env={k: v for k, v in os.environ.items()
                 if k != "XLA_FLAGS"}))
    ms = []
    for pr in procs:
        out, _ = pr.communicate(timeout=600)
        text = out.decode(errors="replace")
        assert pr.returncode == 0, text
        for line in text.splitlines():
            if line.startswith("MEDIAN_MS"):
                ms.append(float(line.split()[1]))
    return max(ms)  # slowest process bounds the solve


def main():
    one = run_config(1, 0)
    two = run_config(2, 12000 + os.getpid() % 2000)
    res = {
        "single_process_8dev_ms": one,
        "two_process_4dev_each_ms": two,
        "cross_process_overhead_ratio": two / one,
        "note": "fixed 4096x64 consensus Lasso, 3 lambdas, 8 virtual CPU "
                "devices total; Gloo collectives across processes; CPU "
                "emulation shares cores so the ratio is an upper bound",
    }
    out = os.path.join(HERE, "multiproc_collective.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
