"""Worker script for the multi-process consensus test (NOT a pytest module).

Usage: ``python multiproc_consensus_worker.py <proc_id> <nprocs> <port>``

Each process drives 4 virtual CPU devices under ``jax.distributed``; the
consensus Lasso path runs over the global ``4*nprocs``-device mesh with
the single fused psum per iteration crossing the process boundary (the
multi-host analog of reference: src/PADMMBase.h:117-214's OpenMP reductions,
scaled past one host as SURVEY.md section 2.5 promises).  Every process
independently computes the serial solution and asserts the consensus
coefficients agree, then prints ``MULTIPROC_OK``.
"""
import os
import sys


def main() -> None:
    proc_id, nprocs, port = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs,
                               process_id=proc_id)
    import numpy as np

    from admm_tpu.models.lasso import lasso_path
    from admm_tpu.parallel.consensus import parallel_lasso_path
    from admm_tpu.parallel.mesh import make_mesh

    assert jax.process_count() == nprocs
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nprocs

    rng = np.random.default_rng(123)
    n, p = 400, 30
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
    X = rng.normal(size=(n, p))
    y = X @ b + 0.5 * rng.normal(size=n)
    lams = np.array([0.3, 0.1, 0.03])

    W = 4 * nprocs
    par = parallel_lasso_path(X, y, nworkers=W, mesh=make_mesh(W),
                              lambdas=lams, standardize=False,
                              intercept=False, eps_abs=1e-6, eps_rel=1e-6)
    coef = np.asarray(par.coef)   # psum-replicated -> readable everywhere

    # Independent serial oracle, computed locally on this process.
    ser = lasso_path(X, y, lambdas=lams, standardize=False,
                     intercept=False, eps_abs=1e-6, eps_rel=1e-6)
    gap = float(np.abs(coef - np.asarray(ser.coef)).max())
    assert gap < 2e-3, f"consensus/serial gap {gap}"

    # Distributed GLM across the process boundary too: the binomial
    # consensus worker's one fused psum rides the same Gloo backend.
    from admm_tpu.models.logistic import logistic_lasso_path
    from admm_tpu.parallel.consensus import parallel_glm_lasso_path
    from admm_tpu.models.glm import binomial

    ylab = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-X @ b))
            ).astype(float)
    lg = np.array([0.05, 0.02])
    parg = parallel_glm_lasso_path(X, ylab, binomial(), nworkers=W,
                                   mesh=make_mesh(W), lambdas=lg,
                                   eps_abs=1e-6, eps_rel=1e-6)
    serg = logistic_lasso_path(X, ylab, lambdas=lg, eps_abs=1e-6,
                               eps_rel=1e-6)
    gapg = float(np.abs(np.asarray(parg.coef)
                        - np.asarray(serg.coef)).max())
    assert gapg < 2e-3, f"consensus/serial GLM gap {gapg}"
    print(f"MULTIPROC_OK proc={proc_id} gap={gap:.2e} glm={gapg:.2e}",
          flush=True)


if __name__ == "__main__":
    main()
