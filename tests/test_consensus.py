"""Consensus (parallel) ADMM tests on an emulated 8-device CPU mesh."""
import jax
import numpy as np
import pytest
from sklearn.linear_model import Lasso

from admm_tpu.models.lasso import lasso_path
from admm_tpu.parallel.consensus import parallel_lasso_path
from admm_tpu.parallel.mesh import make_mesh


def _problem(n=400, p=30, seed=123):
    rng = np.random.default_rng(seed)
    b = rng.uniform(size=p) * (rng.uniform(size=p) < 0.5)
    X = rng.normal(size=(n, p))
    y = 2.0 + X @ b + 0.5 * rng.normal(size=n)
    return X, y


def test_devices_available():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


def test_consensus_matches_serial_single_worker():
    X, y = _problem()
    lam = np.array([0.1])
    ser = lasso_path(X, y, lambdas=lam, standardize=False, intercept=False)
    par = parallel_lasso_path(X, y, nworkers=1, mesh=make_mesh(1),
                              lambdas=lam, standardize=False,
                              intercept=False)
    np.testing.assert_allclose(np.asarray(par.coef), np.asarray(ser.coef),
                               atol=2e-3)


@pytest.mark.parametrize("nworkers,ndev", [(4, 1), (4, 4), (8, 8), (8, 2)])
def test_consensus_matches_sklearn(nworkers, ndev):
    X, y = _problem()
    lam = 0.1
    par = parallel_lasso_path(X, y, nworkers=nworkers,
                              mesh=make_mesh(ndev),
                              lambdas=np.array([lam]), standardize=False,
                              intercept=False, eps_abs=1e-6, eps_rel=1e-6)
    sk = Lasso(alpha=lam, fit_intercept=False, tol=1e-12,
               max_iter=500000).fit(X, y)
    np.testing.assert_allclose(np.asarray(par.coef[0]), sk.coef_,
                               atol=2e-3)


def test_consensus_sharded_equals_batched():
    """The device decomposition must not change the math: W workers on 1
    device == W workers on D devices, bit-for-bit up to reduction order."""
    X, y = _problem()
    lam = np.array([0.3, 0.1, 0.03])
    a = parallel_lasso_path(X, y, nworkers=8, mesh=make_mesh(1),
                            lambdas=lam, standardize=False,
                            intercept=False)
    b = parallel_lasso_path(X, y, nworkers=8, mesh=make_mesh(8),
                            lambdas=lam, standardize=False,
                            intercept=False)
    np.testing.assert_allclose(np.asarray(a.coef), np.asarray(b.coef),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.niter),
                                  np.asarray(b.niter))


def test_consensus_wide_blocks_woodbury():
    """Row blocks smaller than p exercise the Woodbury branch
    (reference: src/PADMMLasso.h:26-29)."""
    X, y = _problem(n=80, p=40)
    lam = 0.05
    par = parallel_lasso_path(X, y, nworkers=4, mesh=make_mesh(4),
                              lambdas=np.array([lam]), standardize=False,
                              intercept=False, eps_abs=1e-6, eps_rel=1e-6)
    sk = Lasso(alpha=lam, fit_intercept=False, tol=1e-12,
               max_iter=500000).fit(X, y)
    np.testing.assert_allclose(np.asarray(par.coef[0]), sk.coef_,
                               atol=3e-3)


def test_consensus_full_path_standardized():
    X, y = _problem()
    par = parallel_lasso_path(X, y, nworkers=8, mesh=make_mesh(8),
                              nlambda=10)
    ser = lasso_path(X, y, nlambda=10)
    np.testing.assert_allclose(np.asarray(par.lambdas),
                               np.asarray(ser.lambdas), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(par.coef[-1]),
                               np.asarray(ser.coef[-1]), atol=5e-3)


def _compiled_consensus_hlo(solver_factory, Xb, yb, nlam=3, mesh=None,
                            axis=None, state_dim=None):
    """Compile a consensus shard body over the 8-device mesh and return
    its post-optimization HLO text.  ``state_dim`` overrides the
    consensus-variable dimension (matrix-variable models carry
    flattened (q, C)/(p, K) blocks wider than the data columns)."""
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    mesh = make_mesh(8) if mesh is None else mesh
    axis = mesh.axis_names[0] if axis is None else axis
    solver = solver_factory(axis)
    W, _, p = Xb.shape
    if state_dim is not None:
        p = state_dim
    state_specs = (P(axis), P(axis), P())
    fn = shard_map(solver, mesh=mesh,
                   in_specs=(P(axis), P(axis)) + state_specs
                   + (P(), P(), P(), P(), P()),
                   out_specs=(P(), P(), state_specs + (P(),)),
                   check_vma=False)
    zeros = jnp.zeros((W, p), Xb.dtype)
    lowered = jax.jit(fn).lower(
        Xb, yb, zeros, zeros, zeros[0],
        jnp.ones((nlam,), Xb.dtype),
        Xb.dtype.type(-1.0), np.int32(50), Xb.dtype.type(1e-5),
        Xb.dtype.type(1e-5))
    return lowered.compile().as_text()


def _allreduce_shapes(hlo):
    """Result shapes of every all-reduce instruction in an HLO module
    (async -done halves and name references excluded)."""
    import re
    return re.findall(r"= *(\S+) all-reduce(?:-start)?\(", hlo)


@pytest.mark.parametrize("variant", ["lasso", "bp", "group", "logistic",
                                     "huber", "poisson", "multinomial",
                                     "multitask", "slope"])
def test_exactly_one_psum_per_iteration(variant):
    """THE central distributed invariant (consensus.py module docstring):
    the whole compiled consensus program contains exactly ONE all-reduce,
    and its operand is the packed (p+3) vector — a regression to a second
    collective anywhere in the iteration fails here."""
    import jax.numpy as jnp
    from functools import partial
    from admm_tpu.parallel import consensus as C

    if variant == "lasso":
        X, y = _problem(n=160, p=16)
        p = 16
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, p)
        yb = jnp.asarray(y, jnp.float32).reshape(8, 20)
        factory = lambda ax: partial(C._consensus_lasso_shard, axis=ax,
                                     nworkers=8, tall_block=True)
    elif variant == "bp":
        p = 64
        rng = np.random.default_rng(5)
        A = rng.normal(size=(32, p))
        x0 = np.zeros(p); x0[:6] = 1.0
        Xb = jnp.asarray(A, jnp.float32).reshape(8, 4, p)
        yb = jnp.asarray(A @ x0, jnp.float32).reshape(8, 4)
        factory = lambda ax: partial(
            C._consensus_shard, axis=ax, nworkers=8,
            make_x_update=partial(C._bp_x_update, jitter=1e-6),
            master_prox=C._bp_master_prox(8),
            auto_rho=lambda lam: 1.0)
    elif variant == "group":
        from admm_tpu.models.grouplasso import normalize_groups
        X, y = _problem(n=160, p=16)
        p = 16
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, p)
        yb = jnp.asarray(y, jnp.float32).reshape(8, 20)
        gj, wj = normalize_groups(np.arange(p) % 4, p, None, jnp.float32)
        factory = lambda ax: partial(C._consensus_lasso_shard, axis=ax,
                                     nworkers=8, tall_block=True,
                                     group_prox=(gj, wj))
    elif variant == "multinomial":
        # Matrix-variable model: the state (and the packed psum) is the
        # FLATTENED (q, nc) block — q*nc + 3 lanes, still one
        # collective.
        q, nc = 16, 3
        p = q * nc
        rng = np.random.default_rng(7)
        X = rng.normal(size=(160, q))
        lab = rng.integers(0, nc, 160).astype(float)
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, q)
        yb = jnp.asarray(lab, jnp.float32).reshape(8, 20)
        mask = jnp.ones((q,), jnp.float32)
        factory = lambda ax: partial(
            C._consensus_shard, axis=ax, nworkers=8,
            make_x_update=partial(C._mn_x_update, nclass=nc,
                                  n_total=160, newton_steps=2),
            master_prox=C._mn_master_prox(8, 1.0, mask, q, nc, False),
            auto_rho=lambda lam: 0.25)
    elif variant == "slope":
        # Callable master-prox plug-in: the sorted-l1 prox (consensus
        # SLOPE) — same packed (p+3) psum, same single collective.
        from admm_tpu.models.slope import prox_sorted_l1

        X, y = _problem(n=160, p=16)
        p = 16
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, p)
        yb = jnp.asarray(y, jnp.float32).reshape(8, 20)
        lam_j = jnp.asarray(np.linspace(2.0, 1.0, p), jnp.float32)

        def mk(W):
            def prox(zbar, lam, rho):
                return prox_sorted_l1(zbar, (lam / (rho * W)) * lam_j)
            return prox

        factory = lambda ax: partial(C._consensus_lasso_shard, axis=ax,
                                     nworkers=8, tall_block=True,
                                     group_prox=mk)
    elif variant == "multitask":
        pdim, K = 16, 3
        p = pdim * K
        rng = np.random.default_rng(8)
        X = rng.normal(size=(160, pdim))
        Y = rng.normal(size=(160, K))
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, pdim)
        yb = jnp.asarray(Y, jnp.float32).reshape(8, 20, K)
        factory = lambda ax: partial(
            C._consensus_shard, axis=ax, nworkers=8,
            make_x_update=partial(C._mt_x_update, ntask=K,
                                  tall_block=True),
            master_prox=C._mt_master_prox(8, pdim, K),
            auto_rho=lambda lam: lam / 8)
    else:
        # The GLM worker is family-generic (consensus.py::_glm_x_update);
        # every family must keep the one-collective invariant.
        from admm_tpu.models.glm import binomial, huber, poisson

        fam = {"logistic": binomial, "huber": huber, "poisson": poisson}[
            variant]()
        p = 16
        rng = np.random.default_rng(6)
        X = rng.normal(size=(160, p))
        ylab = (rng.uniform(size=160) < 0.5).astype(float)
        Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, p)
        yb = jnp.asarray(ylab, jnp.float32).reshape(8, 20)
        mask = jnp.ones((p,), jnp.float32)
        factory = lambda ax: partial(
            C._consensus_shard, axis=ax, nworkers=8,
            make_x_update=partial(C._glm_x_update, family=fam,
                                  n_total=160, newton_steps=2),
            master_prox=C._glm_master_prox(8, 1.0, mask),
            auto_rho=lambda lam: 1.0)

    hlo = _compiled_consensus_hlo(
        factory, Xb, yb,
        state_dim=p if variant in ("multinomial", "multitask") else None)
    shapes = _allreduce_shapes(hlo)
    assert len(shapes) == 1, (
        f"expected exactly one all-reduce, found {len(shapes)}: {shapes}")
    assert shapes[0].startswith(f"f32[{p + 3}]"), shapes[0]


def test_two_level_host_chip_mesh_matches_flat():
    """A two-axis (hosts, chips) mesh — the multi-host layout, psum over
    the axis tuple — must reproduce the 1-D mesh run bit-for-bit."""
    from jax.sharding import Mesh

    X, y = _problem()
    lam = np.array([0.3, 0.1, 0.03])
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                 ("hosts", "chips"))
    a = parallel_lasso_path(X, y, nworkers=8, mesh=mesh2, lambdas=lam,
                            standardize=False, intercept=False)
    b = parallel_lasso_path(X, y, nworkers=8, mesh=make_mesh(8),
                            lambdas=lam, standardize=False,
                            intercept=False)
    # Tolerance, not bit-equality: a different mesh layout may lower the
    # all-reduce with a different accumulation order on real hardware
    # (CLAUDE.md accumulation-reorder rule); on the CPU emulator these
    # happen to agree exactly, but don't pin that.
    np.testing.assert_allclose(np.asarray(a.coef), np.asarray(b.coef),
                               atol=1e-5)
    assert np.abs(np.asarray(a.niter).astype(int)
                  - np.asarray(b.niter).astype(int)).max() <= 1


def test_two_level_mesh_single_collective():
    """The two-axis mesh psum must still be ONE collective (a single
    all-reduce over the full replica group — XLA owns the collective's
    hierarchy), not one per axis."""
    import jax.numpy as jnp
    from functools import partial
    from jax.sharding import Mesh
    from admm_tpu.parallel import consensus as C

    X, y = _problem(n=160, p=16)
    Xb = jnp.asarray(X, jnp.float32).reshape(8, 20, 16)
    yb = jnp.asarray(y, jnp.float32).reshape(8, 20)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("hosts", "chips"))
    axis = ("hosts", "chips")
    factory = lambda ax: partial(C._consensus_lasso_shard, axis=ax,
                                 nworkers=8, tall_block=True)
    hlo = _compiled_consensus_hlo(factory, Xb, yb, mesh=mesh, axis=axis)
    shapes = _allreduce_shapes(hlo)
    assert len(shapes) == 1, shapes
    assert shapes[0].startswith("f32[19]"), shapes[0]


def test_nondivisible_nthread_auto_mesh():
    """Worker counts that don't divide the device count must work via a
    smaller auto-selected mesh (reference accepts any nthread < ncol/5)."""
    X, y = _problem(n=240, p=40)
    par = parallel_lasso_path(X, y, nworkers=12, lambdas=np.array([0.1]),
                              standardize=False, intercept=False,
                              eps_abs=1e-6, eps_rel=1e-6)
    from sklearn.linear_model import Lasso
    sk = Lasso(alpha=0.1, fit_intercept=False, tol=1e-12,
               max_iter=500000).fit(X, y)
    np.testing.assert_allclose(np.asarray(par.coef[0]), sk.coef_,
                               atol=2e-3)
