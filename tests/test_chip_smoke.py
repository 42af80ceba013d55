"""chip_smoke.py's phases at tiny sizes on the CPU, its device check, the
compile-cache helper, and a scan of the package for accelerator-specific
branches."""
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import admm_tpu  # noqa: E402
import chip_smoke as cs  # noqa: E402
from admm_tpu import compile_cache  # noqa: E402


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.check_device(jax.devices())


def test_check_device_counts_gpus():
    gpu = SimpleNamespace(platform="gpu")
    cs.check_device([gpu])
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.check_device([gpu], count=4)


def test_main_on_cpu_exits_nonzero_without_result(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_lasso_tiny():
    cs.phase_lasso(*cs.regression_problem(600, 40, 8))


def test_phase_enet_tiny():
    cs.phase_enet(*cs.regression_problem(600, 40, 8))


def test_phase_wide_tiny():
    cs.phase_wide(*cs.regression_problem(80, 160, 8))


def test_phase_lad_tiny():
    cs.phase_lad(*cs.lad_problem(300, 30))


def test_phase_bp_tiny():
    cs.phase_bp(*cs.bp_problem(60, 160, 6, 4), n_lp=1)


def test_phase_logistic_tiny():
    cs.phase_logistic(*cs.logistic_problem(400, 30), nlambda=8)


def test_phase_mesh_on_four_virtual_devices():
    from admm_tpu.parallel.mesh import make_mesh

    cs.phase_mesh(*cs.regression_problem(400, 30, 6),
                  make_mesh(4, devices=jax.devices()[:4]))


def test_kkt_reference_flags_a_wrong_path():
    """The f64 KKT check is what every phase leans on: a perturbed
    solution must fail it."""
    X, y = cs.regression_problem(300, 20, 5)
    res = admm_tpu.lasso_path(X, y, nlambda=5)
    coef = np.array(res.coef)
    assert cs.gaussian_kkt(X, y, res.lambdas, coef) <= cs.KKT_TOL
    coef[-1, 0] += 0.5
    assert cs.gaussian_kkt(X, y, res.lambdas, coef) > cs.KKT_TOL


@pytest.mark.gpu
def test_lasso_phase_on_gpu(gpu_devices):
    cs.check_device(gpu_devices)
    cs.phase_lasso(*cs.regression_problem(2000, 100, 10))


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_ignored_path(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert compile_cache.enable_compile_cache() == path
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_package_has_no_mosaic_kernels_or_backend_branches():
    pattern = re.compile(
        r"pallas\.tpu|pltpu|pallas\s+import\s+tpu"
        r"|default_backend\(\)\s*==\s*['\"]tpu"
        r"|platform\s*==\s*['\"]tpu")
    hits = []
    for path in (ROOT / "admm_tpu").rglob("*.py"):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                hits.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert hits == []
    assert not (ROOT / "admm_tpu" / "ops").exists()
