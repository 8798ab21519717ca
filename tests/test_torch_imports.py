"""The port stands alone: importing repro_torch loads neither jax nor the JAX
package, no source file under src/repro_torch imports either, and every
entry point runs on the card unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.measure import ios
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import plan as tplan
from repro_torch.core.spmv.ops import make_engine
from repro_torch.configs import registry
from repro_torch.configs.base import smoke_config
from repro_torch.experiments import ExperimentSpec, MeasurePolicy, Runner
from repro_torch.launch import spmv_bench
from repro_torch.models import model as lm
from repro_torch.serving.decode import generate, prefill

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def _hermetic_stores(tmp_path, monkeypatch):
    for var in ("REPRO_TORCH_PLAN_CACHE", "REPRO_TORCH_REORDER_CACHE",
                "REPRO_TORCH_RESULT_STORE"):
        monkeypatch.setenv(var, str(tmp_path / var))


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_import_leaves_jax_and_repro_out():
    names = [name for _, name in _modules()]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "sys.exit('loaded: ' + ', '.join(bad) if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", [p for p, _ in _modules()],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_repro(path):
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & {"jax", "jaxlib", "repro"}, path


def test_chip_smoke_imports_neither():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    assert not set(_imported_roots(tree)) & {"jax", "jaxlib", "repro"}


def _mat():
    d = np.diag(np.arange(1.0, 9.0)) + np.eye(8, k=1)
    return CSRMatrix.from_dense(d)


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mat = _mat()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(mat, "csr")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(mat, "sell", block_shape=(8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tplan.plan(tplan.SpmvProblem(mat), reorder="rcm").build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ios.run_ios_batched(lambda x: x, 8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmv_bench.run_cell(mat, "baseline")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(ExperimentSpec(name="x", matrices=("m",)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmv_bench.campaign_smoke()
    cfg = smoke_config(registry.get("zamba2-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 8)
    params = lm.init_params(cfg, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefill(params, {"tokens": tokens}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, params, tokens, 2, cache_len=8)


def test_cpu_runs_only_on_request():
    mat = _mat()
    x = np.arange(8.0)
    rec, op, _ = spmv_bench.run_cell(mat, "rcm", iters=2, cg_iters=2,
                                     device="cpu")
    assert rec["device"] == "cpu" and rec["verify_rel_err"] < 1e-6
    assert rec["verify_twin_rel_err"] < 1e-6
    assert np.allclose(op(torch.as_tensor(x, dtype=torch.float32)).numpy(),
                       mat.spmv(x), rtol=1e-6)
    with pytest.raises(ValueError, match="use_kernel"):
        make_engine(mat, "sell", block_shape=(8, 8), use_kernel="pallas",
                    device="cpu")


def test_runner_runs_on_the_cpu_only_on_request():
    spec = ExperimentSpec(name="x", matrices=("m",), schemes=("rcm",),
                          policy=MeasurePolicy(iters=2, warmup=1,
                                               verify=True))
    rep = Runner(spec, verbose=False, get_matrix=lambda name: _mat(),
                 device="cpu").run()
    (rec,) = rep.records
    assert rec["device"] == "cpu" and rec["verify_twin_rel_err"] < 1e-6
