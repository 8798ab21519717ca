"""The port stands alone: importing repro_torch loads neither jax nor the JAX
package, no source file under src/repro_torch imports either (nor a network
library), and every entry point runs on the card unless the caller asks for
the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bench import run as bench_run
from repro_torch.core.measure import ios
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.spmv import plan as tplan
from repro_torch.core.spmv.ops import make_engine
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, smoke_config
from repro_torch.experiments import ExperimentSpec, MeasurePolicy, Runner
from repro_torch.core.spmv.topology import Topology
from repro_torch.launch import spmv_bench
from repro_torch.launch import specs as launch_specs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.router import MeshSpec, RoutedSpmvService
from repro_torch.models import model as lm
from repro_torch.serving.decode import generate, prefill
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop
from repro_torch.training.tree import leaves
from repro_torch.launch import train as launch_train

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def _hermetic_stores(tmp_path, monkeypatch):
    for var in ("REPRO_TORCH_PLAN_CACHE", "REPRO_TORCH_REORDER_CACHE",
                "REPRO_TORCH_RESULT_STORE", "REPRO_TORCH_RESULTS_DIR",
                "REPRO_TORCH_CORPUS_CACHE"):
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


NETWORK = {"urllib", "http", "socket", "ssl", "ftplib", "requests"}


@pytest.mark.parametrize("path", [p for p, _ in _modules()],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_has_network_code(path):
    """Nothing is downloaded: no module of the port imports a network
    library."""
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & NETWORK, path


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
        bench_run.smoke_route()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RoutedSpmvService([MeshSpec("m", Topology(devices=2))])
    for arch in ("zamba2-7b", "qwen2-7b", "gemma2-27b", "qwen3-moe-30b-a3b"):
        cfg = smoke_config(registry.get(arch))
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
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_loop.init_state(cfg)
        # the dry-run's cache shapes touch no device: the meta device
        shapes = launch_specs.cache_shape(cfg, SHAPES["decode_32k"])
        assert {t.device.type for t in leaves(shapes)
                if isinstance(t, torch.Tensor)} == {"meta"}
        step, _, _ = train_loop.make_train_step(cfg, topt.OptConfig())
        state = {"params": params, "opt": topt.init_opt_state(params)}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step(state, {"tokens": np.zeros((1, 4), np.int32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.train(launch_train.small_lm_config(), 2, "unused")
    # a mesh, and with it make_serve_step(mesh=), is on the card unless
    # the caller asks for the CPU (make_cpu_mesh, make_mesh(device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh()


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


# -- the figure drivers and the examples --------------------------------------
REFERENCE_ROOTS = {"jax", "jaxlib", "repro", "benchmarks", "examples"}
DRIVER_MODULES = [(p, n) for p, n in _modules()
                  if n.split(".")[1:2] in (["bench"], ["examples"])]


@pytest.mark.parametrize("path", [p for p, _ in DRIVER_MODULES],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_drivers_and_examples_import_no_reference(path):
    """repro_torch.bench and repro_torch.examples keep their own copies:
    no import of jax, the JAX package, its benchmarks/ or its examples/."""
    roots = set(_imported_roots(ast.parse(path.read_text())))
    assert not roots & REFERENCE_ROOTS, path


def test_importing_the_drivers_leaves_the_reference_out():
    names = [name for _, name in DRIVER_MODULES]
    assert {"repro_torch.bench.run", "repro_torch.bench.common",
            "repro_torch.bench.workloads", "repro_torch.bench.moe_dispatch",
            "repro_torch.bench.corpus_scale", "repro_torch.bench.regress",
            "repro_torch.examples.cg_solver",
            "repro_torch.examples.train_small_lm"} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            f"             {sorted(REFERENCE_ROOTS)!r})\n"
            "sys.exit('loaded: ' + ', '.join(bad) if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_drivers_default_to_the_card_and_raise_without_it(monkeypatch):
    from repro_torch.bench import (corpus_scale, fig01_banded_shuffle,
                                   fig03_ios_yax, moe_dispatch, spmm_batch,
                                   summarize_repro, workloads)
    from repro_torch.core.measure import cg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: fig01_banded_shuffle.run(),
                 lambda: fig03_ios_yax.run(matrices=("smoke_banded",)),
                 lambda: summarize_repro.run(matrices=("smoke_banded",)),
                 lambda: spmm_batch.run(smoke=True),
                 lambda: bench_run.smoke(),
                 lambda: bench_run.smoke_parallel(),
                 lambda: bench_run.smoke_serve(),
                 lambda: bench_run.smoke_route(),
                 lambda: workloads.run(quick=True),
                 lambda: workloads.smoke(),
                 lambda: moe_dispatch.run(quick=True),
                 lambda: corpus_scale.run(quick=True),
                 lambda: corpus_scale.smoke(),
                 lambda: spmv_bench.run_single("smoke_banded"),
                 lambda: cg.solve_problem(_mat(), torch.ones(8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
