"""The benchmark corpus — a seeded, named, structurally diverse matrix suite.

The same catalog as the JAX package's synthetic tiers, from the same
generators and seeds, so a name gives the same matrix in both packages:

  * SMOKE    — tiny, for unit tests (seconds).
  * BENCH    — the default benchmark corpus (10k-66k rows).
  * LARGE    — the Fig. 1 pair at 1,048,576 rows.
  * LOCALITY — ~520k rows.
  * CORPUS   — real SuiteSparse matrices (a bundled fixture, a local .mtx,
               or an offline stand-in) resolved through repro_torch.corpus;
               names carry the `corpus://` prefix.
  * WORKLOAD — dynamic model-layer sparsity streams (repro_torch.workloads);
               names carry the `workload://` prefix and resolve to the
               stream's step-0 representative matrix (the full stream is
               the "workload" cell kind's business).

Synthetic entries are
deterministic in their seed and cached on disk (npz, write-then-rename)
after first build, under REPRO_TORCH_MATRIX_CACHE (default
`repro_torch_matrices` under the system temp directory; "off" disables);
corpus entries resolve through the content-addressed `.csrz` artifact
store (REPRO_TORCH_CORPUS_CACHE).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
from typing import Callable, Dict, Optional

import numpy as np

from ..core.sparse.csr import CSRMatrix
from . import generators as G

TIERS = ("smoke", "bench", "large", "locality", "corpus", "workload")


@dataclasses.dataclass(frozen=True)
class MatrixDef:
    """One catalog entry: a named, tiered thunk producing a CSRMatrix."""

    name: str
    tier: str
    thunk: Callable[[], CSRMatrix]


_CATALOG: Dict[str, MatrixDef] = {}


def register_matrix(name: str, tier: str,
                    thunk: Callable[[], CSRMatrix]) -> None:
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; known: {TIERS}")
    if name in _CATALOG:
        raise ValueError(f"matrix {name!r} already registered")
    _CATALOG[name] = MatrixDef(name=name, tier=tier, thunk=thunk)


def _cache_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_MATRIX_CACHE",
        os.path.join(tempfile.gettempdir(), "repro_torch_matrices"))


def _cached(name: str, thunk: Callable[[], CSRMatrix]) -> CSRMatrix:
    root = _cache_dir()
    if root.lower() in ("off", "0", "none", ""):
        return thunk()
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name + ".npz")
    if os.path.exists(path):
        z = np.load(path)
        return CSRMatrix(rowptr=z["rowptr"], cols=z["cols"], vals=z["vals"],
                         shape=tuple(int(v) for v in z["shape"]))
    mat = thunk()
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, rowptr=mat.rowptr, cols=mat.cols, vals=mat.vals,
                 shape=np.asarray(mat.shape))
    os.replace(tmp, path)
    return mat


def names(tier: Optional[str] = None) -> list:
    """Catalog names, optionally restricted to one tier (sorted)."""
    if tier is None:
        return sorted(_CATALOG)
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}; known: {TIERS}")
    return sorted(n for n, d in _CATALOG.items() if d.tier == tier)


def get(name: str) -> CSRMatrix:
    """Resolve a catalog name: synthetic, corpus:// or workload://."""
    if name.startswith("corpus://"):
        from ..corpus import manifest as corpus_manifest

        return corpus_manifest.resolve(name)
    if name.startswith("workload://"):
        from ..workloads import sources as workload_sources

        return workload_sources.representative(name)
    if name not in _CATALOG:
        raise KeyError(f"unknown matrix {name!r}; known: "
                       f"{sorted(_CATALOG)[:10]}... (or a corpus:// / "
                       f"workload:// name)")
    return _cached(name, _CATALOG[name].thunk)


def bench_names() -> list:
    return names("bench")


def smoke_names() -> list:
    return names("smoke")


def large_names() -> list:
    return names("large")


def locality_names() -> list:
    return names("locality")


def corpus_names() -> list:
    """Qualified corpus:// names from the corpus manifest."""
    from ..corpus import manifest as corpus_manifest

    return corpus_manifest.corpus_names()


def workload_names() -> list:
    """Canonical workload:// preset names (any parameterization of the
    repro_torch.workloads name grammar resolves too)."""
    from ..workloads import sources as workload_sources

    return workload_sources.preset_names()


# --------------------------------------------------------------------------
# built-in catalog (names, generators and seeds as in the JAX package)
# --------------------------------------------------------------------------
def _register_bench() -> None:
    # banded family (RCM's home turf) + shuffled twins (Fig. 1 regime)
    for i, (m, bw) in enumerate([(16384, 8), (16384, 32), (32768, 16),
                                 (32768, 63), (65536, 8), (65536, 24)]):
        register_matrix(f"banded_m{m}_bw{bw}", "bench",
                        lambda m=m, bw=bw, i=i: G.banded(m, bw, seed=i))
        register_matrix(f"banded_shuf_m{m}_bw{bw}", "bench",
                        lambda m=m, bw=bw, i=i:
                        G.shuffle(G.banded(m, bw, seed=i), seed=100 + i))
    # 2-D/3-D stencils (+ shuffled: hidden locality that RCM can recover)
    for i, nx in enumerate([128, 181, 256]):
        register_matrix(f"stencil2d_{nx}", "bench",
                        lambda nx=nx, i=i: G.stencil_2d(nx, seed=i))
        register_matrix(f"stencil2d_shuf_{nx}", "bench",
                        lambda nx=nx, i=i:
                        G.shuffle(G.stencil_2d(nx, seed=i), seed=200 + i))
    for i, nx in enumerate([24, 32]):
        register_matrix(f"stencil3d_{nx}", "bench",
                        lambda nx=nx, i=i: G.stencil_3d(nx, seed=i))
        register_matrix(f"stencil3d_shuf_{nx}", "bench",
                        lambda nx=nx, i=i:
                        G.shuffle(G.stencil_3d(nx, seed=i), seed=300 + i))
    # power-law graphs (load-imbalance stressors)
    for i, (scale, ef) in enumerate([(14, 8), (14, 16), (15, 8), (16, 6)]):
        register_matrix(f"rmat_s{scale}_e{ef}", "bench",
                        lambda s=scale, e=ef, i=i: G.rmat(s, e, seed=i))
    # community graphs, shuffled to hide structure
    for i, (m, k, pin) in enumerate([(16384, 16, 0.004), (32768, 32, 0.002),
                                     (16384, 8, 0.006), (32768, 64, 0.004)]):
        register_matrix(f"sbm_m{m}_k{k}", "bench",
                        lambda m=m, k=k, pin=pin, i=i:
                        G.shuffle(G.sbm(m, k, pin, 8.0 / m / m * 4, seed=i),
                                  seed=400 + i))
    # small world
    for i, (m, k, beta) in enumerate([(16384, 6, 0.05), (32768, 8, 0.1),
                                      (65536, 6, 0.02)]):
        register_matrix(f"smallworld_m{m}_k{k}", "bench",
                        lambda m=m, k=k, b=beta, i=i:
                        G.small_world(m, k, b, seed=i))
    # kronecker
    for i, (bm, p) in enumerate([(11, 4), (26, 3)]):
        register_matrix(f"kron_b{bm}_p{p}", "bench",
                        lambda b=bm, p=p, i=i: G.kron_graph(b, p, seed=i))
    # uniform random (no structure to find — reordering should not help)
    for i, (m, d) in enumerate([(16384, 8), (32768, 12), (65536, 6)]):
        register_matrix(f"uniform_m{m}_d{d}", "bench",
                        lambda m=m, d=d, i=i: G.random_uniform(m, d, seed=i))
    # explicit power-law row skew (hub rows; padded-ELL worst case)
    for i, (m, a) in enumerate([(16384, 2.1), (32768, 1.9), (16384, 1.7)]):
        register_matrix(f"powerlaw_m{m}_a{round(a * 10)}", "bench",
                        lambda m=m, a=a, i=i: G.power_law(m, alpha=a, seed=i))


def _register_large() -> None:
    # the Fig. 1 pair: 1,048,576 rows, half-bandwidth 15 (31 nonzeros/row)
    register_matrix("fig1_banded", "large",
                    lambda: G.banded(1048576, 15, seed=7))
    register_matrix("fig1_shuffled", "large",
                    lambda: G.shuffle(G.banded(1048576, 15, seed=7), seed=8))


def _register_locality() -> None:
    M = 524288
    defs = {
        "loc_banded_bw8": lambda: G.banded(M, 8, seed=20),
        "loc_banded_shuf_bw8":
            lambda: G.shuffle(G.banded(M, 8, seed=20), seed=21),
        "loc_banded_shuf_bw24":
            lambda: G.shuffle(G.banded(M, 24, seed=22), seed=23),
        "loc_stencil2d_shuf":
            lambda: G.shuffle(G.stencil_2d(724, seed=24), seed=25),
        "loc_stencil3d_shuf":
            lambda: G.shuffle(G.stencil_3d(80, seed=26), seed=27),
        "loc_sbm_k64": lambda: G.shuffle(
            G.sbm(M, 64, 0.0008, 1.0 / M / 64, seed=28), seed=29),
        "loc_smallworld_k8": lambda: G.small_world(M, 8, 0.05, seed=30),
        "loc_rmat_s19": lambda: G.rmat(19, 8, seed=31),
        "loc_uniform_d8": lambda: G.random_uniform(M, 8, seed=32),
        # naturally-ordered matrices (baseline already near-optimal)
        "loc_stencil2d_nat": lambda: G.stencil_2d(724, seed=33),
        "loc_stencil3d_nat": lambda: G.stencil_3d(80, seed=34),
        "loc_banded_bw24_nat": lambda: G.banded(M, 24, seed=35),
        "loc_banded_bw3_nat": lambda: G.banded(M, 3, seed=36),
    }
    for name, thunk in defs.items():
        register_matrix(name, "locality", thunk)


def _register_smoke() -> None:
    defs = {
        "smoke_banded": lambda: G.banded(256, 4, seed=1),
        "smoke_stencil": lambda: G.stencil_2d(20, seed=2),
        "smoke_rmat": lambda: G.rmat(8, 4, seed=3),
        "smoke_sbm":
            lambda: G.shuffle(G.sbm(512, 8, 0.08, 0.002, seed=4), seed=5),
        "smoke_powerlaw": lambda: G.power_law(1024, alpha=1.9, seed=6),
    }
    for name, thunk in defs.items():
        register_matrix(name, "smoke", thunk)


_register_bench()
_register_large()
_register_locality()
_register_smoke()
