"""Shared campaign specs of the port's paper-figure drivers.

The measurement layer is `repro_torch.experiments` (ExperimentSpec →
Runner → ResultStore → Report); this module holds the two standard
campaign specs the figures share, plus the store wiring:

  * locality campaign    — locality-tier matrices × all schemes on the
                           primary machine profile, instrumented CG
                           included (figs 3, 5, 6, 7, 11, table 1).
  * consistency campaign — the fig-8 matrix subset × all schemes over
                           EVERY registered machine profile (M1..M5;
                           plugin profiles join automatically).

Cells are content-addressed in the result store under RESULTS_DIR, so
the grid is measured once no matter how many figures view it, a re-run
measures nothing, and adding a matrix, scheme or profile measures only
the delta. Every driver measures on the card unless it is given
device="cpu".

RESULTS_DIR (the drivers' CSVs and the store; experiments/store.py) is
bench/results/ beside this module; REPRO_TORCH_RESULTS_DIR moves it, and
REPRO_TORCH_RESULT_STORE moves the store alone.
"""
from __future__ import annotations

from typing import Callable, Optional

from .. import obs
from ..experiments import (PRIMARY, ExperimentSpec, MeasurePolicy, Report,
                           ResultStore, Runner, paper_schemes, write_csv)
from ..experiments.store import RESULTS_DIR, result_path, results_dir

# paper schemes + the random-permutation control (Fig. 1's shuffle)
SCHEMES = paper_schemes()

QUICK_MATRICES = [
    "banded_m16384_bw8", "banded_shuf_m16384_bw8", "stencil2d_shuf_128",
    "rmat_s14_e8", "sbm_m16384_k16", "smallworld_m16384_k6",
    "uniform_m16384_d8", "kron_b11_p4",
]
# fig8 consistency subset (all profiles measured on these)
CONSISTENCY_MATRICES = QUICK_MATRICES + [
    "banded_shuf_m32768_bw63", "stencil3d_shuf_24", "sbm_m32768_k32",
    "rmat_s15_e8", "uniform_m32768_d12", "stencil2d_181",
]


def result_store() -> ResultStore:
    """The drivers' result store (REPRO_TORCH_RESULT_STORE, or the
    operator-cache fallback, overrides `<results_dir()>/store_torch`)."""
    return ResultStore(results_dir=results_dir())


def campaign_policy(iters: int = 12) -> MeasurePolicy:
    """The standard full-protocol cell policy: IOS + YAX + modelled
    parallel + structural metrics everywhere, instrumented CG on the
    primary profile only (the paper's convention)."""
    return MeasurePolicy(iters=iters, cg_profiles=(PRIMARY,))


def locality_names(matrices=None) -> tuple:
    """The locality tier, or the caller's `matrices`."""
    from ..matrices import suite

    return tuple(suite.locality_names() if matrices is None else matrices)


def locality_spec(iters: int = 12, matrices=None) -> ExperimentSpec:
    return ExperimentSpec(
        name="locality", matrices=locality_names(matrices),
        schemes=tuple(SCHEMES), profiles=(PRIMARY,),
        policy=campaign_policy(iters))


def consistency_spec(quick: bool = False, iters: int = 12,
                     matrices=None) -> ExperimentSpec:
    if matrices is None:
        matrices = CONSISTENCY_MATRICES[:6] if quick else CONSISTENCY_MATRICES
    return ExperimentSpec(
        name="consistency", matrices=tuple(matrices), schemes=tuple(SCHEMES),
        profiles=("*",), policy=campaign_policy(iters))


def campaign_report(spec: ExperimentSpec, verbose: bool = True,
                    get_matrix: Optional[Callable] = None,
                    device=None) -> Report:
    """Measure (resumably) and return the typed report. The counters
    bench.cells_measured and bench.cells_reused (repro_torch.obs) add up
    the cells each call measured and served from the store."""
    rep = Runner(spec, store=result_store(), verbose=verbose,
                 get_matrix=get_matrix, device=device).run()
    obs.counter("bench.cells_measured").inc(rep.measured)
    obs.counter("bench.cells_reused").inc(rep.reused)
    return rep


__all__ = [
    "CONSISTENCY_MATRICES", "PRIMARY", "QUICK_MATRICES",
    "RESULTS_DIR", "SCHEMES", "campaign_policy", "campaign_report",
    "consistency_spec", "locality_names", "locality_spec", "result_path",
    "result_store", "results_dir", "write_csv",
]
