"""repro_torch.experiments — declarative measurement campaigns (the paper's
methodology as an API), the port's own.

The harness mirrors the Problem→Plan→Operator pipeline one level up:

    spec   = ExperimentSpec(name="locality",          what to measure
                 matrices=suite.locality_names(),
                 schemes=paper_schemes(),
                 profiles=(PRIMARY,),
                 policy=MeasurePolicy(cg_profiles=(PRIMARY,)))
    report = Runner(spec, ResultStore(...)).run()     resumable, on the card
    perf   = report.grid("seq_ios_gflops", mats, schemes)   typed views

Cells are content-addressed in the ResultStore (atomic write-then-rename
JSON under benchmarks/results/store_torch/), so re-running a campaign
measures nothing and extending an axis measures only the delta. Reports
are strict: a missing cell raises MissingCellError instead of propagating
NaN. The "spmv" and "schedule" kinds are ported; `Runner(...,
device="cpu")` runs on the CPU on purpose.
"""
from .cells import CELL_KINDS, get_cell_kind, register_cell_kind
from .machine_profiles import (PRIMARY, get_profile, primary_profile,
                               register_profile)
from .report import MissingCellError, Report, write_csv
from .runner import Runner, run_spec
from .spec import (Cell, ExperimentSpec, MeasurePolicy, paper_schemes,
                   registered_engines)
from .store import ResultStore

__all__ = [
    "Cell", "CELL_KINDS", "ExperimentSpec", "MeasurePolicy",
    "MissingCellError", "PRIMARY", "Report", "ResultStore", "Runner",
    "get_cell_kind", "get_profile", "paper_schemes", "primary_profile",
    "register_cell_kind", "register_profile", "registered_engines",
    "run_spec", "write_csv",
]
