"""Perf-regression gate CLI (a thin wrapper over experiments/regress.py).

    python -m repro_torch.bench.regress [--baseline A.json] [--current B.json]
        [--rel-tol T] [--portable]

Exit 0 = pass, 1 = regression beyond tolerance, 2 = incomparable (scale
stamps differ / unreadable summary). `--current` defaults to the
summary `bench.run --smoke` writes (BENCH_spmv_torch.json under
common.results_dir()); `--baseline` to the committed card baseline,
baseline/BENCH_spmv_torch.json beside this module. That file is the
summary of one `python -m repro_torch.bench.run --smoke` on an NVIDIA
H100 80GB HBM3 with a 700 W power limit (the five smoke matrices x
{baseline, rcm}, auto engine, 3 iterations; `representative: false`),
so a summary taken on another card or power limit compares best with
`--portable`.
"""
from __future__ import annotations

import os
import sys

from ..experiments.regress import main as regress_main
from ..experiments.report import SUMMARY_NAME
from .common import result_path

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline", SUMMARY_NAME)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--baseline" not in argv:
        argv += ["--baseline", BASELINE]
    if "--current" not in argv:
        argv += ["--current", result_path(SUMMARY_NAME)]
    return regress_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
