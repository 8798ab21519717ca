"""Paper Fig. 5: Dolan-More performance profiles of the reordering schemes,
sequential (measured) and parallel (modelled) — IOS methodology. A pure
view over the locality campaign."""
from __future__ import annotations

import numpy as np

from . import common

TAUS = np.array([1.0, 1.05, 1.1, 1.25, 1.5, 2.0, 3.0])
CSV = "fig05_profiles.csv"
HEADER = ["mode", "scheme", "tau", "fraction"]


def run(quick: bool = False, matrices=None, device=None):
    mats = common.locality_names(matrices)
    rep = common.campaign_report(common.locality_spec(matrices=mats),
                                 device=device)
    schemes = common.SCHEMES
    out = {}
    rows = []
    for mode, field in [("sequential", "seq_ios_gflops"),
                        ("parallel_modelled", "par_static_gflops")]:
        prof = rep.performance_profile(field, mats, schemes, TAUS)
        for i, s in enumerate(schemes):
            for t, v in zip(TAUS, prof[i]):
                rows.append([mode, s, float(t), round(float(v), 4)])
        # winner at tau=1 (fraction of matrices where scheme is the best)
        out[f"{mode}_tau1"] = {s: round(float(prof[i, 0]), 3)
                               for i, s in enumerate(schemes)}
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
