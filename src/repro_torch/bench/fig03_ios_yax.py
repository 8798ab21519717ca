"""Paper Fig. 3: CDF of measured-GFLOP/s ratio (X / Real-CG) for X in
{YAX, IOS}. Claim: YAX systematically overpredicts the CG-embedded SpMV
performance; IOS tracks it. A pure view over the locality campaign."""
from __future__ import annotations

import numpy as np

from ..core.measure import profiles
from . import common

CSV = "fig03_ios_yax_cdf.csv"
HEADER = ["method", "ratio_to_cg", "cdf"]


def run(quick: bool = False, matrices=None, device=None):
    mats = common.locality_names(matrices)
    rep = common.campaign_report(common.locality_spec(matrices=mats),
                                 device=device)
    schemes = common.SCHEMES
    ios_g = rep.grid("seq_ios_gflops", mats, schemes)
    yax_g = rep.grid("seq_yax_gflops", mats, schemes)
    cg_g = rep.grid("cg_gflops", mats, schemes)
    r_ios = (ios_g / cg_g).ravel()
    r_yax = (yax_g / cg_g).ravel()
    rows = []
    for name, r in [("IOS", r_ios), ("YAX", r_yax)]:
        v, c = profiles.cdf(r)
        for vi, ci in zip(v, c):
            rows.append([name, round(float(vi), 4), round(float(ci), 4)])
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return {
        "yax_median_ratio": float(np.median(r_yax)),
        "ios_median_ratio": float(np.median(r_ios)),
        "yax_overpredicts": float(np.mean(r_yax > 1.05)),
        "ios_overpredicts": float(np.mean(r_ios > 1.05)),
    }
