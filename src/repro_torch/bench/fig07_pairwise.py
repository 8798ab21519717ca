"""Paper Fig. 7: pairwise win-rate matrix across schemes (IOS GFLOP/s).
Claim: RCM beats every other scheme on most matrices. A pure view over
the locality campaign."""
from __future__ import annotations

from . import common

CSV = "fig07_pairwise.csv"
HEADER = ["mode", "row_scheme", "col_scheme", "win_rate"]


def run(quick: bool = False, matrices=None, device=None):
    mats = common.locality_names(matrices)
    rep = common.campaign_report(common.locality_spec(matrices=mats),
                                 device=device)
    schemes = common.SCHEMES
    out, rows = {}, []
    for mode, field in [("sequential", "seq_ios_gflops"),
                        ("parallel_modelled", "par_static_gflops")]:
        win = rep.pairwise_win_rates(field, mats, schemes)
        for i, si in enumerate(schemes):
            for j, sj in enumerate(schemes):
                rows.append([mode, si, sj, round(float(win[i, j]), 3)])
        r = schemes.index("rcm")
        out[f"{mode}_rcm_beats_all"] = bool(
            all(win[r, j] >= 0.5 for j in range(len(schemes)) if j != r))
        out[f"{mode}_rcm_vs_metis"] = round(
            float(win[r, schemes.index("metis")]), 3)
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
