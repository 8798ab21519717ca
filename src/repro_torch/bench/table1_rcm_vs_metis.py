"""Paper Table 1: RCM-vs-METIS win/loss counts under IOS, CG, and YAX.
Claim: IOS and CG agree (RCM wins); YAX flips the conclusion.
A pure view over the locality campaign."""
from __future__ import annotations

from . import common

CSV = "table1_rcm_vs_metis.csv"
HEADER = ["method", "rcm_wins", "rcm_losses"]


def run(quick: bool = False, matrices=None, device=None):
    mats = common.locality_names(matrices)
    rep = common.campaign_report(common.locality_spec(matrices=mats),
                                 device=device)
    rows, out = [], {}
    for method, field in [("IOS", "seq_ios_gflops"), ("CG", "cg_gflops"),
                          ("YAX", "seq_yax_gflops")]:
        duel = rep.grid(field, mats, ["rcm", "metis"])
        rcm, met = duel[0], duel[1]
        w = int((rcm > met).sum())
        l = int((rcm < met).sum())
        rows.append([method, w, l])
        out[f"{method}_rcm_w"] = w
        out[f"{method}_rcm_l"] = l
    common.write_csv(common.result_path(CSV), HEADER, rows)
    out["ios_cg_agree"] = (out["IOS_rcm_w"] > out["IOS_rcm_l"]) == \
        (out["CG_rcm_w"] > out["CG_rcm_l"])
    return out
