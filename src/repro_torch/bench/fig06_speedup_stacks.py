"""Paper Fig. 6: stacked speedup-bucket counts per scheme (vs baseline),
sequential (measured) + parallel (modelled). Key paper claim: in the
sequential case every scheme except RCM slows down >50% of matrices.
A pure view over the locality campaign."""
from __future__ import annotations

from ..core.measure import profiles
from . import common

CSV = "fig06_speedup_stacks.csv"
HEADER = ["mode", "scheme", "bucket", "count"]


def run(quick: bool = False, matrices=None, device=None):
    mats = common.locality_names(matrices)
    rep = common.campaign_report(common.locality_spec(matrices=mats),
                                 device=device)
    schemes = [s for s in common.SCHEMES if s != "baseline"]
    rows, out = [], {}
    for mode, field in [("sequential", "seq_ios_gflops"),
                        ("parallel_modelled", "par_static_gflops")]:
        sp = rep.speedup(field, mats, schemes)
        counts = profiles.speedup_buckets(sp)
        for i, s in enumerate(schemes):
            for lbl, c in zip(profiles.BUCKET_LABELS, counts[i]):
                rows.append([mode, s, lbl, int(c)])
            out[f"{mode}_{s}_slowdown_frac"] = round(
                float((sp[i] < 1.0).mean()), 3)
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
