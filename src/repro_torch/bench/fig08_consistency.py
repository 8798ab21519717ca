"""Paper Fig. 8: cross-machine consistency of reordering speedups.

Machines -> the registered machine profiles M1..M5 (engine, dtype and
core-count variations on one device; the reproduced claim is the
EXISTENCE of inconsistency, Consistent% < 100 at low tau). A view over
the consistency campaign, which iterates EVERY registered profile
(profiles="*") — a plugin profile joins this figure by calling
register_profile.
"""
from __future__ import annotations

from ..core.registry import PROFILE_REGISTRY
from . import common

TAUS = [1.1, 1.25, 1.5, 2.0]
CSV = "fig08_consistency.csv"
HEADER = ["mode", "scheme", "tau", "consistent_pct", "n_candidates"]


def run(quick: bool = False, matrices=None, device=None):
    sp = common.consistency_spec(quick, matrices=matrices)
    rep = common.campaign_report(sp, device=device)
    mats = sp.matrices
    profs = list(PROFILE_REGISTRY)
    schemes = [s for s in common.SCHEMES if s != "baseline"]
    rows, out = [], {}
    for mode, field in [("sequential", "seq_ios_gflops"),
                        ("parallel_modelled", "par_static_gflops")]:
        for s in schemes:
            # one speedup stack per (mode, scheme), swept over all taus
            for tau, (cons, n) in zip(
                    TAUS, rep.consistency(field, mats, s, profs, TAUS)):
                rows.append([mode, s, tau, round(cons, 3), n])
                out[f"{mode}_{s}_tau{tau}"] = round(cons, 3)
    common.write_csv(common.result_path(CSV), HEADER, rows)
    return out
