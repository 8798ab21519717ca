"""Built-in machine profiles (the port's own registrations).

Configs standing in for the paper's four hosts — the consistency claims
under reproduction are about the *existence* of cross-machine
inconsistency, so the axis varies engine dtype and core count (the
modelled-parallel p) on one device; the same five as the JAX package:

    M1 csr-f32-p8   — primary
    M2 csr-f64-p8   — 2x bandwidth pressure (bigger values+x)
    M3 csr-f32-p4   — fewer cores
    M4 csr-f32-p16  — more cores
    M5 auto-f32-p8  — autotuned engine (OSKI-style selection)

Registered through the port's core/registry.py, so campaigns that say
`profiles="*"` pick up plugin profiles the same way plan(engine="auto")
picks up plugin engines.
"""
from __future__ import annotations

from ..core.registry import (PROFILE_REGISTRY, get_profile, primary_profile,
                             register_profile)


def _register_builtin_profiles() -> None:
    if "M1_csr_f32_p8" in PROFILE_REGISTRY:
        return
    register_profile("M1_csr_f32_p8", engine="csr", dtype="float32", p=8,
                     primary=True, description="primary host")
    register_profile("M2_csr_f64_p8", engine="csr", dtype="float64", p=8,
                     description="2x bandwidth pressure (bigger values+x)")
    register_profile("M3_csr_f32_p4", engine="csr", dtype="float32", p=4,
                     description="fewer cores")
    register_profile("M4_csr_f32_p16", engine="csr", dtype="float32", p=16,
                     description="more cores")
    register_profile("M5_auto_f32_p8", engine="auto", dtype="float32", p=8,
                     description="autotuned engine (core/spmv/tune.py)")


_register_builtin_profiles()

PRIMARY = primary_profile()

__all__ = ["PRIMARY", "PROFILE_REGISTRY", "get_profile", "register_profile",
           "primary_profile"]
