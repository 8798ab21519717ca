"""ExperimentSpec — the declarative side of the measurement harness.

A campaign is a grid of *cells*; a cell is the smallest unit of
measurement (one matrix under one scheme on one machine point with one
batch width, measured under one policy). The spec enumerates the grid,
the Runner (runner.py) measures whatever the ResultStore doesn't already
hold, and the Report (report.py) is the typed view over the cells.

Axes mirror the paper's experiment design:

    matrices x schemes x (profiles | engines x dtypes x ps) x ks x variants

`profiles` names registered machine profiles (core/registry.py) — the
paper's "machines" axis; each expands to its (engine, dtype, p) point.
Alternatively the physical axes (engines/dtypes/ps) are given directly.
`ks` is the SpMM batch-width axis, `variants` a free-form axis consumed
by non-default cell kinds (the scheduling-policy sweep's policy names).

Cell identity is CONTENT-addressed: the key hashes the physical
coordinates plus the resolved measurement policy — never the profile
*name* (a renamed profile with the same physical point reuses its cells)
and never axes that don't change what is measured (amortize_iters is a
reporting knob). Two specs that overlap in cells share them through the
store, so adding an axis value to a campaign only measures the delta.

The port's cells also carry the kind of device they are measured on
(`device_kind`: "cpu", or the card's name), and the key hashes it: a
record measured on the CPU never answers a campaign on the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, Optional

from ..core import registry

CELL_SCHEMA_VERSION = 1


def _tup(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclasses.dataclass(frozen=True)
class MeasurePolicy:
    """How each cell is measured (everything here is key-relevant except
    `amortize_iters`, which only parameterizes reporting).

    * iters / warmup / repeats — median-of-(iters x repeats) IOS samples
      after `warmup` warm calls; warmup=0 is the cold-cache protocol.
    * with_yax / with_parallel / with_metrics — include the YAX harness,
      the modelled-parallel timings, and the analytic structural metrics.
    * cg_profiles — profiles whose cells include the instrumented-CG
      measurement ("*" = every cell; the paper runs CG on the primary
      host only).
    * time_spmv=False — analytic-only cells (no operator build at all).
    * verify — gate each cell on the original-index-space numpy oracle.
    * probe — tuner probe mode, threaded to plan(): False (cost model
      only), True (probe the top candidates), "learned" (advisor
      shortlist mined from prior cells of the port's result store) or
      "exhaustive" (probe everything).
    * use_kernel — "auto" | "cuda" | "ref" (device.py).
    * trace — record each cell's phase-attributed span events (obs)
      into its stored record. Key-relevant only when True (the
      verify_tol convention), so untraced campaigns keep their keys.
    * amortize_iters — SpMV calls the one-off plan time is spread over in
      the Report's amortization/break-even accounting (paper §3: plan
      time is reported separately, never folded into SpMV time).
    """

    iters: int = 12
    warmup: int = 3
    repeats: int = 1
    time_spmv: bool = True
    with_yax: bool = True
    cg_profiles: tuple = ()
    with_parallel: bool = True
    with_metrics: bool = True
    verify: bool = False
    verify_tol: float = 1e-4
    probe: object = False            # False | True | "learned" | "exhaustive"
    trace: bool = False
    use_kernel: str = "auto"
    seed: int = 0
    amortize_iters: int = 100

    def __post_init__(self):
        object.__setattr__(self, "cg_profiles", _tup(self.cg_profiles))

    def cg_for(self, profile: str) -> bool:
        return "*" in self.cg_profiles or profile in self.cg_profiles

    def resolve(self, profile: str) -> dict:
        """The key-relevant policy as measured for one cell: cg_profiles
        collapses to this cell's with_cg bool, so a primary-only campaign
        and a no-CG campaign share every non-CG cell."""
        out = {
            "iters": int(self.iters), "warmup": int(self.warmup),
            "repeats": int(self.repeats),
            "time_spmv": bool(self.time_spmv),
            "with_yax": bool(self.with_yax),
            "with_cg": self.cg_for(profile),
            "with_parallel": bool(self.with_parallel),
            "with_metrics": bool(self.with_metrics),
            "verify": bool(self.verify),
            "probe": (self.probe if isinstance(self.probe, str)
                      else bool(self.probe)),
            "use_kernel": self.use_kernel,
            "seed": int(self.seed),
        }
        if self.verify:   # tolerance only gates verifying cells
            out["verify_tol"] = float(self.verify_tol)
        if self.trace:    # key-relevant only when tracing (key stability)
            out["trace"] = True
        return out


@dataclasses.dataclass(frozen=True)
class Cell:
    """One grid point, fully resolved (policy already per-cell)."""

    kind: str
    matrix: str
    scheme: str
    engine: str
    dtype: str
    p: int
    k: int
    variant: str
    policy: tuple                    # sorted (name, value) pairs
    profile: str = ""                # presentation label, NOT in the key
    device: str = "cpu"              # device kind: "cpu" or the card's name

    def policy_dict(self) -> dict:
        return dict(self.policy)

    def coords(self) -> dict:
        """The identity coordinates (what the key hashes)."""
        return {
            "v": CELL_SCHEMA_VERSION, "kind": self.kind,
            "matrix": self.matrix, "scheme": self.scheme,
            "engine": self.engine, "dtype": self.dtype,
            "p": int(self.p), "k": int(self.k), "variant": self.variant,
            "policy": dict(self.policy), "device": self.device,
        }

    def key(self) -> str:
        blob = json.dumps(self.coords(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:20]

    def label(self) -> str:
        prof = self.profile or f"{self.engine}_{self.dtype}_p{self.p}"
        tail = f"@k{self.k}" if self.k != 1 else ""
        var = f"/{self.variant}" if self.variant else ""
        return f"{prof}|{self.matrix}|{self.scheme}{tail}{var}"


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A declarative measurement campaign (see module docstring).

    profiles — registered profile names, or "*" for every registered
    profile (plugin profiles join automatically). Mutually exclusive with
    the explicit engines/dtypes/ps axes.
    """

    name: str
    matrices: tuple
    schemes: tuple = ("baseline",)
    profiles: tuple = ()
    engines: tuple = ()
    dtypes: tuple = ("float32",)
    ps: tuple = (8,)
    ks: tuple = (1,)
    variants: tuple = ("",)
    kind: str = "spmv"
    policy: MeasurePolicy = dataclasses.field(default_factory=MeasurePolicy)

    def __post_init__(self):
        for f in ("matrices", "schemes", "profiles", "engines", "dtypes",
                  "ps", "ks", "variants"):
            object.__setattr__(self, f, _tup(getattr(self, f)))
        if self.profiles and (self.engines or self.dtypes != ("float32",)
                              or self.ps != (8,)):
            raise ValueError("give either profiles= or the explicit "
                             "engines/dtypes/ps axes, not both (a profile "
                             "already fixes engine, dtype and p)")
        if not self.matrices:
            raise ValueError("spec has no matrices")

    def _machine_points(self) -> list:
        """[(profile_name, engine, dtype, p)] — the machine axis."""
        if self.profiles:
            names = (list(registry.PROFILE_REGISTRY)
                     if "*" in self.profiles else list(self.profiles))
            out = []
            for n in names:
                ps = registry.get_profile(n)
                out.append((ps.name,) + ps.physical())
            return out
        engines = self.engines or ("auto",)
        return [("", e, d, int(p)) for e in engines for d in self.dtypes
                for p in self.ps]

    def cells(self, matrices: Optional[Iterable[str]] = None,
              device: str = "cpu") -> list:
        """Enumerate the grid (optionally restricted to some matrices) for
        one device kind, matrix-major so the Runner materializes each
        matrix once."""
        mats = self.matrices if matrices is None else _tup(matrices)
        points = self._machine_points()
        out = []
        for m in mats:
            for prof, engine, dtype, p in points:
                pol = tuple(sorted(self.policy.resolve(prof).items()))
                for s in self.schemes:
                    for k in self.ks:
                        for var in self.variants:
                            out.append(Cell(
                                kind=self.kind, matrix=m, scheme=s,
                                engine=engine, dtype=dtype, p=p, k=int(k),
                                variant=var, policy=pol, profile=prof,
                                device=device))
        return out


def paper_schemes() -> list:
    """The paper's scheme axis: baseline + the §2.1 schemes + the random
    control (Fig. 1's shuffle) — pulled from the plugin registry, so a
    third-party paper=True scheme joins every campaign that uses this
    default."""
    from ..core.reorder import api as _api  # noqa: F401 — registers built-ins

    paper = [s.name for s in registry.SCHEME_REGISTRY.values() if s.paper]
    return ["baseline"] + paper + ["random"]


def registered_engines(spmm_only: bool = False) -> list:
    """Engine axis from the plugin registry (importing the built-ins).
    Every engine of the port implements matmul, so spmm_only changes
    nothing."""
    from ..core.spmv import ops  # noqa: F401 — registers built-in engines

    return [e.name for e in registry.ENGINE_REGISTRY.values()]
