"""Plugin registries for reordering schemes, SpMV engines, row
partitioners and machine profiles.

The planner plans over *whatever is registered*: a reordering scheme is a
function `(mat, seed) -> perm` registered with @register_scheme, an engine
is a build function `(mat, dtype=..., block_shape=..., sell_sigma=...,
use_kernel=..., device=...) -> operator` registered with
@register_engine. Every engine implements
operator.matmul(X[n, k]). Planning metadata rides on the spec:

  * SchemeSpec.auto_candidate  — plan(reorder="auto") tries it by default
  * EngineSpec.cost_fn         — bytes-per-SpMM model (core/spmv/tune.py)
  * EngineSpec.candidates_fn   — (mat, feat) -> shape grid the tuner scores

A partitioner is `fn(mat, p, seed=0, **kw) -> (perm | None,
panel_starts[p + 1])` registered with @register_partitioner; a machine
profile is a named (engine, dtype, p) point of a campaign's machines axis,
registered with register_profile (experiments/machine_profiles.py holds
the built-ins).

These are the port's own classes and dicts, so neither package can shadow
or clobber the other's registrations. Built-ins register at import of
core.reorder.api, core.spmv.ops, core.sparse.partition and
repro_torch.experiments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """A registered reordering scheme: perm = fn(mat, seed)."""

    name: str
    fn: Callable
    paper: bool = False               # one of the paper's §2.1 schemes
    auto_candidate: bool = False
    description: str = ""


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """A registered SpMV engine: operator = build(mat, **build_kwargs)."""

    name: str
    build: Callable
    cost_fn: Optional[Callable] = None
    candidates_fn: Optional[Callable] = None
    description: str = ""


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    """A registered row partitioner: fn(mat, p, seed=0, **kw) -> (perm |
    None, panel_starts[p + 1]). `perm` (perm[i] = old row at new position
    i) is applied before the contiguous split; a partitioner that only
    splits returns None. `panel_starts` indexes the (permuted) matrix and
    covers [0, m] monotonically."""

    name: str
    fn: Callable
    auto_candidate: bool = False
    reorders: bool = False            # may return a non-None perm
    description: str = ""


@dataclasses.dataclass(frozen=True)
class ProfileSpec:
    """A registered machine/measurement profile: one point on the paper's
    'machines' axis — the engine family, compute dtype and core count a
    campaign cell is measured under."""

    name: str
    engine: str = "csr"
    dtype: str = "float32"
    p: int = 8
    primary: bool = False
    description: str = ""

    def physical(self) -> tuple:
        """The (engine, dtype, p) coordinates a cell key is built from —
        the profile NAME is presentation, not measurement identity."""
        return (self.engine, self.dtype, int(self.p))


SCHEME_REGISTRY: Dict[str, SchemeSpec] = {}
ENGINE_REGISTRY: Dict[str, EngineSpec] = {}
PROFILE_REGISTRY: Dict[str, ProfileSpec] = {}
PARTITIONER_REGISTRY: Dict[str, PartitionerSpec] = {}


def register_scheme(name: str, *, paper: bool = False,
                    auto_candidate: bool = False,
                    description: str = "") -> Callable:
    """Decorator: register `fn(mat, seed=0) -> perm` under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in SCHEME_REGISTRY:
            raise ValueError(f"scheme {name!r} already registered")
        SCHEME_REGISTRY[name] = SchemeSpec(
            name=name, fn=fn, paper=paper, auto_candidate=auto_candidate,
            description=description)
        return fn

    return deco


def register_engine(name: str, *, cost_fn: Optional[Callable] = None,
                    candidates_fn: Optional[Callable] = None,
                    description: str = "") -> Callable:
    """Decorator: register an operator build function under `name`."""

    def deco(build: Callable) -> Callable:
        if name in ENGINE_REGISTRY:
            raise ValueError(f"engine {name!r} already registered")
        ENGINE_REGISTRY[name] = EngineSpec(
            name=name, build=build, cost_fn=cost_fn,
            candidates_fn=candidates_fn, description=description)
        return build

    return deco


def get_scheme(name: str) -> SchemeSpec:
    try:
        return SCHEME_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scheme {name!r}; known: "
                       f"{sorted(SCHEME_REGISTRY)}") from None


def get_engine(name: str) -> EngineSpec:
    try:
        return ENGINE_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; known: "
                       f"{sorted(ENGINE_REGISTRY)}") from None


def register_partitioner(name: str, *, auto_candidate: bool = False,
                         reorders: bool = False, description: str = "",
                         override: bool = False) -> Callable:
    """Decorator: register `fn(mat, p, seed=0, **kw) -> (perm | None,
    panel_starts)` under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in PARTITIONER_REGISTRY and not override:
            raise ValueError(f"partitioner {name!r} already registered "
                             f"(pass override=True to replace)")
        PARTITIONER_REGISTRY[name] = PartitionerSpec(
            name=name, fn=fn, auto_candidate=auto_candidate,
            reorders=reorders, description=description)
        return fn

    return deco


def register_profile(name: str, *, engine: str = "csr",
                     dtype: str = "float32", p: int = 8,
                     primary: bool = False, description: str = "",
                     override: bool = False) -> ProfileSpec:
    """Register a machine/measurement profile (plain data, no decorator)."""
    if name in PROFILE_REGISTRY and not override:
        raise ValueError(f"profile {name!r} already registered "
                         f"(pass override=True to replace)")
    spec = ProfileSpec(name=name, engine=engine, dtype=dtype, p=int(p),
                       primary=primary, description=description)
    PROFILE_REGISTRY[name] = spec
    return spec


def get_partitioner(name: str) -> PartitionerSpec:
    try:
        return PARTITIONER_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown partitioner {name!r}; known: "
                       f"{sorted(PARTITIONER_REGISTRY)}") from None


def get_profile(name: str) -> ProfileSpec:
    try:
        return PROFILE_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown profile {name!r}; known: "
                       f"{sorted(PROFILE_REGISTRY)}") from None


def primary_profile() -> str:
    """Name of the primary profile (the one the paper's single-machine
    figures are measured on); the first registered when none is marked."""
    for spec in PROFILE_REGISTRY.values():
        if spec.primary:
            return spec.name
    if PROFILE_REGISTRY:
        return next(iter(PROFILE_REGISTRY))
    raise KeyError("no machine profiles registered "
                   "(import repro_torch.experiments to get the built-ins)")
