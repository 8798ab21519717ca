"""Plugin registries for reordering schemes and SpMV engines.

The planner plans over *whatever is registered*: a reordering scheme is a
function `(mat, seed) -> perm` registered with @register_scheme, an engine
is a build function `(mat, dtype=..., block_shape=..., sell_sigma=...,
use_kernel=..., device=...) -> operator` registered with
@register_engine. Every engine implements
operator.matmul(X[n, k]). Planning metadata rides on the spec:

  * SchemeSpec.auto_candidate  — plan(reorder="auto") tries it by default
  * EngineSpec.cost_fn         — bytes-per-SpMM model (core/spmv/tune.py)
  * EngineSpec.candidates_fn   — (mat, feat) -> shape grid the tuner scores

These are the port's own classes and dicts, so neither package can shadow
or clobber the other's registrations. Built-ins register at import of
core.reorder.api and core.spmv.ops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class SchemeSpec:
    """A registered reordering scheme: perm = fn(mat, seed)."""

    name: str
    fn: Callable
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


SCHEME_REGISTRY: Dict[str, SchemeSpec] = {}
ENGINE_REGISTRY: Dict[str, EngineSpec] = {}


def register_scheme(name: str, *, auto_candidate: bool = False,
                    description: str = "") -> Callable:
    """Decorator: register `fn(mat, seed=0) -> perm` under `name`."""

    def deco(fn: Callable) -> Callable:
        if name in SCHEME_REGISTRY:
            raise ValueError(f"scheme {name!r} already registered")
        SCHEME_REGISTRY[name] = SchemeSpec(
            name=name, fn=fn, auto_candidate=auto_candidate,
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
