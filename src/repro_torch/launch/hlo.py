"""Collective-byte accounting for the roofline: the reference's
`repro/launch/hlo.py` over dispatch records instead of HLO text.

There is no compiled program to parse. `hlo_cost` runs the step under a
dispatch mode and records one event per collective that a rank's program
calls, (kind, result bytes, group size); this module holds the
reference's conventions for turning those events into per-kind operand
bytes and the bytes a ring algorithm moves over the wire:

    kind                operand              wire
    all-gather          result / g           result (g-1)/g
    reduce-scatter      result * g           result (g-1)
    all-reduce          result               2 result (g-1)/g
    all-to-all          result               result (g-1)/g
    collective-permute  result               result
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, Tuple

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def operand_and_wire(kind: str, result_bytes: float,
                     g: int) -> Tuple[float, float]:
    """(operand bytes, wire bytes) of one collective of `kind` whose
    result holds `result_bytes` on a group of `g` ranks."""
    g = max(int(g), 1)
    if kind == "all-gather":
        return result_bytes / g, result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * g, result_bytes * (g - 1)
    if kind == "all-reduce":
        return result_bytes, 2 * result_bytes * (g - 1) / g
    if kind == "all-to-all":
        return result_bytes, result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return result_bytes, result_bytes
    raise ValueError(f"unknown collective kind {kind!r}; one of "
                     f"{COLLECTIVES}")


def collective_bytes(events: Iterable[Tuple[str, float, int]]
                     ) -> Dict[str, int]:
    """Per-kind operand bytes and `<kind>_count`, plus 'total' (the
    operand bytes of every kind) and 'wire' (see the module docstring),
    over the events (kind, result bytes, group size) of one rank's
    program."""
    out: Dict[str, float] = defaultdict(float)
    wire = 0.0
    for kind, result_bytes, g in events:
        operand, w = operand_and_wire(kind, result_bytes, g)
        out[kind] += operand
        out[kind + "_count"] += 1
        wire += w
    out["total"] = sum(v for k, v in out.items() if k in COLLECTIVES)
    out["wire"] = wire
    return {k: int(v) for k, v in out.items()}


def op_histogram(op_names: Iterable[str]) -> Dict[str, int]:
    """How many times each op ran, by name (`aten.mm`,
    `c10d.allreduce_`)."""
    return dict(Counter(op_names))
