"""Trace exporters: Chrome-trace/Perfetto JSON and a JSONL event log.

``to_chrome_trace(events)`` converts the span events produced by
``spans.TraceBuffer.flush()`` into the Chrome Trace Event Format that
Perfetto (https://ui.perfetto.dev) and chrome://tracing load directly:
every span becomes a B/E (duration-begin / duration-end) pair on its
originating thread, so nesting falls out of timestamp containment per
tid. ``M`` metadata events name each thread.

``validate_chrome_trace`` is the schema gate: every non-metadata
event must be B or E, carry pid/tid, and the B/E events on each
(pid, tid) must balance like parentheses.

Run as a module to check a trace file:

    python -m repro_torch.obs.export trace.json [--require-span plan]
"""
from __future__ import annotations

import json
from contextlib import contextmanager


def to_chrome_trace(events: list) -> dict:
    """Span events (ts/dur in µs) → Chrome-trace JSON object.

    A naive global (ts, phase) sort cannot parenthesize zero-duration
    spans (their B and E share a timestamp), so each thread's sequence is
    built with a stack sweep instead: spans sorted by (ts, -dur, id) —
    parents before the children they contain on start-time ties — with an
    open span's E emitted once the next span starts at-or-after its end
    (the span's recorded parent link keeps a child that starts exactly at
    its parent's end inside it). The result is well-parenthesized per tid
    by construction.
    """
    out = []
    threads = {}
    by_tid: dict = {}
    for ev in events:
        key = (ev["pid"], ev["tid"])
        threads.setdefault(key, ev.get("thread", ""))
        by_tid.setdefault(key, []).append(ev)

    def close(sp):
        out.append({"ph": "E", "pid": sp["pid"], "tid": sp["tid"],
                    "ts": sp["ts"] + sp["dur"]})

    for key in sorted(by_tid):
        spans = sorted(by_tid[key],
                       key=lambda e: (e["ts"], -e["dur"], e["id"]))
        stack: list = []               # open spans, innermost last
        for ev in spans:
            while stack:
                end = stack[-1]["ts"] + stack[-1]["dur"]
                if end < ev["ts"] or (end == ev["ts"]
                                      and stack[-1]["id"] != ev.get("parent")):
                    close(stack.pop())
                else:
                    break
            out.append({"ph": "B", "name": ev["name"], "cat": "repro_torch",
                        "pid": ev["pid"], "tid": ev["tid"], "ts": ev["ts"],
                        "args": dict(ev.get("args") or {})})
            stack.append(ev)
        while stack:
            close(stack.pop())
    meta = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
             "args": {"name": name or f"tid-{tid}"}}
            for (pid, tid), name in sorted(threads.items())]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, events: list) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events), f)


def write_jsonl(path: str, events: list) -> None:
    """One span event per line, raw (ts/dur µs, id/parent links intact)."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")


def write_trace(path: str, events: list) -> None:
    """Extension-dispatched: .jsonl → event log, else Chrome-trace JSON."""
    if path.endswith(".jsonl"):
        write_jsonl(path, events)
    else:
        write_chrome_trace(path, events)


@contextmanager
def trace_to(path: str):
    """The CLIs' `--trace PATH`: record the spans of the scope inside and
    write them to `path` with write_trace, even when the scope raises or
    exits; prints how many. Records nothing when `path` is empty."""
    if not path:
        yield
        return
    from .spans import tracing

    try:
        with tracing() as buf:
            yield
    finally:
        events = buf.flush()
        write_trace(path, events)
        print(f"# trace: {len(events)} span events -> {path}", flush=True)


def validate_chrome_trace(trace) -> list:
    """Schema-check a Chrome-trace object (or a path to one).

    Returns the trace's duration events on success; raises ValueError
    naming the first violation otherwise.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        raise ValueError("traceEvents missing or empty")
    stacks: dict = {}
    duration_events = []
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if "pid" not in ev or "tid" not in ev:
            raise ValueError(f"event {i} ({ph!r}) lacks pid/tid")
        if ph == "M":
            continue
        if ph not in ("B", "E"):
            raise ValueError(f"event {i} has unexpected ph={ph!r}")
        duration_events.append(ev)
        key = (ev["pid"], ev["tid"])
        stack = stacks.setdefault(key, [])
        if ph == "B":
            if "name" not in ev or "ts" not in ev:
                raise ValueError(f"B event {i} lacks name/ts")
            stack.append(ev)
        else:
            if not stack:
                raise ValueError(f"E event {i} on {key} without open B")
            stack.pop()
    for key, stack in stacks.items():
        if stack:
            raise ValueError(
                f"{len(stack)} unbalanced B event(s) on pid/tid {key}: "
                f"{[e['name'] for e in stack]}")
    return duration_events


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate a Chrome-trace JSON file")
    ap.add_argument("path")
    ap.add_argument("--require-span", action="append", default=[],
                    help="span name that must appear (repeatable)")
    args = ap.parse_args(argv)
    evs = validate_chrome_trace(args.path)
    names = {e.get("name") for e in evs if e.get("ph") == "B"}
    missing = [s for s in args.require_span if s not in names]
    if missing:
        print(f"FAIL: required spans absent: {missing}")
        print(f"present: {sorted(names)}")
        return 1
    n_b = sum(1 for e in evs if e["ph"] == "B")
    print(f"OK: {n_b} spans, {len(names)} distinct names, B/E balanced")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
