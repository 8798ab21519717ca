"""`python -m repro_torch.corpus` — the corpus ingestion CLI (offline).

    python -m repro_torch.corpus list
    python -m repro_torch.corpus ingest --fixtures [--chunk-nnz N] [--trace t.json]
    python -m repro_torch.corpus ingest corpus://bcsstk17 [--expect-cached]
    python -m repro_torch.corpus verify --all

`--trace` wraps the run in obs.tracing() and writes a Perfetto-loadable
Chrome trace, so ingestion shows up as `corpus.parse` / `corpus.build`
spans next to the planner's. `--expect-cached` turns the run into an
assertion that *zero* parsing happened (every matrix resolved from its
`.csrz` artifact), the proof that a re-ingest is a 100% cache hit. An
entry with no local file resolves to its stand-in; nothing is downloaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .. import obs
from . import artifact, manifest


def _select(args) -> list:
    entries = manifest.load_manifest()
    if getattr(args, "all", False):
        return sorted(entries)
    if getattr(args, "fixtures", False):
        return sorted(n for n, e in entries.items() if e.fixture)
    names = [n[len(manifest.CORPUS_PREFIX):]
             if n.startswith(manifest.CORPUS_PREFIX) else n
             for n in (args.names or [])]
    if not names:
        raise SystemExit("no matrices selected: pass names, --fixtures, "
                         "or --all")
    for n in names:
        manifest.get_entry(n)  # fail fast with the known-names message
    return names


def _cmd_list(args) -> int:
    entries = manifest.load_manifest()
    rows = []
    for name in sorted(entries):
        e = entries[name]
        src = ("fixture" if e.fixture else "local" if os.path.exists(
            manifest.local_mtx_path(e)) else "stand-in")
        rows.append({"name": e.qualified, "m": e.m, "n": e.n, "nnz": e.nnz,
                     "symmetric": e.symmetric, "kind": e.kind, "source": src})
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        w = max(len(r["name"]) for r in rows)
        for r in rows:
            print(f"{r['name']:<{w}}  {r['m']:>9} x {r['n']:>9}  "
                  f"nnz {r['nnz']:>10}  {r['kind']:<8} {r['source']}")
    return 0


def _cmd_ingest(args) -> int:
    names = _select(args)
    before = obs.snapshot()["counters"].get("corpus.parses", 0)
    failures = 0
    for name in names:
        try:
            res = manifest.ensure(name, chunk_nnz=args.chunk_nnz)
        except (ValueError, OSError, KeyError) as e:
            print(f"INGEST FAIL {name}: {e}", file=sys.stderr)
            failures += 1
            continue
        how = "cache-hit" if res.cache_hit else (
            "stand-in" if res.meta.get("standin") else "parsed")
        extra = ""
        if res.parse_stats:
            extra = (f"  chunks={res.parse_stats['chunks']}"
                     f" chunk_nnz={res.parse_stats['chunk_nnz']}")
        print(f"{manifest.CORPUS_PREFIX}{name}: {how}  "
              f"{res.mat.m}x{res.mat.n} nnz={res.mat.nnz}  "
              f"artifact={res.artifact or '-'}{extra}")
    parses = obs.snapshot()["counters"].get("corpus.parses", 0) - before
    print(f"ingest: {len(names) - failures}/{len(names)} ok, "
          f"{parses} parse(s)")
    if args.expect_cached and parses:
        print(f"EXPECT-CACHED FAILED: {parses} matrices were re-parsed "
              "instead of resolving from .csrz artifacts", file=sys.stderr)
        return 1
    return 1 if failures else 0


def _cmd_verify(args) -> int:
    names = _select(args)
    failures = 0
    for name in names:
        try:
            rep = manifest.verify_entry(name)
        except (ValueError, OSError, KeyError) as e:
            print(f"VERIFY FAIL {name}: {e}", file=sys.stderr)
            failures += 1
            continue
        tag = "ok" if rep["ok"] else "FAIL"
        kind = " (stand-in)" if rep["standin"] else ""
        print(f"{manifest.CORPUS_PREFIX}{name}: {tag}{kind}")
        for p in rep["problems"]:
            print(f"  - {p}", file=sys.stderr)
        failures += 0 if rep["ok"] else 1
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.corpus",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="print the corpus manifest")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_list)

    for cmd, fn, hlp in (("ingest", _cmd_ingest,
                          "parse matrices into .csrz artifacts"),
                         ("verify", _cmd_verify,
                          "check artifacts against manifest + sidecars")):
        p = sub.add_parser(cmd, help=hlp)
        p.add_argument("names", nargs="*", help="corpus names "
                       "(corpus:// prefix optional)")
        p.add_argument("--fixtures", action="store_true",
                       help="select the bundled fixtures")
        p.add_argument("--all", action="store_true",
                       help="select every manifest entry")
        if cmd == "ingest":
            p.add_argument("--chunk-nnz", type=int, default=None,
                           help="coordinate lines per parse block")
            p.add_argument("--expect-cached", action="store_true",
                           help="fail if any matrix had to be parsed")
        p.set_defaults(fn=fn)

    args = ap.parse_args(argv)
    if args.trace:
        with obs.tracing() as buf:
            try:
                rc = args.fn(args)
            finally:
                obs.write_trace(args.trace, buf.flush())
                print(f"trace written to {args.trace}")
        return rc
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
