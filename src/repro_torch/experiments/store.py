"""ResultStore — content-addressed, resumable persistence for campaign cells.

One cell = one `<key>.json` under the store root (default
`benchmarks/results/store_torch/` under the working directory, overridable
via REPRO_TORCH_RESULT_STORE or the `root=` argument; the JAX package
keeps its own store). Keys come from `Cell.key()` (spec.py): physical
coordinates + device kind + resolved policy, so any two campaigns that
request the same measurement on the same kind of device share the entry
— partial-grid reuse falls out of the addressing, there is no
campaign-level cache file to invalidate.

Write discipline is the plan store's (core/spmv/plan.py): write to a
`<key>.<pid>.<tid>.json.tmp` sibling, then os.replace — readers never
see a torn file, concurrent runners never clobber each other's tmp.

Read discipline is tolerant: a corrupt/truncated/alien-schema entry is
treated as ABSENT (the Runner re-measures and overwrites), never fatal —
the store persists across code versions and interrupted runs.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

from .. import obs

STORE_SCHEMA_VERSION = 1

_OFF = ("off", "0", "none", "")

# where the figure drivers, `spmv_bench --matrix` and the bench summary
# write: repro_torch/bench/results/, or REPRO_TORCH_RESULTS_DIR
RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench",
    "results")


def results_dir() -> str:
    """REPRO_TORCH_RESULTS_DIR, else RESULTS_DIR."""
    return os.environ.get("REPRO_TORCH_RESULTS_DIR") or RESULTS_DIR


def result_path(name: str) -> str:
    return os.path.join(results_dir(), name)


def default_root(results_dir: Optional[str] = None) -> str:
    """Store root resolution: REPRO_TORCH_RESULT_STORE wins; otherwise a
    `results/` sibling under REPRO_TORCH_OPERATOR_CACHE when that is set
    (a run that repoints the caches gets a hermetic result store with
    them — plan.py's convention); otherwise
    `<results_dir|benchmarks/results>/store_torch`."""
    env = os.environ.get("REPRO_TORCH_RESULT_STORE")
    if env:
        return env
    opd = os.environ.get("REPRO_TORCH_OPERATOR_CACHE")
    if opd and opd.lower() not in _OFF:
        return os.path.join(opd, "results")
    base = results_dir or os.path.join(os.getcwd(), "benchmarks", "results")
    return os.path.join(base, "store_torch")


class ResultStore:
    def __init__(self, root: Optional[str] = None,
                 results_dir: Optional[str] = None):
        self.root = root or default_root(results_dir)

    def path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def get(self, key: str) -> Optional[dict]:
        """The stored record for `key`, or None (missing OR unreadable —
        corruption means re-measure, not crash)."""
        path = self.path(key)
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            obs.counter("result_store.misses").inc()
            return None
        if (not isinstance(entry, dict)
                or entry.get("schema") != STORE_SCHEMA_VERSION
                or not isinstance(entry.get("record"), dict)):
            obs.counter("result_store.misses").inc()
            return None
        obs.counter("result_store.hits").inc()
        return entry

    def put(self, key: str, cell: dict, record: dict) -> str:
        """Atomically persist one measured cell. Returns the entry path."""
        os.makedirs(self.root, exist_ok=True)
        path = self.path(key)
        entry = {
            "schema": STORE_SCHEMA_VERSION,
            "key": key,
            "cell": cell,
            "record": record,
            "written_at": time.time(),
        }
        # shared pid.tid tmp + rename convention (plan store / opcache /
        # reorder cache): concurrent writers get distinct tmp names and
        # the rename is the only visible event
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f)
        os.replace(tmp, path)
        obs.counter("result_store.writes").inc()
        return path

    def entries(self):
        """Iterate (key, entry) over every readable cell in the store.

        Same tolerance as get(): unreadable/alien files are skipped, not
        fatal.
        """
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            key = name[:-len(".json")]
            entry = self.get(key)
            if entry is not None:
                yield key, entry

    def delete(self, key: str) -> bool:
        try:
            os.remove(self.path(key))
            return True
        except OSError:
            return False

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.root)
                       if n.endswith(".json"))
        except OSError:
            return 0
