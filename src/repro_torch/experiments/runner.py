"""Runner — resumable execution of an ExperimentSpec over a ResultStore.

The Runner walks the spec's cells matrix-major (each matrix materialized
once), serves every cell it can from the store, measures the rest, and
returns a Report. Resumability is the invariant the CI smoke job pins:
running the same spec twice performs ZERO new measurements the second
time, and extending a spec along any axis measures only the delta.

Corrupt/truncated store entries read as misses (ResultStore.get) and are
re-measured in place — an interrupted campaign can always be resumed by
re-running it.

The Runner measures on one device: the card by default (it raises
without one), the CPU when the caller passes device="cpu". Its cells
carry that device's kind, so the store keeps the two apart.
"""
from __future__ import annotations

import time
import traceback
from typing import Callable, Iterable, Optional

from .. import obs
from ..device import device_kind, resolve_device
from .cells import get_cell_kind
from .report import Report
from .spec import ExperimentSpec
from .store import ResultStore


class Runner:
    """on_error:
    * "raise"  — a failing cell aborts the run (default; campaigns are
                 supposed to be green).
    * "record" — the failure is reported (Report.failures) but the run
                 continues; failed cells are NOT persisted, so a re-run
                 retries them.
    """

    def __init__(self, spec: ExperimentSpec,
                 store: Optional[ResultStore] = None,
                 verbose: bool = True, on_error: str = "raise",
                 get_matrix: Optional[Callable] = None, device=None):
        if on_error not in ("raise", "record"):
            raise ValueError(f"on_error must be 'raise' or 'record', "
                             f"got {on_error!r}")
        self.device = resolve_device(device)
        self.spec = spec
        self.store = store if store is not None else ResultStore()
        self.verbose = verbose
        self.on_error = on_error
        self._get_matrix = get_matrix or _suite_get

    def run(self, matrices: Optional[Iterable[str]] = None) -> Report:
        cells = self.spec.cells(matrices, device=device_kind(self.device))
        measure = get_cell_kind(self.spec.kind)
        entries, failures = [], []
        measured = reused = 0
        mat_name, mat = None, None
        for cell in cells:
            key = cell.key()
            stored = self.store.get(key)
            if stored is not None:
                with obs.span("runner.cell", key=key, label=cell.label(),
                              matrix=cell.matrix, scheme=cell.scheme,
                              store_hit=True):
                    entries.append((cell, stored["record"], True, 0.0))
                reused += 1
                continue
            if cell.matrix != mat_name:    # cells are matrix-major
                mat_name, mat = cell.matrix, self._get_matrix(cell.matrix)
            t0 = time.time()
            try:
                with obs.span("runner.cell", key=key, label=cell.label(),
                              matrix=cell.matrix, scheme=cell.scheme,
                              store_hit=False):
                    record = self._measure_cell(measure, cell, mat,
                                                self.device)
            except Exception as e:
                if self.on_error == "raise":
                    raise
                failures.append({"cell": cell.coords(), "key": key,
                                 "label": cell.label(),
                                 "error": f"{type(e).__name__}: {e}",
                                 "traceback": traceback.format_exc()})
                if self.verbose:
                    print(f"[{self.spec.name}] {cell.label()}: "
                          f"ERROR {type(e).__name__}: {e}", flush=True)
                continue
            self.store.put(key, cell.coords(), record)
            wall = time.time() - t0
            entries.append((cell, record, False, wall))
            measured += 1
            if self.verbose:
                gf = record.get("seq_ios_gflops")
                extra = f" ios={gf:.2f} gflops" if gf is not None else ""
                print(f"[{self.spec.name}] {cell.label()}:{extra} "
                      f"({wall:.1f}s)", flush=True)
        return Report(self.spec, entries, measured=measured, reused=reused,
                      failures=failures, store=self.store)

    @staticmethod
    def _measure_cell(measure, cell, mat, device):
        """Measure one cell; policy trace=True additionally records the
        cell's phase-attributed span events into the record (persisted in
        the ResultStore alongside the measurement — MeasurePolicy makes
        `trace` key-relevant only when set, so untraced campaigns keep
        their cell keys)."""
        if not cell.policy_dict().get("trace"):
            return measure(cell, mat, device)
        with obs.tracing() as buf:
            record = measure(cell, mat, device)
        record["trace"] = buf.flush()
        return record


def _suite_get(name: str):
    from ..matrices import suite

    return suite.get(name)


def run_spec(spec: ExperimentSpec, store: Optional[ResultStore] = None,
             **kw) -> Report:
    """One-liner: Runner(spec, store, **kw).run()."""
    return Runner(spec, store=store, **kw).run()
