"""Step-atomic checkpointing with async write and auto-resume: the
reference's `repro/training/checkpoint.py`, with its on-disk layout, so
that either package restores the other's checkpoints.

Layout:  <dir>/step_<N>/
             manifest.json   (step, config hash, leaf index, status)
             arr_<i>.npy     (one file per leaf, in the reference's flatten
                              order; a bf16 leaf as its raw uint16 bits)
         <dir>/step_<N>.tmp/ during write; os.replace() commits (atomic on
         POSIX), so a crash mid-write never corrupts the latest checkpoint.

Restore picks the newest COMMITTED step; partial .tmp dirs are ignored and
garbage-collected. Async mode runs the write on a worker thread: training
continues, and save() blocks only while a previous save is in flight
(back-pressure rather than an unbounded queue). The copy to the host is
taken before save() returns, so the caller may update the tensors in place
at once.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np

from ..device import host_array, to_device
from .tree import leaves, leaves_with_paths, unflatten


def config_hash(obj: Any) -> str:
    """The first 12 hex digits of sha1(repr(obj)): the reference's, for the
    same configuration (the port's config classes repr as the
    reference's)."""
    return hashlib.sha1(repr(obj).encode()).hexdigest()[:12]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    # -- save --------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None,
             cfg_hash: str = "") -> None:
        """Write `tree` (nested dicts of tensors) as step `step`."""
        if self._thread is not None:
            self._thread.join()  # back-pressure: one save in flight
            self._thread = None
        # the host copy is taken now (np.array copies a CPU tensor's
        # buffer too); the write may go to a thread
        host = [(path, np.array(host_array(leaf)))
                for path, leaf in leaves_with_paths(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}, cfg_hash))
            self._thread.start()
        else:
            self._write(step, host, extra or {}, cfg_hash)

    def _write(self, step: int, host: list, extra: dict, cfg_hash: str):
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        index = []
        for i, (path, arr) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            index.append(path)
        manifest = {"step": step, "cfg_hash": cfg_hash, "index": index,
                    "extra": extra, "time": time.time(), "status": "complete"}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -----------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                mf = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(mf):
                    steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any,
                cfg_hash: str = "") -> tuple[Any, dict]:
        """Restores into the structure of `like` (validates the leaf count
        and the config hash): each leaf on its `like` leaf's device, in its
        type. Returns (tree, extra)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        saved = manifest["cfg_hash"]
        if cfg_hash and saved and saved != cfg_hash:
            raise ValueError(
                f"checkpoint config hash {saved} != {cfg_hash}: refusing to "
                "restore across incompatible configs")
        flat = leaves(like)
        n = len(manifest["index"])
        if n != len(flat):
            raise ValueError(f"leaf count mismatch: ckpt {n} vs model "
                             f"{len(flat)}")
        restored = [to_device(np.load(os.path.join(d, f"arr_{i}.npy")),
                              ref.dtype, ref.device)
                    for i, ref in enumerate(flat)]
        return unflatten(like, restored), manifest.get("extra", {})

    def restore_latest(self, like: Any, cfg_hash: str = ""):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, cfg_hash)
        return step, tree, extra

    # -- gc ----------------------------------------------------------------
    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
