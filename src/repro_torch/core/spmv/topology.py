"""Topology — the device-mesh axis of the Problem→Plan→Operator pipeline.

A Topology describes WHERE a plan executes: how many devices, and which
sharded layout (DESIGN.md "Topology-aware planning"):

  * "1d_rows"   — row panels over a flat mesh; x is row-sharded and is
                  either ALL-GATHERED each SpMV (the CG dataflow) or, when
                  a bandwidth-reducing scheme makes it legal, assembled by
                  two nearest-neighbour ring permutes (halo exchange).
  * "2d_panels" — rows over the "data" axis, columns over the "model"
                  axis; each device holds an (m/D x n/M) brick and only
                  its x segment; partial y is all-reduced over "model".

`Topology(devices=1)` is TRIVIAL: it plans, keys and builds exactly like
no topology at all (single-device caches never fork — the content key is
identical, asserted in tests/test_torch_sharded.py).

`comm_model` is the plan-time cost model: for a candidate (scheme,
partition) it turns the structural metrics the paper uses to explain
parallel SpMV (load imbalance §6.1, cut volume / halo width — the
PaToH/METIS objectives) into modelled collective bytes per SpMV, so the
planner can trade gather traffic against halo exchanges against the 2-D
reduce. This module is numpy-only: the JAX package's module, copied, so
the port's plans hold the same decisions, keys and comm dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..sparse import metrics

LAYOUTS = ("1d_rows", "2d_panels")


@dataclasses.dataclass(frozen=True)
class Topology:
    """devices — total device count; layout — one of LAYOUTS; mesh_shape —
    (rows,) for 1d_rows, (row_devices, col_devices) for 2d_panels
    (defaults: (devices,) and the most-square factoring)."""

    devices: int = 1
    layout: str = "1d_rows"
    mesh_shape: tuple = ()
    mesh_axes: tuple = ()

    def __post_init__(self):
        if self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, "
                             f"got {self.layout!r}")
        shape = tuple(int(s) for s in self.mesh_shape)
        if not shape:
            shape = ((self.devices,) if self.layout == "1d_rows"
                     else _square_factor(self.devices))
        naxes = 1 if self.layout == "1d_rows" else 2
        if len(shape) != naxes:
            raise ValueError(f"{self.layout} needs a {naxes}-axis "
                             f"mesh_shape, got {shape}")
        if int(np.prod(shape)) != self.devices:
            raise ValueError(f"mesh_shape {shape} does not factor "
                             f"devices={self.devices}")
        axes = tuple(self.mesh_axes) or (("data",) if naxes == 1
                                         else ("data", "model"))
        if len(axes) != naxes:
            raise ValueError(f"mesh_axes {axes} must name {naxes} axes")
        object.__setattr__(self, "mesh_shape", shape)
        object.__setattr__(self, "mesh_axes", axes)

    @property
    def trivial(self) -> bool:
        return self.devices == 1

    @property
    def row_devices(self) -> int:
        return self.mesh_shape[0]

    @property
    def col_devices(self) -> int:
        return self.mesh_shape[1] if len(self.mesh_shape) > 1 else 1

    def key_dict(self) -> dict:
        """The content-key-relevant coordinates (mesh_axes are naming,
        not placement — excluded, like profile names in cell keys)."""
        return {"devices": int(self.devices), "layout": self.layout,
                "mesh_shape": list(self.mesh_shape)}

    def to_json(self) -> dict:
        d = self.key_dict()
        d["mesh_axes"] = list(self.mesh_axes)
        return d

    @staticmethod
    def from_json(d: Optional[dict]) -> Optional["Topology"]:
        if not d:
            return None
        return Topology(devices=d["devices"], layout=d["layout"],
                        mesh_shape=tuple(d.get("mesh_shape", ())),
                        mesh_axes=tuple(d.get("mesh_axes", ())))


def _square_factor(n: int) -> tuple:
    """Most-square (rows, cols) factoring with rows >= cols."""
    c = int(math.isqrt(n))
    while c > 1 and n % c:
        c -= 1
    return (n // max(c, 1), max(c, 1))


def normalize(topology) -> Optional[Topology]:
    """None / trivial topologies collapse to None (the single-device
    pipeline); dicts are revived (Plan.from_json path)."""
    if topology is None:
        return None
    if isinstance(topology, dict):
        topology = Topology.from_json(topology)
    if not isinstance(topology, Topology):
        raise TypeError(f"topology must be a Topology, got "
                        f"{type(topology).__name__}")
    return None if topology.trivial else topology


def padded_panel_rows(panel_starts: np.ndarray, bm: int, bn: int,
                      col_devices: int = 1) -> int:
    """Uniform padded panel height: max panel height rounded up to
    lcm(bm, bn * col_devices) so block rows, the all-gathered x tiling,
    and (for 2d_panels) the x column segments all align at every panel
    boundary."""
    heights = np.diff(np.asarray(panel_starts, dtype=np.int64))
    bnc = bn * max(int(col_devices), 1)
    align = bm * bnc // math.gcd(bm, bnc)
    h = int(heights.max()) if heights.size else 0
    return max(((h + align - 1) // align) * align, align)


def comm_model(rmat, panel_starts: np.ndarray, topology: Topology,
               dtype_size: int, k: int, block_shape: tuple) -> dict:
    """Modelled collective bytes per SpMM for one (scheme, partition)
    candidate, from the partition-quality metrics (metrics.py):

      1d_rows all-gather : n * (P-1)/P * dsize * k      per device
      1d_rows halo       : 2 * halo * dsize * k         per device,
        legal only when every out-of-panel column lies within the
        adjacent panel even after padding (halo_pad <= h_pad) — i.e.
        AFTER a bandwidth-reducing reordering; this is the paper's
        data-movement story as a collective-schedule choice.
      2d_panels psum     : 2 * h_pad * (M-1)/M * dsize * k  per device
        (ring all-reduce of the partial y panel over the model axis).

    Also records cut_volume (what hypergraph partitioning minimizes —
    reported so campaigns can correlate cut with measured comm) and the
    nnz load imbalance of the row split.
    """
    starts = np.asarray(panel_starts, dtype=np.int64)
    heights = np.diff(starts)
    bm, bn = block_shape
    h_pad = padded_panel_rows(starts, bm, bn,
                              col_devices=topology.col_devices)
    li = metrics.load_imbalance(rmat, starts)
    cut = metrics.cut_volume(rmat, starts)
    hw = metrics.halo_width(rmat, starts)
    k = max(int(k), 1)
    out = {"li": float(li), "cut_volume": int(cut), "halo_width": int(hw),
           "h_pad": int(h_pad)}
    if topology.layout == "1d_rows":
        p = topology.row_devices
        n_pad = p * h_pad
        gather = n_pad * (p - 1) / p * dtype_size * k
        # padding inflates the halo by (h_pad - height) of the shortest
        # neighbour; round to the bn tile the exchange moves
        hmin = int(heights.min()) if heights.size else 0
        halo_pad = hw + (h_pad - hmin)
        halo_pad = ((halo_pad + bn - 1) // bn) * bn
        halo_legal = p > 1 and hw <= hmin and halo_pad <= h_pad
        halo_bytes = 2 * halo_pad * dtype_size * k
        if halo_legal and halo_bytes < gather:
            out.update(schedule="halo", halo=int(halo_pad),
                       bytes_per_spmv=float(halo_bytes))
        else:
            out.update(schedule="all_gather", halo=0,
                       bytes_per_spmv=float(gather))
        out["gather_bytes"] = float(gather)
        out["halo_bytes"] = float(halo_bytes) if halo_legal else None
    else:
        mm = topology.col_devices
        psum = 2 * h_pad * (mm - 1) / mm * dtype_size * k
        out.update(schedule="psum", halo=0, bytes_per_spmv=float(psum))
    return out
