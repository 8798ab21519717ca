"""Sharded SpMV — the distributed execution layer of the pipeline facade.

`plan(problem, topology=Topology(...))` decides (partition x scheme x
engine x shape x k) with the communication-volume cost model
(core/spmv/topology.py), and `Plan.build()` calls `build_sharded_layout`
and `ShardedOperator` here.

Layouts (both run on uniform padded row panels, so every device runs the
same program):

* 1d_rows   — row panels over a flat mesh; x row-sharded and either
              ALL-GATHERED each SpMV (the CG dataflow) or assembled from the
              two ring neighbours' edges when the plan's reordering made the
              halo legal (the paper's data-movement story as a
              collective-schedule choice).
* 2d_panels — rows over "data", columns over "model"; each device holds an
              (m/D x n/M) brick and only its x segment; partial y is summed
              over "model".

Per-panel engines: "bell" (Block-ELL bricks, an einsum over the gathered x
blocks) and "csr" (padded COO: a gather times the values, `index_add_` into
the panel's rows), chosen by the planner like any other engine axis. Both
are torch ops, the JAX package's own math: it runs them as jnp, outside any
Pallas kernel.

`ShardedOperator` accepts ORIGINAL-index-space vectors (it carries the
plan's composed permutation AND the panel-padding map), supports
`matmul(X[n, k])` and CG, and round-trips through the plan store. It runs
one of two paths over the same local products:

* simulated — every panel on the operator's device at once: the panel
  axis is a leading [d, ...] batch and the halo windows are gathered
  through one index. A process with fewer devices than the topology runs
  this path (`op.simulated`), as the JAX package's single-device process
  does; on one card a p = 8 plan is simulated.
* mesh — one panel per device of `op.mesh_devices`, in this process, the
  collective done as explicit copies: the all-gather concatenates the
  panels' x slices, the halo takes the two ring neighbours' edge slices,
  and the 2-D reduce sums the column bricks' partial y in the order
  q = 0..M-1, the simulated path's order. The JAX package's shard_map runs
  in one process too, and the service and CG call the operator in
  process; torch.distributed would need a process per rank, and NCCL
  refuses two ranks on one card. The list defaults to cuda:0..p-1 when the
  process sees that many cards; it may be set to one device repeated
  (`[cpu] * 8`, `[cuda:0] * 8`), which runs the mesh path's code on one
  device: a check of that code, not of multi-card speed.

Not ported: the JAX package's deprecated plan_1d / spmv_1d / plan_2d /
spmv_2d / plan_halo_1d / spmv_halo_1d shims and their legacy internals (no
caller in the package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ... import obs
from ...device import resolve_device, to_device, torch_dtype
from ..sparse.bell import to_block_ell
from ..sparse.csr import CSRMatrix
from ..sparse.partition import partition_to_owner
from .topology import Topology, padded_panel_rows


# ---------------------------------------------------------------------------
# Sharded layout: host-side arrays for one (matrix, topology, partition)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedLayout:
    """Everything `ShardedOperator` needs to execute, all host numpy:
    per-device engine arrays, the panel split, the padding index maps and
    the collective schedule. Built once per plan; round-trips through the
    plan store via ShardedOperator.state()/from_state()."""

    engine: str                  # "bell" | "csr"
    arrays: dict                 # engine arrays (leading axes = mesh axes)
    panel_starts: np.ndarray     # [P+1] row offsets in the reordered space
    padmap: np.ndarray           # [m] padded slot of reordered row r
    pad_idx: np.ndarray          # [n_pad] reordered row per slot (m = pad)
    shape: tuple                 # original (m, n), square
    topology: Topology
    schedule: str                # "all_gather" | "halo" | "psum"
    halo: int
    h_pad: int
    n_pad: int
    seg_n: int                   # 2d x-segment width (0 for 1d)
    block_shape: tuple


def _index_maps(starts: np.ndarray, m: int, h_pad: int):
    """padmap[r] = padded slot of reordered row r; pad_idx[slot] = r (or m
    for a padding slot, which gathers the appended zero)."""
    starts = np.asarray(starts, dtype=np.int64)
    p = starts.size - 1
    owner = partition_to_owner(starts, m).astype(np.int64)
    padmap = owner * h_pad + (np.arange(m, dtype=np.int64) - starts[owner])
    pad_idx = np.full(p * h_pad, m, dtype=np.int64)
    pad_idx[padmap] = np.arange(m, dtype=np.int64)
    return padmap, pad_idx


def _pack_bell_panels(subs: list, bm: int, bn: int):
    """Uniform Block-ELL arrays over a list of equal-shape CSR panels
    (shared K = max block count)."""
    bells = [to_block_ell(sub, bm, bn) for sub in subs]
    kmax = max(b.k for b in bells)
    nbr = bells[0].num_block_rows
    blocks = np.zeros((len(subs), nbr, kmax, bm, bn),
                      dtype=subs[0].vals.dtype)
    cols = np.zeros((len(subs), nbr, kmax), dtype=np.int32)
    for i, b in enumerate(bells):
        blocks[i, :b.num_block_rows, :b.k] = b.blocks
        cols[i, :b.num_block_rows, :b.k] = b.block_cols
    return blocks, cols


def _pack_csr_panels(entries: list, h_pad: int):
    """Uniform padded COO-CSR arrays over per-device (rows, cols, vals)
    triples: nnz padded to the max with (row=h_pad-1, col=0, val=0) —
    sorted row_ids preserved, contribution exactly zero."""
    nnz_pad = max(max((r.size for r, _, _ in entries), default=0), 1)
    n_dev = len(entries)
    row_ids = np.full((n_dev, nnz_pad), h_pad - 1, dtype=np.int32)
    cols = np.zeros((n_dev, nnz_pad), dtype=np.int32)
    vals = np.zeros((n_dev, nnz_pad),
                    dtype=entries[0][2].dtype if entries else np.float64)
    for i, (r, c, v) in enumerate(entries):
        row_ids[i, :r.size] = r
        cols[i, :c.size] = c
        vals[i, :v.size] = v
    return row_ids, cols, vals


def build_sharded_layout(rmat: CSRMatrix, topology: Topology,
                         panel_starts: np.ndarray, engine: str = "bell",
                         block_shape: tuple = (8, 128),
                         schedule: str = "all_gather",
                         halo: int = 0) -> ShardedLayout:
    """Chop the (already reordered) matrix into per-device arrays for the
    topology's layout. Columns are remapped through the same panel-padding
    map as rows (conformal x partition), so the device program never sees
    the ragged panel heights. The JAX package's arrays, bit for bit."""
    m, n = rmat.shape
    if m != n:
        raise ValueError(f"sharded plans need a square matrix (conformal "
                         f"x partition), got {rmat.shape}")
    if engine not in ("bell", "csr"):
        raise ValueError(f"sharded engines are 'bell'/'csr', got {engine!r}")
    bm, bn = block_shape
    starts = np.asarray(panel_starts, dtype=np.int64)
    d, mm = topology.row_devices, topology.col_devices
    if starts.size != d + 1:
        raise ValueError(f"panel_starts has {starts.size - 1} panels for "
                         f"{d} row devices")
    h_pad = padded_panel_rows(starts, bm, bn, col_devices=mm)
    n_pad = d * h_pad
    padmap, pad_idx = _index_maps(starts, m, h_pad)
    rp = rmat.rowptr.astype(np.int64)
    rows_p = padmap[np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))]
    cols_p = padmap[rmat.cols.astype(np.int64)]
    vals = rmat.vals
    seg_n = 0

    if topology.layout == "1d_rows":
        if schedule == "halo":
            halo = int(halo)
            if halo % bn or halo > h_pad:
                raise ValueError(f"halo {halo} must be a multiple of "
                                 f"bn={bn} and <= h_pad={h_pad}")
            width = h_pad + 2 * halo
        else:
            schedule, halo, width = "all_gather", 0, n_pad
        panel = rows_p // h_pad
        subs, csr_entries = [], []
        for p in range(d):
            sel = panel == p
            lrows = rows_p[sel] - p * h_pad
            lcols = cols_p[sel] - (p * h_pad - halo if schedule == "halo"
                                   else 0)
            if schedule == "halo" and sel.any():
                if lcols.min() < 0 or lcols.max() >= width:
                    raise ValueError(
                        "halo window violated after padding; the plan's "
                        "comm model and the layout builder disagree")
            if engine == "bell":
                subs.append(CSRMatrix.from_coo(lrows, lcols, vals[sel],
                                               (h_pad, width)))
            else:
                csr_entries.append((lrows, lcols, vals[sel]))
        if engine == "bell":
            blocks, bcols = _pack_bell_panels(subs, bm, bn)
            arrays = {"blocks": blocks, "block_cols": bcols}
        else:
            row_ids, ccols, cvals = _pack_csr_panels(csr_entries, h_pad)
            arrays = {"row_ids": row_ids, "cols": ccols, "vals": cvals}
    else:                                    # 2d_panels
        schedule, halo = "psum", 0
        seg_n = n_pad // mm
        panel = rows_p // h_pad
        seg = cols_p // seg_n
        subs, csr_entries = [], []
        for p in range(d):
            for q in range(mm):
                sel = (panel == p) & (seg == q)
                lrows = rows_p[sel] - p * h_pad
                lcols = cols_p[sel] - q * seg_n
                if engine == "bell":
                    subs.append(CSRMatrix.from_coo(lrows, lcols, vals[sel],
                                                   (h_pad, seg_n)))
                else:
                    csr_entries.append((lrows, lcols, vals[sel]))
        if engine == "bell":
            blocks, bcols = _pack_bell_panels(subs, bm, bn)
            arrays = {"blocks": blocks.reshape((d, mm) + blocks.shape[1:]),
                      "block_cols": bcols.reshape((d, mm) + bcols.shape[1:])}
        else:
            row_ids, ccols, cvals = _pack_csr_panels(csr_entries, h_pad)
            arrays = {"row_ids": row_ids.reshape(d, mm, -1),
                      "cols": ccols.reshape(d, mm, -1),
                      "vals": cvals.reshape(d, mm, -1)}

    return ShardedLayout(engine=engine, arrays=arrays, panel_starts=starts,
                         padmap=padmap, pad_idx=pad_idx, shape=(m, n),
                         topology=topology, schedule=schedule, halo=halo,
                         h_pad=h_pad, n_pad=n_pad, seg_n=seg_n,
                         block_shape=(bm, bn))


# ---------------------------------------------------------------------------
# Local products, batched over a leading panel axis b (the simulated path
# runs every panel in one call, the mesh path one panel a call). xw is the
# x window: [b, win, nv], or [win, nv] shared by every panel (all-gather).
# ---------------------------------------------------------------------------
def _bell_local(blocks, bcols, xw, bn: int):
    """Block-ELL panel SpMM: blocks [b, nbr, K, bm, bn], bcols [b, nbr, K]
    -> y [b, nbr*bm, nv]. Accumulates at promote(x.dtype, f32), so f64
    plans keep f64, and casts once."""
    nv = xw.shape[-1]
    if xw.dim() == 2:
        gathered = xw.reshape(-1, bn, nv)[bcols]         # [b, nbr, K, bn, nv]
    else:
        x3 = xw.reshape(xw.shape[0], -1, bn, nv)
        panel = torch.arange(x3.shape[0], device=xw.device)[:, None, None]
        gathered = x3[panel, bcols]
    acc = torch.promote_types(xw.dtype, torch.float32)
    y = torch.einsum("brkij,brkjv->briv", blocks.to(acc),
                     gathered.to(acc)).to(xw.dtype)
    return y.reshape(blocks.shape[0], -1, nv)


def _csr_local(row_ids, cols, vals, xw, h_pad: int):
    """Padded-COO panel SpMM: row_ids, cols, vals [b, nnz_pad] -> y
    [b, h_pad, nv], the products added into the rows in stored order."""
    b = cols.shape[0]
    nv = xw.shape[-1]
    dev = xw.device
    if xw.dim() == 2:
        g = xw[cols]                                     # [b, nnz_pad, nv]
    else:
        win = xw.shape[1]
        base = torch.arange(b, device=dev)[:, None] * win
        g = xw.reshape(-1, nv)[cols + base]
    prod = vals[..., None] * g
    rows = row_ids + torch.arange(b, device=dev)[:, None] * h_pad
    y = torch.zeros(b * h_pad, nv, dtype=xw.dtype, device=dev)
    y.index_add_(0, rows.reshape(-1), prod.reshape(-1, nv))
    return y.reshape(b, h_pad, nv)


def _local_y(engine: str, arrs: tuple, xw, h_pad: int, bn: int):
    if engine == "bell":
        return _bell_local(arrs[0], arrs[1], xw, bn)
    return _csr_local(arrs[0], arrs[1], arrs[2], xw, h_pad)


def _psum(parts):
    """Sum [*, M, h, nv] column-brick partials over M in the order
    q = 0..M-1 (both paths add in this order)."""
    y = parts[:, 0]
    for q in range(1, parts.shape[1]):
        y = y + parts[:, q]
    return y


_ARRAY_ORDER = {"bell": ("blocks", "block_cols"),
                "csr": ("row_ids", "cols", "vals")}
# trailing (per-panel) axes of each engine array
_LOCAL_NDIM = {"blocks": 4, "block_cols": 2, "row_ids": 1, "cols": 1,
               "vals": 1}


def _canonical(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# ShardedOperator
# ---------------------------------------------------------------------------
class _ReorderedView:
    """`unwrap()` counterpart of Operator.unwrap(): the same sharded
    execution, reordered index space in and out (what harnesses time)."""

    def __init__(self, op: "ShardedOperator"):
        self._op = op

    def __call__(self, x):
        return self._op(x, permuted=True)

    def matmul(self, x):
        return self._op.matmul(x, permuted=True)

    @property
    def shape(self):
        return self._op.shape


class ShardedOperator:
    """Permutation- and topology-carrying distributed SpMV/SpMM operator.

    `op(x)` / `op.matmul(X)` take ORIGINAL-index-space vectors: x is
    gathered through the composed (scheme ∘ partitioner) permutation and
    the panel-padding map in ONE gather, the sharded step runs, and y is
    gathered back the same way. `permuted=True` opts out of the
    permutation (x already in the reordered space; padding still applies).

    The engine arrays live on `device` (None = the card) in `dtype` (the
    float arrays' own type by default); a call in another dtype converts
    them once. `simulated` says which path runs (see the module docstring);
    `mesh_devices` (a list of topology.devices devices, in mesh order) and
    `force_simulated` choose it explicitly.
    """

    def __init__(self, layout: ShardedLayout, perm: Optional[np.ndarray],
                 plan=None, build_info: Optional[dict] = None, device=None,
                 dtype=None):
        self.layout = layout
        self.plan = plan
        self.build_info = build_info or {}
        self.device = _canonical(resolve_device(device))
        m = layout.shape[0]
        if perm is not None and np.array_equal(perm, np.arange(perm.size)):
            perm = None
        self._perm_np = None if perm is None else np.asarray(perm, np.int64)
        pad_idx = layout.pad_idx
        if perm is None:
            in_idx = pad_idx
            out_idx = layout.padmap
        else:
            perm_ext = np.append(self._perm_np, m)
            in_idx = perm_ext[pad_idx]          # pad slots gather x_ext[m]=0
            iperm = np.empty(m, dtype=np.int64)
            iperm[self._perm_np] = np.arange(m, dtype=np.int64)
            out_idx = layout.padmap[iperm]

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

        self._in_idx = idx(in_idx)
        self._in_idx_r = idx(pad_idx)
        self._out_idx = idx(out_idx)
        self._out_idx_r = idx(layout.padmap)
        self._win_idx = None                    # halo windows, lazy
        self._panels: dict = {}                 # mesh: off-device copies
        self.mesh_devices = None
        self.force_simulated = False
        if dtype is None:
            floats = [a.dtype for a in layout.arrays.values()
                      if np.issubdtype(a.dtype, np.floating)]
            dtype = floats[0] if floats else np.float32
        self._dev = None
        self._dtype = None
        self._device_arrays(torch_dtype(dtype))

    # -- facade surface ----------------------------------------------------
    @property
    def shape(self) -> tuple:
        return tuple(self.layout.shape)

    @property
    def topology(self) -> Topology:
        return self.layout.topology

    @property
    def perm(self) -> Optional[np.ndarray]:
        return self._perm_np

    @property
    def iperm(self) -> Optional[np.ndarray]:
        if self._perm_np is None:
            return None
        iperm = np.empty_like(self._perm_np)
        iperm[self._perm_np] = np.arange(self._perm_np.size)
        return iperm

    @property
    def panel_starts(self) -> np.ndarray:
        return self.layout.panel_starts

    @property
    def simulated(self) -> bool:
        return self.force_simulated or self._mesh() is None

    def unwrap(self) -> _ReorderedView:
        return _ReorderedView(self)

    # -- execution ---------------------------------------------------------
    def _mesh(self) -> Optional[list]:
        """The devices of the mesh path in mesh order, or None (simulate)."""
        p = self.layout.topology.devices
        if self.mesh_devices is not None:
            devs = [_canonical(d) for d in self.mesh_devices]
            if len(devs) != p:
                raise ValueError(f"mesh_devices lists {len(devs)} devices "
                                 f"for a {p}-device topology")
            return devs
        if self.device.type == "cuda" and torch.cuda.device_count() >= p:
            return [torch.device("cuda", i) for i in range(p)]
        return None

    def _device_arrays(self, dtype: torch.dtype) -> tuple:
        """The engine arrays on self.device with the mesh axes flattened to
        one leading panel axis (d for 1d_rows, d*M for 2d_panels); index
        arrays int64, value arrays in `dtype`."""
        if self._dev is None or self._dtype != dtype:
            lay = self.layout
            nb = lay.topology.row_devices * lay.topology.col_devices
            dev = []
            for name in _ARRAY_ORDER[lay.engine]:
                a = np.asarray(lay.arrays[name])
                a = a.reshape((nb,) + a.shape[a.ndim - _LOCAL_NDIM[name]:])
                floating = np.issubdtype(a.dtype, np.floating)
                dev.append(to_device(a, dtype if floating else torch.int64,
                                     self.device))
            self._dev = tuple(dev)
            self._dtype = dtype
            self._panels = {}
        return self._dev

    def _window(self):
        """[d, h_pad + 2*halo] padded-x rows of each panel's halo window."""
        if self._win_idx is None:
            lay = self.layout
            d, h_pad, halo = lay.topology.row_devices, lay.h_pad, lay.halo
            win = (np.arange(-halo, h_pad + halo)[None, :]
                   + np.arange(d)[:, None] * h_pad) % lay.n_pad
            self._win_idx = torch.as_tensor(win).to(self.device)
        return self._win_idx

    def _simulated_step(self, arrs: tuple, xp):
        lay = self.layout
        d, mm = lay.topology.row_devices, lay.topology.col_devices
        h_pad, bn, nv = lay.h_pad, lay.block_shape[1], xp.shape[1]
        if lay.topology.layout == "1d_rows":
            xw = xp[self._window()] if lay.schedule == "halo" else xp
            y = _local_y(lay.engine, arrs, xw, h_pad, bn)
        else:
            seg = xp.reshape(1, mm, lay.seg_n, nv).expand(d, mm, lay.seg_n,
                                                          nv)
            parts = _local_y(lay.engine, arrs,
                             seg.reshape(d * mm, lay.seg_n, nv), h_pad, bn)
            y = _psum(parts.reshape(d, mm, h_pad, nv))
        return y.reshape(lay.n_pad, nv)

    def _panel(self, i: int, dev: torch.device, arrs: tuple) -> tuple:
        """Panel (or brick) i's engine arrays on `dev`, a leading axis of 1:
        views of the stacked arrays on self.device, copies elsewhere."""
        if dev == self.device:
            return tuple(a[i:i + 1] for a in arrs)
        key = (i, dev)
        if key not in self._panels:
            self._panels[key] = tuple(a[i:i + 1].to(dev) for a in arrs)
        return self._panels[key]

    def _mesh_step(self, devs: list, arrs: tuple, xp):
        lay = self.layout
        d, mm = lay.topology.row_devices, lay.topology.col_devices
        h_pad, halo, bn = lay.h_pad, lay.halo, lay.block_shape[1]
        ys = []
        if lay.topology.layout == "1d_rows":
            # x row-sharded: device i holds its panel's slice
            xs = [xp[i * h_pad:(i + 1) * h_pad].to(devs[i])
                  for i in range(d)]
            for i, dev in enumerate(devs):
                if lay.schedule == "halo" and halo:
                    # ring: the left neighbour's last rows, the right's first
                    xw = torch.cat([xs[(i - 1) % d][-halo:].to(dev), xs[i],
                                    xs[(i + 1) % d][:halo].to(dev)])
                elif lay.schedule == "halo":
                    xw = xs[i]
                else:
                    xw = torch.cat([s.to(dev) for s in xs])   # all-gather
                y = _local_y(lay.engine, self._panel(i, dev, arrs), xw,
                             h_pad, bn)
                ys.append(y[0].to(self.device))
        else:
            seg_n = lay.seg_n
            for p in range(d):
                parts = []
                for q in range(mm):
                    dev = devs[p * mm + q]
                    xs = xp[q * seg_n:(q + 1) * seg_n].to(dev)
                    y = _local_y(lay.engine,
                                 self._panel(p * mm + q, dev, arrs),
                                 xs[None], h_pad, bn)
                    parts.append(y.to(devs[p * mm]))
                ys.append(_psum(torch.stack(parts, dim=1))[0]
                          .to(self.device))
        return torch.cat(ys)

    def _exec(self, x, permuted: bool, batched: bool):
        lay = self.layout
        simulated = self.simulated
        with obs.span("sharded.spmv", engine=lay.engine,
                      schedule=lay.schedule, devices=lay.topology.devices,
                      simulated=simulated, backend="torch"):
            x2 = torch.as_tensor(x, device=self.device)
            x2 = x2 if batched else x2[:, None]
            nv = int(x2.shape[1])
            with obs.span("sharded.gather_x", schedule=lay.schedule,
                          backend="torch"):
                xe = torch.cat([x2, x2.new_zeros(1, nv)])
                xp = xe.index_select(
                    0, self._in_idx_r if permuted else self._in_idx)
            arrs = self._device_arrays(x2.dtype)
            with obs.span("sharded.exec", schedule=lay.schedule,
                          halo=int(lay.halo), backend="torch"):
                if simulated:
                    yp = self._simulated_step(arrs, xp)
                else:
                    yp = self._mesh_step(self._mesh(), arrs, xp)
            with obs.span("sharded.scatter_y", schedule=lay.schedule,
                          backend="torch"):
                y = yp.index_select(
                    0, self._out_idx_r if permuted else self._out_idx)
            return y if batched else y[:, 0]

    def __call__(self, x, permuted: bool = False):
        return self._exec(x, permuted, batched=getattr(x, "ndim", 1) == 2)

    def matmul(self, x, permuted: bool = False):
        """x: [n, k] -> y: [m, k], original index space unless permuted."""
        return self._exec(x, permuted, batched=getattr(x, "ndim", 2) == 2)

    # -- plan-store protocol ----------------------------------------------
    def state(self):
        """(meta, arrays) under the JAX package's names: the host layout."""
        lay = self.layout
        meta = {"engine": lay.engine, "topology": lay.topology.to_json(),
                "schedule": lay.schedule, "halo": int(lay.halo),
                "h_pad": int(lay.h_pad), "n_pad": int(lay.n_pad),
                "seg_n": int(lay.seg_n), "shape": list(lay.shape),
                "block_shape": list(lay.block_shape)}
        arrays = dict(lay.arrays)
        arrays["panel_starts"] = np.asarray(lay.panel_starts, np.int64)
        return meta, arrays

    @classmethod
    def from_state(cls, meta, arrays, dtype=None, perm=None, plan=None,
                   build_info=None, device=None):
        topo = Topology.from_json(meta["topology"])
        starts = np.asarray(arrays["panel_starts"], np.int64)
        m = int(meta["shape"][0])
        padmap, pad_idx = _index_maps(starts, m, int(meta["h_pad"]))
        eng_arrays = {k: np.asarray(v) for k, v in arrays.items()
                      if k != "panel_starts"}
        layout = ShardedLayout(
            engine=meta["engine"], arrays=eng_arrays, panel_starts=starts,
            padmap=padmap, pad_idx=pad_idx, shape=tuple(meta["shape"]),
            topology=topo, schedule=meta["schedule"],
            halo=int(meta["halo"]), h_pad=int(meta["h_pad"]),
            n_pad=int(meta["n_pad"]), seg_n=int(meta["seg_n"]),
            block_shape=tuple(meta["block_shape"]))
        return cls(layout, perm, plan=plan, build_info=build_info,
                   device=device, dtype=dtype)
