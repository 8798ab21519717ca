"""Multi-pod dry-run: every (architecture x input shape) cell on the
production meshes, counted per rank for the roofline. The reference's
`repro/launch/dryrun.py`, on one rank of a fake process group instead of
512 forced host devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape decode_32k [--kv-shard hd] [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

Each cell opens a fake process group of 256 ranks, or 512 with
`--multi-pod` (`torch.testing._internal.distributed.fake_pg`: its
collectives move nothing and return at once), in this process, as rank
0, and builds `make_production_mesh` on "cpu": (16, 16) ("data",
"model") or (2, 16, 16) ("pod", "data", "model"). Every parameter,
optimizer moment, embedding input and cache leaf is a meta tensor of
rank 0's block, so nothing is drawn or allocated; token inputs are
zeros on the CPU. The cell's step runs once
under `hlo_cost.trace`, which counts its flops, bytes and collectives:

  train   — `make_train_step(mesh=)` on the state's blocks and the global
            batch (tokens as zeros on the CPU, embeddings as meta
            tensors, which `batch_to_device` leaves there; the step takes
            the rank's rows of each microbatch);
  prefill — `forward(mesh=)` on the rank's rows, then the argmax of the
            last position;
  decode  — `make_serve_step(mesh=)` on the rank's rows and its blocks of
            the cache under `launch.specs.cache_specs(kv_shard)`.

What is counted is what the port runs. The train and prefill steps are
tensor-parallel over "model", as the reference's SPMD program is: each
rank computes its heads, its part of d_ff, its experts and its block of
the vocabulary, or its block of the sequence where the heads do not split
(`models.model`), so their flops per rank are the reference's share
(ROADMAP C7a). The decode step is tensor-parallel over "model" too: each
rank computes its column and row blocks of every projection, as the
weights are stored, on its dp rows, and attends over its block of the
cache, so its flops per rank are the reference's share
(`tests/test_torch_tp_decode_flops.py`).

A record (<arch>__<shape>__<mesh>[__hd][__ws].json under
`dryrun_dir()`, the variants kv_shard="hd" and --weight-stationary)
holds the reference's keys `walk_flops`, `walk_bytes`, `collectives`,
`op_hist` (aten and c10d ops by name), `params`, `active_params`,
`lower_s` (building the cell and its one counted run, the port's
tracing) and `status`, and `argument_size_in_bytes` (the rank's state,
batch and cache blocks) and `output_size_in_bytes` (what the step
returns), reckoned from shapes. It has no `temp_size_in_bytes` and no
`compile_s`: meta tensors have no allocator whose peak could be read,
and nothing compiles. A cell that raises is written with status "error"
and its traceback, and `main` exits 1 if any cell failed.

`--all` runs `registry.runnable_cells()` on the host: an hour-scale run
(a full-size train cell takes about a minute), which nothing starts by
default.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import registry
from ..configs.base import SHAPES
from ..distributed import sharding as SH
from ..experiments.store import results_dir
from ..models import model as MDL
from ..serving.decode import make_serve_step
from ..training import optimizer as OPT
from ..training import train_loop as TL
from ..training.tree import tree_map
from . import hlo_cost as HLO_COST
from . import specs as SPECS
from .mesh import dp_axes_of, fake_group, make_production_mesh


def dryrun_dir() -> str:
    """Where the records go: dryrun/ under the drivers' results directory
    (`experiments.store.results_dir()`, REPRO_TORCH_RESULTS_DIR)."""
    return os.path.join(results_dir(), "dryrun")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _blocks(tree, specs, mesh):
    """A meta tensor of this rank's block for every tensor leaf of `tree`
    under `specs`; other leaves (a cache's `len`) as they are."""
    def block(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.empty(SH.local_shape(tuple(t.shape), spec, mesh),
                           dtype=t.dtype, device="meta")
    return tree_map(block, tree, specs)


def _batch(cfg, shape, mesh, dp_axes, whole: bool = False):
    """The cell's inputs, this rank's rows or the whole global batch
    (`whole`, which the train step takes): token and label fields as
    zeros on the CPU, where the steps look for the batch of a mesh on
    "cpu" (a few MB at most), the others (embeddings) as meta tensors."""
    out = {}
    for k, s in SPECS.batch_specs(cfg, shape, mesh, dp_axes).items():
        dims = s.shape if whole else SH.local_shape(s.shape, s.spec, mesh)
        out[k] = (torch.empty(dims, dtype=s.dtype, device="meta")
                  if s.dtype.is_floating_point else
                  torch.zeros(dims, dtype=s.dtype))
    return out


def _param_blocks(cfg, mesh, weight_stationary: bool):
    """bf16 parameter blocks under the serving layout (the reference's
    `_param_shardings`): `param_layout`, "data" dropped when
    weight_stationary."""
    full = MDL.init_params(cfg, dtype=torch.bfloat16, device="meta")
    return _blocks(full, MDL.param_layout(cfg, mesh, weight_stationary),
                   mesh)


def default_microbatches(cfg, shape, multi_pod: bool) -> int:
    """The reference's: 16 microbatches above 50B parameters, else 8, as
    long as each still covers the dp axes."""
    mb = 16 if cfg.param_count() > 5e10 else 8
    dp_size = (2 * 16) if multi_pod else 16
    return max(1, min(mb, shape.global_batch // dp_size))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int | None = None, kv_chunk: int = 1024,
               weight_stationary: bool = False, kv_shard: str = "seq"):
    """The cell's step as a thunk on this rank's blocks, and its meta
    record. Needs the fake group of the mesh's size open (`fake_group`;
    `make_production_mesh` raises, naming the ranks, on another)."""
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    if microbatches is None:
        microbatches = default_microbatches(cfg, shape, multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    run, meta = build_cell(cfg, shape, mesh, microbatches, kv_chunk,
                           weight_stationary, kv_shard)
    return run, {"arch": arch, "shape": shape_name,
                 "mesh": mesh_name(multi_pod), **meta}


def build_cell(cfg, shape, mesh, microbatches: int = 1, kv_chunk: int = 1024,
               weight_stationary: bool = False, kv_shard: str = "seq"):
    """`lower_cell` for a config, a ShapeConfig and a mesh of any shape
    over the open group: (thunk, {"kind", "params", "active_params",
    "argument_size_in_bytes", and "kv_shard" for a decode cell})."""
    dp_axes = dp_axes_of(mesh)
    rows = _batch(cfg, shape, mesh, dp_axes)
    if shape.kind == "train":
        step, state_specs, _ = TL.make_train_step(
            cfg, OPT.OptConfig(), mesh=mesh, dp_axes=dp_axes,
            microbatches=microbatches, device="cpu")
        state_shape = TL.init_state_shape(cfg)
        state = _blocks(state_shape, state_specs(state_shape["params"]),
                        mesh)
        batch = _batch(cfg, shape, mesh, dp_axes, whole=True)
        args = (state, rows)

        def run():
            return step(state, batch)
    elif shape.kind == "prefill":
        params = _param_blocks(cfg, mesh, weight_stationary)
        args = (params, rows)

        @torch.no_grad()
        def run():
            logits, _, _ = MDL.forward(
                params, rows, cfg, kv_chunk=kv_chunk, mesh=mesh,
                dp_axes=dp_axes, weight_stationary=weight_stationary)
            return logits[:, -1].argmax(dim=-1)
    else:
        params = _param_blocks(cfg, mesh, weight_stationary)
        serve = make_serve_step(cfg, mesh=mesh, dp_axes=dp_axes,
                                weight_stationary=weight_stationary)
        cache = SPECS.cache_shape(cfg, shape)
        cache_spec = SPECS.cache_specs(cache, cfg, shape, mesh, dp_axes,
                                       kv_shard=kv_shard)
        blocks = _blocks(cache, cache_spec, mesh)
        args = (params, rows, blocks)

        @torch.no_grad()
        def run():
            return serve(params, rows, blocks, cache_spec)
    meta = {"kind": shape.kind, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "argument_size_in_bytes": HLO_COST.nbytes(args)}
    if shape.kind == "decode":
        meta["kv_shard"] = kv_shard
    return run, meta


def analyze(lowered) -> dict:
    """Runs the cell's thunk once under `hlo_cost.trace`: the record's
    counted keys."""
    out, walk = HLO_COST.trace(lowered)
    return {"walk_flops": walk["flops"], "walk_bytes": walk["bytes"],
            "collectives": walk["collectives"], "op_hist": walk["op_hist"],
            "output_size_in_bytes": HLO_COST.nbytes(out)}


def cell_name(arch, shape_name, multi_pod, kv_shard="seq",
              weight_stationary=False) -> str:
    name = f"{arch}__{shape_name}__{mesh_name(multi_pod)}"
    if kv_shard == "hd" and SHAPES[shape_name].kind == "decode":
        name += "__hd"
    if weight_stationary and SHAPES[shape_name].kind != "train":
        name += "__ws"
    return name


def run_cell(arch, shape_name, multi_pod, out_dir=None, **opt):
    """One cell in a fake group of its own, its record written to
    <out_dir>/<cell_name>.json (out_dir None: `dryrun_dir()`) and
    returned."""
    out_dir = out_dir or dryrun_dir()
    name = cell_name(arch, shape_name, multi_pod, opt.get("kv_shard", "seq"),
                     opt.get("weight_stationary", False))
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            lowered, meta = lower_cell(arch, shape_name, multi_pod, **opt)
            meta.update({k: v for k, v in opt.items() if v})
            rec = {**meta, **analyze(lowered)}
        rec["lower_s"] = time.time() - t0
        rec["status"] = "ok"
    except Exception as e:  # a cell's failure is its record
        rec = {"arch": arch, "shape": shape_name,
               "mesh": mesh_name(multi_pod),
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="records directory (default: dryrun_dir())")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--weight-stationary", action="store_true")
    ap.add_argument("--kv-shard", default="seq", choices=["seq", "hd"])
    ap.add_argument("--moe-no-fsdp", action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    if args.moe_no_fsdp:
        SH.MOE_FSDP = False
    cells = []
    if args.all:
        for arch, sname, runnable, reason in registry.runnable_cells():
            if not runnable:
                print(f"SKIP {arch} x {sname}: {reason}")
                continue
            cells.append((arch, sname))
    else:
        cells = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    failures = 0
    for arch, sname in cells:
        for mp in meshes:
            t0 = time.time()
            rec = run_cell(arch, sname, mp, out_dir=args.out,
                           microbatches=args.microbatches,
                           weight_stationary=args.weight_stationary,
                           kv_shard=args.kv_shard)
            ok = rec["status"] == "ok"
            failures += (not ok)
            coll = rec.get("collectives", {})
            msg = (f"flops={rec['walk_flops']:.3e} "
                   f"bytes={rec['walk_bytes']:.3e} "
                   f"coll={coll.get('total', 0):.3e}B "
                   f"wire={coll.get('wire', 0):.3e}B"
                   if ok else rec.get("error", ""))
            print(f"[dryrun] {arch} x {sname} x {mesh_name(mp)}: "
                  f"{rec['status']} ({time.time() - t0:.0f}s) {msg}",
                  flush=True)
            if ok:
                print(f"         args="
                      f"{rec['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
                      f"out={rec['output_size_in_bytes'] / 2**30:.2f}GiB",
                      flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
