"""Per-rank flop, byte and collective accounting of a step: the
reference's `repro/launch/hlo_cost.py` with the dispatcher in place of
HLO text.

`analyze(fn, *args, **kw)` runs `fn` once, eagerly, and counts what the
dispatcher runs (on meta tensors nothing is computed or allocated, so a
production-size step on one rank of a fake process group costs host time
only):

  flops       — `torch.utils.flop_counter.FlopCounterMode`: matmul-type
                ops only (mm, bmm, addmm, baddbmm, convolution, attention),
                as the reference's walker counts dots only;
  bytes       — operand plus result bytes of every aten op: eager
                PyTorch's traffic model, no fusion, each op reads its
                inputs and writes its output. The reference's slice rules
                hold: a view or alias moves nothing; a write into a slice
                (`copy_` into a view, `index_put_`, `slice_scatter`) moves
                the update twice, not the buffer; `index_select`,
                `embedding`, `gather` and indexing read the slice, not the
                table. Without them a KV-cache decode reads as 100-1000x
                more memory-bound than it is;
  collectives — one event per c10d collective the rank calls, under the
                reference's conventions (`hlo.collective_bytes`): the
                group size comes from the op's ProcessGroup argument, a
                `send` is a collective-permute, a `recv_` is its other end
                and is not counted again.

A Python loop over layers or microbatches is unrolled in eager mode, so
each iteration's ops are counted as they run: there is no `while` body
and no trip count to multiply through. A remat unit's forward is
counted again when the backward recomputes it, as it runs.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from . import hlo as HLO

# c10d op -> collective kind; each op's first argument holds the result
# (or the tensors sent)
_COLLECTIVE_OPS = {
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
}
# ops that move nothing: allocation without a write, and views that the
# schema does not mark as aliases
_FREE = {"aten._unsafe_view", "aten.empty", "aten.empty_like",
         "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided",
         "c10d.recv_"}
# ops that write their result and read no tensor of the same size
_WRITE_ONLY = {"aten.zero_", "aten.fill_"}
# writes into a slice (beside `copy_` into a view): argument index of the
# update
_SLICE_WRITES = {"aten.index_put_": 2, "aten.index_put": 2,
                 "aten.slice_scatter": 1, "aten.select_scatter": 1,
                 "aten.index_copy_": 3}
# reads of a slice: argument index of the indices (the table is not read
# whole)
_SLICE_READS = {"aten.index_select": 2, "aten.embedding": 1,
                "aten.gather": 2, "aten.index": 1}


def nbytes(tree) -> int:
    """The bytes of every tensor in `tree` (tensors, lists, tuples and
    dicts of them; anything else counts 0), each by its own shape."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(nbytes(t) for t in tree.values())
    return 0


def group_size(args) -> int:
    """The size of the ProcessGroup among a c10d op's arguments, which
    reach the dispatcher as TorchScript objects; 1 when there is none."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # a ReduceOp or another object
                continue
    return 1


def op_bytes(name: str, is_view: bool, args, kwargs, out) -> int:
    """The bytes that aten op `name` moves under the eager traffic model
    and the slice rules (see the module docstring)."""
    if is_view or name in _FREE:
        return 0
    if name in _WRITE_ONLY:
        return nbytes(out)
    if name == "aten.copy_":
        return nbytes(args[0]) + nbytes(args[1])
    if name in _SLICE_WRITES:
        rest = [a for i, a in enumerate(args)
                if i not in (0, _SLICE_WRITES[name])]
        return 2 * nbytes(args[_SLICE_WRITES[name]]) + nbytes(rest)
    if name in _SLICE_READS:
        return nbytes(args[_SLICE_READS[name]]) + 2 * nbytes(out)
    return nbytes(args) + nbytes(kwargs) + nbytes(out)


class _Counter(TorchDispatchMode):
    """Bytes, collective events and an op histogram of what runs under
    it (flops come from the FlopCounterMode around it)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.events = []
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        self.ops[name] += 1
        kind = _COLLECTIVE_OPS.get(name)
        if kind is None:
            self.bytes += op_bytes(name, func.is_view, args, kwargs, out)
            return out
        result = nbytes(args[0])
        g = group_size(args)
        operand, _ = HLO.operand_and_wire(kind, result, g)
        self.events.append((kind, result, g))
        self.bytes += result + operand
        return out


def trace(fn, *args, **kw):
    """(fn(*args, **kw), record): the record holds "flops", "bytes",
    "collectives" (`hlo.collective_bytes` of the rank's events) and
    "op_hist" (`hlo.op_histogram` of the aten and c10d ops that ran)."""
    with FlopCounterMode(display=False) as flops, _Counter() as counter:
        out = fn(*args, **kw)
    return out, {"flops": flops.get_total_flops(),
                 "bytes": int(counter.bytes),
                 "collectives": HLO.collective_bytes(counter.events),
                 "op_hist": HLO.op_histogram(counter.ops.elements())}


def analyze(fn, *args, **kw) -> dict:
    """{"flops", "bytes", "collectives"} of one run of fn(*args, **kw) on
    this rank, the reference's `analyze_text` keys."""
    _, rec = trace(fn, *args, **kw)
    return {k: rec[k] for k in ("flops", "bytes", "collectives")}
