"""Sharding rules: parameter path -> spec, the reference's
`repro/distributed/sharding.py` over a `torch.distributed` device mesh.

Strategy (the reference's 2-D FSDP x TP layout of the state):
  * "model" axis: heads / d_ff / vocab / experts / SSM channels;
  * "data" axis: the other big dim of each weight;
  * "pod" axis (multi-pod): pure data parallelism, parameters replicated.
Optimizer state inherits the parameter specs; stacked layer leaves get a
None prepended for the layer axis.

A spec is a tuple with one entry per tensor dim: an axis name, a tuple of
axis names (the dim split over all of them, the first outermost), or None
(the reference's `PartitionSpec` entries). A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with `mesh_dim_names`; the pure
spec functions also take anything whose `shape` maps axis names to sizes
(the reference reads only `mesh.shape`), or such a dict itself.

A rank holds the block of each leaf that its mesh coordinates name
(`shard`). Inside the model the layers gather their weights (`gather`):
the forward all-gathers over the axes the spec names but those it is told
to keep, and the backward reduce-scatters the gradient over them and
all-reduces it over the axes the spec does not name. A tensor-parallel
layer (`TensorParallel`) keeps "model": it computes with this rank's block
of heads, d_ff, vocabulary or SSM heads, and moves its activations with
`gather_dim` (all-gather, reduce-scatter back), `reduce_scatter_dim`
(reduce-scatter, all-gather back) and `psum` (all-reduce, all-reduce back).

The gradient rule. Every collective's backward is its forward's adjoint,
so when each rank backpropagates its loss divided by the mesh size, the
ranks together take the gradient of the sum of those losses, which is the
mean loss over the global batch (a "model" group's ranks hold one loss,
its dp rows', M times over; see `training.train_loop`). A leaf's gradient
is then summed over the axes whose ranks each hold a part of it: over the
dp axes always; over "model" for a replicated leaf (a norm scale, an
rwkv6 mix, the router), whose uses on a rank see its block of the sequence
or of the heads only, and for a leaf a layer gathers whole over "model";
never over "model" for a leaf kept split over it, whose block only its
rank uses.
"""
from __future__ import annotations

import copy
import math
import re
from typing import Any, NamedTuple

import torch

from ..training.tree import leaves_with_paths, tree_map

# (regex on path, spec for the UNSTACKED param). First match wins.
_RULES = [
    # embeddings / heads
    (r"embed/table", ("model", "data")),
    (r"head/w", ("data", "model")),
    # attention
    (r"attn/w[qkv]/w", ("data", "model")),
    (r"attn/w[qkv]/b", ("model",)),
    (r"attn/wo/w", ("model", "data")),
    (r"cross_attn/w[qkv]/w", ("data", "model")),
    (r"cross_attn/wo/w", ("model", "data")),
    # dense mlp
    (r"mlp/w_(gate|up)/w", ("data", "model")),
    (r"mlp/w_down/w", ("model", "data")),
    # moe (experts on model = EP, FSDP over data on d_model/d_ff;
    # must match moe_layer's expert specs). See MOE_FSDP below.
    (r"moe/router/w", ()),
    # mamba2
    (r"in_proj/w", ("data", "model")),
    (r"out_proj/w", ("model", "data")),
    (r"conv_w", (None, "model")),
    (r"conv_b", ("model",)),
    (r"(a_log|dt_bias|d_skip)", ("model",)),
    (r"layers/norm/scale", ("model",)),  # mamba gated-norm over d_inner
    # rwkv6
    (r"w[rkvg]/w", ("data", "model")),
    (r"wo/w", ("model", "data")),
    (r"w_lora_a", ("data", None)),
    (r"w_lora_b", (None, "model")),
    (r"u_bonus", ("model", None)),
    (r"wck/w", ("data", "model")),
    (r"wcv/w", ("model", "data")),
    (r"(w0|mix_[rkvwg]|cmix_k)", ()),
    # norms & scalars
    (r"(norm|ln_x)/scale", ()),
    (r"gate", ()),
]

_STACKED_PREFIXES = ("layers", "tail_layers", "cross_layers")

# False = EP-stationary experts (resident on the model axis only, no FSDP
# gather per layer and microbatch).
MOE_FSDP = True


def path_str(path: str) -> str:
    """The reference's "/"-joined path of a keystr path
    (`['layers']['attn']['wq']['w']` -> `layers/attn/wq/w`); a path that
    is already "/"-joined is returned as it is."""
    if not path.startswith("["):
        return path
    return "/".join(re.findall(r"\['([^']*)'\]", path))


def keystr(path: str) -> str:
    """The keystr path (`training.tree`'s names) of a "/"-joined one."""
    if path.startswith("[") or not path:
        return path
    return "".join(f"['{k}']" for k in path.split("/"))


def expert_spec(name: str) -> tuple:
    """The unstacked spec of an MoE expert weight (`w_gate`, `w_up`,
    `w_down`): experts on "model", and under MOE_FSDP d_model (w_gate,
    w_up) or d_model of the output (w_down) on "data"."""
    if name == "w_down":
        return ("model", None, "data") if MOE_FSDP else ("model", None, None)
    return ("model", "data", None) if MOE_FSDP else ("model", None, None)


def param_spec(path: str, leaf) -> tuple:
    """The spec of the parameter at `path` (keystr or "/"-joined) with the
    rank of `leaf` (anything with `ndim` or `dim()`): the first rule that
    matches, else replicated; None for the layer axis of a stacked leaf;
    padded with None to the rank, or trimmed to it."""
    s = path_str(path)
    m = re.search(r"moe/(w_gate|w_up|w_down)", s)
    spec = None
    if m:
        spec = expert_spec(m.group(1))
    else:
        for pat, sp in _RULES:
            if re.search(pat, s):
                spec = sp
                break
    if spec is None:
        spec = ()  # replicate by default (small tensors)
    stacked = s.startswith(_STACKED_PREFIXES)
    ndim = leaf.ndim if hasattr(leaf, "ndim") else leaf.dim()
    parts = ([None] if stacked else []) + list(spec)
    parts += [None] * (ndim - len(parts))
    return tuple(parts[:ndim])


def param_specs(params) -> Any:
    """A tree of specs of `params`' structure (tensors, meta tensors or
    anything with `ndim`)."""
    return _map_paths(param_spec, params)


def _map_paths(fn, tree, *rest, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, *(r[k] for r in rest),
                              prefix=f"{prefix}['{k}']")
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh, of an object whose `shape` maps
    axis names to sizes (a jax Mesh, a stand-in), or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict) or hasattr(shape, "items"):
        return dict(shape)
    raise TypeError(f"not a mesh: {mesh!r} (want a DeviceMesh with "
                    f"mesh_dim_names, or axis sizes by name)")


def entry_axes(entry) -> tuple:
    """The axes a spec entry names: () for None, (name,) for one axis."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_axes(entry, mesh) -> tuple:
    """The axes of a spec entry that hold more than one rank: a dim split
    over one rank is whole on every rank."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in entry_axes(entry) if sizes[a] > 1)


def batch_spec(shape_kind: str, dp_axes) -> tuple:
    """Input batch specs: tokens/labels [B, S] batch-sharded over dp_axes
    (one axis by its name, as a PartitionSpec normalizes it)."""
    dp = tuple(dp_axes)
    return (dp[0] if len(dp) == 1 else dp, None)


def divisible(n: int, mesh, axes) -> bool:
    if axes is None:
        return True
    sizes = axis_sizes(mesh)
    size = 1
    for a in entry_axes(axes):
        size *= sizes[a]
    return n % size == 0


def validate_spec(shape, spec: tuple, mesh) -> tuple:
    """`spec` padded to the rank of `shape`, with every entry whose axes do
    not divide the dim replaced by None."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(ax if divisible(dim, mesh, ax) else None
                 for dim, ax in zip(shape, parts))


def validate_specs(params, specs, mesh):
    """Drop (replace with None) any spec axis that does not divide the dim
    — keeps every arch legal on every mesh (e.g. odd head counts)."""
    return _map_paths(lambda _, leaf, spec: validate_spec(
        tuple(leaf.shape), spec, mesh), params, specs)


def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim, in the mesh's order: Shard(d) where
    tensor dim d names that axis, else Replicate(). A tensor dim that names
    several axes is sharded over each of them, the first outermost, which
    must be the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {dim} names {axes}, not in "
                             f"the mesh's order {tuple(names)}")
        for p in pos:
            out[p] = Shard(dim)
    return out


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of a rank's block of a tensor of `shape` under `spec`."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // math.prod(sizes[a] for a in entry_axes(ax))
                 for dim, ax in zip(shape, spec))


# -- on a DeviceMesh --------------------------------------------------------
def block_index(mesh, axes: tuple) -> int:
    """This rank's block along a dim split over `axes` (first outermost);
    0 for a dim held whole (axes (), where `mesh` is not read)."""
    idx = 0
    for a in axes:
        idx = idx * axis_sizes(mesh)[a] + mesh.get_local_rank(a)
    return idx


def block_start(mesh, axes: tuple, size: int, whole: int) -> int:
    """The first index of this rank's block of `size` along a dim of
    `whole` split over `axes` (the first outermost; () for a whole dim).
    ValueError unless the blocks make up `whole`."""
    if size * math.prod(axis_sizes(mesh)[a] for a in axes) != whole:
        raise ValueError(f"a block of {size} over {axes} is not a block of "
                         f"a dim of {whole}")
    return block_index(mesh, axes) * size


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec`, as a
    contiguous tensor of its own. A leaf that is not a tensor (a decode
    cache's `len`, a missing cache part) is whole on every rank: a copy."""
    if not isinstance(t, torch.Tensor):
        return copy.deepcopy(t)
    sizes = axis_sizes(mesh)
    out = t
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            n = math.prod(sizes[a] for a in axes)
            size = t.shape[dim] // n
            out = out.narrow(dim, block_index(mesh, axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh):
    """`shard` over a tree and its tree of specs."""
    return tree_map(lambda t, sp: shard(t, sp, mesh), tree, specs)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


def _all_gather_dim(t: torch.Tensor, dim: int, axis: str, mesh):
    n = axis_sizes(mesh)[axis]
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, src,
                                             group=_group(mesh, axis))
    # the whole tensor in its own layout: a product reads the same strides
    # on the mesh as on one device, so cuBLAS takes the same algorithm
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(t: torch.Tensor, dim: int, axis: str, mesh):
    n = axis_sizes(mesh)[axis]
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    torch.distributed.reduce_scatter_tensor(out, src,
                                            group=_group(mesh, axis))
    return out.movedim(0, dim).contiguous()


def all_reduce(t: torch.Tensor, axes, mesh,
               op: str = "sum") -> torch.Tensor:
    """The sum (op="max": the largest) of `t` over the ranks along `axes`,
    one axis at a time, in a tensor of its own (`t` is left as it is)."""
    reduce_op = {"sum": torch.distributed.ReduceOp.SUM,
                 "max": torch.distributed.ReduceOp.MAX}[op]
    t = t.clone(memory_format=torch.contiguous_format)
    for a in axes:
        torch.distributed.all_reduce(t, op=reduce_op, group=_group(mesh, a))
    return t


def gather_whole(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from each rank's block (all-gathers, no
    gradient): for checks and checkpoints. A leaf that is not a tensor is
    whole already and is returned as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    with torch.no_grad():
        return _gather(t, _gather_dims(spec, ()), mesh)


def unshard_tree(tree, specs, mesh):
    """`gather_whole` over a tree and its tree of specs."""
    return tree_map(lambda t, sp: gather_whole(t, sp, mesh), tree, specs)


def _gather_dims(spec: tuple, keep: tuple) -> tuple:
    return tuple((dim, tuple(a for a in entry_axes(e) if a not in keep))
                 for dim, e in enumerate(spec)
                 if any(a not in keep for a in entry_axes(e)))


def _gather(t, dims, mesh):
    for dim, axes in dims:
        for a in reversed(axes):             # innermost first
            t = _all_gather_dim(t, dim, a, mesh)
    return t


class _Gather(torch.autograd.Function):
    """Forward: all-gather along `dims` ((dim, axes) pairs). Backward:
    reduce-scatter the gradient along them and all-reduce it over
    `others`."""

    @staticmethod
    def forward(ctx, t, mesh, dims, others):
        ctx.mesh, ctx.dims, ctx.others = mesh, dims, others
        return _gather(t, dims, mesh) if dims else t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        for dim, axes in reversed(ctx.dims):
            for a in axes:                   # outermost first
                g = _reduce_scatter_dim(g, dim, a, ctx.mesh)
        return all_reduce(g, ctx.others, ctx.mesh), None, None, None


def gather(t: torch.Tensor, spec: tuple, mesh, keep: tuple = ()):
    """The whole tensor from this rank's block `t` under `spec`, but for
    the axes in `keep` (which stay sharded). Differentiable: the gradient
    comes back summed over the mesh, reduce-scattered over the gathered
    axes and all-reduced over the axes that `spec` does not name. An axis
    of one rank moves nothing (as `split_axes`): on a (1, 1) mesh the
    result is `t` itself, as the plain path reads it."""
    sizes = axis_sizes(mesh)
    single = tuple(a for a, n in sizes.items() if n == 1)
    named = {a for e in spec for a in entry_axes(e)}
    others = tuple(a for a in sizes if a not in named and a not in single)
    return _Gather.apply(t, mesh, _gather_dims(spec, (*keep, *single)),
                         others)


def gather_dim(t: torch.Tensor, dim: int, axis, mesh) -> torch.Tensor:
    """An activation's blocks along `dim` over `axis` (one axis, or a tuple
    of them, the first outermost) concatenated, differentiable: the
    gradient is reduce-scattered back, and nothing else is summed."""
    return _Gather.apply(t, mesh, ((dim, entry_axes(axis)),), ())


class _ReduceScatter(torch.autograd.Function):
    """Forward: reduce-scatter along `dim` over `axis`. Backward: all-gather
    the gradient along it (the adjoint)."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axis):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim, axis
        return _reduce_scatter_dim(t, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather_dim(g, ctx.dim, ctx.axis, ctx.mesh), None, None,
                None)


def reduce_scatter_dim(t: torch.Tensor, dim: int, axis: str,
                       mesh) -> torch.Tensor:
    """The sum of `t` over the ranks of `axis`, of which this rank keeps its
    block along `dim`; differentiable (the gradient is all-gathered back)."""
    return _ReduceScatter.apply(t, mesh, dim, axis)


class _Psum(torch.autograd.Function):
    """Forward: the sum over `axes`. Backward: the sum of the gradients
    over them (the adjoint)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes, ctx.mesh), None, None


def psum(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """The sum of `t` over the ranks along `axes`, differentiable: the
    reference's psum."""
    return _Psum.apply(t, mesh, tuple(axes))


def regroup_last(t: torch.Tensor, parts, axis: str, mesh) -> torch.Tensor:
    """`t` [..., W/M] is this rank's contiguous block of the last dim of a
    whole [..., W] that is laid out as consecutive parts of the widths
    `parts` (each dividing by the M ranks of `axis`); returns this rank's
    block of each part, concatenated [..., W/M]. One all_to_all over
    `axis`, which moves each column to the one rank that keeps it (no
    gradient)."""
    m, r = axis_sizes(mesh)[axis], mesh.get_local_rank(axis)
    c = t.shape[-1]
    offsets = [sum(parts[:i]) for i in range(len(parts))]

    def cols(s: int, q: int) -> list:
        """The columns of rank s's blocks that lie in rank q's block,
        ascending, as (start, stop) ranges."""
        out = []
        for o, n in zip(offsets, parts):
            lo, hi = max(o + s * n // m, q * c), min(o + (s + 1) * n // m,
                                                     (q + 1) * c)
            if lo < hi:
                out.append((lo, hi))
        return out

    send = [range(lo - r * c, hi - r * c) for s in range(m)
            for lo, hi in cols(s, r)]
    index = torch.tensor([i for rg in send for i in rg], dtype=torch.long,
                         device=t.device)
    src = t.index_select(-1, index).movedim(-1, 0).contiguous()
    out = src.new_empty(src.shape)
    torch.distributed.all_to_all_single(
        out, src, [sum(hi - lo for lo, hi in cols(r, q)) for q in range(m)],
        [sum(hi - lo for lo, hi in cols(s, r)) for s in range(m)],
        group=_group(mesh, axis))
    return out.movedim(0, -1)


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a decode group forms a sum over its ranks in: float64 for
    float32 and float64, whose split then adds no rounding of its own
    where the one-device sum has one, and float32 for a 16-bit type."""
    return (torch.float64 if dtype in (torch.float32, torch.float64)
            else torch.float32)


class TensorParallel(NamedTuple):
    """The ranks of one mesh axis (`axis`, "model") splitting a layer's
    matmuls: `size` ranks, this one `rank`. Between layers each holds its
    block of the sequence (dim 1) of the residual stream, or, with
    `whole` (decode: one token), the whole stream, the same on every
    rank."""
    mesh: Any
    axis: str
    size: int
    rank: int
    whole: bool = False

    def divides(self, n: int) -> bool:
        return n % self.size == 0

    def block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of the whole `t` along `dim` (a view)."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole `t` along `dim` from each rank's block."""
        return gather_dim(t, dim, self.axis, self.mesh)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence from each rank's block (dim 1); the stream
        itself where it is whole."""
        return x if self.whole else self.gather(x, 1)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sequence (dim 1) of the sum of every
        rank's partial `x`; the whole sum where the stream is whole."""
        if self.whole:
            return self.psum(x)
        return reduce_scatter_dim(x, 1, self.axis, self.mesh)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return psum(x, (self.axis,), self.mesh)

    def row_linear(self, p, x: torch.Tensor) -> torch.Tensor:
        """x @ p["w"] of a whole stream (decode), from this rank's block
        x [..., K/M] of the input and its rows of p["w"]: the partial
        products and their sum over the group are formed in `sum_dtype`
        of x's type, then rounded to it once."""
        acc = sum_dtype(x.dtype)
        if acc == torch.float64:
            y = x.to(acc) @ p["w"].to(acc)
        else:                   # a 16-bit type: its product, summed in f32
            y = (x @ p["w"]).to(acc)
        return self.psum(y).to(x.dtype)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The largest `x` over the group, no gradient."""
        return all_reduce(x.detach(), (self.axis,), self.mesh, op="max")


def tensor_parallel(mesh, dp_axes, whole: bool = False):
    """The TensorParallel group of "model" on `mesh`, or None off a mesh or
    where "model" holds one rank: a layer then runs its plain body.
    whole: the residual stream is whole on every rank (decode).
    ValueError if the batch is split over "model" too."""
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return None
    if "model" in dp_axes:
        raise ValueError(f"tensor_parallel: the batch is split over "
                         f"'model' (dp_axes {tuple(dp_axes)}), whose ranks "
                         f"split the matmuls")
    return TensorParallel(mesh, "model", axis_sizes(mesh)["model"],
                          mesh.get_local_rank("model"), whole)


def gather_tree(tree, specs, mesh, keep, path: str):
    """`gather` over the tree at the "/"-joined `path` and its tree of
    specs; keep(a leaf's path) names the axes that leaf stays split over."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh, keep, f"{path}/{k}")
                for k, v in tree.items()}
    return gather(tree, specs, mesh, keep=keep(path))


class _Mean(torch.autograd.Function):
    """The mean over the ranks along some axes, forward and backward (the
    transpose of a mean is the mean of the cotangents)."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _mean(t, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.mesh, ctx.axes), None, None


def _mean(t, mesh, axes):
    sizes = axis_sizes(mesh)
    return all_reduce(t, axes, mesh) / math.prod(sizes[a] for a in axes)


def mesh_mean(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of `t` over the ranks along `axes`, differentiable: the
    reference's pmean."""
    return _Mean.apply(t, mesh, tuple(axes))


def mesh_size(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def global_norm(grads, specs, mesh) -> torch.Tensor:
    """The norm of the whole gradient from its shards: each leaf's sum of
    squares (in float32, float64 for float64) summed over the axes its spec
    names, then added leaf by leaf in the reference's flatten order, as
    `optimizer.global_norm` adds them on one device."""
    flat = leaves_with_paths(grads)
    spec_of = dict(leaves_with_paths(specs))
    sums = [torch.sum(torch.square(g.to(torch.promote_types(
        g.dtype, torch.float32)))) for _, g in flat]
    groups: dict = {}
    for i, (path, _) in enumerate(flat):
        named = tuple(a for a in axis_sizes(mesh)
                      if any(a in entry_axes(e) for e in spec_of[path]))
        groups.setdefault((named, sums[i].dtype), []).append(i)
    for (named, _), idx in groups.items():
        vec = all_reduce(torch.stack([sums[i] for i in idx]), named, mesh)
        for j, i in enumerate(idx):
            sums[i] = vec[j]
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)
