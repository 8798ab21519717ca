"""Mesh factories: the reference's `repro/launch/mesh.py` over
`torch.distributed`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named axes
("data", "model", and "pod" on a multi-pod mesh) over the process group
that the caller has opened (`torch.distributed.init_process_group`: NCCL
on the card, gloo on the CPU). Each factory checks that group's size and
backend and raises, naming what it needs, when they do not fit; a fake
group (`torch.testing._internal.distributed.fake_pg`, the dry-run's)
stands in for either backend.
Functions, not module-level constants: importing this module touches no
device and no process group.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from ..device import resolve_device
from ..distributed.sharding import axis_sizes


def make_mesh(shape, axes, device=None):
    """A DeviceMesh of `shape` with axis names `axes` on `device` (None:
    the card, over NCCL; "cpu": gloo), one rank per process."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ "
                         f"in length")
    world = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh: a {shape} mesh needs a process group "
                           f"of {world} ranks over {backend}; none is open")
    if dist.get_world_size() != world:
        raise RuntimeError(f"make_mesh: a {shape} mesh needs a process group "
                           f"of {world} ranks; this one has "
                           f"{dist.get_world_size()}")
    have = dist.get_backend()
    if backend not in have and "fake" not in have:
        raise RuntimeError(f"make_mesh: a mesh on {dev.type} needs {backend}; "
                           f"the process group runs {have}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model"):
    256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_cpu_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh on the CPU, over gloo (the tests' meshes)."""
    return make_mesh((data, model), ("data", "model"), "cpu")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of `world` ranks in this process, as rank 0,
    destroyed on exit (`torch.testing._internal.distributed.fake_pg`, a
    private module): its collectives take tensors on the CPU or the meta
    device, move nothing and return at once, so one process counts what a
    rank of a production mesh runs. RuntimeError if a group is open."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"fake_group: a process group of "
                           f"{dist.get_world_size()} ranks is open already")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dp_axes_of(mesh) -> tuple:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


HardwareSpec = {
    # NVIDIA H100 SXM5 80 GB at 700 W, from NVIDIA's H100 Tensor Core GPU
    # datasheet: dense bf16 tensor-core peak (the 1,979 TFLOP/s quoted is
    # with 2:4 sparsity), HBM3 bandwidth, and NVLink 4's 900 GB/s both ways
    # over 18 links, so 25 GB/s each way a link
    "peak_flops_bf16": 989e12,   # FLOP/s
    "hbm_bw": 3.35e12,           # B/s
    "ici_bw": 25e9,              # B/s per link, each way
}
