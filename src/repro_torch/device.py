"""Device and kernel-choice resolution shared by every entry point.

`device=None` means the card (`"cuda"`). Without a card the entry point
raises instead of carrying on on the CPU; a caller that wants the CPU (the
tests) passes `device="cpu"`.

`use_kernel` is "auto" | "cuda" | "ref". "auto" launches the hand-written
kernel for CUDA tensors and uses its plain torch version for CPU tensors;
"ref" asks for the plain version anywhere. There is no fallback from a
kernel to its plain version on a CUDA tensor: the wrapper launches or
raises.
"""
from __future__ import annotations

import torch

USE_KERNEL = ("auto", "cuda", "ref")


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU on purpose")
    return dev


def device_kind(dev: torch.device) -> str:
    """What a record says it ran on: "cpu", or the card's name."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def check_use_kernel(use_kernel: str) -> str:
    if use_kernel not in USE_KERNEL:
        raise ValueError(f"use_kernel must be one of {USE_KERNEL}, "
                         f"got {use_kernel!r}")
    return use_kernel


def wants_plain(use_kernel: str, x: torch.Tensor) -> bool:
    """True when the caller asked for the plain version ("ref"). "cuda" on
    a CPU tensor raises; "auto" leaves the choice to the kernel wrapper,
    which launches for CUDA tensors and runs the plain version for CPU
    ones."""
    if use_kernel == "cuda" and not x.is_cuda:
        raise ValueError("use_kernel='cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    return use_kernel == "ref"


def to_device(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host numpy array as a contiguous tensor of `dtype` on `device`.

    numpy has no bf16: a uint16 array going to bf16 holds raw bf16 bits
    (what `host_array` gives for a bf16 tensor) and is restored bit for
    bit."""
    import numpy as np

    arr = np.require(arr, requirements=["C", "W"])  # copies read-only views
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def host_array(t: torch.Tensor):
    """A tensor's values as a host numpy array; a bf16 tensor gives its raw
    bits as uint16 (numpy has no bf16), which `to_device` restores."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("uint16")
    return t.numpy()


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype, a numpy dtype or a name (None = f32)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    return getattr(torch, np.dtype(dtype).name)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator type: at least float32 (the reference's contract)."""
    return torch.promote_types(dtype, torch.float32)
