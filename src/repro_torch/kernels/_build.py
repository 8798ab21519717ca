"""Build the CUDA sources with nvcc and bind them with ctypes.

At first use `library()` compiles `repro_torch/csrc/spmv_kernels.cu` into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/libspmv_<hash>.so <sources>

The library lands in `build/repro_torch/` at the repository root
(REPRO_TORCH_BUILD_DIR overrides), keyed by a hash of the sources and the
flags, written to a temporary name and renamed into place. A failed build
raises with the compiler's output; nothing falls back.

`launch(name, dtype, tensors, ints)` calls the `<name>_f32` / `<name>_f64`
launcher on torch's current stream and raises on a nonzero CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "spmv_kernels.cu",)
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# launcher name -> (pointer args, integer args); every launcher takes the
# stream last and returns a cudaError_t as int
SIGNATURES = {
    "sell_spmv": (5, 4),
    "sell_spmm": (5, 5),
    "bcsr_spmv": (5, 4),
    "bell_spmv": (4, 5),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_lock = threading.Lock()
_lib = None
# what the build did: library path, seconds, whether it compiled, ptxas log
BUILD_INFO: dict = {}


def build_dir() -> Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(d) if d else _PKG.parents[1] / "build" / "repro_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = build_dir() / f"libspmv_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, compiled=False, log="")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      compiled=True, log=proc.stdout + proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (nptr, nint) in SIGNATURES.items():
                for suffix in _SUFFIX.values():
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = ([ctypes.c_void_p] * nptr
                                   + [ctypes.c_longlong] * nint
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
            lib.spmv_error_string.argtypes = [ctypes.c_int]
            lib.spmv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, dtype: torch.dtype, device: torch.device,
          **tensors) -> None:
    """Raise unless every tensor is contiguous on `device`, values in
    `dtype` and indices in the int type the kernel reads (keyword names
    ending in `_i32` / `_i64`)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or float64, "
                        f"got {dtype}")
    for key, t in tensors.items():
        want = (torch.int32 if key.endswith("_i32") else
                torch.int64 if key.endswith("_i64") else dtype)
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def launch(name: str, dtype: torch.dtype, tensors, ints) -> None:
    """Launch `<name>_<f32|f64>` on the current stream; raise on error."""
    fn = getattr(library(), f"{name}_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(*[t.data_ptr() for t in tensors], *[int(v) for v in ints],
            stream)
    if rc != 0:
        msg = library().spmv_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
