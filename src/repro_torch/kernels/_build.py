"""Build the CUDA sources with nvcc and bind them with ctypes.

At first use `library()` compiles every source under `repro_torch/csrc/`
into one shared library with a plain C interface: one nvcc per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <stem>.o <stem>.cu   (each source)
    nvcc -shared -o <build>/librepro_torch_<hash>.so *.o

The library lands in `build/repro_torch/` at the repository root
(REPRO_TORCH_BUILD_DIR overrides), keyed by a hash of the sources and the
flags, written to a temporary name and renamed into place. A failed build
raises with the compiler's output; nothing falls back.

`launch(name, dtype, tensors, ints)` calls the `<name>_<f32|f64|bf16>`
launcher on torch's current stream and raises on a nonzero CUDA error.
Each kernel takes the value types KERNELS lists for it and no other.
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
SOURCES = (_PKG / "csrc" / "spmv_kernels.cu", _PKG / "csrc" / "ssd_chunk.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_F32, _F64, _BF16 = torch.float32, torch.float64, torch.bfloat16
# launcher name -> (pointer args, integer args, value types); every launcher
# takes the stream last and returns a cudaError_t as int
KERNELS = {
    "sell_spmv": (5, 4, (_F32, _F64)),
    "sell_spmm": (5, 5, (_F32, _F64)),
    "bcsr_spmv": (5, 4, (_F32, _F64)),
    "bell_spmv": (4, 5, (_F32, _F64)),
    "ssd_scan": (7, 10, (_F32, _BF16)),
}
_SUFFIX = {_F32: "f32", _F64: "f64", _BF16: "bf16"}
_INDEX = {"_i32": torch.int32, "_i64": torch.int64, "_f32": torch.float32}

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


def _finish(cmd, proc, out: str, err: str) -> str:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{out}{err}")
    return out + err


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = build_dir() / f"librepro_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, compiled=False, log="")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in SOURCES]
    t0 = time.perf_counter()
    cmds = [[_nvcc(), *FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        log = "".join(_finish(cmd, proc, *proc.communicate())
                      for cmd, proc in zip(cmds, procs))
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += _finish(cmd, proc, proc.stdout, proc.stderr)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      compiled=True, log=log)
    return out


def library() -> ctypes.CDLL:
    """The bound kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (nptr, nint, dtypes) in KERNELS.items():
                for dtype in dtypes:
                    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
                    fn.argtypes = ([ctypes.c_void_p] * nptr
                                   + [ctypes.c_longlong] * nint
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
            lib.spmv_error_string.argtypes = [ctypes.c_int]
            lib.spmv_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _packed(t: torch.Tensor, from_dim: int) -> bool:
    """True when the dims from `from_dim` on are laid out densely."""
    want = 1
    for size, stride in reversed(list(zip(t.shape, t.stride()))[from_dim:]):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def check(name: str, dtype: torch.dtype, device: torch.device,
          batch_strided=(), **tensors) -> None:
    """Raise unless every tensor is on `device`, values in `dtype` and
    indices or fixed-type operands in the type the kernel reads (keyword
    names ending in `_i32` / `_i64` / `_f32`), and contiguous; a tensor
    named in `batch_strided` may instead have any stride on its first dim."""
    dtypes = KERNELS[name][2]
    if dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: the kernel takes {names}, got {dtype}")
    for key, t in tensors.items():
        want = _INDEX.get(key[-4:], dtype)
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")
        if not _packed(t, 1 if key in batch_strided else 0):
            raise ValueError(f"{name}: {key} must be contiguous"
                             + (" past its first dim" if key in batch_strided
                                else ""))


def launch(name: str, dtype: torch.dtype, tensors, ints) -> None:
    """Launch `<name>_<suffix>` on the current stream; raise on error."""
    lib = library()
    fn = getattr(lib, f"{name}_{_SUFFIX[dtype]}")
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(*[t.data_ptr() for t in tensors], *[int(v) for v in ints],
            stream)
    if rc != 0:
        msg = lib.spmv_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
