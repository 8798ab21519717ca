#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # the paper's Fig. 1 pair, 1,048,576 rows

Phases, in order, one line each with its seconds; the first failure ends
the run with a nonzero exit code (nothing is caught):

 1. environment — nvidia-smi name and power limit, torch and CUDA versions;
 2. build       — nvcc compiles the four SpMV kernels (repro_torch/csrc)
                  into build/repro_torch/;
 3. kernels     — each kernel against its plain torch version on the card
                  at small random shapes (σ-sorted SELL with empty slices,
                  BCSR with empty block rows, Block-ELL with padding
                  blocks, SpMM widths 1, 3, 8, 33), float32 and float64;
 4. main path   — the paper's SpMV cell through repro_torch.launch
                  .spmv_bench.run_cell (plan → build → verify → IOS/YAX →
                  instrumented CG): fig1_shuffled with baseline and rcm,
                  fig1_banded with baseline, all engine="auto", then
                  fig1_shuffled + rcm at k = 8;
 5. forced      — the kernel engines through make_engine on the structure
                  twin of the RCM-reordered fig1_shuffled (its sparsity
                  pattern, values U(-1, 1) from a seed): sell (K1, and K2
                  at k = 8), bcsr (K3) and bell (K4), each verified, then
                  IOS-timed;
 6. kernel times — each kernel at the shape phase 5 gave it, against its
                  plain version (error, median ms of 20 launches), its
                  byte bound and torch's CSR SpMV/SpMM on the same matrix;
 7. controls    — planted faults at the main-path shape must fail the
                  checks: each kernel with its largest stored chunk or
                  block dropped, and a diagonal-only operator under verify.

Every kernel launch counter is set to 0 just before each cell of phase 4
and each forced path of phase 5 and read just after it; a forced path that
did not launch its kernel, or a cell whose plan picked a kernel engine
that launched nothing, fails the run. The kernels line reports, for each
kernel, the launches of the forced path that feeds its row.

Verification is against the numpy float64 oracle at rel err <= 1e-4 (the
error over the oracle's largest entry); a kernel against its plain version
at rel err <= 1e-5 in float32 (same terms, different summation order) and
1e-12 in float64. The generators give every row a diagonal of m = 1,048,576
at this size, about 1e5 times the rest of the row, and an error divided by
that scale hides wrong off-diagonal terms; so every check at the
main-path shape also runs on the structure twin, where each term counts
(phase 7 shows that it catches what the original matrix hides). TF32 is
off for the plain versions' einsum products. The last lines are one JSON
object with every kernel's numbers, the nvidia-smi line, and the result
line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
VERIFY_TOL = 1e-4
ITERS = 20

KERNELS = {
    "sell_spmv": "src/repro/kernels/sell_spmv/kernel.py:50",
    "sell_spmm": "src/repro/kernels/sell_spmm/kernel.py:56",
    "bcsr_spmv": "src/repro/kernels/bcsr_spmv/kernel.py:42",
    "bell_spmv": "src/repro/kernels/bell_spmv/kernel.py:38",
}
SOURCE = "src/repro_torch/csrc/spmv_kernels.cu"


def phase(name: str, t0: float, **fields) -> None:
    extra = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[phase] {name} {time.perf_counter() - t0:.2f}s {extra}",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|), in float64."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-30)


def check_close(name: str, got, want, dtype) -> float:
    _, rel = rel_err(got, want)
    tol = KERNEL_TOL[str(dtype).replace("torch.", "")]
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel vs plain rel err {rel:.3e} "
                             f"> {tol:.0e}")
    return rel


def time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median device ms of fn() over `iters` calls, one CUDA event pair
    per call, read after one synchronize."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def operator_bytes(op) -> int:
    import torch

    return sum(tensor_bytes(v) for v in vars(op).values()
               if isinstance(v, torch.Tensor))


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- the kernel calls, wrapper and plain version on the same inputs --------
def sell_calls(op, x, spmm: bool = False):
    """K1 for one vector, K2 for a block (or when spmm is set)."""
    from repro_torch.kernels.sell_spmm.kernel import (pick_k_tile, sell_spmm,
                                                      sell_spmm_plain)
    from repro_torch.kernels.sell_spmv.kernel import (sell_spmv,
                                                      sell_spmv_plain)

    args = (op.chunk_vals, op.chunk_cols, op.chunk_slice)
    if x.shape[1] == 1 and not spmm:
        return ("sell_spmv",
                lambda: sell_spmv(*args, op.slice_ptr, x, op.num_slices),
                lambda: sell_spmv_plain(*args, x, op.num_slices))
    kt = pick_k_tile(x.shape[1])
    return ("sell_spmm",
            lambda: sell_spmm(*args, op.slice_ptr, x, op.num_slices, kt),
            lambda: sell_spmm_plain(*args, x, op.num_slices))


def bcsr_calls(op, x2d):
    from repro_torch.kernels.bcsr_spmv.kernel import (bcsr_spmv,
                                                      bcsr_spmv_plain)

    args = (op.blocks, op.block_rows, op.block_cols)
    return ("bcsr_spmv",
            lambda: bcsr_spmv(*args, op.block_rowptr, x2d, op.nbr),
            lambda: bcsr_spmv_plain(*args, x2d, op.nbr))


def bell_calls(op, x2d):
    from repro_torch.kernels.bell_spmv.kernel import (bell_spmv,
                                                      bell_spmv_plain)

    return ("bell_spmv",
            lambda: bell_spmv(op.blocks, op.block_cols, x2d),
            lambda: bell_spmv_plain(op.blocks, op.block_cols, x2d))


def x2d_for(op, nv: int, gen, dtype, dev):
    bn = op.block_shape[1]
    return torch_randn((op.ncb, bn, nv), gen, dtype, dev)


def torch_generator(seed: int):
    import torch

    return torch.Generator().manual_seed(seed)


def torch_randn(shape, gen, dtype, dev):
    import torch

    return torch.randn(shape, generator=gen, dtype=torch.float64).to(
        dev, dtype)


# -- phase 3: small random shapes ------------------------------------------
def small_matrices():
    """Small host matrices that reach the formats' edge cases."""
    import numpy as np

    from repro_torch.core.sparse.csr import CSRMatrix
    from repro_torch.matrices import generators as G

    rng = np.random.default_rng(11)
    holes = rng.standard_normal((300, 280)) * (rng.random((300, 280)) < 0.05)
    holes[40:120] = 0.0                      # empty slices / block rows
    holes[200, :] = rng.standard_normal(280)  # one dense row (SELL padding)
    return {"power_law": G.power_law(700, alpha=1.9, seed=3),
            "holes": CSRMatrix.from_dense(holes)}


def kernels_small(dev) -> int:
    import torch

    from repro_torch.core.spmv.ops import make_engine

    gen = torch_generator(0)
    checked = 0
    for mname, mat in small_matrices().items():
        for dtype in (torch.float32, torch.float64):
            for shape, sigma in (((8, 8), 64), ((8, 32), mat.m)):
                op = make_engine(mat, "sell", dtype=dtype, block_shape=shape,
                                 sell_sigma=sigma, device=dev)
                for k, spmm in ((1, False), (1, True), (3, True),
                                (8, True), (33, True)):
                    x = torch_randn((mat.n, k), gen, dtype, dev)
                    name, kern, plain = sell_calls(op, x, spmm)
                    check_close(f"{name} {mname} {shape} k={k}", kern(),
                                plain(), dtype)
                    checked += 1
            for eng, calls in (("bcsr", bcsr_calls), ("bell", bell_calls)):
                for shape in ((8, 16), (8, 128), (4, 4)):
                    op = make_engine(mat, eng, dtype=dtype,
                                     block_shape=shape, device=dev)
                    for nv in (1, 3):
                        name, kern, plain = calls(
                            op, x2d_for(op, nv, gen, dtype, dev))
                        check_close(f"{name} {mname} {shape} nv={nv}",
                                    kern(), plain(), dtype)
                        checked += 1
    return checked


# -- phases 4-5: the main path ---------------------------------------------
# the forced path that feeds each kernel's row of the kernels line
FEEDS = {"sell_spmv": "forced/sell/k1", "sell_spmm": "forced/sell/k8",
         "bcsr_spmv": "forced/bcsr/k1", "bell_spmv": "forced/bell/k1"}


def main_path(dev, shuffled: str, banded: str, iters: int) -> tuple:
    """The paper cells and forced kernel engines, each run with the launch
    counts set to 0 just before it and read just after. Returns the forced
    operators (for phases 6-7), the RCM-reordered matrix, its structure
    twin (the forced operators' matrix) and the records."""
    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    mats = {shuffled: suite.get(shuffled), banded: suite.get(banded)}
    phase("matrices", t0, **{n: f"{m.m}x{m.n}/nnz={m.nnz}"
                             for n, m in mats.items()})
    kernel_of = {"sell": ("sell_spmv", "sell_spmm"), "bcsr": ("bcsr_spmv",),
                 "bell": ("bell_spmv",)}
    recs, rmat = {}, None
    for name, scheme, k in ((shuffled, "baseline", 1), (shuffled, "rcm", 1),
                            (banded, "baseline", 1), (shuffled, "rcm", 8)):
        t0 = time.perf_counter()
        kernels.reset_launches()
        rec, op, rm = spmv_bench.run_cell(mats[name], scheme, "auto", k=k,
                                          iters=iters, device=dev)
        rec["launches"] = dict(kernels.LAUNCHES)
        del op
        if scheme == "rcm" and k == 1:
            rmat = rm
        tag = f"{name}/{scheme}/k{k}"
        recs[tag] = rec
        picked = [kn for kn in kernel_of.get(rec["engine"], ())
                  if rec["launches"][kn] > 0]
        if rec["engine"] in kernel_of and not picked:
            raise AssertionError(f"{tag}: the plan picked {rec['engine']} "
                                 f"but no kernel of it launched")
        phase(f"cell {tag}", t0, engine=rec["engine"],
              label=rec["plan_label"], plan_ms=f"{rec['plan_ms']:.1f}",
              reorder_ms=f"{rec['reorder_ms']:.1f}",
              tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec["ios_ms"], gflops=f"{rec['ios_gflops']:.2f}",
              yax_ms=rec.get("yax_ms"), cg_ms=rec.get("cg_ms"),
              launches=json.dumps(rec["launches"]))
    base = recs[f"{shuffled}/baseline/k1"]["ios_ms"]
    rcm = recs[f"{shuffled}/rcm/k1"]["ios_ms"]
    print(f"[result] rcm speedup over baseline on {shuffled} (IOS, auto "
          f"engine): {base / rcm:.3f}x", flush=True)

    # forced kernel engines on the RCM order's structure twin, in its space
    forced = {}
    vmat = spmv_bench.structure_twin(rmat, seed=1)
    w_fit = pick_chunk_width(vmat)
    for eng, shape, sigma, ks in (("sell", (8, w_fit), 64, (1, 8)),
                                  ("bcsr", (8, 128), None, (1,)),
                                  ("bell", (8, 128), None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, block_shape=shape, sell_sigma=sigma,
                         device=dev)
        forced[eng] = op
        phase(f"forced build {eng}", t0, block_shape=shape,
              device_bytes=operator_bytes(op))
        for k in ks:
            t0 = time.perf_counter()
            tag = f"forced/{eng}/k{k}"
            kernels.reset_launches()
            err = spmv_bench.verify(op, vmat, k, device=dev, tol=VERIFY_TOL)
            rec = spmv_bench.measure(op, vmat.nnz, vmat.n, k, device=dev,
                                     iters=iters)
            rec["launches"] = dict(kernels.LAUNCHES)
            rec["verify_rel_err"] = err
            recs[tag] = rec
            phase(tag, t0, verify=f"{err:.2e}", ios_ms=rec["ios_ms"],
                  gflops=f"{rec['ios_gflops']:.2f}",
                  launches=json.dumps(rec["launches"]))
    for name, tag in FEEDS.items():
        if recs[tag]["launches"][name] == 0:
            raise AssertionError(f"{tag} never launched {name}")
    return forced, rmat, vmat, recs


# -- phase 6: kernel times at the main-path shapes -------------------------
def kernel_inputs(forced, vmat, dev) -> list:
    """(nv, operator, calls, x, kernel-shaped x) per kernel, main-path
    shapes."""
    gen = torch_generator(1)
    out = []
    for nv, eng, calls in ((1, "sell", sell_calls), (8, "sell", sell_calls),
                           (1, "bcsr", bcsr_calls), (1, "bell", bell_calls)):
        op = forced[eng]
        if calls is sell_calls:
            x = xin = torch_randn((vmat.n, nv), gen, op.chunk_vals.dtype, dev)
        else:
            xin = x2d_for(op, nv, gen, op.blocks.dtype, dev)
            x = xin.reshape(-1, nv)[: vmat.n]
        out.append((nv, op, calls, x, xin))
    return out


def kernel_times(forced, vmat, dev, recs: dict) -> list:
    import torch

    dt = torch.float32
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(vmat.rowptr.astype("int64")),
        torch.as_tensor(vmat.cols.astype("int64")),
        torch.as_tensor(vmat.vals), size=vmat.shape,
        check_invariants=False).to(dev, dt)
    rows = []
    for nv, op, calls, x, xin in kernel_inputs(forced, vmat, dev):
        if calls is sell_calls:
            t, c, w = op.chunk_vals.shape
            mat_bytes = tensor_bytes(op.chunk_vals, op.chunk_cols,
                                     op.slice_ptr)
            flops = 2 * t * c * w * nv
            y_elems = op.num_slices * c * nv
        else:
            mat_bytes = tensor_bytes(op.blocks, op.block_cols)
            if calls is bcsr_calls:
                mat_bytes += tensor_bytes(op.block_rowptr)
            flops = 2 * op.blocks.numel() * nv
            nbr = op.nbr if calls is bcsr_calls else op.blocks.shape[0]
            y_elems = nbr * op.block_shape[0] * nv
        name, kern, plain = calls(op, xin)
        abs_err, rel = rel_err(kern(), plain())
        if not rel <= KERNEL_TOL["float32"]:
            raise AssertionError(f"{name}: kernel vs plain rel err {rel:.3e}"
                                 f" at the main-path shape")
        nbytes = mat_bytes + tensor_bytes(xin) + y_elems * 4
        bms, by = bound_ms(nbytes, flops)
        xl = x.contiguous() if nv > 1 else x[:, 0].contiguous()
        path = FEEDS[name]
        launches = recs[path]["launches"][name]
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": KERNELS[name], "launches": launches,
               "launches_path": path, "max_abs_err": abs_err,
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "bound_ms": bms, "bound_by": by,
               "library_ms": time_ms(lambda: csr @ xl)}
        rows.append(row)
        print(f"[kernel] {name} nv={nv} rel_err={rel:.2e} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms={bms:.4f} "
              f"({by}, {nbytes} B, {flops} flop) "
              f"launches={launches} ({path})", flush=True)
    return rows


# -- phase 7: planted faults must fail the checks --------------------------
def dropped_block(op, attr: str):
    """A shallow copy of `op` whose stored chunk or block (the last two
    dims of `attr`) with the largest |value| is zeroed."""
    import copy

    vals = getattr(op, attr)
    flat = vals.reshape(-1, vals.shape[-2] * vals.shape[-1])
    g = int(flat.abs().amax(dim=1).argmax())
    bad = flat.clone()
    bad[g] = 0
    out = copy.copy(op)
    setattr(out, attr, bad.reshape(vals.shape))
    return out, g


def diagonal_only(mat, dev):
    """y = diag(mat) * x on the card: every off-diagonal term dropped."""
    import numpy as np
    import torch

    rows = np.repeat(np.arange(mat.m), mat.row_nnz())
    on = rows == mat.cols
    d = np.zeros(mat.m)
    d[rows[on]] = mat.vals[on]
    dt = torch.as_tensor(d, dtype=torch.float32, device=dev)
    return lambda x: dt * x


def planted_faults(forced, rmat, vmat, dev) -> None:
    from repro_torch.launch import spmv_bench

    tol = KERNEL_TOL["float32"]
    for nv, op, calls, _, xin in kernel_inputs(forced, vmat, dev):
        attr = "chunk_vals" if calls is sell_calls else "blocks"
        bad, g = dropped_block(op, attr)
        name, kern, plain = calls(bad, xin)
        _, rel = rel_err(kern(), calls(op, xin)[2]())
        if not rel > tol:
            raise AssertionError(f"{name}: dropping stored block {g} gave "
                                 f"rel err {rel:.3e}, which passes {tol:.0e}")
        print(f"[control] {name} nv={nv} with block {g} dropped: rel err "
              f"{rel:.3e} > {tol:.0e}, caught", flush=True)
        del bad
    inf = float("inf")
    hidden = spmv_bench.verify(diagonal_only(rmat, dev), rmat, tol=inf,
                               device=dev)
    seen = spmv_bench.verify(diagonal_only(vmat, dev), vmat, tol=inf,
                             device=dev)
    if not seen > VERIFY_TOL:
        raise AssertionError(f"a diagonal-only operator passes verify on the "
                             f"structure twin (rel err {seen:.3e})")
    verdict = "passes" if hidden <= VERIFY_TOL else "fails"
    print(f"[control] diagonal-only operator under verify: rel err "
          f"{hidden:.3e} on the matrix itself ({verdict} {VERIFY_TOL:.0e}), "
          f"{seen:.3e} on its structure twin, caught", flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of repro_torch on "
                                             "one NVIDIA card")
    ap.add_argument("--shuffled", default="fig1_shuffled")
    ap.add_argument("--banded", default="fig1_banded")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    # the Fig. 1 pair is generated in memory every run; no npz cache
    os.environ.setdefault("REPRO_TORCH_MATRIX_CACHE", "off")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    smi = nvidia_smi()
    phase("environment", t0, nvidia_smi=json.dumps(smi),
          torch=torch.__version__, cuda=torch.version.cuda,
          device=json.dumps(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    phase("build", t0, library=_build.BUILD_INFO["path"],
          nvcc_s=f"{_build.BUILD_INFO['seconds']:.2f}")
    print(_build.BUILD_INFO["log"].strip(), flush=True)

    t0 = time.perf_counter()
    checked = kernels_small(dev)
    phase("kernels small shapes", t0, comparisons=checked)

    forced, rmat, vmat, recs = main_path(dev, args.shuffled, args.banded,
                                         args.iters)
    print(f"[launches] per path: "
          f"{json.dumps({t: r['launches'] for t, r in recs.items()})}",
          flush=True)

    t0 = time.perf_counter()
    rows = kernel_times(forced, vmat, dev, recs)
    phase("kernel times", t0)

    t0 = time.perf_counter()
    planted_faults(forced, rmat, vmat, dev)
    phase("controls", t0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
