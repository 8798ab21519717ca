#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py            # Fig. 1 pair (1,048,576 rows), then
                                     # Zamba2-7B at full width and depth

Phases, in order, one line each with its seconds; the first failure ends
the run with a nonzero exit code (nothing is caught):

 1. environment — nvidia-smi name and power limit, torch and CUDA versions;
 2. build       — nvcc compiles the sources of repro_torch/csrc (the four
                  SpMV kernels, and K5 ssd_chunk), one nvcc per source, all
                  at once, and links them into one library in
                  build/repro_torch/;
 3. kernels     — each SpMV kernel against its plain torch version on the
                  card at small random shapes, float32, float64 and bf16,
                  through
                  every body of K1-K4: σ-sorted SELL with empty slices at
                  C = 8, 32 and W = 8, 32, 128 (K1 at nv = 1, 3; K2 at
                  widths 1, 3, 4, 8, 16, 32, 33, 36, 64: its vector body at
                  k-tiles of 8, 16 and 32 with ragged and second tiles, its
                  scalar body at odd k), BCSR with
                  empty block rows and Block-ELL with padding blocks, each
                  at bm = 4, 8, 16 and bn = 16, 100, 128 (and 4 × 4) at
                  nv = 1, 3, 8, and every kernel once more with its values
                  off a 16-byte boundary (K2 also with x off one); then K5
                  through both of its bodies: single
                  chunks (T = 8 .. 128, several B·H, a nonzero incoming
                  state, f32 and bf16), scans of 3 and 4 chunks against
                  ssd_scan(use_kernel="ref"), a scan over batch-strided
                  views of a longer sequence, and the bf16 tensor-core
                  shape with its operands off a 16-byte boundary;
 4. main path   — the paper's four Fig. 1 cells as one spmv ExperimentSpec
                  through repro_torch.experiments.Runner (plan → build →
                  verify on the matrix and its structure twin → IOS/YAX →
                  instrumented CG → modelled-parallel time and structural
                  metrics at p = 8): fig1_shuffled with baseline and rcm,
                  fig1_banded with baseline, all engine="auto", and
                  fig1_shuffled + rcm at k = 8; then its reordered k = 1
                  cell (fig1_shuffled + rcm) on a fresh result store with
                  the same plan store (a plan-store hit, tune_ms = 0),
                  and the whole spec on the first result store (every
                  cell served from it), each with its seconds against the
                  first run's; then the Fig. 4
                  schedule spec on banded_m65536_bw24 and its shuffled
                  twin (static_default, static_c16, nnz_balanced and
                  metis_cut, p = 8). Plans, reorderings, operators, corpus
                  artifacts and records live in a temporary directory for
                  the run (no earlier run's entry is read);
4c. schemes     — the paper's scheme axis: one spmv ExperimentSpec on
                  loc_stencil2d_shuf (524,176 rows, 2,617,984 nnz) over
                  paper_schemes() (baseline, rcm, metis, louvain, patoh,
                  random) and metis_nnzbal x {auto, sell (K1), bcsr (K3)},
                  the full policy, each cell with its host reorder ms and
                  IOS speedup over baseline; then the RCM-vs-METIS duel
                  (IOS, YAX, CG), pairwise win rates and speedup buckets;
4e. corpus      — every bundled fixture verified against the manifest's
                  dims; spmv cells on corpus://fix_banded_1k and the
                  stand-in of corpus://pwtk; plan(probe="learned") on the
                  stand-in of corpus://cant after the advisor has mined
                  the records of phases 4-4e, beside plan(probe=True);
 5. forced      — the kernel engines through make_engine on the structure
                  twin of the RCM-reordered fig1_shuffled (its sparsity
                  pattern, values U(-1, 1) from a seed; the order comes
                  from the plan store): sell (K1, and K2 at k = 8), bcsr
                  (K3) and bell (K4), each verified, then IOS-timed; then
                  the same engines in bf16, each operator called once and
                  held against the f64 product of the bf16-rounded
                  operands within 1e-2, and the bf16 csr engine held row
                  by row to its rounding bound γ_n·Σ|a·x| (see
                  bf16_row_bound) on 16 readings;
 6. kernel times — each SpMV kernel at the shape phase 5 gave it, against
                  its plain version (error; ms per call, see time_ms), its
                  byte bound and torch's CSR SpMV/SpMM on the same matrix
                  with int32 and with int64 indices (the faster is the
                  row's library_ms); then K2 once more at k = 32 (error,
                  ms, bound, library; kept in K2's row as "k32"); then the
                  bf16 kernels the same way (rows named <kernel>_bf16,
                  torch's bf16 CSR as the library, or none with its error);
6b. power law   — K1 (σ-sorted SELL), K2 at k = 8 and K3 (the largest
                  block shape under 8 GB of BCSR) on the structure twin of
                  the webbase-1M stand-in (1,000,005 rows, largest row
                  115,668 nonzeros), each path verified and IOS-timed, each
                  kernel timed as in phase 6 (rows <kernel>_powerlaw); K4's
                  Block-ELL bytes counted, not built;
 7. controls    — planted faults at the main-path shape must fail the
                  checks: each kernel, f32 and bf16, with its largest
                  stored chunk or block dropped, the bf16 csr engine with
                  one block of rows zeroed against its rounding bound, and
                  a diagonal-only operator under verify;
7s. serve       — repro_torch.serving.spmv_service on the Fig. 1 pair
                  (rcm, max_batch 8, window 20 ms): 48 seeded requests
                  over both matrices with engine sell (K2 per batch, K1
                  for the last, sent alone) and with bcsr (K3), every
                  response within 1e-4 of the float64 host product and
                  within 1e-5 of the unbatched op(x), fewer batches than
                  requests; where a dispatch's time goes; on one sell key
                  a value swap (x 1.01, no replan), a 0.5% deletion delta
                  (Plan.apply_delta: no reorder, no tune) and an
                  over-churn delta (a full replan), each answered
                  correctly, and the planted control (a response after the
                  swap held against the old product must fail); then
                  a profiled stretch of 64 dispatches; open-loop traffic
                  (spmv_bench.run_serve_traffic: 4 keys, Zipf 1.1,
                  poisson, 200 arrivals, 10% value updates, 2% structure
                  deltas, a budget of 2.5 operators) on the Fig. 1
                  generator cut to TRAFFIC_ROWS rows: a sqrt(2) rate ramp
                  to the sustained rate, and the runs at 0.5x and 2x it
                  (every Future answered and none failed, budget kept,
                  counters balanced, operators reloaded, K2 launched,
                  rejects at 2x); one serve cell on fig1_shuffled at its
                  full size (16 arrivals with the value updates, the 0.5x
                  rate) through the Runner under torch.profiler, resumed
                  from its store;
7w. workloads   — repro_torch.workloads.run_stream(verify=True) over the
                  drift scenario: MoE routing at Qwen3-30B-A3B's router
                  (128 experts, top 8, d 2048, 4096 tokens; sell, K2; the
                  dispatch buffer bit for bit the one-hot one's), a GNN
                  of 1,048,576 rows (sell, K2; every step after the first
                  a StructureDelta, no replan) and block-sparse attention
                  at S = 8192 (bcsr 64 x 64, K3);
 8. lm prefill  — the SpMV tensors are freed; Zamba2-7B at full width and
                  depth (81 Mamba2 layers, the shared attention block after
                  each group of 6), random f32 parameters from a seeded
                  generator on the card (embedding scaled, see EMBED_SCALE),
                  B = 2 prompts of S = 4096 tokens through
                  repro_torch.serving.decode.prefill: with K5 (81
                  launches, one per layer) and with the plain SSD chunk, and as a witness
                  the plain SSD with chunks of 64 against that of 128 (the
                  same function, another rounding); every Mamba2 layer
                  of it held, on the input the K5 path gave it, against the
                  plain SSD within 1e-5; the same prefill cut to 15 layers
                  (2 groups and the tail), K5 against plain, logits within
                  1e-3 of the largest, with the witness beside it; then
                  the 81-layer bf16 prefill: each Mamba2 layer with K5
                  against the plain SSD on the same input within 1e-2,
                  then timed (CUDA events, median of 5) in tokens/s, and
                  profiled once (device busy share, device time by kernel
                  group);
 9. lm decode   — generate (greedy, f32, 81 layers) at B = 4, prompt 16,
                  32 new tokens, in tokens/s; one decode step profiled as
                  the prefill is; then 17 tokens decoded one by
                  one through the cache against a K5 prefill over the same
                  17 tokens (padded to one chunk), within rtol = atol =
                  2e-2, at 15 layers (and reported at 81);
10. ssd times   — K5 at the main-path shape, one layer's whole scan (the
                  first Mamba2 layer of phase 8: B = 2, S = 4096 in 32
                  chunks of T = 128, H = 112, N = P = 64, from the zero
                  state), bf16 and f32: error against
                  ssd_scan(use_kernel="ref"), ms per call (time_ms), the
                  per-layer bound, plain ms; beside it one chunk alone
                  (the second, with the state the first left);
11. ssd controls — K5 given xw with its last time step zeroed, and K5's
                  chain with the carried state zeroed between chunks, must
                  each fail the check against the intact plain result.

Every kernel launch counter is set to 0 just before the first campaign of
phase 4, the campaign of phase 4c, each forced path of phase 5 (f32 and
bf16) and of phase 6b, each service and workload path of phases 7s and 7w
and the f32 prefill of phase 8, and read just after it; a forced path that
did not launch its kernel, a cell whose plan (or forced engine) is a
kernel engine that launched nothing in its own timed calls, a service or
workload path that did not launch its kernels, or a prefill whose K5
count is not its number of Mamba2 layers (81), fails the run. The kernels
line reports, for each kernel, the launches of the path that feeds its
row and, for K1-K3 in f32, those of the service and workload paths
(`launches_paths`).

Verification is against the numpy float64 oracle at rel err <= 1e-4 (the
error over the oracle's largest entry); a kernel against its plain version
at rel err <= 1e-5 in float32 (same terms, different summation order),
1e-12 in float64 and 1e-2 in bf16 (f32 sums in both, y rounded once). The generators give every row a diagonal
of m = 1,048,576 at this size, about 1e5 times the rest of the row, and an
error divided by that scale hides wrong off-diagonal terms; so every check
at the main-path shape also runs on the structure twin, where each term
counts (phase 7 shows that it catches what the original matrix hides). TF32
is off for every f32 product. The last lines are one JSON object with every
kernel's numbers, the nvidia-smi line, and the result line.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12, "bfloat16": 1e-2}
LM_TOL = 1e-3                    # prefill logits, K5 against the plain SSD
LAYER_TOL = 1e-5                 # one Mamba2 layer, K5 against the plain SSD
DECODE_TOL = 2e-2                # decode through the cache vs the prefill
VERIFY_TOL = 1e-4
ITERS = 20
BATCH = 20                       # kernel times: calls per CUDA event pair
BATCHES = 5                      # kernel times: event pairs, median taken
POWERLAW_BATCH = 5               # the power-law rows' calls take 9-40 ms each
K2_WIDTHS = (1, 3, 4, 8, 16, 32, 33, 36, 64)   # K2 at small shapes
K2_WIDE = 32                     # K2's second width at the main-path shape
PARALLEL_P = 8                   # modelled-parallel cores of the campaigns

KERNELS = {
    "sell_spmv": "src/repro/kernels/sell_spmv/kernel.py:50",
    "sell_spmm": "src/repro/kernels/sell_spmm/kernel.py:56",
    "bcsr_spmv": "src/repro/kernels/bcsr_spmv/kernel.py:42",
    "bell_spmv": "src/repro/kernels/bell_spmv/kernel.py:38",
    "ssd_chunk": "src/repro/kernels/ssd_chunk/kernel.py:54",
}
SOURCE = "src/repro_torch/csrc/spmv_kernels.cu"
SSD_SOURCE = "src/repro_torch/csrc/ssd_chunk.cu"
LM_ARCH = "zamba2-7b"
# The reference draws the embedding at std 0.02 and runs no residual around
# its Mamba2 blocks: at that scale each block's gated RMS norm sits under its
# eps, the activations shrink to 0 within a few layers at any width, and
# every logit of the 81-layer model is exactly 0, so no comparison could see
# a fault. The smoke run draws the reference's parameters and scales the
# embedding to std 0.2, past which every layer carries activations of RMS
# ~0.9. Those random layers, with no residual, amplify a difference in
# rounding by ~1.5x each (10x per group of 6), so two correct SSD paths
# decorrelate well before layer 81: the end-to-end comparisons run at a
# depth of 15 layers (2 groups and the tail), and the full-depth prefill
# holds K5 against the plain SSD layer by layer.
EMBED_SCALE = 10.0


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


def time_ms(fn, batch: int = BATCH, batches: int = BATCHES) -> float:
    """Device ms per call of fn(): one CUDA event pair around each batch of
    `batch` back-to-back calls, the median over `batches` batches divided by
    `batch`. A batch of warm-up calls is left in the queue when the first
    event is recorded, so the events time the card's work and not the
    host's enqueue of the first call."""
    import numpy as np
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(batch):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(batches)]
    for start, end in ev:
        start.record()
        for _ in range(batch):
            fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev])) / batch


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def operator_bytes(op) -> int:
    import torch

    return sum(tensor_bytes(v) for v in vars(op).values()
               if isinstance(v, torch.Tensor))


def bound_ms(nbytes: int, flops: int,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- the kernel calls, wrapper and plain version on the same inputs --------
def sell_calls(op, x, spmm: bool | None = None):
    """K1, or K2 when spmm is set (by default when x has more than one
    column)."""
    from repro_torch.kernels.sell_spmm.kernel import (pick_k_tile, sell_spmm,
                                                      sell_spmm_plain)
    from repro_torch.kernels.sell_spmv.kernel import (sell_spmv,
                                                      sell_spmv_plain)

    args = (op.chunk_vals, op.chunk_cols, op.chunk_slice)
    if not (x.shape[1] > 1 if spmm is None else spmm):
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


def misaligned(op, attr: str):
    """A shallow copy of `op` whose `attr` holds the same values one element
    past an aligned base (the allocator's blocks start on 512 bytes), which
    sends K1-K4 to their scalar bodies (and K5 in bf16 to its CUDA-core
    body)."""
    import copy

    out = copy.copy(op)
    setattr(out, attr, misaligned_tensor(getattr(op, attr)))
    return out


def misaligned_tensor(t):
    """The values of `t` in a buffer one element past an aligned base."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def kernels_small(dev) -> int:
    import torch

    from repro_torch.core.spmv.ops import make_engine

    gen = torch_generator(0)
    checked = 0

    def check(label, calls, op, x, **kw):
        nonlocal checked
        name, kern, plain = calls(op, x, **kw)
        check_close(f"{name} {label}", kern(), plain(), x.dtype)
        checked += 1

    for mname, mat in small_matrices().items():
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            # K1's bodies: 16-byte loads for W / kN a power of two <= 32
            # (f32 W = 8, 32, 128; f64 W = 8, 32), scalar loads otherwise.
            # K2's: the staged vector body for k a multiple of kN (k-tiles
            # of 8, 16 and 32 columns, 1 to 16 rows a lane; k = 4 and 36
            # leave a tile part empty, k = 64 takes two tiles; W = 128
            # takes 4 or 16 sub-chunks), the scalar body for k = 1, 3, 33
            # (f32) and a base off 16 bytes
            for i, shape in enumerate((c, w) for c in (8, 32)
                                      for w in (8, 32, 128)):
                op = make_engine(mat, "sell", dtype=dtype, block_shape=shape,
                                 sell_sigma=(64, mat.m)[i % 2], device=dev)
                for k, spmm in ((1, False), (3, False),
                                *((k, True) for k in K2_WIDTHS)):
                    x = torch_randn((mat.n, k), gen, dtype, dev)
                    check(f"{mname} {shape} k={k}", sell_calls, op, x,
                          spmm=spmm)
                bad_vals = misaligned(op, "chunk_vals")
                for k, spmm in ((1, False), (8, True)):
                    x = torch_randn((mat.n, k), gen, dtype, dev)
                    check(f"{mname} {shape} k={k} values misaligned",
                          sell_calls, bad_vals, x, spmm=spmm)
                x = misaligned_tensor(torch_randn((mat.n, 8), gen, dtype,
                                                  dev))
                check(f"{mname} {shape} k=8 x misaligned", sell_calls, op, x,
                      spmm=True)
            # K3's and K4's bodies: 16-byte loads at nv = 1 and bm <= 16
            # (R = 4, 8, 16), scalar loads for nv > 1, an odd bn or a
            # misaligned base
            for (eng, calls), shape in (
                    (ec, sh) for ec in (("bcsr", bcsr_calls),
                                        ("bell", bell_calls))
                    for sh in ((4, 4), *((bm, bn) for bm in (4, 8, 16)
                                         for bn in (16, 100, 128)))):
                op = make_engine(mat, eng, dtype=dtype, block_shape=shape,
                                 device=dev)
                for nv in (1, 3, 8):
                    check(f"{mname} {shape} nv={nv}", calls, op,
                          x2d_for(op, nv, gen, dtype, dev))
                check(f"{mname} {shape} misaligned", calls,
                      misaligned(op, "blocks"),
                      x2d_for(op, 1, gen, dtype, dev))
    return checked


# -- phases 4-5: the main path ---------------------------------------------
# the forced path that feeds each kernel's row of the kernels line
FEEDS = {"sell_spmv": "forced/sell/k1", "sell_spmm": "forced/sell/k8",
         "bcsr_spmv": "forced/bcsr/k1", "bell_spmv": "forced/bell/k1"}
KERNEL_OF = {"sell": ("sell_spmv", "sell_spmm"), "bcsr": ("bcsr_spmv",),
             "bell": ("bell_spmv",)}


def fig1_spec(shuffled: str, banded: str, iters: int, keep=None):
    """The paper's four Fig. 1 cells as one spmv ExperimentSpec: the
    product grid (both matrices x {baseline, rcm} x k in {1, 8}) cut to
    fig1_shuffled x {baseline, rcm}, fig1_banded x baseline (k = 1) and
    fig1_shuffled x rcm at k = 8 (or to `keep`, (matrix, scheme, k)
    triples); verified (matrix and structure twin), IOS, YAX, CG, the
    modelled-parallel time and the structural metrics at p = 8."""
    from repro_torch.experiments import ExperimentSpec, MeasurePolicy

    keep = keep or {(shuffled, "baseline", 1), (shuffled, "rcm", 1),
                    (banded, "baseline", 1), (shuffled, "rcm", 8)}

    class Fig1Spec(ExperimentSpec):
        def cells(self, matrices=None, device="cpu"):
            return [c for c in super().cells(matrices, device)
                    if (c.matrix, c.scheme, c.k) in keep]

    return Fig1Spec(
        name="fig1", matrices=(shuffled, banded), schemes=("baseline", "rcm"),
        ks=(1, 8), ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))


def cell_tag(rec) -> str:
    return f"{rec['matrix']}/{rec['scheme']}/k{rec['k']}"


def check_cell_launches(rec) -> None:
    """The engine a cell's plan picked launched its kernel in that cell's
    own timed calls (the record's `launches`, counted by the cell)."""
    kns = KERNEL_OF.get(rec["engine"], ())
    if kns and not any(rec["launches"][kn] > 0 for kn in kns):
        raise AssertionError(f"{cell_tag(rec)}: the plan picked "
                             f"{rec['engine']} but no kernel of it launched "
                             f"in the cell's timed calls: {rec['launches']}")


def campaign(dev, mats: dict, iters: int) -> tuple:
    """Phase 4: the Fig. 1 spec through the Runner on a fresh result store
    (every cell measured, plans from scratch), then twice more: on a fresh
    result store with the same plan store (every plan and operator from
    the plan store: plan_store_hit, tune_ms = 0), and on the first result
    store (every cell served from it). Launch counts are set to 0 before
    the first run and read after it; each record's own `launches` counts
    the launches of its timed IOS/YAX/CG calls alone, and the engine each
    plan picked must have launched its kernel there, in both measured
    runs. Returns the first report and the launches."""
    from repro_torch import kernels
    from repro_torch.experiments import ResultStore, Runner

    shuffled, banded = mats
    spec = fig1_spec(shuffled, banded, iters)
    ncells = len(spec.cells())
    results = os.environ["REPRO_TORCH_RESULT_STORE"]
    t0 = time.perf_counter()
    kernels.reset_launches()
    rep = Runner(spec, ResultStore(os.path.join(results, "first")),
                 get_matrix=mats.__getitem__, device=dev).run()
    launches = dict(kernels.LAUNCHES)
    first_s = time.perf_counter() - t0
    if rep.measured != ncells:
        raise AssertionError(f"fresh store: measured {rep.measured} of "
                             f"{ncells} cells")
    for rec in rep.records:
        tag = cell_tag(rec)
        check_cell_launches(rec)
        ios_ms = rec.get("seq_ios_ms", rec["spmm_ms"])
        phase(f"cell {tag}", time.perf_counter() - rec["runner_wall_s"],
              engine=rec["engine"], label=rec["plan_label"],
              plan_ms=f"{rec['plan_ms']:.1f}",
              reorder_ms=f"{rec['reorder_ms']:.1f}",
              tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=ios_ms,
              gflops=f"{rec.get('seq_ios_gflops', rec.get('spmm_gflops')):.2f}",
              yax_ms=rec.get("seq_yax_ms"), cg_ms=rec.get("cg_ms"),
              li_static=f"{rec['li_static']:.4f}",
              li_nnz_balanced=f"{rec['li_nnz_balanced']:.4f}",
              par_static_ms=rec["par_static_ms"],
              par_nnz_balanced_ms=rec["par_nnz_balanced_ms"],
              bandwidth=rec["bandwidth"], cut_volume=rec["cut_volume"],
              block_fill_8x128=f"{rec['block_fill_8x128']:.4f}",
              launches=json.dumps(rec["launches"]))
    phase("campaign fig1", t0, cells=ncells, measured=rep.measured,
          launches=json.dumps(launches))
    base = rep.value("seq_ios_ms", shuffled, "baseline", k=1)
    rcm = rep.value("seq_ios_ms", shuffled, "rcm", k=1)
    print(f"[result] rcm speedup over baseline on {shuffled} (IOS, auto "
          f"engine): {base / rcm:.3f}x", flush=True)

    # from the plan store: the reordered k = 1 cell, not all four, to keep
    # the run inside its time
    t1 = time.perf_counter()
    again_spec = fig1_spec(shuffled, banded, iters,
                           keep={(shuffled, "rcm", 1)})
    again = Runner(again_spec, ResultStore(os.path.join(results, "again")),
                   get_matrix=mats.__getitem__, device=dev).run()
    again_s = time.perf_counter() - t1
    for rec in again.records:
        if not (rec["plan_store_hit"] and rec["op_cache_hit"]
                and rec["tune_ms"] == 0.0 and rec["reorder_ms"] == 0.0):
            raise AssertionError(f"{cell_tag(rec)}: not served by the plan "
                                 f"store: plan_store_hit="
                                 f"{rec['plan_store_hit']} op_cache_hit="
                                 f"{rec['op_cache_hit']} tune_ms="
                                 f"{rec['tune_ms']}")
        check_cell_launches(rec)
        phase(f"cell {cell_tag(rec)} from the plan store",
              time.perf_counter() - rec["runner_wall_s"],
              plan_ms=f"{rec['plan_ms']:.1f}",
              load_ms=f"{rec['op_load_ms']:.1f}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec.get("seq_ios_ms", rec["spmm_ms"]),
              launches=json.dumps(rec["launches"]))
    phase("campaign fig1 from the plan store", t1,
          plan_store_hits=f"{sum(r['plan_store_hit'] for r in again.records)}"
                          f"/{len(again.records)}", seconds=f"{again_s:.2f}",
          first_run_seconds=f"{first_s:.2f}")

    t1 = time.perf_counter()
    resumed = Runner(spec, ResultStore(os.path.join(results, "first")),
                     get_matrix=mats.__getitem__, device=dev).run()
    if resumed.measured != 0 or resumed.reused != ncells:
        raise AssertionError(f"resume: measured {resumed.measured}, reused "
                             f"{resumed.reused} of {ncells}")
    phase("campaign fig1 resumed", t1,
          result_store_hits=f"{resumed.reused}/{ncells}",
          seconds=f"{time.perf_counter() - t1:.2f}",
          first_run_seconds=f"{first_s:.2f}")
    return rep, launches


def schedule_campaign(dev) -> None:
    """The Fig. 4 scheduling sweep on a bench-tier pair: banded_m65536_bw24
    and its shuffled twin x {static_default, static_c16, nnz_balanced,
    metis_cut} at p = 8, csr panels (the bench tier's size: 65,536 rows);
    metis_cut groups the rows by their METIS 8-way labels and splits the
    grouped matrix into nnz-balanced panels."""
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)

    t0 = time.perf_counter()
    spec = ExperimentSpec(
        name="fig4_schedule", kind="schedule",
        matrices=("banded_m65536_bw24", "banded_shuf_m65536_bw24"),
        engines=("csr",), ps=(PARALLEL_P,),
        variants=("static_default", "static_c16", "nnz_balanced",
                  "metis_cut"),
        policy=MeasurePolicy(iters=10, with_yax=False, with_parallel=False,
                             with_metrics=False))
    rep = Runner(spec, ResultStore(os.path.join(
        os.environ["REPRO_TORCH_RESULT_STORE"], "schedule")),
        device=dev).run()
    for rec in rep.records:
        print(f"[schedule] {rec['matrix']} {rec['variant']} p={rec['p']} "
              f"modelled_par_ms={rec['modelled_par_ms']:.4f} "
              f"gflops={rec['gflops']:.2f}", flush=True)
    if {r["variant"] for r in rep.records} != set(spec.variants):
        raise AssertionError(f"schedule spec: variants measured "
                             f"{sorted({r['variant'] for r in rep.records})}")
    phase("campaign fig4 schedule", t0, cells=len(rep.records))


# -- phase 4c: the paper's scheme axis -------------------------------------
SCHEME_MATRIX = "loc_stencil2d_shuf"   # a shuffled 724 x 724 5-point grid
SCHEME_ENGINES = ("auto", "sell", "bcsr")
DUEL_FIELDS = ("seq_ios_gflops", "seq_yax_gflops", "cg_gflops")
ONE_MATRIX = ("one matrix: a per-matrix answer, not the paper's counts "
              "over its corpus")


def scheme_campaign(dev, iters: int) -> None:
    """Phase 4c: one spmv ExperimentSpec through the Runner on
    loc_stencil2d_shuf: paper_schemes() and metis_nnzbal x {auto, sell (K1),
    bcsr (K3)}, verified on the matrix and its structure twin, IOS, YAX, CG,
    the modelled-parallel time and the metrics at p = 8. Each cell prints its
    reorder ms (host), IOS ms and speedup over baseline on the same engine;
    each sell and bcsr cell must have launched its kernel in its own timed
    calls. Then the paper's views over the schemes: the RCM-vs-METIS duel
    under IOS, YAX and CG (Table 1's question), pairwise win rates (Fig. 7)
    and speedup buckets (Fig. 6). The plan store is off for these cells:
    the bcsr operators of the shuffled orders hold 8.8 GB each (8 x 128
    blocks of 2.6 M scattered nonzeros), which it would write to disk; the
    reorder cache stays on, so each scheme reorders once."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.core.measure.profiles import BUCKET_LABELS
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner, paper_schemes)
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    mat = suite.get(SCHEME_MATRIX)
    phase(f"matrix {SCHEME_MATRIX}", t0, shape=f"{mat.m}x{mat.n}",
          nnz=mat.nnz)
    schemes = tuple(paper_schemes()) + ("metis_nnzbal",)
    spec = ExperimentSpec(
        name="schemes", matrices=(SCHEME_MATRIX,), schemes=schemes,
        engines=SCHEME_ENGINES, ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))
    ncells = len(spec.cells())
    t0 = time.perf_counter()
    plans = os.environ["REPRO_TORCH_PLAN_CACHE"]
    os.environ["REPRO_TORCH_PLAN_CACHE"] = "off"
    kernels.reset_launches()
    try:
        rep = Runner(spec, ResultStore(os.path.join(
            os.environ["REPRO_TORCH_RESULT_STORE"], "schemes")),
            get_matrix={SCHEME_MATRIX: mat}.__getitem__, device=dev).run()
    finally:
        os.environ["REPRO_TORCH_PLAN_CACHE"] = plans
    launches = dict(kernels.LAUNCHES)
    if rep.measured != ncells:
        raise AssertionError(f"scheme spec: measured {rep.measured} of "
                             f"{ncells} cells")
    reorder_ms = {}
    for rec in rep.records:
        check_cell_launches(rec)
        eng = rec["engine_request"]
        base = rep.value("seq_ios_ms", SCHEME_MATRIX, "baseline", engine=eng)
        # the first engine of a scheme reorders, the others hit the cache
        reorder_ms[rec["scheme"]] = max(reorder_ms.get(rec["scheme"], 0.0),
                                        rec["reorder_ms"])
        phase(f"cell {SCHEME_MATRIX}/{rec['scheme']}/{eng}",
              time.perf_counter() - rec["runner_wall_s"],
              engine=rec["engine"], label=rec["plan_label"],
              reorder_ms=f"{rec['reorder_ms']:.1f}",
              tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec["seq_ios_ms"],
              speedup=f"{base / rec['seq_ios_ms']:.3f}",
              yax_ms=rec["seq_yax_ms"], cg_ms=rec["cg_ms"],
              par_static_ms=rec["par_static_ms"],
              par_nnz_balanced_ms=rec["par_nnz_balanced_ms"],
              li_static=f"{rec['li_static']:.4f}",
              bandwidth=rec["bandwidth"], cut_volume=rec["cut_volume"],
              block_fill_8x128=f"{rec['block_fill_8x128']:.4f}",
              launches=json.dumps(rec["launches"]))
    phase("campaign schemes", t0, cells=ncells, measured=rep.measured,
          launches=json.dumps(launches))
    print(f"[reorder] host ms per scheme on {SCHEME_MATRIX} ({mat.m} rows, "
          f"{mat.nnz} nnz, numpy {np.__version__}, {os.cpu_count()} cores): "
          f"{json.dumps(reorder_ms)}", flush=True)
    for eng in SCHEME_ENGINES:
        duel = {}
        for field in DUEL_FIELDS:
            rcm, metis = (rep.value(field, SCHEME_MATRIX, s, engine=eng)
                          for s in ("rcm", "metis"))
            duel[field] = {"rcm": rcm, "metis": metis,
                           "winner": "rcm" if rcm > metis else "metis"}
        print(f"[view] table 1, rcm vs metis (GFLOP/s), engine={eng}, "
              f"{ONE_MATRIX}: {json.dumps(duel)}", flush=True)
        win = rep.pairwise_win_rates("seq_ios_gflops", [SCHEME_MATRIX],
                                     schemes, engine=eng)
        print(f"[view] fig. 7, pairwise win rates under IOS (row beats "
              f"column), engine={eng}, {ONE_MATRIX}: " + json.dumps(
                  {a: {b: float(win[i, j]) for j, b in enumerate(schemes)
                       if j != i} for i, a in enumerate(schemes)}),
              flush=True)
        buckets = rep.speedup_buckets("seq_ios_gflops", [SCHEME_MATRIX],
                                      schemes, engine=eng)
        print(f"[view] fig. 6, speedup buckets under IOS, engine={eng}, "
              f"{ONE_MATRIX}: " + json.dumps(
                  {s: dict(zip(BUCKET_LABELS, map(int, row)))
                   for s, row in zip(schemes, buckets)}), flush=True)


# -- phase 4e: the offline corpus and the learned probe ---------------------
CORPUS_CELLS = ("corpus://fix_banded_1k", "corpus://pwtk")
LEARNED_MATRIX = "corpus://cant"


def corpus_phase(dev, iters: int) -> None:
    """Phase 4e: `python -m repro_torch.corpus verify`'s check over every
    bundled fixture (its CSR held to the manifest's m, n, nnz); one spmv cell
    on fix_banded_1k and one on the stand-in of pwtk (217,918 rows, banded),
    engine auto, the full policy; then plan(probe="learned") on the stand-in
    of cant, after the advisor has mined every record phases 4-4e wrote,
    beside plan(probe=True) on the same matrix."""
    from repro_torch.core.spmv.plan import SpmvProblem, plan
    from repro_torch.corpus import advisor, manifest
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    entries = manifest.load_manifest()
    for name in sorted(n for n, e in entries.items() if e.fixture):
        rep = manifest.verify_entry(name)
        mat, e = manifest.resolve(name), entries[name]
        if not rep["ok"] or rep["standin"] or \
                (mat.m, mat.n, mat.nnz) != (e.m, e.n, e.nnz):
            raise AssertionError(f"corpus fixture {name}: {rep}, CSR "
                                 f"{(mat.m, mat.n, mat.nnz)} against the "
                                 f"manifest's {(e.m, e.n, e.nnz)}")
        print(f"[corpus] {e.qualified}: ok, m={mat.m} n={mat.n} "
              f"nnz={mat.nnz}", flush=True)
    phase("corpus fixtures verified", t0)

    results = os.environ["REPRO_TORCH_RESULT_STORE"]
    spec = ExperimentSpec(
        name="corpus", matrices=CORPUS_CELLS, schemes=("baseline",),
        ps=(PARALLEL_P,),
        policy=MeasurePolicy(iters=iters, warmup=3, cg_profiles=("*",),
                             verify=True, verify_tol=VERIFY_TOL))
    t0 = time.perf_counter()
    rep = Runner(spec, ResultStore(os.path.join(results, "corpus")),
                 device=dev).run()
    if rep.measured != len(CORPUS_CELLS):
        raise AssertionError(f"corpus spec: measured {rep.measured} of "
                             f"{len(CORPUS_CELLS)} cells")
    for rec in rep.records:
        check_cell_launches(rec)
        meta = manifest.ensure(rec["matrix"]).meta
        phase(f"cell {rec['matrix']}", time.perf_counter()
              - rec["runner_wall_s"], standin=bool(meta.get("standin")),
              m=rec["m"], nnz=rec["nnz"], engine=rec["engine"],
              label=rec["plan_label"], tune_ms=f"{rec['tune_ms']:.1f}",
              build_ms=f"{rec['format_build_ms']:.1f}",
              verify=f"{rec['verify_rel_err']:.2e}",
              verify_twin=f"{rec['verify_twin_rel_err']:.2e}",
              ios_ms=rec["seq_ios_ms"], yax_ms=rec["seq_yax_ms"],
              cg_ms=rec["cg_ms"], par_static_ms=rec["par_static_ms"],
              launches=json.dumps(rec["launches"]))
    phase("campaign corpus", t0, cells=rep.measured)

    # the advisor mines the default result store: gather every record the
    # campaigns of phases 4-4e wrote into it
    t0 = time.perf_counter()
    kb = ResultStore(results)
    for sub in sorted(os.listdir(results)):
        if os.path.isdir(os.path.join(results, sub)):
            for key, entry in ResultStore(os.path.join(results,
                                                       sub)).entries():
                kb.put(key, entry["cell"], entry["record"])
    advisor.advisor_reset()
    known = advisor.default_advisor().knowledge_size()
    mat = suite.get(LEARNED_MATRIX)
    learned = plan(SpmvProblem(mat), reorder="baseline", probe="learned",
                   cache=False, device=dev)
    probed = plan(SpmvProblem(mat), reorder="baseline", probe=True,
                  cache=False, device=dev)
    info = learned.tune.advisor or {}
    if learned.tune.source != "learned" or not known:
        raise AssertionError(f"plan(probe='learned') on {LEARNED_MATRIX}: "
                             f"source {learned.tune.source!r} with "
                             f"{known} mined records")
    phase(f"learned plan {LEARNED_MATRIX}", t0, standin=bool(
              manifest.ensure(LEARNED_MATRIX).meta.get("standin")),
          mined_records=known, source=learned.tune.source,
          confidence=f"{learned.advisor_confidence:.4f}",
          predicted=info.get("predicted"), hit=info.get("hit"),
          probed=json.dumps(learned.tune.probe_ms),
          learned_choice=learned.tune.label(),
          probe_choice=probed.tune.label(),
          probe_probed=json.dumps(probed.tune.probe_ms),
          agree=learned.tune.label() == probed.tune.label())


def forced_paths(dev, rmat, iters: int) -> tuple:
    """Phase 5: the kernel engines on the structure twin of the RCM-ordered
    fig1_shuffled, each path run with the launch counts set to 0 just
    before it and read just after. Returns the forced operators, the twin
    and the records."""
    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench

    forced, recs = {}, {}
    vmat = spmv_bench.structure_twin(rmat, seed=1)
    w_fit = pick_chunk_width(vmat)
    for eng, shape, sigma, ks in (("sell", (8, w_fit), 64, (1, 8, K2_WIDE)),
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
    return forced, vmat, recs


def rcm_order(dev, mat):
    """The RCM-reordered fig1_shuffled, from the plan store the campaign
    filled (a hit: no reordering, no tuning)."""
    from repro_torch.core.spmv.plan import SpmvProblem, plan

    pl = plan(SpmvProblem(mat, hints={"seed": 0}), reorder="rcm",
              device=dev)
    if not pl.cache_hit:
        raise AssertionError("the rcm plan of the campaign is not in the "
                             "plan store")
    return pl.reordered_matrix()


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


def library_csr(vmat, index_dtype, dev, dtype=None):
    """torch's CSR of `vmat` on the card, `dtype` values (float32 by
    default) and `index_dtype` row pointers and columns (the library
    yardstick; the port never calls it)."""
    import torch

    return torch.sparse_csr_tensor(
        torch.as_tensor(vmat.rowptr).to(index_dtype),
        torch.as_tensor(vmat.cols).to(index_dtype),
        torch.as_tensor(vmat.vals), size=vmat.shape,
        check_invariants=False).to(dev, dtype or torch.float32)


def kernel_work(op, calls, nv: int, xin) -> tuple[int, int]:
    """(bytes, flops) the kernel's function needs on these inputs: the
    stored matrix read once, x read once, y written once."""
    if calls is sell_calls:
        t, c, w = op.chunk_vals.shape
        mat_bytes = tensor_bytes(op.chunk_vals, op.chunk_cols, op.slice_ptr)
        flops = 2 * t * c * w * nv
        y_elems = op.num_slices * c * nv
    else:
        mat_bytes = tensor_bytes(op.blocks, op.block_cols)
        if calls is bcsr_calls:
            mat_bytes += tensor_bytes(op.block_rowptr)
        flops = 2 * op.blocks.numel() * nv
        nbr = op.nbr if calls is bcsr_calls else op.blocks.shape[0]
        y_elems = nbr * op.block_shape[0] * nv
    return mat_bytes + tensor_bytes(xin) + y_elems * xin.element_size(), flops


def kernel_time(op, calls, nv: int, x, xin, csrs,
                plain_batch: int = BATCH, batch: int = BATCH):
    """One kernel at one shape: its error against its plain version (which
    must be within the f32 tolerance), its ms (one event pair per `batch`
    calls), the plain version's ms (one per min(`plain_batch`, `batch`)
    calls), its bound and torch's CSR product on the same matrix with int32
    and int64 indices."""
    name, kern, plain = calls(op, xin)
    abs_err, rel = rel_err(kern(), plain())
    dname = str(xin.dtype).replace("torch.", "")
    if not rel <= KERNEL_TOL[dname]:
        raise AssertionError(f"{name} {dname} nv={nv}: kernel vs plain rel "
                             f"err {rel:.3e} at the main-path shape")
    nbytes, flops = kernel_work(op, calls, nv, xin)
    bms, by = bound_ms(nbytes, flops)
    xl = x.contiguous() if nv > 1 else x[:, 0].contiguous()
    lib = library_times(csrs, xl)
    lib_index = min(lib, key=lib.get) if lib else None
    out = {"name": name, "max_abs_err": abs_err, "rel_err": rel,
           "ms": time_ms(kern, batch),
           "plain_ms": time_ms(plain, min(plain_batch, batch)),
           "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops,
           "library_ms": lib[lib_index] if lib else None,
           "library_index": lib_index,
           "library_int32_ms": lib.get("int32"),
           "library_int64_ms": lib.get("int64")}
    if not lib:
        out["library_error"] = csrs["error"]
    lib_s = (f"{out['library_ms']:.4f} (CSR int32 {lib['int32']:.4f}, "
             f"int64 {lib['int64']:.4f})" if lib
             else f"none ({csrs['error']})")
    print(f"[kernel] {name} {dname} nv={nv} rel_err={rel:.2e} "
          f"ms={out['ms']:.4f} plain_ms={out['plain_ms']:.4f} "
          f"library_ms={lib_s} "
          f"bound_ms={bms:.4f} ({by}, {nbytes} B, {flops} flop)",
          flush=True)
    return out


def library_csrs(vmat, dev, dtype=None) -> dict:
    """torch's CSR of `vmat` with int32 and with int64 indices, or
    {"error": why} when torch cannot multiply it in `dtype` on the card."""
    import torch

    csrs = {str(d).replace("torch.", ""): library_csr(vmat, d, dev, dtype)
            for d in (torch.int32, torch.int64)}
    x = torch.ones(vmat.n, dtype=dtype or torch.float32, device=dev)
    try:
        for a in csrs.values():
            a @ x
        torch.cuda.synchronize()
    except RuntimeError as e:        # the yardstick only, never the port
        return {"error": str(e).splitlines()[0][:200]}
    return csrs


def library_times(csrs: dict, x) -> dict:
    if "error" in csrs:
        return {}
    return {ix: time_ms(lambda a=a: a @ x) for ix, a in csrs.items()}


def kernel_times(forced, vmat, dev, recs: dict, feeds: dict = FEEDS,
                 suffix: str = "") -> list:
    """Phase 6: each SpMV kernel at the shape phase 5 gave it, and in f32
    K2 once more at k = K2_WIDE (its numbers kept inside K2's row). A bf16
    row's name carries `suffix`."""
    import torch

    dtype = forced["sell"].chunk_vals.dtype
    csrs = library_csrs(vmat, dev, dtype)
    rows = []
    for nv, op, calls, x, xin in kernel_inputs(forced, vmat, dev):
        m = kernel_time(op, calls, nv, x, xin, csrs)
        name = m["name"]
        path = feeds[name]
        launches = recs[path]["launches"][name]
        row = {"name": name + suffix, "route": "cuda", "source": SOURCE,
               "replaces": KERNELS[name], "launches": launches,
               "launches_path": path, "max_abs_err": m["max_abs_err"],
               "ms": m["ms"], "plain_ms": m["plain_ms"],
               "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
               "library_ms": m["library_ms"],
               "library_index": m["library_index"],
               "dtype": str(dtype).replace("torch.", "")}
        if "library_error" in m:
            row["library_error"] = m["library_error"]
        print(f"[kernel] {name}{suffix} nv={nv} launches={launches} "
              f"({path})", flush=True)
        if name == "sell_spmm" and dtype == torch.float32:
            # the plain version at k = 32 gathers 4.3 GB and takes ~0.1 s a
            # call: one event pair per 2 calls
            xw = torch_randn((vmat.n, K2_WIDE), torch_generator(3),
                             op.chunk_vals.dtype, dev)
            wide = kernel_time(op, calls, K2_WIDE, xw, xw, csrs,
                               plain_batch=2)
            wide_path = f"forced/sell/k{K2_WIDE}"
            row[f"k{K2_WIDE}"] = dict({key: wide[key] for key in (
                "max_abs_err", "rel_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_int32_ms",
                "library_int64_ms")}, launches=recs[wide_path]["launches"][
                    name], launches_path=wide_path)
            del xw
        rows.append(row)
    return rows


# -- phase 6b: power-law rows, the paper's load-imbalance case -------------
POWERLAW = "corpus://webbase-1M"         # its stand-in: 1,000,005 rows
BCSR_CAP_BYTES = 8e9
BCSR_LADDER = ((8, 128), (8, 64), (8, 32), (8, 16), (4, 16), (2, 16),
               (1, 16))                  # block shapes, largest first
BELL_SHAPE = (8, 128)


def block_counts(mat, bm: int, bn: int) -> tuple[int, int]:
    """(nonempty blocks, blocks of the widest block row) of `mat` at bm x
    bn, counted from its CSR without building a block format."""
    import numpy as np

    from repro_torch.core.sparse.metrics import sorted_unique

    nbc = -(-mat.n // bn)
    rows = np.repeat(np.arange(mat.m, dtype=np.int64), mat.row_nnz())
    keys = sorted_unique(rows // bm * nbc + mat.cols.astype(np.int64) // bn)
    return int(keys.size), int(np.bincount(keys // nbc).max())


def powerlaw_phase(dev, iters: int) -> list:
    """Phase 6b: the kernels on power-law rows, the structure twin of the
    webbase-1M stand-in (median row 3 nonzeros, largest 115,668): K1 on
    SELL σ-sorted (C = 8, σ = m), K2 on it at k = 8, and K3 at the largest
    block shape of BCSR_LADDER whose BCSR bytes, counted before the build,
    stay under 8 GB. Each path is verified and IOS-timed with the launch
    counts set to 0 just before and read just after, then its kernel timed
    as in phase 6. K4's Block-ELL pads every block row to the widest: its
    bytes are counted, not built. Returns the kernels line's rows."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine
    from repro_torch.launch import spmv_bench
    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    vmat = spmv_bench.structure_twin(suite.get(POWERLAW), seed=1)
    rn = vmat.row_nnz()
    phase(f"matrix {POWERLAW} (stand-in, structure twin)", t0,
          shape=f"{vmat.m}x{vmat.n}", nnz=vmat.nnz,
          row_nnz_median=float(np.median(rn)),
          row_nnz_p99=float(np.percentile(rn, 99)), row_nnz_max=int(rn.max()))

    t0 = time.perf_counter()
    sized, widest = {}, {}
    for bm, bn in BCSR_LADDER:
        nb, widest[(bm, bn)] = block_counts(vmat, bm, bn)
        # values, a block-row and a block-column id per block, row pointer
        sized[(bm, bn)] = nb * (bm * bn * 4 + 8) + 4 * (-(-vmat.m // bm) + 1)
        if sized[(bm, bn)] < BCSR_CAP_BYTES:
            bcsr_shape = (bm, bn)
            break
    else:
        raise AssertionError(f"no BCSR shape of {BCSR_LADDER} under "
                             f"{BCSR_CAP_BYTES:.0e} B: {sized}")
    nbr = -(-vmat.m // BELL_SHAPE[0])
    bell = nbr * widest[BELL_SHAPE] * (BELL_SHAPE[0] * BELL_SHAPE[1] * 4 + 4)
    phase("powerlaw sizes", t0, bcsr_bytes=json.dumps(
              {f"{bm}x{bn}": b for (bm, bn), b in sized.items()}),
          bcsr_shape=f"{bcsr_shape[0]}x{bcsr_shape[1]}",
          bcsr_shape_bytes=sized[bcsr_shape])
    print(f"[powerlaw] bell_spmv (K4) is not built on these rows: Block-ELL "
          f"at {BELL_SHAPE[0]}x{BELL_SHAPE[1]} pads each of {nbr} block rows "
          f"to the widest ({widest[BELL_SHAPE]} blocks), {bell} B in f32, "
          f"{bell / 80e9:.0f}x the card's 80 GB", flush=True)

    csrs = library_csrs(vmat, dev)
    gen = torch_generator(7)
    rows = []
    for eng, shape, sigma, ks in (
            ("sell", (8, pick_chunk_width(vmat)), vmat.m, (1, 8)),
            ("bcsr", bcsr_shape, None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, block_shape=shape, sell_sigma=sigma,
                         device=dev)
        phase(f"powerlaw build {eng}", t0, block_shape=shape, sigma=sigma,
              device_bytes=operator_bytes(op))
        for k in ks:
            t0 = time.perf_counter()
            path = f"powerlaw/{eng}/k{k}"
            kernels.reset_launches()
            err = spmv_bench.verify(op, vmat, k, device=dev, tol=VERIFY_TOL)
            rec = spmv_bench.measure(op, vmat.nnz, vmat.n, k, device=dev,
                                     iters=iters)
            launches = dict(kernels.LAUNCHES)
            phase(path, t0, verify=f"{err:.2e}", ios_ms=rec["ios_ms"],
                  gflops=f"{rec['ios_gflops']:.2f}",
                  launches=json.dumps(launches))
            if eng == "sell":
                calls = sell_calls
                x = xin = torch_randn((vmat.n, k), gen, torch.float32, dev)
            else:
                calls = bcsr_calls
                xin = x2d_for(op, k, gen, torch.float32, dev)
                x = xin.reshape(-1, k)[: vmat.n]
            m = kernel_time(op, calls, k, x, xin, csrs, batch=POWERLAW_BATCH)
            name = m["name"]
            if launches[name] == 0:
                raise AssertionError(f"{path} never launched {name}")
            rows.append({
                "name": f"{name}_powerlaw", "route": "cuda",
                "source": SOURCE, "replaces": KERNELS[name],
                "launches": launches[name], "launches_path": path,
                "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": m["bound_by"], "library_ms": m["library_ms"],
                "library_index": m["library_index"], "dtype": "float32",
                "matrix": f"{POWERLAW} (stand-in, structure twin)",
                "block_shape": list(shape), "sigma": sigma,
                "bytes": m["bytes"]})
            del x, xin
        del op
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- phase 5b: the bf16 kernels on the main path ---------------------------
BF16_FEEDS = {name: path.replace("forced/", "forced_bf16/")
              for name, path in FEEDS.items()}
BF16_ORACLE_TOL = 1e-2           # bf16 kernel operators vs the f64 product
BF16_U = 2.0 ** -8               # bf16 unit roundoff (8 significand bits)
BF16_CSR_REPEATS = 8             # calls of the csr engine on one x
BF16_CSR_OTHER_XS = 8            # then one call on each of 8 other x
BF16_CSR_DROPPED_ROWS = 64       # the planted control's zeroed rows


def bf16_oracle(vmat, dev):
    """x -> A·x in float64, A's values rounded to bf16 first (the f64
    product of the bf16-rounded operands), on the card."""
    import numpy as np
    import torch

    from repro_torch.core.spmv import ref

    rows = torch.as_tensor(np.repeat(np.arange(vmat.m), vmat.row_nnz()),
                           device=dev)
    cols = torch.as_tensor(vmat.cols, device=dev)
    vals = torch.as_tensor(vmat.vals).to(torch.bfloat16).to(dev,
                                                            torch.float64)
    return lambda x: ref.spmv_csr(rows, cols, vals, x.double(), vmat.m)


def bf16_row_bound(vmat, dev):
    """x -> the rounding bound of each row of the bf16 csr engine, in
    float64: |y_i - ŷ_i| <= γ_{n_i} · Σ_j |a_ij x_j| with γ_n = n·u / (1 -
    n·u), u = 2^-8, for a and x rounded to bf16 and y_i their exact
    product. The engine rounds each of the n_i products of row i to bf16
    and adds them into y_i in bf16, atomically in any order: each term
    passes at most n_i roundings (its product and up to n_i - 1 adds)."""
    import numpy as np
    import torch

    from repro_torch.core.spmv import ref

    nnz = vmat.row_nnz().astype(np.float64)
    if not (nnz * BF16_U).max() < 1:
        raise ValueError("a row too long for the bf16 rounding bound")
    gamma = torch.as_tensor(nnz * BF16_U / (1 - nnz * BF16_U), device=dev)
    rows = torch.as_tensor(np.repeat(np.arange(vmat.m), vmat.row_nnz()),
                           device=dev)
    cols = torch.as_tensor(vmat.cols, device=dev)
    absvals = torch.as_tensor(vmat.vals).to(torch.bfloat16).to(
        dev, torch.float64).abs()
    return lambda x: gamma * ref.spmv_csr(rows, cols, absvals,
                                          x.double().abs(), vmat.m)


def bf16_csr_ratio(y, want, bound) -> float:
    """The largest err_i / bound_i over the rows (a row whose bound is 0
    must be exact); the engine passes where it is <= 1."""
    import torch

    err = (y.double() - want).abs()
    ratio = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max())


def bf16_paths(dev, vmat) -> tuple:
    """The forced kernel engines of phase 5 in bf16 (values and x bf16,
    f32 sums, y rounded once): each operator called once with the launch
    counts set to 0 just before and read just after, held against the f64
    product of the bf16-rounded operands; then the csr engine in bf16.
    Returns the bf16 operators and records."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.sparse.sell import pick_chunk_width
    from repro_torch.core.spmv.ops import make_engine

    bf16 = torch.bfloat16
    oracle = bf16_oracle(vmat, dev)
    gen = torch_generator(5)
    forced, recs = {}, {}
    w_fit = pick_chunk_width(vmat)
    for eng, shape, sigma, ks in (("sell", (8, w_fit), 64, (1, 8)),
                                  ("bcsr", (8, 128), None, (1,)),
                                  ("bell", (8, 128), None, (1,))):
        t0 = time.perf_counter()
        op = make_engine(vmat, eng, dtype=bf16, block_shape=shape,
                         sell_sigma=sigma, device=dev)
        forced[eng] = op
        for k in ks:
            tag = f"forced_bf16/{eng}/k{k}"
            x = torch_randn((vmat.n, k), gen, bf16, dev)
            kernels.reset_launches()
            y = op(x[:, 0]) if k == 1 else op.matmul(x)
            launches = dict(kernels.LAUNCHES)
            _, rel = rel_err(y, oracle(x[:, 0] if k == 1 else x))
            if not rel <= BF16_ORACLE_TOL:
                raise AssertionError(f"{tag}: rel err {rel:.3e} against the "
                                     f"f64 product > {BF16_ORACLE_TOL:.0e}")
            recs[tag] = {"launches": launches, "oracle_rel_err": rel}
            phase(tag, t0, block_shape=shape, oracle_rel_err=f"{rel:.3e}",
                  launches=json.dumps(launches))
            del y, x
    for name, tag in BF16_FEEDS.items():
        if recs[tag]["launches"][name] == 0:
            raise AssertionError(f"{tag} never launched {name}")
    t0 = time.perf_counter()
    op = make_engine(vmat, "csr", dtype=bf16, device=dev)
    bound = bf16_row_bound(vmat, dev)
    xs = [torch_randn((vmat.n,), gen, bf16, dev)
          for _ in range(1 + BF16_CSR_OTHER_XS)]
    # 16 readings: the atomic bf16 sums add in another order on every call
    # (the same x again) and round other values (other x); every row of
    # every reading is held to its rounding bound
    ratios, rels = [], []
    for i, x in enumerate([xs[0]] * BF16_CSR_REPEATS + xs[1:]):
        y, want = op(x), oracle(x)
        ratios.append(bf16_csr_ratio(y, want, bound(x)))
        rels.append(rel_err(y, want)[1])
        if not ratios[-1] <= 1.0:
            raise AssertionError(f"csr bf16 reading {i}: a row's error is "
                                 f"{ratios[-1]:.3f} times its rounding "
                                 f"bound γ_n·Σ|a·x|")
    same, other = slice(0, BF16_CSR_REPEATS), slice(BF16_CSR_REPEATS, None)
    phase("bf16 csr engine", t0, readings=len(ratios),
          max_err_over_bound=f"{max(ratios):.4f}",
          same_x_ratio=" ".join(f"{r:.4f}" for r in ratios[same]),
          other_x_ratio=" ".join(f"{r:.4f}" for r in ratios[other]),
          same_x_rel_err=" ".join(f"{r:.3e}" for r in rels[same]),
          other_x_rel_err=" ".join(f"{r:.3e}" for r in rels[other]),
          max_rel_err=f"{max(rels):.3e}")
    return forced, recs


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


def planted_faults(forced_sets, rmat, vmat, dev) -> None:
    from repro_torch.launch import spmv_bench

    for forced in forced_sets:
        for nv, op, calls, _, xin in kernel_inputs(forced, vmat, dev):
            dname = str(xin.dtype).replace("torch.", "")
            tol = KERNEL_TOL[dname]
            attr = "chunk_vals" if calls is sell_calls else "blocks"
            bad, g = dropped_block(op, attr)
            name, kern, plain = calls(bad, xin)
            _, rel = rel_err(kern(), calls(op, xin)[2]())
            if not rel > tol:
                raise AssertionError(f"{name} {dname}: dropping stored block "
                                     f"{g} gave rel err {rel:.3e}, which "
                                     f"passes {tol:.0e}")
            print(f"[control] {name} {dname} nv={nv} with block {g} "
                  f"dropped: rel err {rel:.3e} > {tol:.0e}, caught",
                  flush=True)
            del bad
    bf16_csr_control(vmat, dev)
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


def bf16_csr_control(vmat, dev) -> None:
    """The bf16 csr engine with the values of one block of rows zeroed must
    fail the per-row rounding gate against the intact product."""
    import dataclasses

    import torch

    from repro_torch.core.spmv.ops import make_engine

    r0 = vmat.m // 2
    r1 = r0 + BF16_CSR_DROPPED_ROWS
    vals = vmat.vals.copy()
    vals[vmat.rowptr[r0]:vmat.rowptr[r1]] = 0.0
    bad = make_engine(dataclasses.replace(vmat, vals=vals), "csr",
                      dtype=torch.bfloat16, device=dev)
    x = torch_randn((vmat.n,), torch_generator(6), torch.bfloat16, dev)
    ratio = bf16_csr_ratio(bad(x), bf16_oracle(vmat, dev)(x),
                           bf16_row_bound(vmat, dev)(x))
    if not ratio > 1.0:
        raise AssertionError(f"csr bf16 with rows {r0}..{r1 - 1} zeroed "
                             f"passes the rounding gate (largest err / "
                             f"bound {ratio:.3f})")
    print(f"[control] csr bf16 with the values of rows {r0}..{r1 - 1} "
          f"zeroed: largest err / rounding bound {ratio:.3f} > 1, caught",
          flush=True)


# -- phase 7s: the SpMV service --------------------------------------------
SERVE_REQUESTS = 48
SERVE_KW = {"reorder": "rcm", "max_batch": 8, "window_ms": 20.0}
SERVE_TOL = 1e-5                 # a response against the unbatched op(x)
# The rate ramp runs on the Fig. 1 generator cut to TRAFFIC_ROWS rows (the
# same band, seeds and shuffle; PERF.md lists the cut): at 1,048,576 rows a
# value swap rebuilds the operator in the submitting thread for ~6 s and an
# evicted key reloads its 1.1 GB operator, so the service answers about one
# request a second under this mix (the serve cell) and each ramp step there
# would take minutes. The serve cell (SERVE_CELL) runs at the full size.
TRAFFIC_ROWS = 65536
TRAFFIC_MATRIX = f"fig1_shuffled_m{TRAFFIC_ROWS}"
# max_queue: two batches a key, one dispatching and one filling; a request
# past that would wait out two more dispatches and is refused with a
# retry-after instead
TRAFFIC = {"arrival": "poisson", "requests": 200, "n_keys": 4,
           "zipf_s": 1.1, "update_frac": 0.1, "structure_frac": 0.02,
           "max_batch": 8, "window_ms": 2.0, "max_queue": 16,
           "overload": "reject", "engine": "sell", "reorder": "rcm"}
TRAFFIC_BUDGET_OPS = 2.5         # the memory budget, in operators
# the ramp's rates are RAMP_BASE * sqrt(2)**i: the runs at 0.5x and 2x a
# step are the steps two below and two above it. It starts at step
# RAMP_START and walks up while runs are sustained, or down until one is.
RAMP_BASE, RAMP_START, RAMP_STEPS = 10.0, 2, range(-4, 11)
# the serve cell at the full size: the first 16 arrivals of the schedule
# with the value updates of the mix (the cell kind has no structure deltas)
SERVE_CELL = {"requests": 16, "update_frac": 0.1}
OVER_CHURN = 0.16                # deletion fraction past delta.MAX_CHURN


def device_product(mat, x, dev):
    """float64 A @ x on the card (x [n] or [n, b]): the workloads' plain
    product (gather, scale, index_add_) over the port's host CSR arrays.
    The checker, no kernel under test."""
    import numpy as np
    import torch

    from repro_torch.workloads.adapters import _plain_product

    x2 = torch.as_tensor(np.asarray(x, np.float64).reshape(mat.n, -1),
                         device=dev)
    fn, args = _plain_product(mat, x2, dev)
    return fn(*args).cpu().numpy().reshape((mat.m,) + np.shape(x)[1:])


def scaled_err(got, want) -> float:
    """max |got - want| over the largest |want| (float64)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


def check_product(name: str, got, want, tol: float = VERIFY_TOL) -> float:
    err = scaled_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:.0e}")
    return err


def serve_requests(dev, mats: dict) -> tuple:
    """SERVE_REQUESTS (matrix, x) requests from a seeded generator over
    the matrices, and each response's float64 product (device_product)."""
    import numpy as np

    names = list(mats)
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(SERVE_REQUESTS):
        name = names[rng.integers(len(names))]
        reqs.append((name, rng.standard_normal(mats[name].n)))
    want = [None] * len(reqs)
    for name in names:
        idx = [i for i, (n, _) in enumerate(reqs) if n == name]
        y = device_product(mats[name],
                           np.stack([reqs[i][1] for i in idx], axis=1), dev)
        for j, i in enumerate(idx):
            want[i] = y[:, j]
    return reqs, want


def serve_sim(dev, mats: dict, engine: str, reqs: list, want: list) -> dict:
    """7s.1: the requests of serve_requests through one SpmvService over
    both Fig. 1 matrices; the last one is sent after the burst has
    drained, so a lone request takes op(x). Every response is held
    against its float64 product (VERIFY_TOL of its largest entry) and
    against the unbatched op(x) (SERVE_TOL). Launch counts are set to 0
    just before the requests and read just after the last response; the
    op(x) comparisons come after. Returns the launches and the service
    (open: the dynamic checks of a sell run continue on it)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.spmv.opcache import operator_nbytes
    from repro_torch.serving.spmv_service import SpmvService

    t0 = time.perf_counter()
    names = list(mats)
    svc = SpmvService(engine=engine, device=dev, **SERVE_KW)
    for name, mat in mats.items():
        svc.register(name, mat)
    for name in names:            # plan + build before the clock starts
        svc.operator(name)
    build_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    kernels.reset_launches()
    futs = [svc.submit(name, x) for name, x in reqs[:-1]]
    svc.flush(timeout=600)
    futs.append(svc.submit(*reqs[-1]))
    ys = [f.result(timeout=600) for f in futs]
    launches = dict(kernels.LAUNCHES)
    serve_s = time.perf_counter() - t1
    stats = svc.stats()
    errs, alone_errs = [], []
    for i, (name, x) in enumerate(reqs):
        errs.append(check_product(f"serve-sim {engine} {name} request {i}",
                                  ys[i], want[i]))
        alone = svc.operator(name)(torch.as_tensor(
            x, dtype=torch.float32, device=dev)).cpu().numpy()
        alone_errs.append(check_product(
            f"serve-sim {engine} {name} request {i} against op(x)", ys[i],
            alone, SERVE_TOL))
    if not stats["batches"] < SERVE_REQUESTS:
        raise AssertionError(f"serve-sim {engine}: {stats['batches']} "
                             f"batches for {SERVE_REQUESTS} requests")
    need = KERNEL_OF[engine]
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"serve-sim {engine}: the dispatches did not "
                             f"launch {need}: {launches}")
    phase(f"serve-sim {engine}", t0, requests=SERVE_REQUESTS,
          batches=stats["batches"], avg_batch=f"{stats['avg_batch']:.2f}",
          build_s=f"{build_s:.2f}", serve_s=f"{serve_s:.3f}",
          p50_ms=stats["slo"]["p50_ms"], p99_ms=stats["slo"]["p99_ms"],
          max_rel_err=f"{max(errs):.2e}",
          max_rel_err_vs_op=f"{max(alone_errs):.2e}",
          op_bytes=json.dumps({n: operator_nbytes(svc.operator(n))
                               for n in names}),
          launches=json.dumps(launches))
    return {"launches": launches, "service": svc}


def serve_dynamic(dev, svc, mat, key: str) -> None:
    """7s.2 on one sell key of the serve-sim service: a value swap (values
    x 1.01), a 0.5% deletion delta (applied under the frozen plan) and an
    over-churn delta (a full replan), each followed by a request held
    against the new product; then the planted control: a response after
    the swap, held against the product before it, must fail."""
    import dataclasses

    import numpy as np

    from repro_torch import obs
    from repro_torch.serving import traffic

    rng = np.random.default_rng(5)
    x = rng.standard_normal(mat.n)
    old_want = device_product(mat, x, dev)

    t0 = time.perf_counter()
    s0 = svc.stats()
    cur = dataclasses.replace(mat, vals=mat.vals * 1.01)
    svc.update_values(key, cur.vals)
    y = svc.submit(key, x).result(timeout=600)
    err = check_product("value swap", y, device_product(cur, x, dev))
    s1 = svc.stats()
    swaps = s1["value_swaps"] - s0["value_swaps"]
    replans = s1["replans"] - s0["replans"]
    if (swaps, replans) != (1, 0):
        raise AssertionError(f"value swap: value_swaps +{swaps}, replans "
                             f"+{replans} (want +1, +0)")
    phase("serve value swap", t0, rel_err=f"{err:.2e}", value_swaps=swaps,
          replans=replans,
          build_ms=f"{svc._build_info[key]['build_ms']:.1f}")
    stale = scaled_err(y, old_want)
    if stale <= VERIFY_TOL:
        raise AssertionError(f"control: the response after the 1.01 swap "
                             f"passes against the old product ({stale:.3e})")
    print(f"[control] response after the value swap held against the "
          f"product before it: rel err {stale:.3e} > {VERIFY_TOL:.0e}, "
          f"caught", flush=True)

    for label, frac, counter in (("delta", 0.005, "delta.applies"),
                                 ("over-churn delta", OVER_CHURN,
                                  "delta.fallbacks")):
        t0 = time.perf_counter()
        c0 = obs.counter(counter).value
        r0 = svc.stats()["replans"]
        d = traffic._deletion_delta(cur, rng, frac)
        churn = d.churn(cur)
        fut = svc.update_structure(key, delta=d)
        submit_s = time.perf_counter() - t0
        fut.result(timeout=900)
        landed_s = time.perf_counter() - t0
        cur = d.apply_to(cur)
        y = svc.submit(key, x).result(timeout=600)
        err = check_product(label, y, device_product(cur, x, dev))
        moved = obs.counter(counter).value - c0
        info = svc._build_info[key]
        pl = svc._plans[key][2]
        if moved != 1 or svc.stats()["replans"] - r0 != 1:
            raise AssertionError(f"{label}: {counter} +{moved}, replans "
                                 f"+{svc.stats()['replans'] - r0}")
        if counter == "delta.applies" and not (
                info["tune_ms"] == 0.0 and pl.tune_ms == 0.0
                and pl.reorder_ms == 0.0):
            raise AssertionError(f"delta: the new operator was tuned or "
                                 f"reordered: build tune_ms="
                                 f"{info['tune_ms']} plan tune_ms="
                                 f"{pl.tune_ms} reorder_ms={pl.reorder_ms}")
        phase(f"serve {label}", t0, deleted=d.churn_nnz,
              churn=f"{churn:.4f}", **{counter: moved},
              submit_s=f"{submit_s:.2f}", landed_s=f"{landed_s:.2f}",
              tune_ms=info["tune_ms"], reorder_ms=pl.reorder_ms,
              plan_ms=f"{pl.plan_ms:.1f}", rel_err=f"{err:.2e}")


def ramp_rate(step: int) -> float:
    return RAMP_BASE * 2.0 ** (step / 2)


def sustained_at(rec) -> bool:
    """A traffic run kept pace: every request offered over the submit
    window was answered (none rejected, shed or failed), and the last
    answer came within the run's p95 latency of the last arrival. A
    backlog that grows through the run leaves its last request the
    longest wait, past the p95; a service that keeps up answers it as it
    answers the others."""
    return (not (rec["rejected"] or rec["shed"] or rec["errors"])
            and rec["drain_s"] - rec["submit_s"] <= rec["p95_ms"] / 1e3)


def traffic_matrix():
    """The Fig. 1 matrix's generator at TRAFFIC_ROWS rows, registered in
    the suite under TRAFFIC_MATRIX."""
    from repro_torch.matrices import generators as G
    from repro_torch.matrices import suite

    if TRAFFIC_MATRIX not in suite.names("large"):
        suite.register_matrix(
            TRAFFIC_MATRIX, "large",
            lambda: G.shuffle(G.banded(TRAFFIC_ROWS, 15, seed=7), seed=8))
    return suite.get(TRAFFIC_MATRIX)


def traffic_run(dev, matrix: str, rate: float, budget_mb: float,
                label: str) -> dict:
    """One run_serve_traffic run; fails on any failed, unanswered or
    unaccounted request, update or replan."""
    from repro_torch.launch import spmv_bench

    t0 = time.perf_counter()
    rec = spmv_bench.run_serve_traffic(
        matrix=matrix, rate_rps=rate, budget_mb=budget_mb, device=dev,
        **TRAFFIC)
    if not rec["ok"]:
        raise AssertionError(
            f"traffic {label}: unresolved={rec['unresolved']} "
            f"replan_unresolved={rec['replan_unresolved']} "
            f"errors={rec['errors']} replan_errors={rec['replan_errors']} "
            f"update_errors={rec['update_errors']} "
            f"structure_errors={rec['structure_errors']} "
            f"budget_ok={rec['budget_ok']} "
            f"counters_balanced={rec['counters_balanced']}")
    if rec["op_reloads"] < 1 or rec["launches"]["sell_spmm"] == 0:
        raise AssertionError(f"traffic {label}: op_reloads="
                             f"{rec['op_reloads']} launches="
                             f"{rec['launches']}")
    phase(f"traffic {label}", t0, rate_rps=rate, ok=rec["ok_count"],
          shed=rec["shed"], rejected=rec["rejected"], errors=rec["errors"],
          unresolved=rec["unresolved"],
          p50_ms=rec["p50_ms"], p95_ms=rec["p95_ms"], p99_ms=rec["p99_ms"],
          offered_rps=(rec["ok_count"] + rec["shed"] + rec["errors"]
                       + rec["unresolved"] + rec["rejected"])
          / rec["submit_s"],
          achieved_rps=rec["ok_count"] / rec["drain_s"],
          schedule_s=rec["schedule_s"], submit_s=rec["submit_s"],
          drain_s=rec["drain_s"], wall_s=rec["wall_s"],
          drain_after_last_s=rec["drain_s"] - rec["submit_s"],
          sustained=sustained_at(rec),
          coalesce=f"{rec['coalesce_ratio']:.3f}",
          evictions=rec["evictions"], reloads=rec["op_reloads"],
          builds=rec["op_builds"], swaps=rec["value_swaps"],
          replans_landed=rec["replans_landed"],
          structure_updates=rec["structure_updates"],
          resident_bytes_max=rec["resident_bytes_max"],
          budget_bytes=rec["memory_budget_bytes"],
          retry_after_positive=rec["retry_after_positive"],
          launches=json.dumps(rec["launches"]))
    return rec


def dispatch_stretch(svc, key: str) -> None:
    """One profiled stretch of dispatches: 64 requests on one resident
    key of the serve-sim service, under torch.profiler (device busy
    share)."""
    import numpy as np

    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(svc.operator(key).shape[1])
          for _ in range(64)]

    def stretch():
        futs = [svc.submit(key, x) for x in xs]
        for f in futs:
            f.result(timeout=600)

    profile_call(f"serve dispatches {key} x{len(xs)}", stretch)


def serve_traffic(dev) -> dict:
    """7s.3 on TRAFFIC_MATRIX: the ramp (RAMP_*) finds the sustained rate,
    the highest step whose run is sustained (sustained_at) below one that
    is not; the runs at 0.5x and 2x it are the steps two below and two
    above, run if the ramp did not reach them. The 2x run must reject with
    a positive retry_after. The memory budget holds TRAFFIC_BUDGET_OPS
    operators, read from one built operator. Returns the launches of the
    0.5x and 2x runs and the 0.5x rate."""
    from repro_torch.core.spmv.opcache import operator_nbytes
    from repro_torch.core.spmv.plan import SpmvProblem, plan

    mat = traffic_matrix()
    t0 = time.perf_counter()
    op = plan(SpmvProblem(mat, k=TRAFFIC["max_batch"]),
              reorder=TRAFFIC["reorder"], engine=TRAFFIC["engine"],
              device=dev).build(device=dev)
    nbytes = operator_nbytes(op)
    del op
    budget_mb = TRAFFIC_BUDGET_OPS * nbytes / (1 << 20)
    phase("traffic matrix", t0, matrix=TRAFFIC_MATRIX,
          shape=f"{mat.m}x{mat.n}", nnz=mat.nnz, operator_bytes=nbytes,
          budget_mb=f"{budget_mb:.3f}")
    runs = {}

    def held(step: int, label: str = "") -> bool:
        if step not in runs:
            rate = ramp_rate(step)
            runs[step] = traffic_run(dev, TRAFFIC_MATRIX, rate, budget_mb,
                                     label or f"ramp {rate:.4g} rps")
        return sustained_at(runs[step])

    step = RAMP_START
    up = held(step)
    while True:
        nxt = step + (1 if up else -1)
        if nxt not in RAMP_STEPS:
            raise AssertionError(f"traffic: the ramp left its steps at "
                                 f"{ramp_rate(step):.4g} rps")
        if held(nxt) != up:
            sustained = step if up else nxt
            break
        step = nxt
    launches = {}
    for mult, k in ((0.5, sustained - 2), (2.0, sustained + 2)):
        held(k, f"{mult:g}x sustained")
        for name, n in runs[k]["launches"].items():
            launches[name] = launches.get(name, 0) + n
    over, half = runs[sustained + 2], runs[sustained - 2]
    if not (over["rejected"] and over["retry_after_positive"]):
        raise AssertionError(f"traffic 2x sustained "
                             f"({ramp_rate(sustained + 2):.4g} rps): "
                             f"rejected={over['rejected']} "
                             f"retry_after_positive="
                             f"{over['retry_after_positive']}")
    print(f"[result] traffic on {TRAFFIC_MATRIX}: sustained "
          f"{ramp_rate(sustained):.4g} rps; 0.5x "
          f"({ramp_rate(sustained - 2):.4g} rps) p50/p99 "
          f"{half['p50_ms']:.1f}/{half['p99_ms']:.1f} ms; 2x "
          f"({ramp_rate(sustained + 2):.4g} rps) rejected "
          f"{over['rejected']} of {over['ok_count'] + over['rejected']}, "
          f"p50/p99 "
          f"{over['p50_ms']:.1f}/{over['p99_ms']:.1f} ms", flush=True)
    return {"launches": launches, "rate": ramp_rate(sustained - 2)}


def serve_cell(dev, name: str, mat, rate: float, op_bytes: int) -> None:
    """7s.4: one serve cell on the Fig. 1 matrix at its full size (sell,
    k = 8, K = 4 keys, SERVE_CELL's arrivals at the traffic's 0.5x rate, a
    budget of TRAFFIC_BUDGET_OPS of its operators) through the Runner on a
    fresh result store, under torch.profiler (the device's idle share
    under the value-update mix), then resumed from the store."""
    from repro_torch.experiments import (ExperimentSpec, MeasurePolicy,
                                         ResultStore, Runner)
    from repro_torch.experiments.cells import serve_variant

    t0 = time.perf_counter()
    budget_mb = TRAFFIC_BUDGET_OPS * op_bytes / (1 << 20)
    spec = ExperimentSpec(
        name="serve", kind="serve", matrices=(name,),
        schemes=(TRAFFIC["reorder"],), engines=(TRAFFIC["engine"],),
        ks=(TRAFFIC["max_batch"],),
        variants=(serve_variant(rate_rps=rate, n_keys=TRAFFIC["n_keys"],
                                budget_mb=budget_mb,
                                max_queue=TRAFFIC["max_queue"],
                                **SERVE_CELL),),
        policy=MeasurePolicy(iters=1, warmup=0, with_yax=False,
                             with_parallel=False, with_metrics=False))
    store = ResultStore(os.path.join(
        os.environ["REPRO_TORCH_RESULT_STORE"], "serve"))
    get = {name: mat}.__getitem__
    out = {}
    profile_call(f"serve cell {name}", lambda: out.update(
        rep=Runner(spec, store, get_matrix=get, device=dev).run()))
    (rec,) = out["rep"].records
    check_cell_launches(dict(rec, engine=rec["engine_request"]))
    if not (rec["budget_ok"] and rec["counters_balanced"]
            and rec["unresolved"] == 0 and rec["errors"] == 0
            and rec["update_errors"] == 0):
        raise AssertionError(f"serve cell: {rec}")
    again = Runner(spec, store, get_matrix=get, device=dev).run()
    if again.measured != 0 or again.reused != 1:
        raise AssertionError(f"serve cell resume: measured "
                             f"{again.measured}, reused {again.reused}")
    phase("serve cell", t0, variant=spec.variants[0], ok=rec["ok"],
          rejected=rec["rejected"], updates=rec["updates"],
          p50_ms=rec["p50_ms"], p95_ms=rec["p95_ms"], p99_ms=rec["p99_ms"],
          offered_rps=(rec["submitted"] + rec["rejected"]) / rec["submit_s"],
          achieved_rps=rec["ok"] / rec["drain_s"],
          submit_s=rec["submit_s"], drain_s=rec["drain_s"],
          coalesce=f"{rec['coalesce_ratio']:.3f}",
          reloads=rec["op_reloads"], builds=rec["op_builds"],
          evictions=rec["evictions"], swaps=rec["value_swaps"],
          resident_bytes_max=rec["resident_bytes_max"],
          budget_bytes=rec["memory_budget_bytes"],
          resumed=f"{again.reused}/1", launches=json.dumps(rec["launches"]))


def dispatch_breakdown(dev, svc, key: str) -> None:
    """Where one dispatch of a batch of max_batch float64 requests goes at
    the Fig. 1 size, step by step as the service runs it (host clock
    around each step with the card synchronized, median of 10): host
    stack, host-to-device copy and cast, the perm gather, the kernel
    (inner.matmul), the iperm gather, device-to-host copy."""
    import numpy as np
    import torch

    op = svc.operator(key)
    n = op.shape[1]
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(n) for _ in range(SERVE_KW["max_batch"])]
    steps = {k: [] for k in ("stack", "h2d_cast", "perm_gather", "kernel",
                             "iperm_gather", "d2h", "whole")}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name].append((time.perf_counter() - t) * 1e3)
        return out

    for _ in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        xb = timed("stack", lambda: np.stack(xs, axis=1))
        xd = timed("h2d_cast", lambda: torch.as_tensor(
            xb, dtype=torch.float32, device=dev))
        xp = timed("perm_gather", lambda: xd.index_select(0, op._perm))
        yp = timed("kernel", lambda: op.inner.matmul(xp))
        yd = timed("iperm_gather", lambda: yp.index_select(0, op._iperm))
        timed("d2h", lambda: yd.cpu().numpy())
        steps["whole"].append((time.perf_counter() - t) * 1e3)
    med = {k: float(np.median(v[2:])) for k, v in steps.items()}
    print(f"[serve] dispatch breakdown {key} batch="
          f"{SERVE_KW['max_batch']} float64 ms: {json.dumps(med)}",
          flush=True)


def serve_phase(dev, mats: dict) -> dict:
    """Phase 7s; returns the launches of its service paths by kernel."""
    from repro_torch import kernels
    from repro_torch.core.spmv.opcache import operator_nbytes

    paths = {}
    shuffled = next(iter(mats))
    reqs, want = serve_requests(dev, mats)
    for engine in ("sell", "bcsr"):
        out = serve_sim(dev, mats, engine, reqs, want)
        paths[f"serve-sim/{engine}"] = out["launches"]
        svc = out["service"]
        if engine == "sell":
            op_bytes = operator_nbytes(svc.operator(shuffled))
            dispatch_breakdown(dev, svc, shuffled)
            dispatch_stretch(svc, shuffled)
            serve_dynamic(dev, svc, mats[shuffled], shuffled)
        svc.close()
    del svc, out
    traffic = serve_traffic(dev)
    paths["serve-traffic"] = traffic["launches"]
    kernels.reset_launches()
    serve_cell(dev, shuffled, mats[shuffled], traffic["rate"], op_bytes)
    paths["serve-cell"] = dict(kernels.LAUNCHES)
    return paths


# -- phase 7w: the workload streams ----------------------------------------
WORKLOAD_CELLS = (
    # name, engine, use_deltas, the kernel its products run
    ("workload://moe-e128-k8-t4096-d2048-n4", "sell", False, "sell_spmm"),
    ("workload://gnn-m1048576-deg16-f64-n4-rw0.01", "sell", True,
     "sell_spmm"),
    ("workload://attn-s8192-b64-w2-g1-d128-n4", "bcsr", False, "bcsr_spmv"),
)


def workload_phase(dev) -> dict:
    """Phase 7w: each cell's drift stream through run_stream(verify=True);
    returns the launches of each cell's stream."""
    from repro_torch import kernels
    from repro_torch.workloads import (DynamicSparseProblem, WorkloadSession,
                                       run_stream)

    paths = {}
    for name, engine, deltas, kernel in WORKLOAD_CELLS:
        t0 = time.perf_counter()
        problem = DynamicSparseProblem(name, scenario="drift", seed=0)
        session = WorkloadSession(problem, engine=engine, use_deltas=deltas,
                                  device=dev)
        kernels.reset_launches()
        rec = run_stream(problem, session, iters=3, verify=True)
        launches = dict(kernels.LAUNCHES)
        paths[f"workload/{problem.wdef.kind}"] = launches
        fails = []
        if not rec["verify_ok"]:
            fails.append(f"max_rel_err {rec['max_rel_err']:.3e}")
        if problem.wdef.kind == "moe" and not rec["dispatch_bitwise_equal"]:
            fails.append("dispatch buffer differs from the one-hot one")
        if deltas and not (rec["replans"] == 0
                           and rec["deltas"] == rec["steps"] - 1):
            fails.append(f"replans {rec['replans']}, deltas "
                         f"{rec['deltas']} of {rec['steps']} steps")
        if launches[kernel] == 0:
            fails.append(f"{kernel} never launched: {launches}")
        if fails:
            raise AssertionError(f"{name}: " + "; ".join(fails))
        phase(f"workload {name}", t0, engine=engine,
              steps=rec["steps"], m=rec["m"], n=rec["n"], nnz=rec["nnz"],
              plans=rec["plans"], replans=rec["replans"],
              reuses=rec["reuses"], rebuilds=rec["rebuilds"],
              deltas=rec["deltas"], reuse_rate=rec["reuse_rate"],
              plan_cost_share=rec["plan_cost_share"],
              plan_ms_total=rec["plan_ms_total"],
              sparse_ms=rec["sparse_ms"], ref_ms=rec["ref_ms"],
              max_rel_err=f"{rec['max_rel_err']:.2e}",
              dispatch_bitwise_equal=rec.get("dispatch_bitwise_equal"),
              launches=json.dumps(launches))
        del session
    return paths


def add_path_launches(rows: list, paths: dict) -> None:
    """Fold the launches of the service and workload paths into the
    kernels line: each row's `launches` becomes the sum over its forced
    path and these, `launches_paths` lists each."""
    for row in rows:
        name = row["name"]
        if name not in FEEDS:           # the f32 rows of K1-K4
            continue
        by = {row["launches_path"]: row["launches"]}
        by.update({p: n[name] for p, n in paths.items() if n.get(name)})
        row["launches_paths"] = by
        row["launches"] = sum(by.values())


# -- K5 ssd_chunk: small shapes, the Zamba2 path, times, control -----------
def ssd_inputs(b, t, h, n, p, gen, dtype, dev):
    """la, xw, B, C and a nonzero incoming state, drawn as
    tests/test_ssd_kernel.py draws them (la in [-0.2, -0.001])."""
    import torch

    la = -(torch.rand((b, t, h), generator=gen, dtype=torch.float64)
           * 0.199 + 0.001)
    rest = [torch_randn(shape, gen, dtype, dev)
            for shape in ((b, t, h, p), (b, t, n), (b, t, n), (b, h, n, p))]
    return (la.to(dev, torch.float32), *rest)


def ssd_errors(got, want) -> tuple[float, float]:
    """(max abs error, max rel error) over both outputs, y and the state."""
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def ssd_small(dev) -> int:
    """K5 at small shapes through both bodies, against its plain version:
    single chunks (the S = T case), scans of 3 and 4 chunks from a nonzero
    state (one launch each, against ssd_scan(use_kernel="ref")), a scan over
    batch-strided views, and operands off a 16-byte boundary."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    gen = torch_generator(2)
    checked = 0

    def check(label, got, want, dtype):
        nonlocal checked
        for part, g, w in zip(("y", "state"), got, want):
            check_close(f"{label} {part} {dtype}", g, w, dtype)
        checked += 1

    def scan(args, t):
        return (ssd_scan(*args, chunk=t),
                ssd_scan(*args, chunk=t, use_kernel="ref"))

    for dtype in (torch.float32, torch.bfloat16):
        for b, t, h, n, p in ((2, 8, 4, 4, 16), (2, 16, 3, 8, 8),
                              (1, 16, 1, 64, 64), (2, 64, 3, 64, 64),
                              (3, 128, 5, 16, 32), (2, 128, 112, 64, 64)):
            args = ssd_inputs(b, t, h, n, p, gen, dtype, dev)
            check(f"ssd_chunk B={b} T={t} H={h} N={n} P={p}",
                  ssd_chunk(*args), ssd_chunk_plain(*args), dtype)
        for b, t, nc, h, n, p in ((2, 16, 3, 3, 8, 8), (1, 16, 3, 2, 64, 64),
                                  (2, 32, 4, 3, 64, 64),
                                  (2, 128, 4, 6, 64, 64),
                                  (1, 128, 3, 4, 16, 32)):
            args = ssd_inputs(b, t * nc, h, n, p, gen, dtype, dev)
            check(f"ssd_scan B={b} S={t * nc} T={t} H={h} N={n} P={p}",
                  *scan(args, t), dtype)
        # chunks 1-2 of a 3-chunk sequence, as views with its batch stride
        args = ssd_inputs(2, 384, 6, 64, 64, gen, dtype, dev)
        check("ssd_scan views S=256 of 384",
              *scan([a[:, 128:] for a in args[:4]] + [args[4]], 128), dtype)
        # every operand one element off a 16-byte boundary
        args = ssd_inputs(2, 256, 4, 64, 64, gen, dtype, dev)
        check("ssd_scan misaligned S=256",
              ssd_scan(*map(misaligned_tensor, args), chunk=128),
              ssd_scan(*args, chunk=128, use_kernel="ref"), dtype)
    return checked


def tree_bytes(tree) -> tuple[int, int]:
    """(elements, bytes) of every tensor in a nested dict."""
    if isinstance(tree, dict):
        parts = [tree_bytes(v) for v in tree.values()]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    return tree.numel(), tensor_bytes(tree)


def cut_depth(cfg, params, groups: int):
    """The first `groups` groups and the tail of a Zamba2 model: the config
    and views of the same parameters (no copy)."""
    import dataclasses

    from repro_torch.models.model import _layer

    period = cfg.hybrid_attn_period
    tail = params["tail_layers"]["in_proj"]["w"].shape[0]
    cut = dict(params, layers=_layer(params["layers"],
                                     slice(0, groups * period)))
    return dataclasses.replace(cfg, n_layers=groups * period + tail), cut


def logits_check(name, got, want, shape) -> tuple[float, float]:
    """Shape, finiteness and max error of `got` over the largest |want|."""
    import torch

    for lg in (got, want):
        if tuple(lg.shape) != shape or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name}: logits {tuple(lg.shape)} (want "
                                 f"{shape}) or not finite")
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def chunk_witness(cfg, params, batch, want, shape) -> tuple[float, float]:
    """The plain SSD with chunks of 64 against `want`, the plain SSD with the
    config's chunks of 128: the same function summed in another order, so
    its error is what rounding alone does to the logits at this depth."""
    import dataclasses

    from repro_torch.serving.decode import prefill

    half = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, chunk=cfg.ssm.chunk // 2))
    _, logits = prefill(params, batch, half, use_kernel="ref")
    return logits_check(f"{cfg.n_layers}-layer plain prefill, chunk "
                        f"{half.ssm.chunk}", logits, want, shape)


def layerwise_ssd(cfg, params, tokens) -> tuple[float, int]:
    """Every Mamba2 layer of the full-depth prefill, on the input that the
    K5 path gave it, with K5 and with the plain SSD chunk, in the
    parameters' type; the walk is _zamba_forward's. Returns (largest rel err
    of a layer's output, layers checked)."""
    from repro_torch.models import model as MDL
    from repro_torch.models.layers import mamba2 as M
    from repro_torch.models.layers.common import embed

    worst, checked = 0.0, 0

    def mamba(lp, x):
        nonlocal worst, checked
        y = M.mamba2_block(lp, x, cfg.ssm, use_kernel="auto")[0]
        want = M.mamba2_block(lp, x, cfg.ssm, use_kernel="ref")[0]
        worst = max(worst, rel_err(y, want)[1])
        checked += 1
        return y

    x = embed(params["embed"], tokens)
    period = cfg.hybrid_attn_period
    for g in range(params["layers"]["in_proj"]["w"].shape[0] // period):
        for j in range(period):
            x = mamba(MDL._layer(params["layers"], g * period + j), x)
        x = MDL._shared_attn_block(params["shared_attn"], x, cfg)[0]
    for j in range(params["tail_layers"]["in_proj"]["w"].shape[0]):
        x = mamba(MDL._layer(params["tail_layers"], j), x)
    return worst, checked


def lm_prefill(dev) -> dict:
    """Phase 8: the Zamba2-7B prefill at full width and depth."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import registry
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import cast_params, prefill

    cfg = registry.get(LM_ARCH)
    t0 = time.perf_counter()
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
    params["embed"]["table"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    nparams, nbytes = tree_bytes(params)
    phase("lm params", t0, arch=cfg.name, layers=cfg.n_layers,
          d_model=cfg.d_model, params=nparams, f32_bytes=nbytes)

    bsz, seq = 2, 4096
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (bsz, seq), generator=gen,
                           device=dev)
    batch = {"tokens": tokens}
    shape = (bsz, seq, cfg.padded_vocab)
    want_launches = cfg.n_layers      # one K5 launch per Mamba2 layer
    t0 = time.perf_counter()
    kernels.reset_launches()
    next_k, logits_k = prefill(params, batch, cfg, use_kernel="auto")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["ssd_chunk"] != want_launches:
        raise AssertionError(f"the prefill launched ssd_chunk "
                             f"{launches['ssd_chunk']} times, expected "
                             f"{want_launches}")
    phase("lm prefill f32 kernel", t0, tokens=f"{bsz}x{seq}",
          launches=json.dumps(launches), argmax=next_k.tolist())
    t0 = time.perf_counter()
    next_r, logits_r = prefill(params, batch, cfg, use_kernel="ref")
    torch.cuda.synchronize()
    if kernels.LAUNCHES != launches:
        raise AssertionError("the plain prefill launched a kernel")
    err, rel = logits_check("81-layer prefill", logits_k, logits_r, shape)
    phase("lm prefill f32 plain", t0, argmax=next_r.tolist(),
          logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}",
          note="random layers amplify any rounding difference; gated per "
               "layer and at 15 layers below")
    del logits_k
    t0 = time.perf_counter()
    err, rel = chunk_witness(cfg, params, batch, logits_r, shape)
    phase("lm prefill f32 witness", t0, pair="plain chunk 64 vs plain "
          "chunk 128", logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}")
    del logits_r

    t0 = time.perf_counter()
    worst, checked = layerwise_ssd(cfg, params, tokens)
    if not worst <= LAYER_TOL:
        raise AssertionError(f"a Mamba2 layer with K5 against the plain SSD: "
                             f"rel err {worst:.3e} > {LAYER_TOL:.0e}")
    phase("lm prefill f32 per layer", t0, layers=checked,
          worst_rel_err=f"{worst:.3e}")

    t0 = time.perf_counter()
    cfg15, params15 = cut_depth(cfg, params, 2)
    kernels.reset_launches()
    next_k, logits_k = prefill(params15, batch, cfg15, use_kernel="auto")
    k5 = kernels.LAUNCHES["ssd_chunk"]
    next_r, logits_r = prefill(params15, batch, cfg15, use_kernel="ref")
    torch.cuda.synchronize()
    if k5 != cfg15.n_layers \
            or kernels.LAUNCHES["ssd_chunk"] != k5:
        raise AssertionError(f"the 15-layer prefills launched ssd_chunk "
                             f"{kernels.LAUNCHES['ssd_chunk']} times")
    err, rel = logits_check("15-layer prefill", logits_k, logits_r, shape)
    if not rel <= LM_TOL:
        raise AssertionError(f"15-layer prefill logits, K5 against the "
                             f"plain SSD: rel err {rel:.3e} > {LM_TOL:.0e}")
    _, w_rel = chunk_witness(cfg15, params15, batch, logits_r, shape)
    phase(f"lm prefill f32 {cfg15.n_layers} layers", t0, launches=k5,
          argmax_kernel=next_k.tolist(), argmax_plain=next_r.tolist(),
          logits_max_abs_err=f"{err:.3e}", rel=f"{rel:.3e}",
          witness_rel=f"{w_rel:.3e}")
    del logits_k, logits_r

    t0 = time.perf_counter()
    params_bf = cast_params(params, torch.bfloat16)
    worst, checked = layerwise_ssd(cfg, params_bf, tokens)
    if not worst <= KERNEL_TOL["bfloat16"]:
        raise AssertionError(f"a bf16 Mamba2 layer with K5 against the plain "
                             f"SSD: rel err {worst:.3e} > "
                             f"{KERNEL_TOL['bfloat16']:.0e}")
    phase("lm prefill bf16 per layer", t0, layers=checked,
          worst_rel_err=f"{worst:.3e}")

    t0 = time.perf_counter()
    kernels.reset_launches()
    prefill(params_bf, batch, cfg)                 # warm-up
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    torch.cuda.reset_peak_memory_stats()
    for start, end in ev:
        start.record()
        next_b, _ = prefill(params_bf, batch, cfg)
        end.record()
    torch.cuda.synchronize()
    runs = [s.elapsed_time(e) for s, e in ev]
    ms = float(np.median(runs))
    phase("lm prefill bf16 timed", t0, ms=f"{ms:.3f}",
          runs_ms=json.dumps([round(r, 3) for r in runs]),
          tokens_per_s=f"{bsz * seq / (ms / 1e3):.1f}",
          ssd_launches_per_prefill=kernels.LAUNCHES["ssd_chunk"] / 6,
          argmax=next_b.tolist(),
          peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    t0 = time.perf_counter()
    profile_call("bf16 prefill", lambda: prefill(params_bf, batch, cfg))
    phase("lm prefill bf16 profiled", t0)
    return {"cfg": cfg, "params": params, "params_bf": params_bf,
            "tokens": tokens, "launches": launches["ssd_chunk"],
            "prefill_bf16_ms": ms}


def kernel_group(name: str) -> str:
    for group, keys in (("ssd_chunk (K5)", ("ssd_scan_",)),
                        ("matmul", ("gemm", "nvjet", "xmma", "gemv")),
                        ("copy", ("copy",)),
                        ("elementwise", ("elementwise",)),
                        ("reduce", ("reduce",))):
        if any(k in name for k in keys):
            return group
    return "other"


def profile_call(label: str, fn) -> None:
    """fn() once under torch.profiler: device busy time against the wall
    time of the same call (CUDA events), device time by kernel group, and
    the kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    if not kernels:
        print(f"[profile] {label}: the trace holds no device time: not "
              f"measured", flush=True)
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups: dict = {}
    for e in kernels:
        g = groups.setdefault(kernel_group(e.key), {"calls": 0, "ms": 0.0})
        g["calls"] += e.count
        g["ms"] += e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"[profile] {label}: " + json.dumps({
        "wall_ms": wall, "device_busy_ms": busy,
        "idle_share": 1 - busy / wall, "groups": groups,
        "top": [{"kernel": e.key[:80], "calls": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in top]}),
        flush=True)


def decode_vs_prefill(cfg, params, toks) -> tuple[int, float, float]:
    """Decode `toks` one by one through the cache; hold the last step's
    logits against a prefill over the same tokens. Returns (logits off by
    more than rtol = atol = DECODE_TOL, max abs err, max |logit|)."""
    import torch

    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import prefill

    _, full = prefill(params, {"tokens": toks}, cfg)
    cache = MDL.init_cache(cfg, 1, 32, dtype=torch.float32,
                           device=toks.device)
    for t in range(toks.shape[1]):
        logits, cache, _ = MDL.forward(params, {"tokens": toks[:, t:t + 1]},
                                       cfg, cache=cache)
    got, want = logits[0, 0], full[0, -1]
    diff = (got - want).abs()
    bad = int((diff > DECODE_TOL + DECODE_TOL * want.abs()).sum())
    return bad, float(diff.max()), float(want.abs().max())


def lm_decode(dev, lm: dict) -> None:
    """Phase 9: greedy generate in f32, then decode through the cache
    against the prefill."""
    import torch

    from repro_torch import kernels
    from repro_torch.models import model as MDL
    from repro_torch.serving.decode import generate, make_serve_step

    cfg, params = lm["cfg"], lm["params"]
    gen = torch.Generator(device=dev).manual_seed(2)
    bsz, prompt_len, new = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab, (bsz, prompt_len), generator=gen,
                           device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompt, new,
                   cache_len=prompt_len + new + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if tuple(out.shape) != (bsz, new) or not bool(
            ((out >= 0) & (out < cfg.padded_vocab)).all()):
        raise AssertionError(f"generate gave {tuple(out.shape)} tokens "
                             f"outside the vocabulary")
    steps = prompt_len + new - 1
    phase("lm decode generate f32", t0, batch=bsz, prompt=prompt_len,
          new_tokens=new, steps=steps,
          tokens_per_s=f"{bsz * new / dt:.2f}",
          ms_per_step=f"{dt / steps * 1e3:.2f}", sample=out[0].tolist())

    t0 = time.perf_counter()
    step = make_serve_step(cfg, compute_dtype=torch.float32)
    cache = MDL.init_cache(cfg, bsz, prompt_len + 2, dtype=torch.float32,
                           device=dev)
    for t in range(prompt_len):
        tok, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache)
    profile_call("f32 decode step", lambda: step(
        params, {"tokens": tok[:, None]}, cache))
    phase("lm decode step profiled", t0, batch=bsz, position=prompt_len)

    toks = torch.randint(0, cfg.vocab, (1, 17), generator=gen, device=dev)
    t0 = time.perf_counter()
    cfg15, params15 = cut_depth(cfg, params, 2)
    kernels.reset_launches()
    bad, err, top = decode_vs_prefill(cfg15, params15, toks)
    if bad:
        raise AssertionError(f"{cfg15.n_layers}-layer decode through the "
                             f"cache: {bad} "
                             f"logits off the prefill's by more than rtol = "
                             f"atol = {DECODE_TOL}")
    phase(f"lm decode vs prefill {cfg15.n_layers} layers", t0, tokens=17,
          prefill_ssd_launches=kernels.LAUNCHES["ssd_chunk"],
          max_abs_err=f"{err:.3e}", max_abs_logit=f"{top:.3e}")
    t0 = time.perf_counter()
    bad, err, top = decode_vs_prefill(cfg, params, toks)
    phase(f"lm decode vs prefill {cfg.n_layers} layers", t0, tokens=17,
          logits_off=bad, max_abs_err=f"{err:.3e}",
          max_abs_logit=f"{top:.3e}", note="not gated, as the full-depth "
          "prefill comparison")


def ssd_main_inputs(cfg, params, tokens):
    """The first Mamba2 layer's SSD operands for the whole prefill (la, xw,
    B, C over S = 4096 and the zero state it starts from), and its second
    chunk alone with the state the kernel left after the first."""
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk
    from repro_torch.models.layers import mamba2 as M
    from repro_torch.models.layers.common import embed
    from repro_torch.models.model import _layer

    lp = _layer(params["layers"], 0)
    _, xh, dt, b_mat, c_mat, _ = M._mix(lp, embed(params["embed"], tokens),
                                        cfg.ssm)
    la, xw = M._discretize(xh, dt, lp["a_log"])
    t = cfg.ssm.chunk
    bsz, _, h, p = xh.shape
    zero = xh.new_zeros((bsz, h, cfg.ssm.d_state, p))
    layer = [la, xw, b_mat.contiguous(), c_mat.contiguous(), zero]
    first = [a[:, :t].contiguous() for a in layer[:4]]
    _, state = ssd_chunk(*first, zero)
    chunk = [a[:, t:2 * t].contiguous() for a in layer[:4]] + [state]
    return layer, chunk


def ssd_flops(bsz: int, s: int, t: int, h: int, n: int, p: int) -> int:
    """The least work of the SSD over S steps in chunks of T: per chunk C·Bᵀ
    once per batch row (B and C do not depend on the head) and, like the
    decayed product with xw, on and below the diagonal only; C·state and
    the state update in full."""
    return s // t * (bsz * t * (t + 1) * n
                     + bsz * h * (t * (t + 1) * p + 4 * t * n * p))


def ssd_times(lm: dict) -> tuple[dict, list]:
    """Phase 10: K5 at the main-path shape, bf16 (the row) and f32: one
    layer's whole scan (one launch), and one chunk beside it."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    cfg = lm["cfg"]
    t = cfg.ssm.chunk
    out, f32_args = {}, None
    for name, params in (("bfloat16", lm["params_bf"]),
                         ("float32", lm["params"])):
        layer, chunk = ssd_main_inputs(cfg, params, lm["tokens"])
        if name == "float32":
            f32_args = (layer, chunk)
        rate = BF16_FLOPS_PER_S if name == "bfloat16" else FP32_FLOPS_PER_S
        tol = KERNEL_TOL[name]
        rows = {}
        for part, args, kern, plain, batch in (
                ("layer", layer,
                 lambda a=layer: ssd_scan(*a, chunk=t),
                 lambda a=layer: ssd_scan(*a, chunk=t, use_kernel="ref"), 5),
                ("chunk", chunk, lambda a=chunk: ssd_chunk(*a),
                 lambda a=chunk: ssd_chunk_plain(*a), BATCH)):
            got = kern()
            abs_err, rel = ssd_errors(got, plain())
            if not rel <= tol:
                raise AssertionError(f"ssd {part} {name}: kernel vs plain rel "
                                     f"err {rel:.3e} > {tol:.0e} at the "
                                     f"main-path shape")
            bsz, s, h, p = args[1].shape
            n = args[2].shape[-1]
            nbytes = tensor_bytes(*args, *got)
            flops = ssd_flops(bsz, s, t, h, n, p)
            bms, by = bound_ms(nbytes, flops, rate)
            row = {"ms": time_ms(kern), "plain_ms": time_ms(plain, batch),
                   "bound_ms": bms, "bound_by": by, "max_abs_err": abs_err,
                   "rel_err": rel, "bytes": nbytes, "flops": flops}
            rows[part] = row
            print(f"[kernel] ssd_chunk {name} {part} B={bsz} S={s} T={t} "
                  f"H={h} N={n} P={p} rel_err={rel:.2e} ms={row['ms']:.4f} "
                  f"plain_ms={row['plain_ms']:.4f} library_ms=none "
                  f"bound_ms={bms:.4f} ({by}, {nbytes} B, {flops} flop) "
                  f"launches={lm['launches']} (lm prefill f32, B=2, "
                  f"S=4096)", flush=True)
            del got
        out[name] = dict(rows["layer"], chunk=rows["chunk"])
    bf = out["bfloat16"]
    row = {"name": "ssd_chunk", "route": "cuda", "source": SSD_SOURCE,
           "replaces": KERNELS["ssd_chunk"], "launches": lm["launches"],
           "launches_path": "lm prefill f32, B=2, S=4096",
           "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
           "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
           "bound_by": bf["bound_by"], "library_ms": None,
           "dtype": "bfloat16", "per": "layer (S=4096, 32 chunks)",
           "chunk": bf["chunk"], "float32": out["float32"]}
    return row, f32_args


def ssd_control(args) -> None:
    """Phase 11: K5 with the last time step of xw zeroed, and K5's chain
    with the carried state zeroed between chunks, must each fail the check
    against the intact plain result."""
    import torch

    from repro_torch.kernels.ssd_chunk.kernel import (ssd_chunk,
                                                      ssd_chunk_plain)
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan

    layer, chunk = args
    tol = KERNEL_TOL["float32"]
    la, xw, b_mat, c_mat, state = chunk
    bad = xw.clone()
    bad[:, -1] = 0
    _, rel = ssd_errors(ssd_chunk(la, bad, b_mat, c_mat, state),
                        ssd_chunk_plain(*chunk))
    if not rel > tol:
        raise AssertionError(f"ssd_chunk with xw's last step zeroed gave rel "
                             f"err {rel:.3e}, which passes {tol:.0e}")
    print(f"[control] ssd_chunk float32 with xw's last time step zeroed: "
          f"rel err {rel:.3e} > {tol:.0e}, caught", flush=True)

    t = chunk[0].shape[1]
    la, xw, b_mat, c_mat, zero = layer
    parts = [ssd_chunk(la[:, i:i + t], xw[:, i:i + t], b_mat[:, i:i + t],
                       c_mat[:, i:i + t], zero)
             for i in range(0, la.shape[1], t)]
    reset = (torch.cat([y for y, _ in parts], dim=1), parts[-1][1])
    _, rel = ssd_errors(reset, ssd_scan(*layer, chunk=t, use_kernel="ref"))
    if not rel > tol:
        raise AssertionError(f"the scan with its state zeroed between chunks "
                             f"gave rel err {rel:.3e}, which passes "
                             f"{tol:.0e}")
    print(f"[control] ssd_scan float32 with the carried state zeroed between "
          f"chunks: rel err {rel:.3e} > {tol:.0e}, caught", flush=True)


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
    # hermetic stores: every plan, reordering, operator and campaign record
    # of this run lives in a temporary directory, removed at the end, so
    # every timed number of the first campaign includes its tune
    stores = tempfile.mkdtemp(prefix="chip_smoke_stores_")
    for var, sub in (("REPRO_TORCH_PLAN_CACHE", "plans"),
                     ("REPRO_TORCH_OPERATOR_CACHE", "opcache"),
                     ("REPRO_TORCH_REORDER_CACHE", "reorder"),
                     ("REPRO_TORCH_RESULT_STORE", "results"),
                     ("REPRO_TORCH_CORPUS_CACHE", "corpus")):
        os.environ[var] = os.path.join(stores, sub)
    try:
        return run(args, torch)
    finally:
        shutil.rmtree(stores, ignore_errors=True)


def run(args, torch) -> int:
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
    info = _build.BUILD_INFO
    phase("build", t0, library=info["path"], compiled=info["compiled"],
          nvcc_s=f"{info['seconds']:.2f}")
    print(f"[ptxas]\n{info['log'].strip()}", flush=True)

    t0 = time.perf_counter()
    checked = kernels_small(dev)
    phase("kernels small shapes", t0, comparisons=checked)
    t0 = time.perf_counter()
    checked = ssd_small(dev)
    phase("kernels small shapes ssd_chunk", t0, comparisons=checked)

    from repro_torch.matrices import suite

    t0 = time.perf_counter()
    mats = {args.shuffled: suite.get(args.shuffled),
            args.banded: suite.get(args.banded)}
    phase("matrices", t0, **{n: f"{m.m}x{m.n}/nnz={m.nnz}"
                             for n, m in mats.items()})
    campaign(dev, mats, args.iters)
    t0 = time.perf_counter()
    rmat = rcm_order(dev, mats[args.shuffled])
    phase("rcm order from the plan store", t0)
    schedule_campaign(dev)
    scheme_campaign(dev, args.iters)
    corpus_phase(dev, args.iters)

    forced, vmat, recs = forced_paths(dev, rmat, args.iters)
    forced16, recs16 = bf16_paths(dev, vmat)
    recs.update(recs16)
    print(f"[launches] per path: "
          f"{json.dumps({t: r['launches'] for t, r in recs.items()})}",
          flush=True)

    t0 = time.perf_counter()
    rows = kernel_times(forced, vmat, dev, recs)
    rows += kernel_times(forced16, vmat, dev, recs, BF16_FEEDS, "_bf16")
    phase("kernel times", t0)
    t0 = time.perf_counter()
    rows += powerlaw_phase(dev, args.iters)
    phase("powerlaw kernel times", t0)

    t0 = time.perf_counter()
    planted_faults((forced, forced16), rmat, vmat, dev)
    phase("controls", t0)

    t0 = time.perf_counter()
    paths = serve_phase(dev, mats)
    del mats
    phase("serve", t0)
    t0 = time.perf_counter()
    paths.update(workload_phase(dev))
    phase("workloads", t0)
    add_path_launches(rows, paths)
    print(f"[launches] service and workload paths: {json.dumps(paths)}",
          flush=True)

    t0 = time.perf_counter()
    del forced, forced16, rmat, vmat
    gc.collect()
    torch.cuda.empty_cache()
    phase("free spmv", t0,
          allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    lm = lm_prefill(dev)
    lm_decode(dev, lm)
    t0 = time.perf_counter()
    row, f32_args = ssd_times(lm)
    rows.append(row)
    phase("ssd times", t0)
    t0 = time.perf_counter()
    ssd_control(f32_args)
    phase("ssd control", t0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
