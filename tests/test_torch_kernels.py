"""K1-K4: the port's operators and kernel wrappers on CPU tensors (which take
the plain torch version) against the JAX package's Pallas kernels run in
interpret mode, on the same host formats: σ-sorted SELL with empty slices
(C = 8, 32; W = 8, 32, 128), BCSR with empty block rows, Block-ELL with
padding blocks (bm up to 16, bn = 4, 16, 100, 128), and widths 1, 3, 8, 16,
32, 33 and 64 for K1 and K2 (every k-tile of K2, and two k-tiles at 33 and
64). Float32, rel 1e-5 (same terms, another summation order).
The CUDA kernels themselves run only on the card (chip_smoke.py); a source
test checks that each launcher the bindings name is defined.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse.bell import to_bcsr as ref_to_bcsr
from repro.core.sparse.bell import to_block_ell as ref_to_block_ell
from repro.core.sparse.csr import CSRMatrix as RefCSR
from repro.core.sparse.sell import to_sell as ref_to_sell
from repro.kernels.bcsr_spmv.kernel import bcsr_spmm as pallas_bcsr
from repro.kernels.bcsr_spmv.ops import BcsrOperator as RefBcsr
from repro.kernels.bcsr_spmv.ops import pad_empty_rows as ref_pad_empty_rows
from repro.kernels.bell_spmv.kernel import bell_spmm as pallas_bell
from repro.kernels.bell_spmv.ops import BellOperator as RefBell
from repro.kernels.sell_spmm.kernel import sell_spmm_ktiled as pallas_spmm
from repro.kernels.sell_spmm.ops import pick_k_tile as ref_pick_k_tile
from repro.kernels.sell_spmv.kernel import sell_spmm as pallas_sell
from repro.kernels.sell_spmv.ops import SellOperator as RefSell
from repro.matrices import generators as RG
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.core.sparse.bell import BCSR, BlockELL
from repro_torch.core.sparse.sell import SellCS
from repro_torch.kernels.bcsr_spmv.kernel import bcsr_spmv
from repro_torch.kernels.bcsr_spmv.ops import BcsrOperator
from repro_torch.kernels.bell_spmv.kernel import bell_spmv
from repro_torch.kernels.bell_spmv.ops import BellOperator
from repro_torch.kernels.sell_spmm.kernel import pick_k_tile, sell_spmm
from repro_torch.kernels.sell_spmv.kernel import sell_spmv, slice_chunk_ptr
from repro_torch.kernels.sell_spmv.ops import SellOperator

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _mat(kind):
    if kind == "power_law":
        return RG.power_law(120, alpha=1.9, seed=4)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((96, 80)) * (rng.random((96, 80)) < 0.08)
    d[8:40] = 0.0                        # empty slices and block rows
    d[60] = rng.standard_normal(80)      # one long row (SELL / ELL padding)
    return RefCSR.from_dense(d)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _port(host, cls, **kw):
    """The same host arrays, re-wrapped in the port's dataclass."""
    fields = {f: getattr(host, f) for f in cls.__dataclass_fields__}
    return cls(**fields, **kw)


def _sell_pair(kind, sigma, w, c=8):
    rm = _mat(kind)
    h = ref_to_sell(rm, c=c, sigma=sigma, w=w)
    ph = object.__new__(SellCS)
    ph.__dict__.update(h.__dict__)
    return rm, h, ph


@pytest.mark.parametrize("kind", ["power_law", "holes"])
@pytest.mark.parametrize("sigma", [1, 16, 10_000])
@pytest.mark.parametrize("c,w", [
    pytest.param(8, 8, id="8"), pytest.param(8, 32, id="32"),
    pytest.param(8, 128, id="128"), pytest.param(32, 8, id="c32-8"),
    pytest.param(32, 32, id="c32-32"), pytest.param(32, 128, id="c32-128")])
def test_sell_operator_matches_pallas(kind, sigma, c, w):
    rm, h, ph = _sell_pair(kind, sigma, w, c)
    assert (np.bincount(h.chunk_slice, minlength=h.num_slices) >= 1).all()
    x = np.random.default_rng(0).standard_normal(rm.n)
    want = RefSell(h, use_kernel="interpret")(jnp.asarray(x, jnp.float32))
    op = SellOperator(ph, device="cpu")
    got = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(got, want) < 1e-5
    assert _rel(got, rm.spmv(x)) < 1e-5


@pytest.mark.parametrize("kind", ["power_law", "holes"])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 32, 33, 64])
def test_sell_matmul_matches_pallas_ktiled(kind, k):
    rm, h, ph = _sell_pair(kind, 16, 8)
    x = np.random.default_rng(k).standard_normal((rm.n, k))
    want = RefSell(h, use_kernel="interpret").matmul(
        jnp.asarray(x, jnp.float32))
    got = SellOperator(ph, device="cpu").matmul(
        torch.as_tensor(x, dtype=torch.float32))
    assert got.shape == (rm.m, k)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("k", [1, 3, 8, 16, 32, 33, 64])
def test_sell_kernel_wrappers_match_pallas(k):
    """The wrappers at the kernel level: y in slice order, [S, C, nv]."""
    rm, h, ph = _sell_pair("holes", 16, 8)
    x = np.random.default_rng(k).standard_normal((rm.n, k))
    vals = torch.as_tensor(h.chunk_vals, dtype=torch.float32)
    cols = torch.as_tensor(h.chunk_cols)
    cs = torch.as_tensor(h.chunk_slice)
    ptr = torch.as_tensor(slice_chunk_ptr(h.chunk_slice, h.num_slices))
    kb = ref_pick_k_tile(k)
    k_pad = -(-k // kb) * kb
    xp = np.zeros((-(-rm.n // 128) * 128, k_pad))
    xp[: rm.n, :k] = x
    want = pallas_spmm(jnp.asarray(h.chunk_vals, jnp.float32),
                       jnp.asarray(h.chunk_cols), jnp.asarray(h.chunk_slice),
                       jnp.asarray(xp, jnp.float32), h.num_slices, kb,
                       interpret=True)[..., :k]
    xt = torch.as_tensor(x, dtype=torch.float32)
    got = sell_spmm(vals, cols, cs, ptr, xt, h.num_slices, pick_k_tile(k))
    assert _rel(got, want) < 1e-5
    # K1 takes any number of columns too (its kernel walks them on grid.y)
    want1 = pallas_sell(jnp.asarray(h.chunk_vals, jnp.float32),
                        jnp.asarray(h.chunk_cols), jnp.asarray(h.chunk_slice),
                        jnp.asarray(xp[:, :k], jnp.float32), h.num_slices,
                        interpret=True)
    assert _rel(sell_spmv(vals, cols, cs, ptr, xt, h.num_slices),
                want1) < 1e-5


@pytest.mark.parametrize("k,kt", [(1, 8), (4, 8), (8, 8), (9, 16),
                                  (16, 16), (17, 32), (32, 32), (33, 32),
                                  (64, 32), (1000, 32)])
def test_pick_k_tile_values(k, kt):
    """K2's k-tile: the smallest of 8, 16 and 32 covering k (the launcher
    compiles its vector body for those three and no other)."""
    assert pick_k_tile(k) == kt


@pytest.mark.parametrize("bad", ["kt", "x1d", "ptr"])
def test_sell_spmm_wrapper_rejects_bad_arguments(bad):
    """A kt the kernel was not compiled for, a 1-D x or a slice pointer of
    the wrong length raises before the device is looked at (so on the CPU
    too, where the plain version would otherwise run)."""
    _, h, _ = _sell_pair("holes", 16, 8)
    ptr = torch.as_tensor(slice_chunk_ptr(h.chunk_slice, h.num_slices))
    x = torch.zeros((h.shape[1], 8))
    kt = pick_k_tile(8)
    if bad == "kt":
        kt = 64
    elif bad == "x1d":
        x = x[:, 0]
    else:
        ptr = ptr[:-1]
    with pytest.raises(ValueError, match="kt must be|x must be"):
        sell_spmm(torch.as_tensor(h.chunk_vals, dtype=torch.float32),
                  torch.as_tensor(h.chunk_cols),
                  torch.as_tensor(h.chunk_slice), ptr, x, h.num_slices, kt)


def test_slice_chunk_ptr_covers_chunks():
    _, h, _ = _sell_pair("holes", 16, 8)
    ptr = slice_chunk_ptr(h.chunk_slice, h.num_slices)
    assert ptr[0] == 0 and ptr[-1] == h.num_chunks
    for s in range(h.num_slices):
        assert (h.chunk_slice[ptr[s]:ptr[s + 1]] == s).all()
        assert ptr[s + 1] > ptr[s]             # empty slices keep a chunk


@pytest.mark.parametrize("kind", ["power_law", "holes"])
@pytest.mark.parametrize("bm,bn", [(8, 16), (8, 128), (4, 4), (16, 100),
                                   (4, 128), (16, 128)])
@pytest.mark.parametrize("nv", [1, 3, 8])
def test_bcsr_operator_matches_pallas(kind, bm, bn, nv):
    rm = _mat(kind)
    h = ref_to_bcsr(rm, bm, bn)
    x = np.random.default_rng(nv).standard_normal((rm.n, nv))
    want = RefBcsr(h, use_kernel="interpret")(jnp.asarray(x, jnp.float32))
    op = BcsrOperator(_port(h, BCSR), device="cpu")
    got = op(torch.as_tensor(x, dtype=torch.float32))
    assert _rel(got, want) < 1e-5
    # the kernel's row pointer covers every block row (empty ones padded)
    ptr = op.block_rowptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == op.blocks.shape[0]
    assert (np.diff(ptr) >= 1).all()


def test_bcsr_kernel_wrapper_matches_pallas_with_empty_rows():
    rm = _mat("holes")
    h = ref_pad_empty_rows(ref_to_bcsr(rm, 8, 16))
    assert (np.diff(h.block_rowptr) >= 1).all()
    ncb = -(-rm.n // 16)
    x2d = np.random.default_rng(1).standard_normal((ncb, 16, 2))
    want = pallas_bcsr(jnp.asarray(h.blocks, jnp.float32),
                       jnp.asarray(h.block_rows), jnp.asarray(h.block_cols),
                       jnp.asarray(x2d, jnp.float32), h.num_block_rows,
                       interpret=True)
    got = bcsr_spmv(torch.as_tensor(h.blocks, dtype=torch.float32),
                    torch.as_tensor(h.block_rows),
                    torch.as_tensor(h.block_cols),
                    torch.as_tensor(h.block_rowptr.astype(np.int64)),
                    torch.as_tensor(x2d, dtype=torch.float32),
                    h.num_block_rows)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("kind", ["power_law", "holes"])
@pytest.mark.parametrize("bm,bn", [(8, 16), (8, 128), (4, 4), (16, 100),
                                   (4, 128), (16, 128)])
@pytest.mark.parametrize("nv", [1, 3, 8])
def test_bell_operator_matches_pallas(kind, bm, bn, nv):
    rm = _mat(kind)
    h = ref_to_block_ell(rm, bm, bn)
    x = np.random.default_rng(nv).standard_normal((rm.n, nv))
    want = RefBell(h, use_kernel="interpret")(jnp.asarray(x, jnp.float32))
    got = BellOperator(_port(h, BlockELL), device="cpu")(
        torch.as_tensor(x, dtype=torch.float32))
    assert _rel(got, want) < 1e-5


def test_bell_kernel_wrapper_matches_pallas_with_padding_blocks():
    rm = _mat("holes")
    h = ref_to_block_ell(rm, 8, 16)
    assert (h.nblocks < h.k).any()          # some rows carry padding blocks
    ncb = -(-rm.n // 16)
    x2d = np.random.default_rng(2).standard_normal((ncb, 16, 1))
    want = pallas_bell(jnp.asarray(h.blocks, jnp.float32),
                       jnp.asarray(h.block_cols),
                       jnp.asarray(x2d, jnp.float32), interpret=True)
    got = bell_spmv(torch.as_tensor(h.blocks, dtype=torch.float32),
                    torch.as_tensor(h.block_cols),
                    torch.as_tensor(x2d, dtype=torch.float32))
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("cls", ["sell", "bcsr", "bell"])
def test_cpu_tensors_take_the_plain_version_and_never_count(cls):
    rm = _mat("power_law")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(rm.n),
                        dtype=torch.float32)
    op = {"sell": lambda: SellOperator(
              _sell_pair("power_law", 16, 8)[2], device="cpu"),
          "bcsr": lambda: BcsrOperator(
              _port(ref_to_bcsr(rm, 8, 16), BCSR), device="cpu"),
          "bell": lambda: BellOperator(
              _port(ref_to_block_ell(rm, 8, 16), BlockELL),
              device="cpu")}[cls]()
    before = dict(kernels.LAUNCHES)
    for use_kernel in ("auto", "ref"):
        op.use_kernel = use_kernel
        assert _rel(op(x), rm.spmv(x.double().numpy())) < 1e-5
        if cls == "sell":
            op.matmul(x[:, None].repeat(1, 3))
    assert kernels.LAUNCHES == before
    op.use_kernel = "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        op(x)


def test_wrappers_reject_bad_inputs_before_launch():
    """Shape and type checks run before any launch; on the CPU only the
    float type check and the plain path are reachable, so check the plain
    wrappers keep the float64 contract (more exact than the float32 TPU
    accumulator, as the port promises)."""
    rm, h, ph = _sell_pair("power_law", 16, 8)
    op = SellOperator(ph, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(4).standard_normal(rm.n)
    assert _rel(op(torch.as_tensor(x)), rm.spmv(x)) < 1e-12
    assert pick_k_tile(1) == 8 and pick_k_tile(20) == 32
    assert pick_k_tile(1000) == 32


_DEF = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _launchers() -> dict:
    """name -> parameters of every extern "C" int function in the sources,
    with the launcher macros (`#define M(SUFFIX, TYPE)` around
    `name_##SUFFIX(...)`) expanded at each of their uses."""
    out = {}
    for src in _build.SOURCES:
        text = src.read_text().replace("\\\n", " ")
        out.update(_DEF.findall(text))
        for macro, body in re.findall(r"#define (\w+)\(SUFFIX, TYPE\)(.*)",
                                      text):
            for suffix in re.findall(rf"^{macro}\((\w+), ", text, re.M):
                out.update(_DEF.findall(body.replace("##SUFFIX", suffix)))
    return out


@pytest.mark.parametrize("name,dtype", [
    pytest.param(n, d, id=f"{n}_{_build._SUFFIX[d]}")
    for n, (_, _, dtypes) in _build.KERNELS.items() for d in dtypes])
def test_every_bound_launcher_is_defined_in_the_sources(name, dtype):
    """Each launcher `_build.library()` binds has an extern "C" definition
    with the pointer and integer arguments KERNELS gives it, then the
    stream (K1 and K2 have launchers of their own with 4 and 5 ints)."""
    nptr, nint, _ = _build.KERNELS[name]
    params = [p.strip() for p in
              _launchers()[f"{name}_{_build._SUFFIX[dtype]}"].split(",")]
    assert params[-1] == "void* stream"
    assert sum("*" in p for p in params[:-1]) == nptr
    assert sum(p.startswith("long long ") for p in params) == nint
    assert len(params) == nptr + nint + 1


def test_bcsr_and_bell_share_their_block_row_bodies():
    """K3 and K4 run one warp-per-block-row body each for the 16-byte path
    and the scalar path; only the block range differs (K3's row pointer,
    K4's K slots), and both launchers send the same shapes to the scalar
    body."""
    text = _build.SOURCES[0].read_text()
    for kernel, body in (("bcsr_spmv_kernel", "block_row_vec<T, R>"),
                         ("bell_spmv_kernel", "block_row_vec<T, R>"),
                         ("bcsr_spmv_rows_kernel", "block_row_scalar<T>"),
                         ("bell_spmv_rows_kernel", "block_row_scalar<T>")):
        start = text.index(f"    {kernel}(")
        assert body in text[start:text.index("\n}\n", start)], kernel
    assert "block_rowptr[r],\n" in text and "block_rowptr[r + 1]" in text
    for launcher in ("launch_bcsr_spmv", "launch_bell_spmv"):
        start = text.index(f"int {launcher}(")
        assert "block_rows_scalar<T>(blocks, x, bm, bn, nv)" in \
            text[start:text.index("\n}\n", start)]


BF16_ENGINES = {"csr": None, "ell": None, "sell": (8, 8), "bcsr": (4, 4),
                "bell": (4, 4)}
BF16_MATS = {"stencil_2d": lambda: RG.stencil_2d(8, seed=1),
             "power_law": lambda: _mat("power_law")}


@pytest.mark.parametrize("engine", sorted(BF16_ENGINES))
@pytest.mark.parametrize("name", sorted(BF16_MATS))
@pytest.mark.parametrize("nv", [1, 3])
def test_bf16_engines_match_the_references_bf16_engines(engine, name, nv):
    """Each of the five engines in bf16 (the plain path on the CPU: values
    and x bf16, f32 sums, y rounded once; csr in bf16 throughout) against
    the reference's engine in bf16 (its Pallas kernels in interpret mode)
    within 0.05 of the scale (tests/test_kernels.py's bf16 tolerance), and
    against the float64 oracle within 0.15 (tests/test_spmv_engines.py's)."""
    from repro.core.spmv.ops import make_engine as ref_make_engine
    from repro_torch.core.sparse.csr import CSRMatrix
    from repro_torch.core.spmv.ops import make_engine

    rm = BF16_MATS[name]()
    pm = CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                   shape=rm.shape)
    kw = {} if BF16_ENGINES[engine] is None else \
        {"block_shape": BF16_ENGINES[engine]}
    x = np.random.default_rng(11).standard_normal((rm.n, nv))
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    ref_op = ref_make_engine(rm, engine, dtype=jnp.bfloat16,
                             use_kernel="interpret", **kw)
    op = make_engine(pm, engine, dtype=torch.bfloat16, device=CPU, **kw)
    xt = torch.as_tensor(xb).to(torch.bfloat16)
    if nv == 1:
        want = ref_op(jnp.asarray(xb[:, 0], jnp.bfloat16))
        got = op(xt[:, 0])
        oracle = rm.spmv(x[:, 0])
    else:
        want = ref_op.matmul(jnp.asarray(xb, jnp.bfloat16))
        got = op.matmul(xt)
        oracle = np.stack([rm.spmv(x[:, j]) for j in range(nv)], axis=1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert _rel(got, np.asarray(want.astype(jnp.float32))) < 0.05
    assert _rel(got, oracle) < 0.15


@pytest.mark.parametrize("engine,attr,shape", [
    ("sell", "chunk_vals", (8, 32)), ("bcsr", "blocks", (8, 16)),
    ("bell", "blocks", (4, 16))])
@pytest.mark.parametrize("kind", ["power_law", "holes"])
def test_float32_formats_hold_the_float64_formats_values(kind, engine, attr,
                                                         shape):
    """A float32 operator's padded format is built from float32 values on
    the host: its device values are the float64 format's, cast once."""
    from repro_torch.core.sparse.bell import to_bcsr, to_block_ell
    from repro_torch.core.sparse.csr import CSRMatrix
    from repro_torch.core.sparse.sell import to_sell
    from repro_torch.core.spmv.ops import make_engine

    rm = _mat(kind)
    mat = CSRMatrix(rowptr=rm.rowptr, cols=rm.cols, vals=rm.vals,
                    shape=rm.shape)
    op = make_engine(mat, engine, block_shape=shape, sell_sigma=64,
                     device=CPU)
    host = {"sell": lambda: to_sell(mat, c=shape[0], sigma=64, w=shape[1]),
            "bcsr": lambda: to_bcsr(mat, *shape),
            "bell": lambda: to_block_ell(mat, *shape)}[engine]()
    want = getattr(host, "chunk_vals" if engine == "sell" else "blocks")
    got = getattr(op, attr)
    assert got.dtype == torch.float32
    if engine == "bcsr":             # the operator adds a block per empty row
        from repro_torch.kernels.bcsr_spmv.ops import pad_empty_rows
        want = pad_empty_rows(host).blocks
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
