"""K5 ssd_chunk and ssd_scan: the port's wrapper on CPU tensors (which takes
the plain torch version) against the JAX package's Pallas kernel in
interpret mode, its jnp oracle and the model's own `_ssd_chunked`, on the
same numpy inputs. Float32 within 1e-5 of the largest entry (same terms,
another summation order); bf16 within 1e-2 (both round y and the state to
bf16 once, from f32 arithmetic). The CUDA kernel itself runs only on the
card (chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.kernel import ssd_chunk as pallas_ssd_chunk
from repro.kernels.ssd_chunk.ops import ssd_scan as ref_ssd_scan
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro.models.layers.mamba2 import _ssd_chunked as ref_ssd_chunked
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.kernel import (SMEM_LIMIT, check_sequence,
                                                  smem_bytes, ssd_chunk,
                                                  ssd_chunk_plain,
                                                  ssd_sequence,
                                                  tensor_core_shape)
from repro_torch.kernels.ssd_chunk.ops import ssd_scan
from repro_torch.models.layers.mamba2 import _ssd_chunked

torch.set_num_threads(1)

SHAPES = [(2, 16, 3, 8, 8), (1, 32, 2, 16, 8), (2, 8, 4, 4, 16),
          (1, 128, 2, 64, 64)]


def _inputs(b, t, h, n, p, seed=0):
    """la, xw, b, c, state as numpy f32, drawn as test_ssd_kernel.py does."""
    rng = np.random.default_rng(seed)
    la = -rng.uniform(0.001, 0.2, (b, t, h)).astype(np.float32)
    xw = rng.standard_normal((b, t, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    st = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return la, xw, bm, cm, st


def _jax(args, dtype=jnp.float32):
    la, *rest = args
    return (jnp.asarray(la),) + tuple(jnp.asarray(a, dtype) for a in rest)


def _torch(args, dtype=torch.float32):
    la, *rest = args
    return (torch.as_tensor(la),) + tuple(torch.as_tensor(a).to(dtype)
                                          for a in rest)


def _rel(got, want):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32), np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


@pytest.mark.parametrize("b,t,h,n,p", SHAPES)
def test_chunk_matches_pallas_interpret_and_ref(b, t, h, n, p):
    args = _inputs(b, t, h, n, p)
    y_k, s_k = pallas_ssd_chunk(*_jax(args), interpret=True)
    y_r, s_r = ssd_chunk_ref(*_jax(args))
    y, s = ssd_chunk(*_torch(args))
    assert y.dtype == torch.float32 and s.shape == (b, h, n, p)
    for got, want in ((y, y_k), (s, s_k), (y, y_r), (s, s_r)):
        assert _rel(got, want) <= 1e-5


def test_chunk_bf16_matches_pallas_interpret():
    args = _inputs(2, 16, 3, 8, 8, seed=2)
    y_k, s_k = pallas_ssd_chunk(*_jax(args, jnp.bfloat16), interpret=True)
    y, s = ssd_chunk(*_torch(args, torch.bfloat16))
    assert y.dtype == s.dtype == torch.bfloat16
    assert _rel(y, y_k) <= 1e-2 and _rel(s, s_k) <= 1e-2


def test_chunk_writes_into_out_and_counts_no_launch_on_cpu():
    args = _torch(_inputs(2, 16, 3, 8, 8, seed=3))
    before = dict(kernels.LAUNCHES)
    out = torch.full_like(args[1], float("nan"))
    y, s = ssd_chunk(*args, out=out)
    y_p, s_p = ssd_chunk_plain(*args)
    assert y is out and torch.equal(out, y_p) and torch.equal(s, s_p)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_pallas_scan(dtype):
    b, s, h, n, p, chunk = 2, 64, 3, 8, 8, 16
    args = _inputs(b, s, h, n, p, seed=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y_k, s_k = ref_ssd_scan(*_jax(args, jdt), chunk=chunk,
                            use_kernel="interpret")
    y, st = ssd_scan(*_torch(args, tdt), chunk=chunk)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(y, y_k) <= tol and _rel(st, s_k) <= tol


def test_scan_and_ssd_chunked_match_the_model_ssd():
    """The port's ssd_scan (and _ssd_chunked, which prepares la and xw as
    the model does) against the reference model's _ssd_chunked, at the
    2e-3 that tests/test_ssd_kernel.py holds the Pallas scan to."""
    b, s, h, n, p, chunk = 2, 64, 2, 8, 8, 16
    rng = np.random.default_rng(1)
    a_log = rng.uniform(-1, 1, (h,)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    y_m, s_m = ref_ssd_chunked(*map(jnp.asarray, (xh, dt, a_log, bm, cm)),
                               chunk)
    t = [torch.as_tensor(a) for a in (xh, dt, a_log, bm, cm)]
    la = -torch.exp(t[2]) * t[1]
    xw = t[0] * t[1][..., None]
    y_s, s_s = ssd_scan(la, xw, t[3], t[4], torch.zeros(b, h, n, p),
                        chunk=chunk)
    y_c, s_c = _ssd_chunked(*t, chunk)
    for got, want in ((y_s, y_m), (s_s, s_m), (y_c, y_m), (s_c, s_m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)
    assert torch.equal(y_s, y_c) and torch.equal(s_s, s_c)


def test_scan_kernel_choice():
    args = _torch(_inputs(1, 32, 2, 4, 4, seed=5))
    y_a, s_a = ssd_scan(*args, chunk=16)
    y_r, s_r = ssd_scan(*args, chunk=16, use_kernel="ref")
    assert torch.equal(y_a, y_r) and torch.equal(s_a, s_r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(*args, chunk=16, use_kernel="cuda")
    with pytest.raises(ValueError, match="use_kernel"):
        ssd_scan(*args, chunk=16, use_kernel="pallas")
    with pytest.raises(ValueError, match="divide"):
        ssd_scan(*args, chunk=24)


def test_build_table_types_and_sources():
    """K5's sequence launcher is built into the one library beside K1-K4's:
    seven pointers (la, xw, b, c, state, y, state out) and ten integers
    (B, S, T, H, N, P and four batch strides); it takes f32 and bf16 (la
    always f32), and the per-chunk launcher is gone. K1-K4 still take f32
    and f64 only."""
    assert [p.name for p in _build.SOURCES] == ["spmv_kernels.cu",
                                                "ssd_chunk.cu"]
    assert all(p.exists() for p in _build.SOURCES)
    assert _build.KERNELS["ssd_scan"][:2] == (7, 10)
    assert "ssd_chunk" not in _build.KERNELS
    src = _build.SOURCES[1].read_text()
    assert 'extern "C" int ssd_scan_f32(' in src
    assert 'extern "C" int ssd_scan_bf16(' in src
    cpu = torch.device("cpu")
    x = torch.zeros(4, 3, dtype=torch.bfloat16)
    la = torch.zeros(4, 3)
    _build.check("ssd_scan", torch.bfloat16, cpu, la_f32=la, xw=x)
    with pytest.raises(TypeError, match="la_f32 is torch.bfloat16"):
        _build.check("ssd_scan", torch.bfloat16, cpu, la_f32=x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _build.check("ssd_scan", torch.float64, cpu, xw=x.double())
    for name in ("sell_spmv", "sell_spmm", "bcsr_spmv", "bell_spmv"):
        with pytest.raises(TypeError, match="float32 or float64"):
            _build.check(name, torch.bfloat16, cpu, x=x)


def test_check_takes_batch_strided_views_only_where_asked():
    cpu = torch.device("cpu")
    full = torch.zeros(2, 64, 3)
    view = full[:, 16:32]
    _build.check("ssd_scan", torch.float32, cpu, batch_strided=("xw",),
                 xw=view)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check("ssd_scan", torch.float32, cpu, xw=view)
    with pytest.raises(ValueError, match="past its first dim"):
        _build.check("ssd_scan", torch.float32, cpu, batch_strided=("xw",),
                     xw=full[:, :, :2])


def test_shared_memory_sizing():
    """The main-path chunk (T = 128, N = P = 64) fits one block's 227 KB in
    both tensor-core bodies, and two blocks fit an SM's 228 KB with 1 KB
    reserved for each: bf16 stages C, B and xw twice as bf16 rows of 64,
    the state, two cumsums and the decays (108,032 B); f32 stages C, B and
    xw once as f32 rows, the state, the cumsum and the decays (115,712 B).
    The CUDA-core body keeps its f32 layout (182,272 B at that shape). T =
    256 fits no body, and the wrapper says so before any launch."""
    for dtype, size in ((torch.bfloat16, 108032), (torch.float32, 115712)):
        assert tensor_core_shape(128, 64, 64, dtype)
        assert smem_bytes(128, 64, 64, dtype) == size
        assert 2 * (size + 1024) <= 233472           # 228 KB per SM
        assert smem_bytes(256, 64, 64, dtype) > SMEM_LIMIT
    assert smem_bytes(128, 64, 32) == 4 * (128 + 2 * 128 * 65 + 128 * 32
                                           + 64 * 32 + 128 * 129)
    assert smem_bytes(128, 64, 48) <= SMEM_LIMIT
    # shapes no tensor-core body takes use the CUDA-core layout
    for t, n, p in ((8, 4, 16), (128, 16, 32), (144, 64, 64), (24, 64, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            assert not tensor_core_shape(t, n, p, dtype)
        assert smem_bytes(t, n, p, torch.bfloat16) == smem_bytes(t, n, p)
    assert not tensor_core_shape(128, 64, 64, torch.float64)


def _seq(b=2, s=48, h=3, n=8, p=8, dtype=torch.float32, seed=6):
    return list(_torch(_inputs(b, s, h, n, p, seed=seed), dtype))


def test_sequence_refuses_bad_operands_before_any_launch():
    """The sequence wrapper checks shapes, S against the chunk, types and
    strides before it launches (or, on the CPU, runs the plain version)."""
    la, xw, b, c, st = _seq()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="does not divide by chunk 32"):
        ssd_sequence(la, xw, b, c, st, 32)
    with pytest.raises(ValueError, match="state must be"):
        ssd_sequence(la, xw, b, c, st[:, :2], 16)
    with pytest.raises(ValueError, match="xw must be"):
        ssd_sequence(la, xw[:, :, :2], b, c, st, 16)
    with pytest.raises(ValueError, match="c_mat must be"):
        ssd_sequence(la, xw, b, c[:, :16], st, 16)
    with pytest.raises(ValueError, match="out must be"):
        check_sequence(la, xw, b, c, st, 16, out=xw[:, :16])
    with pytest.raises(ValueError, match="shared memory"):
        ssd_sequence(*_seq(1, 512, 1, 64, 64), 256)
    with pytest.raises(ValueError, match="share a batch stride"):
        check_sequence(la, xw, b, torch.cat([c, c], 1)[:, :48], st, 16)
    with pytest.raises(ValueError, match="contiguous past its first dim"):
        check_sequence(la, xw.transpose(2, 3).contiguous().transpose(2, 3),
                       b, c, st, 16)
    with pytest.raises(ValueError, match="state must be contiguous"):
        check_sequence(la, xw, b, c, st.transpose(2, 3).contiguous()
                       .transpose(2, 3), 16)
    with pytest.raises(TypeError, match="la_f32 is torch.bfloat16"):
        check_sequence(la.bfloat16(), xw, b, c, st, 16)
    with pytest.raises(TypeError, match="b is torch.bfloat16"):
        check_sequence(la, xw, b.bfloat16(), c, st, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check_sequence(la, *(a.double() for a in (xw, b, c, st)), 16)
    assert kernels.LAUNCHES == before
    # chunks as batch-strided views of a longer sequence are accepted
    check_sequence(*(a[:, 16:32] for a in (la, xw, b, c)), st, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sequence_on_cpu_is_the_plain_scan(dtype):
    args = _seq(dtype=getattr(torch, dtype))
    before = dict(kernels.LAUNCHES)
    y, s = ssd_sequence(*args, 16)
    y_r, s_r = ssd_scan(*args, chunk=16, use_kernel="ref")
    assert torch.equal(y, y_r) and torch.equal(s, s_r)
    out = torch.full_like(args[1], float("nan"))
    y_o, _ = ssd_sequence(*args, 16, out=out)
    assert y_o is out and torch.equal(out, y_r)
    # one chunk is the S = T case of the same function
    y1, s1 = ssd_sequence(*(a[:, :16] for a in args[:4]), args[4], 16)
    y1_r, s1_r = ssd_chunk_plain(*(a[:, :16] for a in args[:4]), args[4])
    assert torch.equal(y1, y1_r) and torch.equal(s1, s1_r)
    assert kernels.LAUNCHES == before


def test_plain_scan_bf16_rounds_the_state_as_the_reference():
    """ssd_scan(use_kernel="ref") in bf16 over 3 chunks with a nonzero
    incoming state against the reference's ssd_scan over the Pallas chunk
    in interpret mode: both round the carried state to bf16 at each chunk
    boundary, which the CUDA kernel reproduces. Within 1e-2 of the largest
    entry (bf16); a chain that carries the state in f32 instead is a
    different function, and its final state differs from the rounded
    chain's."""
    b, s, h, n, p, chunk = 2, 48, 3, 8, 16, 16
    args = _inputs(b, s, h, n, p, seed=7)
    y_k, s_k = ref_ssd_scan(*_jax(args, jnp.bfloat16), chunk=chunk,
                            use_kernel="interpret")
    targs = _torch(args, torch.bfloat16)
    y, st = ssd_scan(*targs, chunk=chunk, use_kernel="ref")
    assert y.dtype == st.dtype == torch.bfloat16
    assert _rel(y, y_k) <= 1e-2 and _rel(st, s_k) <= 1e-2
    # the same chain with the state kept in f32 between chunks
    la, xw, bm, cm, st0 = targs
    carry = st0.float()
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        _, carry = ssd_chunk_plain(la[:, sl], xw[:, sl], bm[:, sl],
                                   cm[:, sl], carry)
    assert not torch.equal(carry.bfloat16(), st)
