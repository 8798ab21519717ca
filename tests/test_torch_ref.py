"""The port's plain torch oracles (repro_torch/core/spmv/ref.py) against the
JAX package's jnp oracles at float32 (rel 1e-5: same terms, another
summation order) and against the numpy float64 oracle CSRMatrix.spmv at
float64 (rel 1e-12). Both packages get the same host arrays, built by the
JAX package's numpy conversions; the port's conversions are checked to produce
bit-identical arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse.bell import to_bcsr as ref_to_bcsr
from repro.core.sparse.bell import to_block_ell as ref_to_block_ell
from repro.core.sparse.sell import to_sell as ref_to_sell
from repro.core.spmv import ref as jref
from repro.kernels.bcsr_spmv.ops import pad_empty_rows as ref_pad_empty_rows
from repro.matrices import generators as RG
from repro_torch.core.sparse.bell import to_bcsr, to_block_ell
from repro_torch.core.sparse.csr import CSRMatrix
from repro_torch.core.sparse.sell import to_sell
from repro_torch.core.spmv import ref as tref
from repro_torch.kernels.bcsr_spmv.ops import pad_empty_rows
from repro_torch.matrices import generators as TG

torch.set_num_threads(1)

KINDS = ("banded", "power_law", "holes")


def _ref_mat(kind):
    if kind == "banded":
        return RG.banded(96, 4, seed=1)
    if kind == "power_law":
        return RG.power_law(160, alpha=1.9, seed=2)
    rng = np.random.default_rng(3)
    d = rng.standard_normal((120, 100)) * (rng.random((120, 100)) < 0.08)
    d[16:48] = 0.0                       # empty slices and block rows
    d[70] = rng.standard_normal(100)     # one long row (padding)
    from repro.core.sparse.csr import CSRMatrix as RefCSR

    return RefCSR.from_dense(d)


def _port_mat(ref_mat):
    return CSRMatrix(rowptr=ref_mat.rowptr, cols=ref_mat.cols,
                     vals=ref_mat.vals, shape=ref_mat.shape)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-30)


def _x(n, nv, seed=0):
    return np.random.default_rng(seed).standard_normal((n, nv))


def _ell(mat):
    counts = mat.row_nnz()
    k = max(int(counts.max()), 1)
    cols = np.zeros((mat.m, k), np.int32)
    vals = np.zeros((mat.m, k))
    r = np.repeat(np.arange(mat.m), counts)
    j = np.arange(mat.nnz) - np.repeat(mat.rowptr[:-1].astype(np.int64),
                                       counts)
    cols[r, j] = mat.cols
    vals[r, j] = mat.vals
    return cols, vals


@pytest.mark.parametrize("name", ["banded", "stencil_2d", "rmat", "sbm",
                                  "small_world", "kron_graph", "power_law",
                                  "random_uniform", "shuffle"])
def test_generators_bit_identical(name):
    args = {"banded": (64, 3), "stencil_2d": (9,), "rmat": (6, 4),
            "sbm": (64, 4, 0.2, 0.01), "small_world": (64, 4, 0.1),
            "kron_graph": (4, 3), "power_law": (80,),
            "random_uniform": (64, 3)}
    if name == "shuffle":
        a = RG.shuffle(RG.banded(64, 3, seed=1), seed=2)
        b = TG.shuffle(TG.banded(64, 3, seed=1), seed=2)
    else:
        a = getattr(RG, name)(*args[name], seed=5)
        b = getattr(TG, name)(*args[name], seed=5)
    for f in ("rowptr", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["sell", "bcsr", "bell"])
def test_host_formats_bit_identical(kind, fmt):
    rm = _ref_mat(kind)
    pm = _port_mat(rm)
    if fmt == "sell":
        a, b = ref_to_sell(rm, c=8, sigma=16, w=8), to_sell(pm, 8, 16, 8)
        fields = ("chunk_cols", "chunk_vals", "chunk_slice", "slice_width",
                  "row_perm", "inv_perm")
    elif fmt == "bcsr":
        a = ref_pad_empty_rows(ref_to_bcsr(rm, 8, 16))
        b = pad_empty_rows(to_bcsr(pm, 8, 16))
        fields = ("blocks", "block_rows", "block_cols", "block_rowptr")
    else:
        a, b = ref_to_block_ell(rm, 8, 16), to_block_ell(pm, 8, 16)
        fields = ("blocks", "block_cols", "nblocks")
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nv", [1, 3])
def test_csr_ell_dense_oracles(kind, nv):
    rm = _ref_mat(kind)
    x = _x(rm.n, nv)
    row_ids = np.repeat(np.arange(rm.m, dtype=np.int32), rm.row_nnz())
    ecols, evals = _ell(rm)
    xv = x[:, 0] if nv == 1 else x
    want64 = np.stack([rm.spmv(x[:, j]) for j in range(nv)], 1)
    want64 = want64[:, 0] if nv == 1 else want64
    jx = jnp.asarray(xv, jnp.float32)
    cases = {
        "csr": ((jref.spmv_csr if nv == 1 else jref.spmm_csr)(
                    jnp.asarray(row_ids), jnp.asarray(rm.cols),
                    jnp.asarray(rm.vals, jnp.float32), jx, rm.m),
                lambda dt: tref.spmv_csr(
                    torch.as_tensor(row_ids), torch.as_tensor(rm.cols),
                    torch.as_tensor(rm.vals).to(dt),
                    torch.as_tensor(xv).to(dt), rm.m)),
        "ell": ((jref.spmv_ell if nv == 1 else jref.spmm_ell)(
                    jnp.asarray(ecols), jnp.asarray(evals, jnp.float32), jx),
                lambda dt: tref.spmv_ell(
                    torch.as_tensor(ecols), torch.as_tensor(evals).to(dt),
                    torch.as_tensor(xv).to(dt))),
        "dense": (jref.spmv_dense(jnp.asarray(rm.to_dense(), jnp.float32),
                                  jx),
                  lambda dt: tref.spmv_dense(
                      torch.as_tensor(rm.to_dense()).to(dt),
                      torch.as_tensor(xv).to(dt))),
    }
    for name, (jax_y, port) in cases.items():
        assert _rel(port(torch.float32), jax_y) < 1e-5, name
        assert _rel(port(torch.float64), want64) < 1e-12, name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nv", [1, 4])
def test_sell_oracle(kind, nv):
    rm = _ref_mat(kind)
    host = ref_to_sell(rm, c=8, sigma=rm.m, w=8)
    x = _x(rm.n, nv)
    jax_y = jref.spmv_sell(jnp.asarray(host.chunk_vals, jnp.float32),
                           jnp.asarray(host.chunk_cols),
                           jnp.asarray(host.chunk_slice),
                           jnp.asarray(x, jnp.float32), host.num_slices)

    def port(dt):
        return tref.spmv_sell(torch.as_tensor(host.chunk_vals).to(dt),
                              torch.as_tensor(host.chunk_cols),
                              torch.as_tensor(host.chunk_slice),
                              torch.as_tensor(x).to(dt), host.num_slices)

    assert _rel(port(torch.float32), jax_y) < 1e-5
    y = port(torch.float64).reshape(-1, nv)[torch.as_tensor(host.inv_perm)]
    want = np.stack([rm.spmv(x[:, j]) for j in range(nv)], 1)
    assert _rel(y, want) < 1e-12


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fmt", ["bcsr", "bell"])
@pytest.mark.parametrize("bm,bn", [(8, 16), (4, 4)])
def test_block_oracles(kind, fmt, bm, bn):
    rm = _ref_mat(kind)
    nv = 2
    ncb = (rm.n + bn - 1) // bn
    x = _x(rm.n, nv)
    x2d = np.zeros((ncb * bn, nv))
    x2d[: rm.n] = x
    x2d = x2d.reshape(ncb, bn, nv)
    if fmt == "bcsr":
        h = ref_pad_empty_rows(ref_to_bcsr(rm, bm, bn))
        jax_y = jref.spmv_bcsr(jnp.asarray(h.blocks, jnp.float32),
                               jnp.asarray(h.block_rows),
                               jnp.asarray(h.block_cols),
                               jnp.asarray(x2d, jnp.float32),
                               h.num_block_rows)

        def port(dt):
            return tref.spmv_bcsr(torch.as_tensor(h.blocks).to(dt),
                                  torch.as_tensor(h.block_rows),
                                  torch.as_tensor(h.block_cols),
                                  torch.as_tensor(x2d).to(dt),
                                  h.num_block_rows)
    else:
        h = ref_to_block_ell(rm, bm, bn)
        jax_y = jref.spmv_bell(jnp.asarray(h.blocks, jnp.float32),
                               jnp.asarray(h.block_cols),
                               jnp.asarray(x2d, jnp.float32))

        def port(dt):
            return tref.spmv_bell(torch.as_tensor(h.blocks).to(dt),
                                  torch.as_tensor(h.block_cols),
                                  torch.as_tensor(x2d).to(dt))

    assert _rel(port(torch.float32), jax_y) < 1e-5
    y = port(torch.float64).reshape(-1, nv)[: rm.m]
    want = np.stack([rm.spmv(x[:, j]) for j in range(nv)], 1)
    assert _rel(y, want) < 1e-12


BF16_CSR_MATS = {
    "stencil_2d": lambda: RG.stencil_2d(8, seed=1),
    "random_uniform": lambda: RG.random_uniform(4096, 12, seed=0),
    "banded": lambda: RG.banded(4096, 15, seed=0),
}


@pytest.mark.parametrize("name", sorted(BF16_CSR_MATS))
@pytest.mark.parametrize("nv", [1, 3])
def test_bf16_csr_oracle_is_the_references_bit_for_bit(name, nv):
    """In bf16 the CSR oracle multiplies and segment-sums in bf16, as the
    reference's does, and agrees with it bit for bit (spmv_csr at nv = 1,
    spmm_csr at nv = 3); the other types keep their >= f32 sums."""
    rm = BF16_CSR_MATS[name]()
    rows = np.repeat(np.arange(rm.m, dtype=np.int32), rm.row_nnz())
    x = _x(rm.n, nv, seed=7).astype(np.float32)
    if nv == 1:
        x = x[:, 0]
    fn = jref.spmv_csr if nv == 1 else jref.spmm_csr
    want = fn(jnp.asarray(rows), jnp.asarray(rm.cols),
              jnp.asarray(rm.vals, jnp.bfloat16),
              jnp.asarray(x, jnp.bfloat16), rm.m)
    got = tref.spmv_csr(torch.as_tensor(rows), torch.as_tensor(rm.cols),
                        torch.as_tensor(rm.vals).to(torch.bfloat16),
                        torch.as_tensor(x).to(torch.bfloat16), rm.m)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
