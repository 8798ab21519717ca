"""MatrixMarket I/O so real SuiteSparse .mtx files drop in when available.

`read_mtx` is a thin veneer over the corpus streaming parser
(`repro_torch.corpus.mtxstream`): chunked two-pass ingestion with peak
parser memory bounded by the chunk size, `real`/`integer`/`pattern` fields,
`general`/`symmetric` symmetry, and clear rejection of `complex`/
`hermitian`/`skew-symmetric` files. For cached, content-addressed
ingestion use `repro_torch.corpus.ingest_path`: it wraps the same parser
behind the `.csrz` artifact store so a file is parsed once.

`write_mtx` batches formatting through np.savetxt and emits the `%.17g`
general/real encoding, so round-trips are value-exact. The port's own copy
of the JAX package's module.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.sparse.csr import CSRMatrix
from ..corpus import mtxstream


def read_mtx(path: str, chunk_nnz: Optional[int] = None) -> CSRMatrix:
    """Parse a MatrixMarket coordinate file into CSR (streaming)."""
    return mtxstream.read_mtx(path, chunk_nnz=chunk_nnz)


def write_mtx(path: str, mat: CSRMatrix) -> None:
    r = np.repeat(np.arange(1, mat.m + 1, dtype=np.int64), mat.row_nnz())
    c = mat.cols.astype(np.int64) + 1
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{mat.m} {mat.n} {mat.nnz}\n")
        np.savetxt(f, np.column_stack([r, c, mat.vals]),
                   fmt=("%d", "%d", "%.17g"))
