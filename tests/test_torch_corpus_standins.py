"""The stand-ins of the three largest non-fixture corpus entries
(webbase-1M, thermal2, amazon0601: 0.4-1.2 M rows, 3.7-9.4 M nnz) against
the JAX package's on the CPU, compared whole, bit for bit. They take
seconds each per package, so they have a file of their own.
"""
import numpy as np
import pytest

from repro.corpus import manifest as rmanifest
from repro_torch.corpus import manifest


@pytest.mark.parametrize("name", ["webbase-1M", "thermal2", "amazon0601"])
def test_largest_standins_are_the_references(name):
    entry, rentry = manifest.get_entry(name), rmanifest.get_entry(name)
    assert manifest._standin_key(entry) == rmanifest._standin_key(rentry)
    got = manifest.standin(entry)
    want = rmanifest.standin(rentry)
    assert got.shape == want.shape == (entry.m, entry.n)
    for f in ("rowptr", "cols", "vals"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)
