"""The one known jax deprecation in the reference package, taken once in
every pytest process at collection.

`repro/core/spmv/distributed.py` imports `jax.experimental.shard_map`; it
was written for jax 0.4.37, and later jax deprecates that name and warns
once per process (the module `__getattr__` that warns is cached).
`tests/test_distributed_spmv.py::test_no_in_src_shim_callers` runs the
facade with DeprecationWarning promoted to an error, so its outcome hung on
whether an earlier file in the same pytest process had taken that import,
that is on how pytest-xdist spread the files over its workers. Every worker
collects this file, so importing the name here takes that one warning
before any test runs; any other deprecated call on the facade path still
fails that test. ROADMAP.md queue C records the deprecation itself.
"""
import subprocess
import sys
import warnings

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    try:
        from jax.experimental.shard_map import shard_map  # noqa: F401
    except (ImportError, AttributeError):
        pass


def test_shard_map_name_still_deprecated():
    """Pins why the import above is here: in a fresh process, with
    DeprecationWarning as an error, this jax refuses the name the reference
    imports. Once it no longer does, the import above can go."""
    proc = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning", "-c",
         "from jax.experimental.shard_map import shard_map"],
        capture_output=True, text=True, timeout=120,
        env={"JAX_PLATFORMS": "cpu", "PATH": ""})
    assert proc.returncode != 0
    assert "DeprecationWarning: jax.experimental.shard_map is deprecated" \
        in proc.stderr
