"""The port's launch.specs against the reference's, on the CPU with no
process group: the production meshes (16, 16) ("data", "model") and
(2, 16, 16) ("pod", "data", "model") as axis sizes by name on the port's
side and as a jax AbstractMesh of the same sizes on the reference's (its
`batch_specs` builds NamedShardings, which want a mesh; its `cache_specs`
reads only `mesh.shape`).

- cache_specs: every leaf of the cache of the nine decoding archs, at
  decode_32k and long_500k, on both meshes (dp axes ("data",) and ("pod",
  "data")), for kv_shard "seq" and "hd": the port's spec equals the
  reference's PartitionSpec entry for entry;
- cache_shape: the port's meta tensors have the reference's eval_shape
  leaf for leaf (shape and dtype; `len`, a list of ints per layer here,
  has the shape of the reference's int32 array);
- batch_specs: every input of the ten archs at the four shapes, on both
  meshes: shape, dtype and spec equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs as SP

ARCHS = tuple(sorted(registry.ARCHS))
DECODING = tuple(a for a in ARCHS if not registry.get(a).encoder_only)
MESHES = {"16x16": ({"data": 16, "model": 16}, ("data",)),
          "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data"))}
DECODE_SHAPES = ("decode_32k", "long_500k")


def _ref():
    from jax.sharding import AbstractMesh

    from repro.configs import registry as ref_registry
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.launch import specs as ref_specs

    def mesh(sizes):
        return AbstractMesh(tuple(sizes.values()), tuple(sizes))

    return ref_registry, REF_SHAPES, ref_specs, mesh


def _flat(tree, prefix=""):
    """{path: leaf} of a dict tree (PartitionSpecs, ShapeDtypeStructs,
    tensors and lists are leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _spec(p):
    return None if p is None else tuple(p)


@pytest.mark.parametrize("kv", ("seq", "hd"))
@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("arch", DECODING)
def test_cache_specs_are_the_references(arch, shape, mesh, kv):
    ref_registry, ref_shapes, ref_specs, ref_mesh = _ref()
    sizes, dp = MESHES[mesh]
    rcfg = ref_registry.get(arch)
    want = ref_specs.cache_specs(
        ref_specs.cache_shape(rcfg, ref_shapes[shape]), rcfg,
        ref_shapes[shape], ref_mesh(sizes), dp, kv_shard=kv)
    cfg = registry.get(arch)
    got = SP.cache_specs(SP.cache_shape(cfg, SHAPES[shape]), cfg,
                         SHAPES[shape], sizes, dp, kv_shard=kv)
    want, got = _flat(want), _flat(got)
    assert sorted(got) == sorted(want)
    assert {k: _spec(v) for k, v in want.items()} == got


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("arch", DECODING)
def test_cache_shape_is_the_references(arch, shape):
    ref_registry, ref_shapes, ref_specs, _ = _ref()
    want = _flat(ref_specs.cache_shape(ref_registry.get(arch),
                                       ref_shapes[shape]))
    got = _flat(SP.cache_shape(registry.get(arch), SHAPES[shape]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
        elif path.endswith("len"):
            assert np.shape(g) == w.shape and not np.any(g), path
            assert str(w.dtype) == "int32", path
        else:
            assert g.device.type == "meta", path
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("shape", tuple(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_are_the_references(arch, shape, mesh):
    ref_registry, ref_shapes, ref_specs, ref_mesh = _ref()
    sizes, dp = MESHES[mesh]
    want = ref_specs.batch_specs(ref_registry.get(arch), ref_shapes[shape],
                                 ref_mesh(sizes), dp)
    got = SP.batch_specs(registry.get(arch), SHAPES[shape], sizes, dp)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        assert g.spec == tuple(w.sharding.spec), name


@pytest.mark.parametrize("shape,want", (
    ("decode_32k", (None, "data", "model", None, None)),
    ("long_500k", (None, None, ("data", "model"), None, None))))
def test_qwen2_kv_specs(shape, want):
    """Two cases written out: the KV cache of qwen2-7b on
    (16, 16) splits its batch over "data" and its positions over "model"
    at decode_32k, and its positions over both at batch 1."""
    cfg = registry.get("qwen2-7b")
    spec = SP.cache_specs(SP.cache_shape(cfg, SHAPES[shape]), cfg,
                          SHAPES[shape], MESHES["16x16"][0], ("data",))
    assert spec["k"] == spec["v"] == want
    assert spec["len"] == ()


def test_cache_shape_allocates_nothing():
    cfg = registry.get("qwen2-7b")
    cache = SP.cache_shape(cfg, SHAPES["long_500k"], torch.float32)
    assert cache["k"].device.type == "meta"
    assert cache["k"].shape == (28, 1, 524288, 4, 128)
    assert cache["k"].dtype == torch.float32


def test_batch_specs_without_a_mesh_have_no_spec():
    got = SP.batch_specs(registry.get("hubert-xlarge"), SHAPES["train_4k"],
                         None, ("data",))
    assert {k: v.spec for k, v in got.items()} == {"embeds": None,
                                                   "labels": None}


def test_an_unknown_kv_shard_raises():
    cfg = registry.get("qwen2-7b")
    with pytest.raises(ValueError, match="kv_shard"):
        SP.cache_specs(SP.cache_shape(cfg, SHAPES["decode_32k"]), cfg,
                       SHAPES["decode_32k"], MESHES["16x16"][0], ("data",),
                       kv_shard="heads")
