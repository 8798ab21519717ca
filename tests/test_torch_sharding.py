"""The port's sharding rules, shape-only state, registry cells, int8
compression and mesh factories against the JAX package on the CPU, in one
process (no mesh devices: the reference's spec functions read only
`mesh.shape`, so a SimpleNamespace stands in for its meshes):

- for the ten archs at full size, init_state_shape (the meta device) has
  every leaf of the reference's jax.eval_shape(init_state): path, shape,
  dtype;
- every parameter leaf's param_spec is the reference's PartitionSpec, and
  validate_specs is the reference's on a (16, 16) and a (2, 16, 16) mesh;
- runnable_cells() is the reference's list, reasons included;
- compress_int8_stochastic's map, fed the reference's uniforms
  (jax.random.split / uniform), is the reference's bit for bit; with its
  own generator its mean over 2,000 draws is within 3 sigma of the input;
- placements on hand-made specs, HardwareSpec's H100 figures, and the
  mesh factories' refusals (no group, a group of the wrong size).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as ref_registry
from repro.distributed import compression as RCOMP
from repro.distributed import sharding as RSH
from repro.training import train_loop as RTL
from repro_torch.configs import registry
from repro_torch.distributed import compression as COMP
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves_with_paths

torch.set_num_threads(1)

ARCHS = sorted(registry.ARCHS)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
INT8_DRAWS = 2000


def _ref_specs(tree):
    """{keystr path: tuple(spec)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _entry(e):
    """A reference spec entry in the port's form (a list of axes becomes a
    tuple)."""
    return tuple(e) if isinstance(e, list) else e


@pytest.fixture(scope="module")
def shapes():
    """{arch: (the reference's eval_shape state, the port's meta state)}."""
    return {a: (RTL.init_state_shape(ref_registry.get(a)),
                TL.init_state_shape(registry.get(a))) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_state_shape_is_the_references(shapes, arch):
    want, got = shapes[arch]
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    want = {jax.tree_util.keystr(p): (tuple(s.shape), np.dtype(s.dtype).name)
            for p, s in flat}
    got_leaves = leaves_with_paths(got)
    assert all(t.device.type == "meta" for _, t in got_leaves)
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in got_leaves}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_references(shapes, arch):
    ref_state, state = shapes[arch]
    want = {p: tuple(_entry(e) for e in s) for p, s in _ref_specs(
        RSH.param_specs(ref_state["params"])).items()}
    got = dict(leaves_with_paths(SH.param_specs(state["params"])))
    assert got == want
    for path, leaf in leaves_with_paths(state["params"]):   # "/" paths too
        assert SH.param_spec(SH.path_str(path), leaf) == want[path]
        assert SH.keystr(SH.path_str(path)) == path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_validate_specs_is_the_references(shapes, arch, mesh):
    ref_state, state = shapes[arch]
    rmesh = types.SimpleNamespace(shape=MESHES[mesh])
    rp = ref_state["params"]
    want = {p: tuple(_entry(e) for e in s) for p, s in _ref_specs(
        RSH.validate_specs(rp, RSH.param_specs(rp), rmesh)).items()}
    params = state["params"]
    got = dict(leaves_with_paths(SH.validate_specs(
        params, SH.param_specs(params), types.SimpleNamespace(
            shape=MESHES[mesh]))))
    assert got == want
    # a rank's blocks tile every dim its spec names
    sizes = MESHES[mesh]
    for path, leaf in leaves_with_paths(params):
        local = SH.local_shape(leaf.shape, got[path], sizes)
        for n, dim, entry in zip(local, leaf.shape, got[path]):
            axes = entry if isinstance(entry, tuple) else (
                () if entry is None else (entry,))
            assert n * int(np.prod([sizes[a] for a in axes])) == dim, path


def test_batch_spec_and_divisible_are_the_references():
    for dp in (("data",), ("pod", "data")):
        assert SH.batch_spec("train", dp) == tuple(RSH.batch_spec("train",
                                                                  dp))
    rmesh = types.SimpleNamespace(shape=MESHES["2x16x16"])
    for n in (1, 16, 32, 48, 512, 1000):
        for axes in (None, "data", ("pod", "data"), ("pod", "data",
                                                      "model")):
            assert SH.divisible(n, rmesh, axes) == RSH.divisible(n, rmesh,
                                                                 axes)


def test_runnable_cells_are_the_references():
    assert registry.runnable_cells() == ref_registry.runnable_cells()


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.standard_normal((7, 5)).astype(np.float32)},
            "a": rng.standard_normal(13).astype(np.float32) * 3e-3,
            "z": np.zeros(4, np.float32)}


def test_int8_map_is_the_references_given_its_uniforms():
    grads = _grads(0)
    key = jax.random.PRNGKey(5)
    want = RCOMP.compress_int8_stochastic(
        jax.tree_util.tree_map(jnp.asarray, grads), key)
    leaves, _ = jax.tree_util.tree_flatten(grads)
    keys = jax.random.split(key, len(leaves))
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    for (path, w), g, k in zip(flat, leaves, keys):
        u = np.asarray(jax.random.uniform(k, g.shape))
        got = COMP.int8_round(torch.from_numpy(g), torch.from_numpy(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_int8_is_unbiased_with_its_own_generator():
    g = torch.from_numpy(_grads(1)["b"]["w"])
    gen = torch.Generator().manual_seed(3)
    draws = torch.stack([COMP.compress_int8_stochastic({"g": g}, gen)["g"]
                         for _ in range(INT8_DRAWS)]).double()
    scale = float(g.abs().max()) / 127.0
    frac = (g.double() / scale) - torch.floor(g.double() / scale)
    sigma = scale * torch.sqrt(frac * (1 - frac) / INT8_DRAWS)
    # each entry's draws take its two neighbouring levels, so the draws'
    # mean over every entry and draw has sigma sqrt(sum sigma_i^2) / n;
    # unbiased, it sits within 3 sigma of the input's mean (always rounding
    # down would sit ~0.5 scale below it, some 300 sigma)
    err = float((draws.mean(0) - g.double()).mean())
    sd = float(torch.sqrt((sigma ** 2).sum()) / g.numel())
    assert abs(err) <= 3 * sd, (err, sd)
    assert set(torch.unique(torch.round(draws / scale)).tolist()) <= set(
        range(-127, 128))


def test_int8_keeps_the_tree():
    grads = {k: torch.from_numpy(v) if not isinstance(v, dict) else
             {"w": torch.from_numpy(v["w"])} for k, v in _grads(2).items()}
    out = COMP.compress_int8_stochastic(grads, torch.Generator())
    assert [p for p, _ in leaves_with_paths(out)] == \
        [p for p, _ in leaves_with_paths(grads)]
    assert torch.equal(out["z"], grads["z"])


@pytest.mark.parametrize("spec, mesh, want", [
    ((), {"data": 2, "model": 2}, ["R", "R"]),
    (("data", "model"), {"data": 2, "model": 2}, ["S0", "S1"]),
    (("model", "data"), {"data": 2, "model": 2}, ["S1", "S0"]),
    ((None, "model"), {"data": 2, "model": 2}, ["R", "S1"]),
    ((("pod", "data"), None), {"pod": 2, "data": 16, "model": 16},
     ["S0", "S0", "R"]),
    (("model", None, "data"), {"pod": 2, "data": 16, "model": 16},
     ["R", "S2", "S0"]),
])
def test_placements(spec, mesh, want):
    got = SH.placements(spec, mesh)
    assert got == [Replicate() if w == "R" else Shard(int(w[1]))
                   for w in want]


def test_placements_refuse_axes_out_of_the_mesh_order():
    with pytest.raises(ValueError, match="order"):
        SH.placements((("data", "pod"),), {"pod": 2, "data": 2})


def test_local_shape_and_dp_axes():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert SH.local_shape((64, 48), (("pod", "data"), "model"), mesh) == \
        (2, 3)
    assert MESH.dp_axes_of(mesh) == ("pod", "data")
    assert MESH.dp_axes_of({"data": 2, "model": 2}) == ("data",)


def test_hardware_spec_is_the_h100s():
    assert MESH.HardwareSpec == {"peak_flops_bf16": 989e12,
                                 "hbm_bw": 3.35e12, "ici_bw": 25e9}


def test_mesh_factories_need_a_group_of_their_size(tmp_path):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="4 ranks"):
        MESH.make_cpu_mesh(2, 2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="256 ranks"):
            MESH.make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="512 ranks"):
            MESH.make_production_mesh(multi_pod=True, device="cpu")
        mesh = MESH.make_cpu_mesh()
        assert SH.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()


def test_make_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MESH.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MESH.make_production_mesh()
