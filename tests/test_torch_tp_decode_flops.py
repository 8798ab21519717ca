"""The flop oracle of the tensor-parallel decode step: the reference's own
serve step, compiled by XLA over host devices, against the port's dry-run
decode cell on a fake process group.

One subprocess imports `repro.launch.dryrun`, which sets
`XLA_FLAGS=--xla_force_host_platform_device_count=512` before jax starts,
and builds plain `jax.sharding.Mesh`es (not `jax.make_mesh`, whose
Explicit axes `with_sharding_constraint` refuses):

- (2, 4) ("data", "model") over 8 of the devices: `repro`'s
  `make_serve_step(mesh=)` jitted with its serving parameter shardings
  (`dryrun._param_shardings`) and the cache's `cache_specs` shardings
  (kv_shard "seq"), at each decoding arch's smoke config, batch 8 and a
  cache of 128 positions, and at qwen2-7b's smoke config with 2 KV heads;
- (16, 16) over 256 of them: `repro.launch.dryrun.lower_cell` for
  qwen2-7b x decode_32k, kv_shard "seq" and "hd", with
  `make_production_mesh` replaced by the plain mesh.

Each is compiled and counted by `repro.launch.hlo_cost.analyze_text`; the
subprocess prints the per-device flops and wire bytes as JSON, which a
module-scoped fixture reads once (about 15 s on a host CPU).

The port's side is `launch.dryrun`'s `build_cell` and `analyze` on a fake
group of 8 (a (2, 4) mesh) or 256 (`lower_cell` on the production mesh).
Cases: each (2, 4) arch within 0.85-1.10x of the reference's flops
(rwkv6-7b counts 1.0357x: its decay LoRA's first product, whose weight is
whole, runs on every "model" rank; the others equal the reference's to
the digit); at (16, 16), kv_shard "seq" within 0.85-1.10x of the
reference's flops (13,646,954,496) and at most its wire bytes; kv_shard
"hd" within 1% of the port's own "seq" flops, at most the reference's hd
flops and at most its wire bytes. Before the decode step split its
matmuls over "model", the port counted 1.27-3.93x the reference's flops
at (2, 4) and 8.77x at (16, 16) seq. And a decode cell whose d_ff does
not divide over "model" raises ValueError naming the weight.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_group, make_mesh

MESH = (2, 4)
DECODE = ShapeConfig("d", 128, 8, "decode")
KV2 = "qwen2-7b-kv2"
ARCHS = tuple(a for a in sorted(registry.ARCHS)
              if not registry.get(a).encoder_only) + (KV2,)
BIG_ARCH, BIG_SHAPE = "qwen2-7b", "decode_32k"
KV_SHARDS = ("seq", "hd")
MOST, LEAST = 1.10, 0.85
HD_OF_SEQ = 0.01                 # hd's flops against seq's, relative

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json
    import numpy as np
    import repro.launch.dryrun as RD     # 512 host devices, before jax
    import jax
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.configs.base import ShapeConfig, smoke_config
    from repro.distributed import sharding as SH
    from repro.launch import hlo_cost, specs
    from repro.serving.decode import make_serve_step
    devs = np.array(jax.devices())
    mesh = Mesh(devs[:%d].reshape(%d, %d), ("data", "model"))
    shape = ShapeConfig("d", %d, %d, "decode")
    out = {}

    def count(text):
        r = hlo_cost.analyze_text(text)
        return {"flops": int(r["flops"]),
                "wire": int(r["collectives"].get("wire", 0))}

    for name in %r:
        arch = name[:-4] if name == %r else name
        cfg = smoke_config(registry.get(arch))
        if name == %r:
            cfg = dataclasses.replace(cfg, kv_heads=2)
        with mesh:
            pshape, psh = RD._param_shardings(cfg, mesh)
            serve = make_serve_step(cfg, mesh=mesh, dp_axes=("data",))
            cache = specs.cache_shape(cfg, shape)
            csh = SH.named_shardings(specs.cache_specs(
                cache, cfg, shape, mesh, ("data",), kv_shard="seq"), mesh)
            batch = specs.batch_specs(cfg, shape, mesh, ("data",))
            fn = jax.jit(serve, in_shardings=(psh, None, csh),
                         out_shardings=(None, csh))
            out[name] = count(fn.lower(pshape, batch, cache)
                              .compile().as_text())
    RD.make_production_mesh = lambda multi_pod=False: Mesh(
        devs[:256].reshape(16, 16), ("data", "model"))
    for kv in %r:
        lowered, _ = RD.lower_cell(%r, %r, False, kv_shard=kv)
        out["16x16/" + kv] = count(lowered.compile().as_text())
    print("REF " + json.dumps(out))
""") % (MESH[0] * MESH[1], *MESH, DECODE.seq_len, DECODE.global_batch,
        ARCHS, KV2, KV2, KV_SHARDS, BIG_ARCH, BIG_SHAPE)


@pytest.fixture(scope="module")
def reference():
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                       capture_output=True, text=True, timeout=900,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu",
                            "HOME": os.environ.get("HOME", "/tmp")})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF ")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(line[0][4:])


def _port_flops(name) -> int:
    cfg = smoke_config(registry.get("qwen2-7b" if name == KV2 else name))
    if name == KV2:
        cfg = dataclasses.replace(cfg, kv_heads=2)
    with fake_group(MESH[0] * MESH[1]):
        mesh = make_mesh(MESH, ("data", "model"), "cpu")
        run, _ = D.build_cell(cfg, DECODE, mesh)
        return D.analyze(run)["walk_flops"]


def _port_big(kv_shard) -> dict:
    with fake_group(256):
        run, _ = D.lower_cell(BIG_ARCH, BIG_SHAPE, False, kv_shard=kv_shard)
        rec = D.analyze(run)
    return {"flops": rec["walk_flops"], "wire": rec["collectives"]["wire"]}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flops_per_rank_are_the_references(reference, arch):
    port, ref = _port_flops(arch), reference[arch]["flops"]
    assert LEAST * ref <= port <= MOST * ref, (arch, port, ref, port / ref)


@pytest.mark.parametrize("kv_shard", KV_SHARDS)
def test_production_decode_cell_is_the_references(reference, kv_shard):
    """qwen2-7b x decode_32k on (16, 16): seq's flops in the band around
    the reference's; hd's equal to seq's within HD_OF_SEQ and at most the
    reference's (its compile re-lays the hd cache out by KV heads, see
    PERF.md); the wire bytes of each at most the reference's."""
    port, ref = _port_big(kv_shard), reference["16x16/" + kv_shard]
    assert port["wire"] <= ref["wire"], (port, ref)
    if kv_shard == "seq":
        assert LEAST * ref["flops"] <= port["flops"] <= MOST * ref["flops"], \
            (port, ref)
    else:
        seq = _port_big("seq")["flops"]
        assert abs(port["flops"] - seq) <= HD_OF_SEQ * seq, (port, seq)
        assert port["flops"] <= ref["flops"], (port, ref)


def test_a_weight_the_decode_group_cannot_split_raises():
    """A d_ff that does not divide over the 4 "model" ranks: param_layout
    keeps the MLP's weights whole over "model", and the decode step names
    the first such weight in a ValueError instead of running it whole."""
    cfg = dataclasses.replace(smoke_config(registry.get("qwen2-7b")),
                              d_ff=258)
    with fake_group(MESH[0] * MESH[1]):
        mesh = make_mesh(MESH, ("data", "model"), "cpu")
        run, _ = D.build_cell(cfg, DECODE, mesh)
        with pytest.raises(ValueError, match=r"mlp/w_\w+/w .* 'model'"):
            run()
