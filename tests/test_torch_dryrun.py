"""The port's dry-run (`launch/dryrun.py`) on fake process groups: the
counterpart of `tests/test_dryrun_small.py`, which is red in the
reference (its multi-device subprocess), so the oracle is the port's own.

- qwen2-7b's smoke config on a (2, 4) fake mesh: a train cell counts
  flops and collectives, and decode cells run for both kv_shards;
- the train cell's flops per rank are a quarter (0.99/4 to 1.10/4) of
  those of the port's single-device train step on that rank's dp rows:
  the mesh step splits each layer's matmuls and attention over the 4
  "model" ranks, as the reference's SPMD program does (the counter reads
  matmul and attention flops only, which a full split divides by 4);
- decode: under kv_shard "hd" an all-reduce carries more than one token's
  activations (the partial q.k scores over the rank's positions), under
  "seq" none does;
- a record written by `run_cell` at full size (minicpm-2b x decode_32k on
  (16, 16)) carries the reference's keys, a failing cell is an "error"
  record with its traceback, and `main` exits 1 on it;
- `--weight-stationary` drops "data" from the parameter specs, so the
  step gathers no weight over "data";
- every cell of `registry.runnable_cells()` is the reference's and is
  named as the reference names its records.
"""
import json

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, ShapeConfig, smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.models import model as MDL
from repro_torch.training import optimizer as OPT
from repro_torch.training import train_loop as TL

CFG = smoke_config(registry.get("qwen2-7b"))
TRAIN = ShapeConfig("t", 64, 8, "train")
DECODE = ShapeConfig("d", 128, 8, "decode")
MB = 2


def _cell(shape, **kw):
    """(record, all-reduce events) of one cell on a (2, 4) fake mesh."""
    with fake_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        run, meta = D.build_cell(CFG, shape, mesh, **kw)
        with HC._Counter() as events:       # beside the record's own
            rec = {**meta, **D.analyze(run)}
    return rec, [e for e in events.events if e[0] == "all-reduce"]


def test_small_mesh_train_cell_counts_flops_and_collectives():
    rec, _ = _cell(TRAIN, microbatches=MB)
    assert rec["kind"] == "train"
    assert rec["walk_flops"] > 0 and rec["walk_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["collectives"]["all-gather_count"] > 0
    assert rec["collectives"]["reduce-scatter_count"] > 0
    assert rec["argument_size_in_bytes"] > 0
    assert rec["output_size_in_bytes"] > 0


def test_train_flops_per_rank_are_a_model_share_of_the_step_on_its_rows():
    rec, _ = _cell(TRAIN, microbatches=MB)
    step, _, _ = TL.make_train_step(CFG, OPT.OptConfig(), microbatches=MB,
                                    device="cpu")
    state = TL.init_state_shape(CFG)
    rows = TRAIN.global_batch // 2               # the rank's dp rows
    batch = {"tokens": torch.empty((rows, TRAIN.seq_len), dtype=torch.int32,
                                   device="meta")}
    one = HC.analyze(step, state, batch)
    model = 4                                    # the mesh's "model" axis
    share = rec["walk_flops"] * model / one["flops"]
    assert 0.99 <= share <= 1.10, (rec["walk_flops"], one["flops"])


@pytest.mark.parametrize("kv_shard", ["seq", "hd"])
def test_decode_cells_and_the_one_token_rule(kv_shard):
    rec, all_reduces = _cell(DECODE, kv_shard=kv_shard)
    assert rec["kind"] == "decode" and rec["walk_flops"] > 0
    assert rec["collectives"]["all-gather_count"] > 0
    token = DECODE.global_batch // 2 * CFG.d_model * 4   # f32, rank's rows
    biggest = max(size for _, size, _ in all_reduces)
    if kv_shard == "hd":
        assert biggest > token
    else:
        assert biggest <= token


def test_weight_stationary_gathers_no_weight_over_data():
    """Under the serving layout a rank holds 1/16 of each weight over
    "data"; weight-stationary holds it whole over "data", so its
    all-gathers move (data - 1) / data less."""
    base, _ = _cell(DECODE)
    ws, _ = _cell(DECODE, weight_stationary=True)
    assert ws["argument_size_in_bytes"] > base["argument_size_in_bytes"]
    assert ws["collectives"]["all-gather"] < base["collectives"]["all-gather"]
    layout = MDL.param_layout(CFG, {"data": 2, "model": 4}, True)
    assert "data" not in json.dumps(layout)


REF_KEYS = {"arch", "shape", "mesh", "kind", "params", "active_params",
            "lower_s", "walk_flops", "walk_bytes", "collectives", "op_hist",
            "status"}


def test_run_cell_writes_the_references_record(tmp_path):
    rec = D.run_cell("minicpm-2b", "decode_32k", False, out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("traceback")
    on_disk = json.loads(
        (tmp_path / "minicpm-2b__decode_32k__16x16.json").read_text())
    assert on_disk == rec
    assert REF_KEYS <= set(rec)
    assert {"argument_size_in_bytes", "output_size_in_bytes"} <= set(rec)
    assert "temp_size_in_bytes" not in rec and "compile_s" not in rec
    assert rec["mesh"] == "16x16" and rec["kv_shard"] == "seq"
    assert rec["collectives"]["total"] > 0
    assert rec["op_hist"]["c10d._allgather_base_"] > 0


def test_a_failing_cell_is_an_error_record_and_main_exits_1(tmp_path,
                                                            capsys):
    rec = D.run_cell("no-such-arch", "decode_32k", True, out_dir=tmp_path)
    assert rec["status"] == "error" and "KeyError" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert (tmp_path / "no-such-arch__decode_32k__2x16x16.json").exists()
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                "--out", str(tmp_path)])
    assert e.value.code == 1
    assert "error" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        D.main([])
    assert e.value.code == 2


def test_runnable_cells_are_named_as_the_references():
    from repro.configs import registry as ref_registry

    port = registry.runnable_cells()
    assert port == ref_registry.runnable_cells()
    for arch, sname, _, _ in port:
        for multi_pod, mesh in ((False, "16x16"), (True, "2x16x16")):
            assert D.cell_name(arch, sname, multi_pod) == \
                f"{arch}__{sname}__{mesh}"
    assert D.cell_name("qwen2-7b", "decode_32k", False, "hd") == \
        "qwen2-7b__decode_32k__16x16__hd"
    assert D.default_microbatches(registry.get("qwen2-7b"),
                                  SHAPES["train_4k"], False) == 8
