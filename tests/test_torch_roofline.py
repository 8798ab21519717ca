"""The port's roofline (`bench/roofline.py`) on hand-written dry-run
records: its terms, dominant term, `model_over_hlo_flops` and
`roofline_fraction` follow the reference's formulas (checked by hand and
by running the reference's `benchmarks/roofline.run` on the same records
with the H100's HardwareSpec patched in), and an error record gives an
ERROR row. The port adds the record's layout variant in the last column
(`note`), where the reference leaves an ok row's note empty.
"""
import csv
import json

import pytest

from repro_torch.bench import roofline as RL
from repro_torch.launch.mesh import HardwareSpec

RECORDS = [
    {"arch": "qwen2-7b", "shape": "train_4k", "mesh": "16x16",
     "status": "ok", "params": 7_615_616_512, "active_params": 7_615_616_512,
     "walk_flops": 3.8e15, "walk_bytes": 1.0e12,
     "collectives": {"total": 1.3e10, "wire": 3.3e10}},
    {"arch": "qwen2-7b", "shape": "decode_32k", "mesh": "2x16x16",
     "status": "ok", "params": 7_615_616_512, "active_params": 7_615_616_512,
     "kv_shard": "hd", "walk_flops": 6.0e10, "walk_bytes": 7.0e10,
     "collectives": {"total": 9.4e8, "wire": 1.4e10}},
    {"arch": "qwen3-moe-30b-a3b", "shape": "prefill_32k", "mesh": "16x16",
     "status": "ok", "params": 30_000_000_000, "active_params": 3_000_000_000,
     "weight_stationary": True, "walk_flops": 1.0e14, "walk_bytes": 1.0e15,
     "collectives": {"total": 5.0e9}},          # no "wire": total stands in
    {"arch": "rwkv6-7b", "shape": "long_500k", "mesh": "16x16",
     "status": "error", "error": "RuntimeError: " + "x" * 200},
]


@pytest.fixture
def records(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_RESULTS_DIR", str(tmp_path / "port"))
    d = tmp_path / "port" / "dryrun"
    d.mkdir(parents=True)
    for i, rec in enumerate(RECORDS):
        (d / f"{i}_{rec['arch']}.json").write_text(json.dumps(rec))
    return tmp_path


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _by_hand(rec):
    hw = HardwareSpec
    chips = 512 if rec["mesh"] == "2x16x16" else 256
    n = rec["active_params"]
    b, s = {"train_4k": (256, 4096), "decode_32k": (128, 1),
            "prefill_32k": (32, 32768)}[rec["shape"]]
    mf = (6.0 if rec["shape"] == "train_4k" else 2.0) * n * b * s / chips
    coll = rec["collectives"]
    terms = {"compute": rec["walk_flops"] / hw["peak_flops_bf16"],
             "memory": rec["walk_bytes"] / hw["hbm_bw"],
             "collective": coll.get("wire", coll["total"]) / hw["ici_bw"]}
    dom = max(terms, key=terms.get)
    return terms, dom, mf / rec["walk_flops"], \
        mf / terms[dom] / hw["peak_flops_bf16"]


def test_terms_follow_the_references_formulas(records):
    summary = RL.run()
    assert summary == {"cells_ok": 3, "cells_err": 1}
    rows = _rows(records / "port" / "roofline.csv")
    assert rows[0] == RL.HEADER
    for rec, row in zip(RECORDS[:3], rows[1:4]):
        terms, dom, useful, frac = _by_hand(rec)
        assert row[:4] == [rec["arch"], rec["shape"], rec["mesh"], "ok"]
        assert [float(v) for v in row[4:7]] == pytest.approx(
            [terms["compute"], terms["memory"], terms["collective"]],
            rel=1e-4)
        assert row[7] == dom
        assert float(row[8]) == pytest.approx(useful, abs=1e-3)
        assert float(row[9]) == pytest.approx(frac, abs=1e-3)
    assert [r[10] for r in rows[1:4]] == [
        "", "kv_shard=hd", "weight_stationary"]
    assert [r[7] for r in rows[1:4]] == ["compute", "collective", "memory"]


def test_an_error_record_gives_an_error_row(records):
    RL.run()
    row = _rows(records / "port" / "roofline.csv")[4]
    assert row[:4] == ["rwkv6-7b", "long_500k", "16x16", "ERROR"]
    assert row[4:10] == [""] * 6
    assert row[10] == RECORDS[3]["error"][:80]


def test_rows_are_the_references(records, monkeypatch):
    import benchmarks.roofline as ref

    monkeypatch.setattr(ref, "DRYRUN_DIR",
                        str(records / "port" / "dryrun"))
    monkeypatch.setattr(ref, "RESULTS_DIR", str(records / "ref"))
    monkeypatch.setattr(ref, "HardwareSpec", dict(HardwareSpec))
    (records / "ref").mkdir()
    assert ref.run() == RL.run()
    want = _rows(records / "ref" / "roofline.csv")
    got = _rows(records / "port" / "roofline.csv")
    assert [r[:10] for r in got] == [r[:10] for r in want]
    assert [r[10] for r in got][-1] == [r[10] for r in want][-1]


def test_model_flops_per_device():
    rec = RECORDS[1]
    assert RL.model_flops_per_device(rec) == 2.0 * rec["params"] * 128 / 512
