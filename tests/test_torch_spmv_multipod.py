"""The distributed-SpMV dry-run (`spmv_bench`'s multi-pod branch:
`lower_1d`, `lower_2d`, `lower_halo`, `run_multi_pod`) on a (2, 4) fake
mesh at M_ROWS = 2^14, against closed forms and against the reference's
lowerings compiled by XLA over 8 host devices (a subprocess, ~2 s).

Closed forms per rank for ITERS iterations on g ranks (f32):
  1-D:  ITERS all-gathers of the x panel (result M_ROWS * 4 B, g = 8);
  2-D:  ITERS all-reduces of the partial y over "model" (M_ROWS / data
        * 4 B, g = 4) and ITERS all-gathers of the next x segment over
        "data" (M_ROWS / model * 4 B, g = 2);
  halo: 2 * ITERS collective-permutes of `halo` values;
and 2 * blocks * BM * BN flops a SpMV. XLA's counts agree with these
exactly at this size: each of the reference's collectives lowers to one
HLO op of the same result shape, and the flops are its one dot.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.launch import hlo_cost
from repro_torch.launch import spmv_bench as SB
from repro_torch.launch.mesh import fake_group, make_mesh

M = 1 << 14
DATA, MODEL = 2, 4
G = DATA * MODEL
F32 = 4


def _closed_forms():
    it = SB.ITERS
    panel = M // G
    seg = M // MODEL
    part = seg // DATA
    y2 = M // DATA
    halo = 128
    return {
        "1d": {"flops": it * 2 * (panel // SB.BM) * SB.K_1D * SB.BM * SB.BN,
               "collectives": {
                   "all-gather": it * panel * F32,
                   "all-gather_count": it,
                   "total": it * panel * F32,
                   "wire": it * M * F32 * (G - 1) // G}},
        "2d": {"flops": it * 2 * (y2 // SB.BM) * max(SB.K_1D // MODEL, 2)
               * SB.BM * SB.BN,
               "collectives": {
                   "all-reduce": it * y2 * F32,
                   "all-reduce_count": it,
                   "all-gather": it * part * F32,
                   "all-gather_count": it,
                   "total": it * (y2 + part) * F32,
                   "wire": it * (2 * y2 * F32 * (MODEL - 1) // MODEL
                                 + seg * F32 * (DATA - 1) // DATA)}},
        "halo": {"flops": it * 2 * (panel // SB.BM) * 2 * SB.BM * SB.BN,
                 "collectives": {
                     "collective-permute": 2 * it * halo * F32,
                     "collective-permute_count": 2 * it,
                     "total": 2 * it * halo * F32,
                     "wire": 2 * it * halo * F32}},
    }


def _port():
    out = {}
    with fake_group(G):
        mesh = make_mesh((DATA, MODEL), ("data", "model"), "cpu")
        for name, lower in [("1d", SB.lower_1d), ("2d", SB.lower_2d),
                            ("halo", SB.lower_halo)]:
            walk = hlo_cost.analyze(lower(mesh, m_rows=M))
            out[name] = {"flops": walk["flops"],
                         "collectives": walk["collectives"]}
    return out


@pytest.mark.parametrize("layout", ["1d", "2d", "halo"])
def test_layouts_match_their_closed_forms(layout):
    assert _port()[layout] == _closed_forms()[layout]


REF_SCRIPT = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.launch import spmv_bench as SB, hlo_cost
    SB.M_ROWS = %d
    mesh = jax.make_mesh((%d, %d), ("data", "model"))
    out = {}
    for name, fn in [("1d", SB.lower_1d), ("2d", SB.lower_2d),
                     ("halo", SB.lower_halo)]:
        with mesh:
            text = fn(mesh).compile().as_text()
        w = hlo_cost.analyze_text(text)
        out[name] = {"flops": int(w["flops"]), "collectives": {
            k: int(v) for k, v in w["collectives"].items()}}
    print("REF " + json.dumps(out))
""") % (M, DATA, MODEL)


def test_layouts_match_the_references_xla_counts():
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                       capture_output=True, text=True, timeout=600,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu",
                            "HOME": os.environ.get("HOME", "/tmp")})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("REF ")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    ref = json.loads(line[0][4:])
    port = _port()
    for layout in ("1d", "2d", "halo"):
        assert port[layout]["flops"] == ref[layout]["flops"]
        assert port[layout]["collectives"] == ref[layout]["collectives"]


def test_run_multi_pod_writes_the_references_summary(tmp_path, capsys,
                                                     monkeypatch):
    """The full mesh (16, 16) at a small M_ROWS: the ratios the reference
    prints and stores; `main` with no --matrix reaches it."""
    out = SB.run_multi_pod(m_rows=1 << 16, out_dir=str(tmp_path))
    on_disk = json.loads((tmp_path / "spmv_distributed.json").read_text())
    assert on_disk == out
    wire = {k: out[k]["collectives"]["wire"] for k in ("1d", "2d", "halo")}
    assert out["wire_ratio_1d_over_2d"] == wire["1d"] / wire["2d"]
    assert out["wire_ratio_1d_over_halo"] == wire["1d"] / wire["halo"]
    assert wire["1d"] > wire["2d"] > wire["halo"]
    printed = capsys.readouterr().out
    assert "[spmv-1d] flops/dev=" in printed
    assert "[spmv] 1d/2d wire ratio:" in printed
    seen = []
    monkeypatch.setattr(SB, "run_multi_pod",
                        lambda multi_pod=False: seen.append(multi_pod))
    SB.main(["--multi-pod"])
    assert seen == [True]
    with pytest.raises(SystemExit) as e:
        SB.main(["--devices", "8"])
    assert e.value.code == 2
