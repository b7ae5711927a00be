"""The port's benchmark (``cudacam_tpu_torch/benchmark.py``) and the CLI's
``bench`` on ``device='cpu'`` at small sizes: one parseable JSON line from
``main``, every row of the extended table written where it is asked to be,
and no run on the CPU in place of the card."""
from __future__ import annotations

import inspect
import json

import pytest
import torch

from cudacam_tpu_torch import benchmark
from cudacam_tpu_torch.cli import main as port_cli

#: The table's sizes here: every label small, the spiral frames' minimum
#: (28 x 28) respected.
SMALL = {"VGA": (24, 32), "1080p": (40, 64), "4K": (48, 80), "8K": (56, 96)}

ROWS = (
    ["1080p stream ms/frame [cpu]"]
    + [f"1080p to stage {s:8s} [cpu]"
       for s in ("MONO", "GAUSSIAN", "GRADIENT", "NMS", "THRESH", "HYSTER")]
    + ["VGA (24x32) grayscale stream ms/frame",
       "1080p all-stage outputs ms/frame",
       "1080p ks=3 norm=l2 stream ms/frame",
       "1080p ks=7 norm=l2 stream ms/frame",
       "1080p ks=5 norm=l1 stream ms/frame",
       "1080p single frame (seed 0) ms/frame",
       "1080p batched x4 (fixed scene) ms/frame [cpu]",
       "1080p batched x8 (fixed scene) ms/frame [cpu]",
       "1080p batched x8 (mixed scenes) ms/frame [cpu]",
       "4K single frame (seed 0) ms/frame",
       "4K batched x2 (fixed scene) ms/frame [cpu]",
       "4K batched x4 (fixed scene) ms/frame [cpu]",
       "1080p threshold sweep K=16 [cpu]",
       "4K threshold sweep K=16 [cpu]",
       "hysteresis worst case (1080p spiral)",
       "1080p worst case through engine [cont=kernel]",
       "1080p worst case through engine [cont=split]",
       "4K worst case through engine",
       "8K worst case through engine (escalation cliff)",
       "1080p sharded 1x1x1 mesh [cpu]",
       "4K sharded 1x1x1 mesh [cpu]",
       "8K sharded 1x1x1 mesh [cpu]",
       "4K batched x2 sharded 1x1x1 mesh [cpu]",
       "4K (48x80) stream ms/frame",
       "8K (56x96) stream ms/frame"]
)


@pytest.mark.parametrize("h,w", [(40, 64), (37, 53)])
def test_main_prints_one_json_line(capsys, h, w):
    benchmark.main(device="cpu", height=h, width=w)
    cap = capsys.readouterr()
    lines = [ln for ln in cap.out.splitlines() if ln.strip()]
    assert len(lines) == 1, cap.out
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    # The name states the size and the clock: the wall clock on the CPU.
    assert rec["metric"] == f"canny_{h}x{w}_wall_ms_per_frame_cpu"
    assert rec["unit"] == "ms" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(benchmark.BASELINE_MS / rec["value"], rel=1e-2)
    assert "cpu" in cap.err


def test_size_tag_names_1080p():
    assert benchmark._size_tag(1080, 1920) == "1080p"
    assert benchmark._size_tag(2160, 3840) == "2160x3840"


def test_full_table_writes_every_row(tmp_path, capsys):
    out = tmp_path / "table.md"
    rows = benchmark.full_table(device="cpu", out_path=str(out), sizes=SMALL)
    assert [r["name"] for r in rows] == ROWS
    for r in rows:
        # The CPU has no device clock: event and device are not measured.
        assert r["event"] is None and r["device"] is None and r["wall"] > 0
        assert r["launches"] == 0
    text = out.read_text()
    header = ("| Benchmark | event ms/frame | device ms/frame | wall ms/frame | vs 6 ms | "
              "launches / frame | Note |")
    assert header in text
    assert "Card (nvidia-smi name, power limit): cpu" in text
    for name in ROWS:
        assert f"| {name} | not measured | not measured |" in text, name
    assert "## Roofline (40x64, measured)" in text and "not measured (no card)" in text
    assert "## Sharded (one card, measured)" in text
    assert "| 4K batched x2 sharded 1x1x1 mesh [cpu] | 0 |" in text
    assert "waits for two or more cards" in text
    assert "v5e" not in text and "VMEM" not in text
    assert capsys.readouterr().out.rstrip().endswith(f"wrote {out}")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["table.md"]


def test_full_table_writes_its_own_file_by_default():
    default = inspect.signature(benchmark.full_table).parameters["out_path"].default
    assert default == "BENCH_TABLE_CUDA.md"


@pytest.mark.parametrize("argv,fn", [
    (["bench", "--device", "cpu"], "main"),
    (["bench", "--full", "--device", "cpu"], "full_table"),
])
def test_bench_cli_routes(monkeypatch, argv, fn):
    calls = []
    for name in ("main", "full_table"):
        monkeypatch.setattr(benchmark, name,
                            lambda *a, _n=name, **kw: calls.append((_n, kw["device"])))
    assert port_cli(argv) == 0
    assert benchmark.cli_entry(argv[1:]) == 0
    assert calls == [(fn, torch.device("cpu"))] * 2


def test_bench_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["bench"], ["bench", "--full"], ["bench", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_cli(argv)
    for call in (lambda: benchmark.main(), lambda: benchmark.full_table(out_path="unused.md")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
