"""The per-layer metrics read from the program's own counters and spans: the
round counters (``round_counts()``) against the flags of the same calls on a
whole CPU run, and the span readers with no device lane."""
import dataclasses

import pytest

from benchmarks import devtrace, harness
from benchmarks.tests.helpers import small_config
from cudacam_tpu_torch.ops import cuda as kernels
from cudacam_tpu_torch.ops.cuda import megakernel
from cudacam_tpu_torch.parallel import packed_halo

SUITE = harness.Suite.load()
COUNTERS = ("hyst_phase1.rounds_per_plane", "hyst_phase2.rounds_per_frame",
            "sharded_loop.rounds_per_call")
SPANS = ("dispatch.validate_us_per_call", "dispatch.prep_us_per_call",
         "dispatch.launch_us_per_call")
NEW = COUNTERS + ("hyst_phase1_roofline",) + SPANS


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_resolves_to_its_reader(name):
    (m,) = [m for m in SUITE.spec["per_layer"] if m["name"] == name]
    assert (harness.BENCH_DIR / "metrics" / f"{name}.py").is_file()
    assert callable(SUITE.reader(name))
    assert set(m["workloads"]) <= {w["name"] for w in SUITE.spec["workloads"]}


def _traced_cpu_run(name, monkeypatch):
    """A whole traced CPU run of cell ``name`` at a small size, with the
    counters zeroed first, and the flags of every round launch it made:
    (result, phase-1 flags rows, phase-2 (rounds before, after) of each
    continued plane, collective rounds of each loop call)."""
    p1, p2, loops = [], [], []
    phase1, phase2, loop = (megakernel.hyst_phase1_plain, megakernel.hyst_phase2_plain,
                            packed_halo.sharded_loop_plain)

    def rec1(f, p, flags, h, **kw):
        phase1(f, p, flags, h, **kw)
        p1.extend(flags.reshape(-1, 2, 2)[:, 0, 0].tolist())

    def rec2(f, p, flags, h, **kw):
        before = flags.reshape(-1, 2, 2)[:, 0].tolist()
        phase2(f, p, flags, h, **kw)
        after = flags.reshape(-1, 2, 2)[:, 1, 0].tolist()
        p2.extend((it0, it1) for (it0, grow), it1 in zip(before, after)
                  if grow and it0 < kw["max_iters"])

    def rec_loop(*args, **kw):
        rounds = loop(*args, **kw)
        loops.append(int(rounds))
        return rounds

    monkeypatch.setattr(megakernel, "hyst_phase1_plain", rec1)
    monkeypatch.setattr(megakernel, "hyst_phase2_plain", rec2)
    monkeypatch.setattr(packed_halo, "sharded_loop_plain", rec_loop)
    kernels.reset_round_counts()
    cell = SUITE.cell(name)
    result = harness.run_cell(SUITE, name, 2**31 + 11, 0.3, True, device="cpu",
                              config=small_config(cell))
    return result, p1, p2, loops


@pytest.mark.parametrize("name", ["cam1080p.x8_escalating", "mega8k.tiles_calm"])
def test_counter_readers_equal_the_flags_of_the_same_calls(name, monkeypatch):
    result, p1, p2, loops = _traced_cpu_run(name, monkeypatch)
    got = result["metrics"]
    assert result["correct"] and p1
    assert got["hyst_phase1.rounds_per_plane"]["value"] == pytest.approx(sum(p1) / len(p1))
    if name == "mega8k.tiles_calm":
        assert loops and got["sharded_loop.rounds_per_call"]["value"] == pytest.approx(
            sum(loops) / len(loops))
        assert "hyst_phase2.rounds_per_frame" not in got
    else:
        assert p2  # the spiral
        assert got["hyst_phase2.rounds_per_frame"]["value"] == pytest.approx(
            sum(b - a for a, b in p2) / len(p1))
        assert "sharded_loop.rounds_per_call" not in got
    for metric in SPANS + ("hyst_phase1_roofline",):
        assert metric not in got  # no device lane on the CPU


def _readings(lane=None):
    return harness.Readings("cam1080p.x8_calm", {"height": 96, "width": 128,
                                                 "hysteresis_inner_steps": 16}, 8, {}, [1.0],
                            lane)


@pytest.mark.parametrize("name", SPANS + ("hyst_phase1_roofline",))
def test_span_and_roofline_readers_read_nothing_without_a_lane(name):
    assert SUITE.reader(name)(_readings()) is None


def test_span_readers_on_a_lane():
    """Spans per call over the stretch's ``bench.call`` spans; launch records
    count only inside a call; a lane without the program's spans (the
    parent's) reads None for them."""
    op = devtrace.Op
    host = [op(devtrace.CALL_SPAN, 0, 100), op("cc.validate", 1, 3),
            op("cc.prep.ff_pack", 4, 10), op("cudaLaunchKernel", 10, 14),
            op("cc.prep.hyst_phase1", 15, 25), op("cudaLaunchCooperativeKernel", 25, 35),
            op(devtrace.CALL_SPAN, 200, 300), op("cc.validate", 201, 205),
            op("cudaLaunchKernel", 210, 212), op("cudaLaunchKernel", 400, 450)]
    lane = devtrace.Lane([op("hyst_kernel<false, false>", 0, 50)], host, 500, 16)
    r = _readings(lane)
    assert SUITE.reader("dispatch.validate_us_per_call")(r) == pytest.approx(3.0)
    assert SUITE.reader("dispatch.prep_us_per_call")(r) == pytest.approx(8.0)
    assert SUITE.reader("dispatch.launch_us_per_call")(r) == pytest.approx(8.0)
    bare = dataclasses.replace(lane, host=[h for h in host if not h.name.startswith("cc.")])
    assert SUITE.reader("dispatch.validate_us_per_call")(_readings(bare)) is None
    assert SUITE.reader("dispatch.prep_us_per_call")(_readings(bare)) is None
