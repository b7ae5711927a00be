"""The round counters and the host spans of the port's main path, on the CPU.

The round kernels add the rounds they ran to a counter block on their
device (``ops/cuda/_build.py``: ``ROUNDS``); the plain versions, which CPU
tensors take, add the same values to ``PLAIN_ROUNDS``, so these tests hold the
plain route to the flags it returns and the card tests
(``tests/test_torch_cuda.py``) hold the kernel route to the plain one
through the same ``round_counts()``. The launch wrappers and ``process``
enter ``torch.profiler`` ranges (``cc.validate``, ``cc.prep.<launch
name>``) only while a profiler session records.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudacam_tpu_torch import CannyConfig
from cudacam_tpu_torch.engine import CannyEngine, ShardedCannyEngine
from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame
from cudacam_tpu_torch.ops import cuda as kernels
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline_batched, mega_export
from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh
from cudacam_tpu_torch.parallel.packed_halo import sharded_loop_plain

THR = torch.tensor([10, 40], dtype=torch.int32)
KW = dict(kernel_size=5, grad_coeff=4, norm="l2", parity="reference", dilate_steps=16,
          scan_after=12, max_iters=100)


def _delta(before, after):
    return {k: (after[k][0] - before[k][0], after[k][1] - before[k][1]) for k in after}


def _batch(h, w):
    """Three scenes that converge in phase 1 at scan_after 12 and the spiral
    frame, which phase 2 continues."""
    return torch.from_numpy(np.stack([make_scene(h, w, seed=s) for s in range(3)]
                                     + [make_spiral_frame(h, w)]))


@pytest.mark.parametrize("max_iters", [100, 20])
def test_batched_hyster_counts_equal_the_flags(max_iters):
    """Phase 1 adds every frame and its rounds; phase 2 the frames it
    continued (growing at phase 1's exit and below the cap) and the rounds
    it added to them."""
    before = kernels.round_counts("cpu")
    _, flags = canny_mega_pipeline_batched(_batch(64, 96), THR, **dict(KW, max_iters=max_iters))
    got = _delta(before, kernels.round_counts("cpu"))
    it0, grow0, it1 = flags[:, 0, 0], flags[:, 0, 1], flags[:, 1, 0]
    continued = (grow0 == 1) & (it0 < max_iters)
    assert int(continued.sum()) == 1  # the spiral
    assert got["hyst_phase1"] == (4, int(it0.sum()))
    assert got["hyst_phase2"] == (1, int((it1 - it0)[continued].sum()))
    assert got["sharded_loop"] == (0, 0)


def test_phase2_that_continues_nothing_counts_nothing():
    before = kernels.round_counts("cpu")
    _, flags = canny_mega_pipeline_batched(_batch(64, 96)[:3], THR, **KW)
    got = _delta(before, kernels.round_counts("cpu"))
    assert flags[:, 0, 1].tolist() == [0, 0, 0]
    assert got["hyst_phase1"] == (3, int(flags[:, 0, 0].sum())) and got["hyst_phase2"] == (0, 0)


def test_sharded_loop_plain_counts_its_collective_rounds():
    """(1, rounds) a call; the local saturate inside it counts nothing, as
    the kernel's does not."""
    h, w = 64, 96
    cfg = CannyConfig(height=h, width=w, max_hysteresis_iters=12, hysteresis_scan_after=4)
    pipe = build_sharded_pipeline(cfg, make_mesh(1, 2, 2))
    kw = dict(dilate_steps=16, scan_after=4, max_iters=12)
    frames = torch.from_numpy(make_spiral_frame(h, w))[None]
    for max_rounds in (12, 3, 0):
        f, p, flags = mega_export(frames, THR, pipe.tiling, **kw)
        before = kernels.round_counts("cpu")
        rounds = sharded_loop_plain(f, p, flags, (1, 2, 2), pipe.geo, max_rounds=max_rounds, **kw)
        got = _delta(before, kernels.round_counts("cpu"))
        assert got == {"hyst_phase1": (0, 0), "hyst_phase2": (0, 0),
                       "sharded_loop": (1, int(rounds))}
    assert int(rounds) == 0
    before = kernels.round_counts("cpu")
    saturate_packed(f, p, flags, pipe.geo.ext_h, **kw)
    assert kernels.round_counts("cpu") == before


def test_sharded_engine_counts_tiles_and_the_loop():
    """On the tile path a phase-1 plane is an extended tile; the loop's
    count equals ``ShardedPipeline.rounds``."""
    h, w = 64, 96
    eng = ShardedCannyEngine(CannyConfig(height=h, width=w), make_mesh(1, 2, 2), device="cpu")
    before = kernels.round_counts("cpu")
    eng.process(np.stack([make_scene(h, w, seed=1), make_spiral_frame(h, w)]))
    got = _delta(before, kernels.round_counts("cpu"))
    assert got["hyst_phase1"][0] == 8 and got["hyst_phase1"][1] >= 8
    assert got["sharded_loop"] == (1, int(eng.pipeline().rounds)) and got["hyst_phase2"] == (0, 0)


def test_reset_round_counts_zeroes_and_none_sums_every_block():
    canny_mega_pipeline_batched(_batch(32, 64)[:1], THR, **KW)
    assert kernels.round_counts()["hyst_phase1"][0] >= 1
    assert kernels.round_counts() == kernels.round_counts("cpu")  # the only block here
    kernels.reset_round_counts()
    zero = dict.fromkeys(kernels.round_counts(), (0, 0))
    assert kernels.round_counts() == kernels.round_counts("cpu") == zero
    assert set(zero) == {"hyst_phase1", "hyst_phase2", "sharded_loop"}


def _span_names(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return Counter(e.name for e in prof.events() if e.name.startswith("cc."))


@pytest.mark.parametrize("batched", [False, True])
def test_process_spans_one_validate_and_one_prep_a_launch(batched):
    h, w = 32, 64
    eng = CannyEngine(CannyConfig(height=h, width=w, hysteresis_scan_after=12), device="cpu")
    frames = _batch(h, w)
    x = frames if batched else frames[3]
    eng.process(x)
    names = _span_names(lambda: eng.process(x))
    assert names == {"cc.validate": 1, "cc.prep.ff_pack": 1, "cc.prep.hyst_phase1": 1,
                     "cc.prep.hyst_phase2": 1, "cc.prep.unpack": 1}
    assert not any("_kernel" in n for n in names)


def test_sharded_process_spans_one_validate_and_one_prep_a_launch():
    h, w = 64, 96
    eng = ShardedCannyEngine(CannyConfig(height=h, width=w), make_mesh(1, 2, 2), device="cpu")
    frames = np.stack([make_scene(h, w, seed=1)])
    names = _span_names(lambda: eng.process(frames))
    assert names == {"cc.validate": 1, "cc.prep.ff_pack_export": 1, "cc.prep.hyst_phase1": 1,
                     "cc.prep.sharded_loop": 1, "cc.prep.unpack_core": 1}
    assert not any("_kernel" in n for n in names)


def test_no_profiler_enters_no_range(monkeypatch):
    """Without a profiler session the spans are one check each: a
    ``record_function`` entered anyway would raise here."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    h, w = 32, 64
    eng = CannyEngine(CannyConfig(height=h, width=w), device="cpu")
    frames = _batch(h, w)
    assert eng.process(frames).shape == (4, h, w)
    sharded = ShardedCannyEngine(CannyConfig(height=h, width=w), make_mesh(1, 2, 2),
                                 device="cpu")
    assert sharded.process(frames[:1]).shape == (1, h, w)


def test_phase1_route_counts_count_kernel_launches_only(monkeypatch):
    """``phase1_route_counts()`` counts each ``hyst_phase1`` launch under
    the route ``round_layout`` reports for its shape; the plain version
    launches nothing and counts nothing; ``launch_counts()`` is not split."""
    from cudacam_tpu_torch.ops.cuda import megakernel as mk

    kernels.reset_phase1_route_counts()
    assert kernels.phase1_route_counts() == {"registers": 0, "shared": 0}
    canny_mega_pipeline_batched(_batch(32, 64), THR, **KW)
    assert kernels.phase1_route_counts() == {"registers": 0, "shared": 0}
    asked = []

    def route(nb, h, w, steps, device):
        asked.append((nb, h, w, steps, device))
        return "registers" if h <= 1152 else "shared"

    launches = kernels.launch_counts()["hyst_phase1"]
    monkeypatch.setattr(mk, "use_plain", lambda *t: False)
    monkeypatch.setattr(mk, "_launch_rounds", lambda *a, **k: None)
    monkeypatch.setattr(mk, "_phase1_route", route)
    flags = torch.zeros((3, 2, 2), dtype=torch.int32)
    for h in (1080, 1152, 1153):
        hw = (h + 31) // 32
        f, p = torch.zeros((3, hw, 40), dtype=torch.int32), torch.zeros((3, hw, 40), dtype=torch.int32)
        mk.hyst_phase1(f, p, flags, h, dilate_steps=8)
    assert asked == [(3, 1080, 40, 8, None), (3, 1152, 40, 8, None), (3, 1153, 40, 8, None)]
    assert kernels.phase1_route_counts() == {"registers": 2, "shared": 1}
    assert kernels.launch_counts()["hyst_phase1"] == launches  # the stub launched nothing
    kernels.reset_phase1_route_counts()
    assert kernels.phase1_route_counts() == {"registers": 0, "shared": 0}


def _route_share_reader():
    """The benchmark's reader of ``hyst_phase1.register_route_share``,
    loaded from its file (``benchmarks/metrics``)."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "benchmarks" / "metrics"
            / "hyst_phase1.register_route_share.py")
    spec = importlib.util.spec_from_file_location("register_route_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("counts,share", [({"registers": 3, "shared": 0}, 100.0),
                                          ({"registers": 1, "shared": 3}, 25.0),
                                          ({"registers": 0, "shared": 2}, 0.0),
                                          ({"registers": 0, "shared": 0}, None)])
def test_register_route_share_reads_the_route_counter(monkeypatch, counts, share):
    """The metric's reader: the % of ``hyst_phase1`` launches on the
    register route, None where no launch was counted, and None (no raise)
    where the program has no route counter."""
    read = _route_share_reader()
    monkeypatch.setattr(kernels, "phase1_route_counts", lambda: dict(counts))
    assert read(None) == share
    monkeypatch.delattr(kernels, "phase1_route_counts")
    assert read(None) is None
