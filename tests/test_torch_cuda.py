"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc: every test here is marked ``cuda`` and skips
without a card. The module imports no jax, so it runs on a GPU host that
has none (``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``;
the repository's conftest pins JAX to the CPU and imports it).

Tolerance: 0 for every integer output (packed words, flags, stage buffers,
edge maps): the contract is byte equality with the plain version on the
same inputs. The float inspection planes of ``process_all`` are plain torch
ops on both sides, so they are equal too.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from cudacam_tpu_torch.io.sources import make_scene, make_spiral_frame, make_spiral_thresh
from cudacam_tpu_torch import CannyConfig, CannyStage
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops import bitpack, cuda as kernels, torch_ops
from cudacam_tpu_torch.ops.cuda.feedforward import (
    FF_STAGES, NMSQ, ff_pack, ff_pack_batched, ff_pack_plain, ff_stages, ff_stages_batched,
    ff_stages_plain, load_route,
)
from cudacam_tpu_torch.ops.cuda.canny import sweep_bounds
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
    hysteresis_fused, hysteresis_fused_nmsq, pack_thresh, pack_thresh_plain, sweep_fused,
    sweep_fused_plain, sweep_pack_all, sweep_pack_all_plain, sweep_seed, sweep_seed_plain,
)
from cudacam_tpu_torch.ops.cuda.megakernel import (
    canny_mega_pipeline, canny_mega_pipeline_batched, hyst_phase1, hyst_phase2, unpack,
    unpack_plain,
)

pytestmark = pytest.mark.cuda

SHAPES = [(80, 256), (37, 53), (1, 1), (2, 5), (720, 1280)]
#: Alignment classes of ff_pack's loads and unpack's row runs: BGR rows of
#: 5757 and 5763 bytes (cp.async chunks), 48 and 5760 (TMA).
ALIGN_SHAPES = [(33, 1919), (64, 1921), (17, 16), (1080, 1920)]
CONFIGS = [{}, dict(kernel_size=3, norm="l1"), dict(kernel_size=7, parity="opencv", grad_coeff=2)]
MAIN_PATH = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _frame(h, w, dev, seed=0):
    if min(h, w) < 8:
        g = torch.Generator().manual_seed(seed)
        return torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8).to(dev)
    return torch.from_numpy(make_scene(h, w, seed=seed)).to(dev)


def _thr(lo, hi, dev):
    return torch.tensor([lo, hi], dtype=torch.int32, device=dev)


@pytest.mark.parametrize("h,w", SHAPES + ALIGN_SHAPES)
@pytest.mark.parametrize("kw", CONFIGS)
def test_ff_pack_matches_plain(dev, h, w, kw):
    fr = _frame(h, w, dev, seed=h)
    for lo, hi in [(0, 0), (10, 40), (254, 255), (-3, 300)]:  # C '/' truncates: floor_div
        thr = _thr(lo, hi, dev)
        for x in (fr, fr[..., 2].contiguous()):
            got, want = ff_pack(x, thr, **kw), ff_pack_plain(x, thr, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", [(37, 53)] + ALIGN_SHAPES)
@pytest.mark.parametrize("kw", CONFIGS)
def test_ff_pack_batched_matches_plain(dev, h, w, kw):
    batch = torch.stack([_frame(h, w, dev, seed=s) for s in range(3)])
    thr = _thr(10, 40, dev)
    for x in (batch, batch[..., 0].contiguous(), batch[1:]):  # the last: base one frame in
        got = ff_pack_batched(x, thr, **kw)
        for i in range(len(x)):
            want = ff_pack_plain(x[i], thr, **kw)
            assert torch.equal(got[0][i], want[0]) and torch.equal(got[1][i], want[1])


#: Both load paths of ff_pack, by name: (route, shape, channels).
ROUTES = [("tma", (1080, 1920), 3), ("tma", (17, 16), 1), ("tma", (33, 64), 3),
          ("cp.async", (33, 1919), 3), ("cp.async", (64, 1921), 1), ("cp.async", (37, 53), 3)]


@pytest.mark.parametrize("route,hw,channels", ROUTES,
                         ids=[f"{r}-{h}x{w}-{'bgr' if c == 3 else 'mono'}" for r, (h, w), c in ROUTES])
def test_ff_pack_load_paths(dev, route, hw, channels):
    fr = _frame(*hw, dev, seed=hw[1])
    x = fr if channels == 3 else fr[..., 1].contiguous()
    assert load_route(x) == route
    for kw in CONFIGS:
        for lo, hi in [(10, 40), (0, 0)]:
            got, want = ff_pack(x, _thr(lo, hi, dev), **kw), ff_pack_plain(x, _thr(lo, hi, dev), **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("kw", CONFIGS)
def test_ff_stages_matches_plain(dev, h, w, kw):
    fr = _frame(h, w, dev, seed=w)
    sets = [FF_STAGES, FF_STAGES[1:], (NMSQ,)] + [(s,) for s in FF_STAGES]
    for lo, hi in [(10, 40), (0, 255), (-3, 300)]:
        thr = _thr(lo, hi, dev)
        for x in (fr, fr[..., 0].contiguous()):
            for stages in sets:
                got = ff_stages(x, thr, stages, **kw)
                want = ff_stages_plain(x, thr, stages, **kw)
                for s, g, e in zip(stages, got, want):
                    assert g.dtype == e.dtype and torch.equal(g, e), (s, lo, hi, x.ndim)


@pytest.mark.parametrize("h,w", SHAPES)
def test_pack_thresh_matches_plain(dev, h, w):
    g = torch.Generator().manual_seed(h * w)
    levels = torch.tensor([0, 128, 255, 127, 1], dtype=torch.uint8)
    t = levels[torch.randint(0, 5, (h, w), generator=g)].to(dev)
    got, want = pack_thresh(t), pack_thresh_plain(t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kg = torch.randint(0, 3000, (h, w), generator=g, dtype=torch.int32).to(dev)
    for lo, hi in [(100, 900), (-5, 400), (-9, -1), (0, 0)]:
        b = _thr(lo, hi, dev)
        got, want = pack_thresh(kg, b), pack_thresh_plain(kg, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


#: The stage walk's cases: kernel sizes 3 / 5 / 7, L1 and L2, both parities.
STAGE_CONFIGS = CONFIGS + [dict(kernel_size=5, norm="l1", parity="opencv"),
                           dict(kernel_size=3, parity="opencv", grad_coeff=8)]
#: 1 x 1, a narrow frame, odd widths, 1080p, and BGR rows of 5754 bytes
#: (W = 1918: the cp.async route).
STAGE_SHAPES = [(1, 1), (33, 5), (270, 481), (1080, 1920), (66, 1918)]


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose base lies one byte past an aligned
    allocation (the cp.async route)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _stages_equal(x, thr, kw, sets=None, **geo):
    for stages in sets or [FF_STAGES, FF_STAGES[1:], (NMSQ,)] + [(s,) for s in FF_STAGES]:
        got = ff_stages(x, thr, stages, **kw, **geo)
        want = ff_stages_plain(x, thr, stages, **kw, **geo)
        for s, g, e in zip(stages, got, want):
            assert g.dtype == e.dtype and torch.equal(g, e), (s, tuple(x.shape), kw, geo)


@pytest.mark.parametrize("h,w", STAGE_SHAPES)
@pytest.mark.parametrize("kw", STAGE_CONFIGS)
def test_ff_stages_walk_matches_plain(dev, h, w, kw):
    """Every stage set on both load routes: BGR and gray, and a copy whose
    base is off a 16-byte boundary; the low threshold -3 (keep-gated)."""
    fr = _frame(h, w, dev, seed=h + w)
    for lo, hi in [(10, 40), (-3, 300)]:
        thr = _thr(lo, hi, dev)
        for x in (fr, fr[..., 1].contiguous(), _unaligned(fr)):
            _stages_equal(x, thr, kw)
    assert load_route(_unaligned(fr)) == "cp.async"


@pytest.mark.parametrize("kw", STAGE_CONFIGS)
def test_ff_stages_origin_tiles_match_plain(dev, kw):
    """Tiles whose pixel (0, 0) lies at a global origin of a larger image
    (the sharded display route): zero padding pinned to the image, every
    output 0 outside it."""
    fr = _frame(150, 260, dev, seed=5)
    thr = _thr(10, 40, dev)
    for origin, image in [((-4, -6), (140, 250)), ((70, 120), (200, 300)), ((0, 0), (150, 260)),
                          ((-3, 200), (100, 240))]:
        for x in (fr, fr[..., 2].contiguous(), _unaligned(fr)):
            _stages_equal(x, thr, kw, [FF_STAGES, (NMSQ,), (CannyStage.GRADIENT,)],
                          origin=origin, image_size=image)


@pytest.mark.parametrize("h,w,n", [(37, 53, 3), (270, 481, 2), (1080, 1920, 4), (66, 1918, 2)])
def test_ff_stages_batched_matches_single(dev, h, w, n):
    """One launch for the batch; each frame equals its solo call and the
    plain version, byte for byte."""
    batch = torch.stack([_frame(h, w, dev, seed=s) for s in range(n)])
    thr = _thr(10, 40, dev)
    for x in (batch, batch[..., 0].contiguous(), batch[1:]):
        for stages in (FF_STAGES, (NMSQ,), (CannyStage.GRADIENT,), (CannyStage.MONO,)):
            kernels.reset_launch_counts()
            got = ff_stages_batched(x, thr, stages)
            assert kernels.launch_counts()["ff_stages"] == 1
            for i in range(len(x)):
                solo = ff_stages(x[i], thr, stages)
                want = ff_stages_plain(x[i], thr, stages)
                for g, o, e in zip(got, solo, want):
                    assert torch.equal(g[i], o) and torch.equal(g[i], e)


@pytest.mark.parametrize("h,w", [(1, 1), (33, 5), (96, 70), (270, 481), (1080, 1920)])
def test_pack_thresh_walk_matches_plain(dev, h, w):
    """Both modes of the column walk, rows past H included; the int32 ends."""
    g = torch.Generator().manual_seed(h + w)
    levels = torch.tensor([0, 128, 255, 127, 129, 254, 1], dtype=torch.uint8)
    t = levels[torch.randint(0, 7, (h, w), generator=g)].to(dev)
    for x in (t, _unaligned(t)):
        got, want = pack_thresh(x), pack_thresh_plain(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kg = torch.randint(-2**31, 2**31 - 1, (h, w), generator=g, dtype=torch.int32).to(dev)
    for lo, hi in [(100, 900), (-5, 400), (-9, -1), (0, 0), (-2**31, 2**31 - 1), (2**31 - 2, 0)]:
        b = _thr(lo, hi, dev)
        got, want = pack_thresh(kg, b), pack_thresh_plain(kg, b)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", [(80, 256), (37, 53), (1, 1), (720, 1280)])
@pytest.mark.parametrize("scan_after,max_iters", [(10, 100), (2, 5), (3, 3)])
def test_hysteresis_fused_matches_plain(dev, h, w, scan_after, max_iters):
    kw = dict(dilate_steps=16, scan_after=scan_after, max_iters=max_iters)
    fr = _frame(h, w, dev, seed=3)
    (thresh,) = ff_stages_plain(fr, _thr(10, 40, dev), (CannyStage.THRESH,))
    want = bitpack.hysteresis_packed(thresh, **kw)
    out, iters = hysteresis_fused(thresh, return_iters=True, **kw)
    assert torch.equal(out, want)
    f, p = bitpack.pack_pair(thresh)
    assert int(iters) == bitpack.converge_packed(f, p, h, w, **kw)[1]
    kept = hysteresis_fused(thresh, remove_candidates=False, **kw)
    assert torch.equal(kept, torch.where(want == 255, want, thresh))
    (kg,) = ff_stages_plain(fr, None, (NMSQ,))
    lo_c = torch_ops.threshold_magnitude_bound(torch.tensor(10), 4, "l2") - 1
    hi_c = torch_ops.threshold_magnitude_bound(torch.tensor(40), 4, "l2") - 1
    assert torch.equal(hysteresis_fused_nmsq(kg, lo_c, hi_c, **kw), want)


def test_spiral_threshold_map_cap_digests(dev):
    """K6 on the 1080p spiral threshold map cut off at caps 100 and 400: the
    recorded digests of tests/test_cap_golden.py."""
    import hashlib

    t = torch.from_numpy(make_spiral_thresh(1080, 1920)).to(dev)
    for cap, sha in [(100, "61ca860520f82b7a43be20833dcc5858dd7e6d25770f37aa4d9ed3e991848417"),
                     (400, "a822292e4a2125148907b11f7ca4ed75552e46db4bfa02d196364616b2bfa20d")]:
        out, iters = hysteresis_fused(t, max_iters=cap, dilate_steps=16, scan_after=12,
                                      return_iters=True)
        assert int(iters) == cap
        assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() == sha


#: Shapes at the round kernels' band edges (bands are multiples of 32 columns).
BAND_EDGE_SHAPES = [(33, 31), (33, 33), (33, 129), (33, 1000), (200, 1000)]
#: Planes past the word rows one band in a block's shared memory holds (476
#: in phase 2, 785 in phase 1): stacked height segments.
TALL_SHAPES = [(16000, 33), (26000, 129)]


@pytest.mark.parametrize("h,w", SHAPES + BAND_EDGE_SHAPES + TALL_SHAPES)
@pytest.mark.parametrize("dilate_steps,scan_after,max_iters", [
    (16, 64, 100), (16, 1, 100), (3, 2, 5), (40, 1, 3),
    (1, 1, 100), (8, 2, 100), (9, 1, 60), (32, 2, 40), (256, 1, 4),  # halo and segments
    (16, 1, 1), (16, 1, 2), (16, 2, 2),  # caps of 1 and 2 rounds
])
def test_rounds_match_plain(dev, h, w, dilate_steps, scan_after, max_iters):
    f, p = ff_pack_plain(_frame(h, w, dev, seed=w), _thr(10, 40, dev))
    fk, flags = f.clone(), torch.zeros((2, 2), dtype=torch.int32, device=dev)
    hyst_phase1(fk, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters)
    f1, it, grow = bitpack.converge_phase1(f, p, h, w, dilate_steps, scan_after, max_iters)
    assert torch.equal(fk, f1) and flags[0].tolist() == [it, int(grow)]
    hyst_phase2(fk, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters)
    if grow:
        f1, it, grow = bitpack.converge_phase2(f1, p, h, w, it, dilate_steps, max_iters)
    assert torch.equal(fk, f1) and flags[1].tolist() == [it, int(grow)]
    assert torch.equal(unpack(fk, h), unpack_plain(f1, h))


@pytest.mark.parametrize("h,w,n", [(37, 53, 3), (80, 256, 5), (1, 1, 2), (720, 1280, 4),
                                   (33, 129, 3), (64, 1000, 4), (33, 31, 6),
                                   (16000, 64, 2), (26000, 33, 3)])
@pytest.mark.parametrize("scan_after,max_iters", [(10, 100), (1, 100), (2, 5), (4, 4), (1, 1),
                                                  (1, 2)])
def test_batched_rounds_match_plain(dev, h, w, n, scan_after, max_iters):
    """Batched round kernels against the plain frame-by-frame loops, on a
    batch whose frames stop at different rounds (the spiral escalates; at a
    cap of 1 or 2 rounds every frame stops there)."""
    frames = [_frame(h, w, dev, seed=s) for s in range(n - 1)]
    frames.append(torch.from_numpy(make_spiral_frame(h, w)).to(dev) if min(h, w) >= 8
                  else _frame(h, w, dev, seed=99))
    thr = _thr(10, 40, dev)
    f, p = ff_pack_batched(torch.stack(frames), thr)
    kw = dict(dilate_steps=16, max_iters=max_iters)
    fk, flags = f.clone(), torch.zeros((n, 2, 2), dtype=torch.int32, device=dev)
    hyst_phase1(fk, p, flags, h, scan_after=scan_after, **kw)
    fp, flags_p = f.clone().cpu(), torch.zeros((n, 2, 2), dtype=torch.int32)
    hyst_phase1(fp, p.cpu(), flags_p, h, scan_after=scan_after, **kw)
    assert torch.equal(fk.cpu(), fp) and torch.equal(flags.cpu()[:, 0], flags_p[:, 0])
    hyst_phase2(fk, p, flags, h, **kw)
    hyst_phase2(fp, p.cpu(), flags_p, h, **kw)
    assert torch.equal(fk.cpu(), fp) and torch.equal(flags.cpu(), flags_p)
    assert torch.equal(unpack(fk, h).cpu(), unpack_plain(fp, h))


@pytest.mark.parametrize("h,w,n", [(37, 53, 3), (512, 1024, 4)])
def test_batched_pipeline_matches_single_frames(dev, h, w, n):
    frames = [_frame(h, w, dev, seed=s) for s in range(n - 1)]
    frames.append(torch.from_numpy(make_spiral_frame(h, w)).to(dev))
    batch, thr = torch.stack(frames), _thr(10, 40, dev)
    for x in (batch, batch[..., 1].contiguous()):
        kernels.reset_launch_counts()
        edges, flags = canny_mega_pipeline_batched(x, thr, scan_after=2)
        assert kernels.launch_counts() == dict(dict.fromkeys(kernels.KERNELS, 0),
                                               **dict.fromkeys(MAIN_PATH, 1))
        for i in range(n):
            e1, f1 = canny_mega_pipeline(x[i], thr, scan_after=2)
            assert torch.equal(edges[i], e1) and torch.equal(flags[i], f1)


def test_pipeline_and_engine_match_plain(dev):
    cfg = CannyConfig(height=512, width=1024)
    eng = CannyEngine(cfg, device="cuda")
    spiral = torch.from_numpy(make_spiral_frame(512, 1024)).to(dev)
    kernels.reset_launch_counts()
    for fr in (_frame(512, 1024, dev, seed=1), spiral):
        got = eng.process(fr)
        want = torch_ops.canny_to_stage(fr, *eng._thresholds(), cfg, CannyStage.HYSTER)
        assert torch.equal(got, want)
    counts = kernels.launch_counts()
    assert all(counts[k] == 2 for k in MAIN_PATH) and counts["ff_stages"] == 0
    _, flags = canny_mega_pipeline(spiral, eng._thresholds(), scan_after=2)
    assert flags[0].tolist()[1] == 1


@pytest.mark.parametrize("channels", [3, 1])
def test_every_stage_and_process_all_match_plain(dev, channels):
    cfg = CannyConfig(height=96, width=200, channels=channels, hysteresis_scan_after=2)
    eng = CannyEngine(cfg, device="cuda")
    fr = _frame(96, 200, dev, seed=4)
    if channels == 1:
        fr = fr[..., 0].contiguous()
    thr = eng._thresholds()
    for stage in CannyStage:
        want = torch_ops.canny_to_stage(fr, thr[0], thr[1], cfg, stage)
        assert torch.equal(eng.process(fr, stage), want), stage
    got = eng.process_all(fr)
    want = torch_ops.canny_all_stages(fr, thr[0], thr[1], cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    batch = torch.stack([fr, torch.flip(fr, (0,)).contiguous()])
    for stage in (CannyStage.NMS, CannyStage.HYSTER):
        kernels.reset_launch_counts()
        out = eng.process(batch, stage)
        assert kernels.launch_counts()["ff_stages"] == (stage == CannyStage.NMS)  # one a batch
        assert all(torch.equal(out[i], eng.process(batch[i], stage)) for i in range(2))


def test_no_host_sync_on_the_hot_path(dev):
    eng = CannyEngine(CannyConfig(height=256, width=512), device="cuda")
    fr = _frame(256, 512, dev, seed=2)
    batch = torch.stack([fr, _frame(256, 512, dev, seed=3)])
    calls = [lambda: eng.process(fr), lambda: eng.process(batch),
             lambda: eng.process(fr, CannyStage.GRADIENT), lambda: eng.process_all(fr)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _kg(h, w, dev, seed=0, **kw):
    (kg,) = ff_stages(_frame(h, w, dev, seed=seed), None, (NMSQ,), **kw)
    return kg


@pytest.mark.parametrize("h,w", SHAPES + [(33, 1919), (4320, 7680)])
def test_sweep_pack_matches_plain(dev, h, w):
    """Every slot's planes from one ``sweep_pack_all`` launch over planes
    that held other words; then each slot's seed from the same prior
    planes. The pairs hold negatives, a duplicate and a pair that does not
    dominate the next; the values negatives and ones past every bound."""
    g = torch.Generator().manual_seed(h + w)
    kg = torch.randint(-100, 3000, (h, w), generator=g, dtype=torch.int32).to(dev)
    bounds = torch.tensor([900, 2000, 900, 2000, -4, 2500, 100, 400, 0, 0],
                          dtype=torch.int32, device=dev)
    shape = (5, -(-h // 32), w)
    f0 = torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int32).to(dev)
    p0 = torch.randint(-2**31, 2**31 - 1, shape, generator=g, dtype=torch.int32).to(dev)
    f, p, fp, pp = f0.clone(), p0.clone(), f0.clone(), p0.clone()
    kernels.reset_launch_counts()
    sweep_pack_all(kg, bounds, f, p)
    assert kernels.launch_counts()["sweep_pack_all"] == 1
    sweep_pack_all_plain(kg, bounds, fp, pp)
    assert torch.equal(f, fp) and torch.equal(p, pp)
    for slot in range(1, 5):
        f, fp = f0.clone(), f0.clone()
        sweep_seed(bounds, slot, f)
        sweep_seed_plain(bounds, slot, fp)
        assert torch.equal(f, fp), slot


@pytest.mark.parametrize("h,w,n", [(37, 53, 3), (80, 256, 6), (1, 1, 2), (720, 1280, 16),
                                   (33, 1919, 3), (64, 1921, 2), (17, 16, 2), (1080, 1920, 4)])
def test_unpack_to_index_matches_plain(dev, h, w, n):
    g = torch.Generator().manual_seed(n)
    f = torch.randint(-2**31, 2**31 - 1, (n, -(-h // 32), w), generator=g,
                      dtype=torch.int32).to(dev)
    index = torch.randperm(n, generator=g).to(torch.int32).to(dev)
    got = unpack(f, h, index)
    assert torch.equal(got, unpack_plain(f, h, index))
    assert torch.equal(got[index.long()], unpack(f, h))


@pytest.mark.parametrize("h,w", [(80, 256), (37, 53), (1, 1), (720, 1280)])
@pytest.mark.parametrize("scan_after,max_iters", [(64, 100), (2, 100), (2, 5), (3, 3)])
def test_sweep_fused_matches_plain(dev, h, w, scan_after, max_iters):
    """Shuffled pairs with negative lows and an exact duplicate, both seed
    modes, converged and cut off by the cap."""
    kg = _kg(h, w, dev, seed=5)
    cfg = CannyConfig(height=h, width=w)
    lows = torch.tensor([20, -1, 5, -3, 20, 10, 40], dtype=torch.int32, device=dev)
    highs = torch.tensor([60, 40, 40, 30, 60, 25, 254], dtype=torch.int32, device=dev)
    bounds = sweep_bounds(lows, highs, cfg)
    kw = dict(dilate_steps=16, scan_after=scan_after, max_iters=max_iters)
    for seed in (True, False):
        got = sweep_fused(kg, bounds, monotone_seed=seed, **kw)
        assert torch.equal(got, sweep_fused_plain(kg, bounds, monotone_seed=seed, **kw)), seed


def test_sweep_spiral_cut_off_by_the_cap(dev):
    """The truncating spiral: seeded finals [5, 9, 13] against cold [5, 5, 5]
    (and [738, 1410, 2018] against [738, 738, 738] with phase 2)."""
    t = torch.from_numpy(make_spiral_thresh(64, 128)).to(dev)
    kg = torch.where(t == 255, 3, torch.where(t == 128, 2, 0)).to(torch.int32)
    bounds = torch.tensor([1, 2, 1, 2, 0, 2], dtype=torch.int32, device=dev)
    for (max_iters, scan_after), want in (((4, 100), ([5, 9, 13], [5, 5, 5])),
                                          ((6, 2), ([738, 1410, 2018], [738, 738, 738]))):
        kw = dict(max_iters=max_iters, scan_after=scan_after, dilate_steps=1)
        for seed, finals in zip((True, False), want):
            got = sweep_fused(kg, bounds, monotone_seed=seed, **kw)
            assert torch.equal(got, sweep_fused_plain(kg, bounds, monotone_seed=seed, **kw))
            assert (got == 255).sum((1, 2)).tolist() == finals


@pytest.mark.parametrize("parity", ["reference", "opencv"])
def test_engine_threshold_sweep_matches_plain(dev, parity):
    cfg = CannyConfig(height=256, width=512, parity=parity, hysteresis_scan_after=2)
    eng = CannyEngine(cfg, device="cuda")
    fr = _frame(256, 512, dev, seed=6)
    lows, highs = [20, -3, 5, 20, 10], [60, 30, 40, 60, 25]
    kernels.reset_launch_counts()
    maps, counts = eng.threshold_sweep(fr, lows, highs)
    assert kernels.launch_counts() == dict(dict.fromkeys(kernels.KERNELS, 0), ff_stages=1,
                                           sweep_pack_all=1, sweep_seed=4, hyst_phase1=5,
                                           hyst_phase2=5, unpack=1)  # 3K + 2
    want, want_counts = torch_ops.threshold_sweep(fr, torch.tensor(lows), torch.tensor(highs), cfg)
    assert torch.equal(maps, want) and torch.equal(counts, want_counts)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.threshold_sweep(fr, lows, highs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- the tile-sharded path: K8 (mega_export), K9 (saturate_packed), K10
# (unpack_core) and the halo exchange, each against its plain version, and
# the sharded engine against the single-frame engine.

from cudacam_tpu_torch.engine import ShardedCannyEngine  # noqa: E402
from cudacam_tpu_torch.ops.cuda.halo import halo_exchange, halo_exchange_plain  # noqa: E402
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (  # noqa: E402
    saturate_packed, saturate_packed_plain,
)
from cudacam_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    mega_export, mega_export_plain, unpack_core, unpack_core_plain,
)
from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh  # noqa: E402
from cudacam_tpu_torch.parallel.packed_halo import sharded_loop, sharded_loop_plain  # noqa: E402

SHARDED = [((96, 384), (1, 2, 1)), ((200, 320), (1, 2, 2)), ((64, 96), (2, 4, 2)),
           ((37, 53), (1, 1, 1)), ((540, 960), (1, 2, 2))]


def _batch(h, w, n, dev):
    frames = [_frame(h, w, dev, seed=s) for s in range(n - 1)]
    if min(h, w) >= 28:
        frames.append(torch.from_numpy(make_spiral_frame(h, w)).to(dev))
    else:
        frames.append(_frame(h, w, dev, seed=n))
    return torch.stack(frames)


def _tiles(h, w, mesh, **kw):
    return build_sharded_pipeline(CannyConfig(height=h, width=w, **kw), make_mesh(*mesh))


#: Export tilings whose tile pitch is not 16-byte aligned: 959 BGR columns
#: of a 1918-pixel frame, 968 of a 1936-pixel (aligned) frame.
UNALIGNED_TILES = [((66, 1918), (1, 2, 2)), ((64, 1936), (1, 1, 2))]


@pytest.mark.parametrize("hw,mesh", SHARDED + UNALIGNED_TILES)
@pytest.mark.parametrize("kw", CONFIGS)
def test_mega_export_matches_plain(dev, hw, mesh, kw):
    h, w = hw
    t = _tiles(h, w, mesh, **kw).tiling
    batch, thr = _batch(h, w, 2, dev), _thr(10, 40, dev)
    rounds = dict(dilate_steps=16, scan_after=3, max_iters=100)
    for x in (batch, batch[..., 1].contiguous(), batch[1:]):  # the last: base one frame in
        got = mega_export(x, thr, t, **kw, **rounds)
        want = mega_export_plain(x, thr, t, **kw, **rounds)
        for g, e in zip(got, want):
            assert torch.equal(g, e)


@pytest.mark.parametrize("hw,mesh", SHARDED)
@pytest.mark.parametrize("scan_after,max_iters", [(64, 100), (2, 100), (2, 5), (3, 3)])
def test_saturate_packed_matches_plain(dev, hw, mesh, scan_after, max_iters):
    h, w = hw
    pipe = _tiles(h, w, mesh)
    f, p, flags = mega_export(_batch(h, w, 2, dev), _thr(10, 40, dev), pipe.tiling,
                              dilate_steps=16, scan_after=2, max_iters=100)
    kw = dict(dilate_steps=16, scan_after=scan_after, max_iters=max_iters)
    ext_h = pipe.geo.ext_h
    fk, flk = f.clone(), flags.clone()
    fp, flp = f.clone(), flags.clone()
    kernels.reset_launch_counts()
    _, grow = saturate_packed(fk, p, flk, ext_h, **kw)
    counts = kernels.launch_counts()
    _, grow_p = saturate_packed_plain(fp, p, flp, ext_h, **kw)
    assert torch.equal(fk, fp) and torch.equal(flk, flp) and torch.equal(grow, grow_p)
    assert counts["saturate_phase1"] == 1 and counts["hyst_phase1"] == 0
    assert counts["saturate_phase2"] == int(scan_after < max_iters)


#: Meshes whose tiles put e_top % 32 != 0 (16, 8, 12, 24) and odd core
#: widths (53, 37), and the 8K (1, 4, 2) tiles of the main sharded path.
ODD_CORES = [((64, 96), (1, 8, 1)), ((48, 106), (1, 4, 2)), ((40, 74), (1, 5, 2)),
             ((96, 74), (2, 4, 2)), ((120, 106), (1, 3, 2)), ((4320, 7680), (1, 4, 2))]


@pytest.mark.parametrize("hw,mesh", SHARDED + ODD_CORES)
def test_unpack_core_matches_plain(dev, hw, mesh):
    h, w = hw
    t = _tiles(h, w, mesh).tiling
    g = torch.Generator().manual_seed(h + w)
    n = 2 * t.tiles
    f = torch.randint(-2**31, 2**31 - 1, (n, -(-t.ext_h // 32), t.ext_w), generator=g,
                      dtype=torch.int32).to(dev)
    out = torch.full((2, h, w), 7, dtype=torch.uint8, device=dev)
    want = unpack_core_plain(f, out.clone(), t)
    assert torch.equal(unpack_core(f, out, t), want) and not (want == 7).any()
    tt = dataclasses.replace(t, e_top=t.e_top + 1, e_left=t.e_left + 1, ext_h=t.ext_h + 1,
                             ext_w=t.ext_w + 1)  # one bit and one lane further in
    f2 = torch.randint(-2**31, 2**31 - 1, (n, -(-tt.ext_h // 32), tt.ext_w), generator=g,
                       dtype=torch.int32).to(dev)
    want = unpack_core_plain(f2, out.clone(), tt)
    assert torch.equal(unpack_core(f2, out, tt), want)


@pytest.mark.parametrize("hw,mesh", SHARDED + [((64, 96), (1, 8, 1)), ((64, 96), (1, 2, 4))])
def test_halo_exchange_matches_plain(dev, hw, mesh):
    h, w = hw
    geo = _tiles(h, w, mesh).geo
    nb, ny, nx = mesh
    g = torch.Generator().manual_seed(h * w)
    x = torch.randint(-2**31, 2**31 - 1, (nb * ny * nx, geo.hw, geo.ext_w), generator=g,
                      dtype=torch.int32)
    x &= torch.randint(-2**31, 2**31 - 1, x.shape, generator=g, dtype=torch.int32)  # sparser
    x = x.to(dev)
    one = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)  # noqa: E731
    grown = torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
    grown[-1] = 1
    for grow in (None, torch.zeros_like(grown), grown):
        pk, pp = one(5), one(5)
        xk, xp = x.clone(), x.clone()
        halo_exchange(xk, mesh, geo, grow=grow, pending=pk)
        halo_exchange_plain(xp, mesh, geo, grow=grow, pending=pp)
        assert torch.equal(xk, xp) and torch.equal(pk, pp), grow
        # every bit of a second refresh is already there: only growth is pending
        halo_exchange(xk, mesh, geo, grow=grow, pending=pk)
        assert torch.equal(xk, xp) and int(pk) == int(grow is not None and bool(grow.any()))


@pytest.mark.parametrize("hw,mesh", SHARDED)
@pytest.mark.parametrize("channels", [3, 1])
def test_sharded_engine_matches_engine(dev, hw, mesh, channels):
    """Converged frames equal the single-frame engine's; every stage of the
    sharded pipeline through the kernels equals its plain route."""
    h, w = hw
    cfg = CannyConfig(height=h, width=w, channels=channels)
    batch = torch.stack([_frame(h, w, dev, seed=s) for s in range(2 * mesh[0])])
    if channels == 1:
        batch = batch[..., 0].contiguous()
    eng = CannyEngine(cfg, device="cuda")
    sharded = ShardedCannyEngine(cfg, make_mesh(*mesh))
    kernels.reset_launch_counts()
    got = sharded.process(batch)
    counts = kernels.launch_counts()
    assert {k: v for k, v in counts.items() if v} == dict(
        ff_pack_export=1, hyst_phase1=1, halo_exchange=2, sharded_loop=1, unpack_core=1)
    assert torch.equal(got, eng.process(batch))
    plain = ShardedCannyEngine(cfg, make_mesh(*mesh), device="cpu")
    for stage in CannyStage:
        want = plain.process(batch.cpu(), stage)
        assert torch.equal(sharded.process(batch, stage).cpu(), want), stage


def test_sharded_spiral_cut_off_by_the_cap_matches_plain(dev):
    """Cap-class growth across tiles: the kernel route equals the plain
    route byte for byte where the cap cuts the output off."""
    h, w = 256, 384
    cfg = CannyConfig(height=h, width=w, max_hysteresis_iters=12, hysteresis_scan_after=4)
    spiral = torch.from_numpy(make_spiral_frame(h, w))[None]
    mesh = make_mesh(1, 2, 2)
    run = build_sharded_pipeline(cfg, mesh)
    thr = _thr(10, 40, dev)
    got = run(spiral.to(dev), thr)
    rounds = int(run.rounds)
    want = run(spiral, thr.cpu())
    assert torch.equal(got.cpu(), want) and rounds == int(run.rounds) == 12
    converged = CannyEngine(CannyConfig(height=h, width=w), device="cuda").process(spiral[0])
    assert not torch.equal(got[0], converged)  # the cap cut it off


@pytest.mark.parametrize("cap", [100, 400])
@pytest.mark.parametrize("hw,mesh", [((256, 384), (1, 2, 2)), ((200, 320), (2, 2, 1)),
                                     ((37, 53), (1, 1, 1)), ((96, 384), (1, 1, 4))])
def test_sharded_loop_matches_the_host_loop(dev, hw, mesh, cap):
    """The one-launch round loop against its plain version (the host loop,
    on the same card) from the export's state: the planes, every tile's
    flags and the round count, converged and cut off by the budget (the
    spiral at budget 3); six launches a call whatever the cap."""
    h, w = hw
    cfg = CannyConfig(height=h, width=w, max_hysteresis_iters=cap, hysteresis_scan_after=4)
    pipe = build_sharded_pipeline(cfg, make_mesh(*mesh))
    frames = _batch(h, w, 2 * mesh[0], dev)
    kw = dict(dilate_steps=16, scan_after=4, max_iters=cap)
    for max_rounds in (cap, 3):
        f, p, flags = mega_export(frames, _thr(10, 40, dev), pipe.tiling, **kw)
        fp, pp, flp = f.clone(), p.clone(), flags.clone()
        grid = (2 * mesh[0], mesh[1], mesh[2])
        rounds = sharded_loop(f, p, flags, grid, pipe.geo, max_rounds=max_rounds, **kw)
        want = sharded_loop_plain(fp, pp, flp, grid, pipe.geo, max_rounds=max_rounds, **kw)
        assert int(rounds) == int(want) <= max_rounds
        assert torch.equal(f, fp) and torch.equal(p, pp) and torch.equal(flags, flp)
    sharded = ShardedCannyEngine(cfg, make_mesh(*mesh))
    sharded.process(frames)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = sharded.process(frames)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == dict(
        ff_pack_export=1, hyst_phase1=1, halo_exchange=2, sharded_loop=1, unpack_core=1)
    plain = ShardedCannyEngine(cfg, make_mesh(*mesh), device="cpu")
    assert torch.equal(got.cpu(), plain.process(frames.cpu()))
    assert int(sharded.pipeline().rounds) == int(plain.pipeline().rounds)


def test_sharded_no_host_sync(dev):
    cfg = CannyConfig(height=256, width=512)
    eng = ShardedCannyEngine(cfg, make_mesh(2, 2, 2))
    batch = torch.stack([_frame(256, 512, dev, seed=s) for s in range(2)])
    calls = [lambda: eng.process(batch), lambda: eng.process(batch, CannyStage.THRESH)]
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# -- K11: the column-split continuation ---------------------------------------

from cudacam_tpu_torch.ops.cuda.hysteresis import (  # noqa: E402
    hysteresis_sweeps, hysteresis_sweeps_plain,
)
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (  # noqa: E402
    converge_packed_split, converge_packed_split_plain,
)


def _split_both(t, flags0, n_split, dev, **kw):
    """Kernel and plain from the same planes and flags: (f, flags) of each."""
    h = t.shape[0]
    f, p = bitpack.pack_pair(t.to(dev))
    out = []
    for fn in (converge_packed_split, converge_packed_split_plain):
        fk, fl = f.clone(), torch.tensor(flags0, dtype=torch.int32, device=dev)
        _, growing = fn(fk, p, fl, h, n_split, **kw)
        assert int(growing) == int(fl[1, 1])
        out.append((fk, fl))
    return out


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("kw", [
    dict(dilate_steps=4, scan_after=2, max_iters=12, chunk=4),   # cut off by the budget
    dict(dilate_steps=4, scan_after=0, max_iters=20, chunk=8),   # the continuation's schedule
    dict(dilate_steps=4, scan_after=2, max_iters=5),             # unchunked, cut off
    dict(dilate_steps=4, scan_after=2, max_iters=3000, chunk=8),  # converges
    dict(dilate_steps=1, scan_after=3, max_iters=9, chunk=1),
])
def test_converge_packed_split_matches_plain(dev, n_split, kw):
    for t in (make_spiral_thresh(64, 512), make_spiral_thresh(96, 384)):
        for it0 in (0, 3):
            (fk, flk), (fp, flp) = _split_both(torch.from_numpy(t), [[it0, 1], [0, 0]], n_split,
                                               dev, **kw)
            assert flk.tolist() == flp.tolist(), (flk.tolist(), flp.tolist())
            assert torch.equal(fk, fp)


def test_converge_packed_split_gate_and_odd_shapes(dev):
    g = torch.Generator().manual_seed(5)
    t = torch.tensor([0, 128, 255], dtype=torch.uint8)[
        torch.multinomial(torch.tensor([0.5, 0.45, 0.05]), 37 * 54, True, generator=g)
    ].reshape(37, 54)
    for n_split in (2, 3, 6):
        kw = dict(dilate_steps=3, scan_after=1, max_iters=40, chunk=4)
        (fk, flk), (fp, flp) = _split_both(t, [[2, 1], [0, 0]], n_split, dev, **kw)
        assert torch.equal(fk, fp) and flk.tolist() == flp.tolist()
        # growing == 0: nothing runs, row 1 = row 0
        (fk, flk), (fp, flp) = _split_both(t, [[7, 0], [9, 9]], n_split, dev, **kw)
        f0, _ = bitpack.pack_pair(t.to(dev))
        assert torch.equal(fk, f0) and torch.equal(fp, f0)
        assert flk.tolist() == flp.tolist() == [[7, 0], [7, 0]]
    with pytest.raises(ValueError):
        _split_both(t, [[0, 1], [0, 0]], 4, dev, dilate_steps=3, max_iters=4)


@pytest.mark.parametrize("h,w", [(64, 512), (270, 480), (37, 54)])
@pytest.mark.parametrize("cap", [100, 400])
def test_engine_split_continuation(dev, cap, h, w):
    """continuation='split' equals the default engine wherever the frame
    converges, equals the plain split route when the cap cuts it off, and
    its launch count does not depend on the cap."""
    frames = [make_scene(h, w, seed=1), make_spiral_frame(h, w) if min(h, w) >= 32 else
              make_scene(h, w, seed=2)]
    kw = dict(height=h, width=w, hysteresis_scan_after=2, max_hysteresis_iters=cap)
    base = CannyEngine(CannyConfig(**kw), device="cuda")
    split = CannyEngine(CannyConfig(continuation="split", **kw), device="cuda")
    plain = CannyEngine(CannyConfig(continuation="split", **kw), device="cpu")
    for fr in frames:
        split.process(fr)
        kernels.reset_launch_counts()
        got = split.process(fr)
        counts = kernels.launch_counts()
        assert {k: v for k, v in counts.items() if v} == dict(
            ff_pack=1, hyst_phase1=1, split_converge=1, unpack=1)
        assert torch.equal(got.cpu(), plain.process(fr))
        _, flags = canny_mega_pipeline(torch.from_numpy(fr).to(dev), split._thresholds(),
                                       **_pipeline_kw(split.config), continuation="split")
        if int(flags[1, 1]) == 0:
            assert torch.equal(got, base.process(fr))
    batch = torch.from_numpy(__import__("numpy").stack(frames)).to(dev)
    kernels.reset_launch_counts()
    bout = split.process(batch)
    assert kernels.launch_counts()["split_converge"] == 2
    for b, fr in enumerate(frames):
        assert torch.equal(bout[b], split.process(fr))


def _pipeline_kw(cfg):
    from cudacam_tpu_torch.ops.cuda.canny import pipeline_kwargs

    return pipeline_kwargs(cfg)


# -- K12: the legacy row-sweep hysteresis ------------------------------------


def _random_map(h, w, seed, p_final=0.03):
    g = torch.Generator().manual_seed(seed)
    idx = torch.multinomial(torch.tensor([0.5, 0.5 - p_final, p_final]), h * w, True, generator=g)
    return torch.tensor([0, 128, 255], dtype=torch.uint8)[idx].reshape(h, w)


@pytest.mark.parametrize("h,w", [(40, 96), (37, 53), (1, 1), (200, 300)])
@pytest.mark.parametrize("block_h", [None, 8, 16, 24, 56])
def test_hysteresis_sweeps_matches_plain(dev, h, w, block_h):
    t = _random_map(h, w, h + w).to(dev)
    for max_iters, max_local in ((100, 4096), (1, 4096), (100, 2), (1, 1), (0, 3), (3, 0)):
        for rc in (True, False):
            kw = dict(max_iters=max_iters, remove_candidates=rc, block_h=block_h,
                      max_local_iters=max_local, return_info=True)
            got, info = hysteresis_sweeps(t, **kw)
            want, winfo = hysteresis_sweeps_plain(t, **kw)
            assert torch.equal(got, want), kw
            assert info[:2].tolist() == winfo[:2].tolist(), kw
    # converged: the fused hysteresis' fixed point
    assert torch.equal(hysteresis_sweeps(t, block_h=block_h), hysteresis_fused(t, max_iters=10000))


def test_hysteresis_sweeps_spiral_cut_off(dev):
    t = torch.from_numpy(make_spiral_thresh(64, 128)).to(dev)
    for max_iters, max_local, finals in ((100, 4096, 4097), (2, 4096, 875), (3, 16, 97)):
        got = hysteresis_sweeps(t, max_iters=max_iters, block_h=16, max_local_iters=max_local)
        assert torch.equal(got, hysteresis_sweeps_plain(t, max_iters=max_iters, block_h=16,
                                                        max_local_iters=max_local))
        assert int((got == 255).sum()) == finals  # the JAX package's, in interpret mode
    with pytest.raises(ValueError):
        hysteresis_sweeps(torch.zeros((64, 30000), dtype=torch.uint8, device=dev))


# -- the live app, profiling and the debug switches on the card --------------


def test_app_on_the_card_matches_the_engine(dev):
    from cudacam_tpu_torch.app import CannyApp
    from cudacam_tpu_torch.io import SyntheticSource, open_source, to_host

    h, w = 72, 128
    eng = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
    with CannyApp(SyntheticSource(height=h, width=w, n_frames=100), ring_capacity=3) as app:
        seen = []
        assert app.run(10, on_frame=lambda i, o: seen.append((app._last_input, o))) == 10
        for raw, out in seen:  # more frames than staging buffers: each was reused
            assert out.is_cuda and torch.equal(out, eng.process(raw))
        assert all(t.is_cuda for t in app.ring.history()) and len(app._staging) == 3
        assert all(b.is_pinned() for b in app._staging)
        app.ring.wait(len(app.ring) - 1)
        app.toggle_pipeline()
        out = app.step()
        assert out.is_cuda and torch.equal(out.cpu(), torch.from_numpy(app._last_input))
        app.toggle_pipeline()
        assert app.preload_device_loop(4) == 4 and all(t.is_cuda for t in app._device_frames)
        outs = [to_host(app.step()) for _ in range(8)]
        assert (outs[0] == outs[4]).all() and app.status()["backend"] == "cuda"
    with CannyApp(open_source("multi:3*synthetic:72x128", n_frames=4)) as app:
        kernels.reset_launch_counts()
        out = app.step()
        assert {k: v for k, v in kernels.launch_counts().items() if v} == dict.fromkeys(MAIN_PATH, 1)
        for b in range(3):
            assert torch.equal(out[b], eng.process(app._last_input[b]))


@pytest.mark.parametrize("mode", ["auto", "stages", "cumulative", "device"])
def test_profiling_on_the_card(dev, mode):
    from cudacam_tpu_torch.utils.timer import TimerManager

    h, w = 72, 128
    fr = _frame(h, w, dev, seed=2)
    plain = CannyEngine(CannyConfig(height=h, width=w), device="cuda")
    eng = CannyEngine(CannyConfig(height=h, width=w), device="cuda", profiling=True,
                      timers=TimerManager())
    eng.profiling_mode = mode
    if mode == "stages":
        # The plain stage ops are the CPU engine's path: on the card the mode
        # raises, in the engine and when an app is made with it.
        from cudacam_tpu_torch.app import CannyApp
        from cudacam_tpu_torch.io import SyntheticSource

        with pytest.raises(ValueError, match="cpu"):
            eng.process(fr)
        with pytest.raises(ValueError, match="cpu"):
            CannyApp(SyntheticSource(height=h, width=w, n_frames=2), profiling_mode="stages")
    else:
        kernels.reset_launch_counts()
        for stage in CannyStage:
            for x in (fr, torch.stack([fr, fr])):
                assert torch.equal(eng.process(x, stage), plain.process(x, stage))
        assert kernels.launch_counts()["ff_pack"] > 2  # beyond the unprofiled engine's two
        names = [n for n, _, _ in eng.timers.items()]
        assert len(names) == 6 and sum(eng.timers.get_average_time(n) for n in names) > 0.0
        if mode in ("auto", "device"):
            # At 1080p every stage's row reads a time (at 72 x 128 a stage's
            # own buffer is a few ns of the one-pass kernel).
            big = CannyEngine(CannyConfig(height=1080, width=1920), device="cuda", profiling=True,
                              timers=TimerManager())
            big.profiling_mode = mode
            assert big._profiling_mode_resolved() == "device"
            big.process(_frame(1080, 1920, dev, seed=2))
            rows = [n for n, _, _ in big.timers.items()]
            assert len(rows) == 6 and all(big.timers.get_average_time(n) > 0.0 for n in rows), \
                big.profiling_table()
    # off again: process launches exactly the main path and reads nothing back
    eng.set_profiling(False)
    eng.process(fr)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.process(fr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: v for k, v in kernels.launch_counts().items() if v} == dict.fromkeys(MAIN_PATH, 1)


def test_devtime_and_debug_switches_on_the_card(dev, tmp_path):
    from cudacam_tpu_torch.ops.cuda import _build
    from cudacam_tpu_torch.utils import debug
    from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call, event_time_ms_per_call

    eng = CannyEngine(CannyConfig(height=72, width=128), device="cuda")
    fr = _frame(72, 128, dev)
    ev = event_time_ms_per_call(lambda: eng.process(fr), calls=3, device=dev)
    assert ev is not None and ev > 0.0
    busy = device_time_ms_per_call(lambda: eng.process(fr), calls=3, device=dev)
    assert busy is None or 0.0 < busy  # None: this host's profiler cannot see the card
    assert debug.device_health_check() == "cuda"
    debug.enable_checks()
    try:
        assert _build._sync_after_launch
        out = eng.process(fr)  # every launch synchronizes: still the same bytes
    finally:
        debug.disable_checks()
    assert torch.equal(out, eng.process(fr)) and not _build._sync_after_launch
    with eng.trace(str(tmp_path / "prof")):
        eng.process(fr)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


# -- K13, K14: the probes' kernels -------------------------------------------

from cudacam_tpu_torch.probes import hyster_kernel as hk  # noqa: E402
from cudacam_tpu_torch.probes import i16_swar  # noqa: E402


@pytest.mark.parametrize("h,w", [(128, 256), (1, 1), (37, 53), (4320, 7680)])
def test_probe_packs_and_unpacks_match_plain(dev, h, w):
    mask = torch.from_numpy(hk.pack_input(h * w % 7, h, w) * 3).to(dev)
    want = hk.probe_pack_plain(mask)
    kernels.reset_launch_counts()
    assert torch.equal(hk.probe_pack(mask), want) and torch.equal(hk.probe_pack_ballot(mask), want)
    for per_word in (True, False):
        assert torch.equal(hk.probe_unpack(want, per_word), hk.probe_unpack_plain(want))
    counts = kernels.launch_counts()
    assert counts["probe_pack"] == counts["probe_pack_ballot"] == 1
    assert counts["probe_unpack"] == 2


@pytest.mark.parametrize("shape,cap", [((40, 256), 400), ((40, 256), 5), ((1, 1), 400),
                                       ((135, 7680), 3), ((7, 9), 400)])
def test_probe_loop_matches_plain(dev, shape, cap):
    plane = torch.from_numpy(hk.loop_input(*shape)).to(dev)
    got, flags = hk.probe_loop(plane, cap)
    want, want_flags = hk.probe_loop_plain(plane, cap)
    assert torch.equal(got, want) and torch.equal(flags, want_flags)
    if shape == (40, 256) and cap == 400:
        assert flags.tolist() == [[326, 0]]
    limit = hk.probe_loop_max_blocks(dev)
    for blocks in (1, 33, limit):
        assert torch.equal(hk.probe_loop(plane, cap, blocks=blocks)[0], want)
    out, fl = hk.probe_loop(plane, 50, sync_only=True, blocks=limit)
    assert torch.equal(out, plane) and fl.tolist() == [[50, 0]]
    with pytest.raises(RuntimeError):
        hk.probe_loop(plane, 1, blocks=limit + 1)
    assert [b for b, _ in hk.grid_sync_us(dev, rounds=10, reps=1)][-1] == limit


@pytest.mark.parametrize("shape", [(256, 512), (1, 1), (7, 9), (1080, 1920), (3, 513)])
@pytest.mark.parametrize("body", [1, 2, 3, 4])
def test_swar_stencil_matches_plain(dev, shape, body):
    g = torch.Generator().manual_seed(body)
    x = (torch.randint(0, 255, shape, generator=g, dtype=torch.uint8) if body == 4
         else torch.randint(-2**15, 2**15, shape, generator=g, dtype=torch.int16)).to(dev)
    want = i16_swar.swar_stencil_plain(x, body)
    for swar in (True, False):
        assert torch.equal(i16_swar.swar_stencil(x, body, swar), want), swar


@pytest.mark.parametrize("domain,pair", [("reference", (10, 40)), ("reference", (30, 90)),
                                         ("opencv", (20, 80)), ("opencv", (60, 180))])
def test_parity_card_route_equals_cpu_route(dev, domain, pair):
    from cudacam_tpu_torch import parity

    for h, w, seed in ((288, 512, 0), (37, 53, 1)):
        frame = make_scene(h, w, seed=seed)
        assert np.array_equal(parity._our_canny(frame, *pair, domain, dev),
                              parity._our_canny(frame, *pair, domain, "cpu"))


def test_bench_main_prints_one_event_line(dev, capsys):
    from cudacam_tpu_torch import benchmark

    benchmark.main(device=dev, height=270, width=480)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "canny_270x480_event_ms_per_frame_cuda" and rec["value"] > 0
