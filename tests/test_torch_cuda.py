"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs a CUDA device and nvcc: every test here is marked ``cuda`` and skips
without a card. The module imports no jax, so it runs on a GPU host that
has none (``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``;
the repository's conftest pins JAX to the CPU and imports it).

Tolerance: 0. Packed words, flags and edge maps are integers; the contract
is byte equality with the plain version on the same inputs.
"""
from __future__ import annotations

import pytest
import torch

from cudacam_tpu.io.sources import make_scene, make_spiral_frame
from cudacam_tpu_torch import CannyConfig, CannyStage
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops import bitpack, cuda as kernels, torch_ops
from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack, ff_pack_plain
from cudacam_tpu_torch.ops.cuda.megakernel import (
    canny_mega_pipeline, hyst_phase1, hyst_phase2, unpack, unpack_plain,
)

pytestmark = pytest.mark.cuda

SHAPES = [(80, 256), (37, 53), (1, 1), (2, 5), (720, 1280)]


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


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("kw", [{}, dict(kernel_size=3, norm="l1"),
                                dict(kernel_size=7, parity="opencv", grad_coeff=2)])
def test_ff_pack_matches_plain(dev, h, w, kw):
    fr = _frame(h, w, dev, seed=h)
    for lo, hi in [(0, 0), (10, 40), (254, 255), (-3, 300)]:  # C '/' truncates: floor_div
        thr = torch.tensor([lo, hi], dtype=torch.int32, device=dev)
        for x in (fr, fr[..., 2].contiguous()):
            got, want = ff_pack(x, thr, **kw), ff_pack_plain(x, thr, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dilate_steps,scan_after,max_iters", [(16, 64, 100), (16, 1, 100),
                                                               (3, 2, 5), (40, 1, 3)])
def test_rounds_match_plain(dev, h, w, dilate_steps, scan_after, max_iters):
    f, p = ff_pack_plain(_frame(h, w, dev, seed=w), torch.tensor([10, 40], dtype=torch.int32, device=dev))
    fk, flags = f.clone(), torch.zeros((2, 2), dtype=torch.int32, device=dev)
    hyst_phase1(fk, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters)
    f1, it, grow = bitpack.converge_phase1(f, p, h, w, dilate_steps, scan_after, max_iters)
    assert torch.equal(fk, f1) and flags[0].tolist() == [it, int(grow)]
    hyst_phase2(fk, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters)
    if grow:
        f1, it, grow = bitpack.converge_phase2(f1, p, h, w, it, dilate_steps, max_iters)
    assert torch.equal(fk, f1) and flags[1].tolist() == [it, int(grow)]
    assert torch.equal(unpack(fk, h), unpack_plain(f1, h))


def test_pipeline_and_engine_match_plain(dev):
    cfg = CannyConfig(height=512, width=1024)
    eng = CannyEngine(cfg, device="cuda")
    spiral = torch.from_numpy(make_spiral_frame(512, 1024)).to(dev)
    kernels.reset_launch_counts()
    for fr in (_frame(512, 1024, dev, seed=1), spiral):
        got = eng.process(fr)
        want = torch_ops.canny_to_stage(fr, *eng._thresholds(), cfg, CannyStage.HYSTER)
        assert torch.equal(got, want)
    assert all(n == 2 for n in kernels.launch_counts().values())
    _, flags = canny_mega_pipeline(spiral, eng._thresholds(), scan_after=2)
    assert flags[0].tolist()[1] == 1


def test_no_host_sync_on_the_hot_path(dev):
    eng = CannyEngine(CannyConfig(height=256, width=512), device="cuda")
    fr = _frame(256, 512, dev, seed=2)
    eng.process(fr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.process(fr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_non_hyster_stage_raises(dev):
    eng = CannyEngine(CannyConfig(height=37, width=53), device="cuda")
    with pytest.raises(NotImplementedError):
        eng.process(_frame(37, 53, dev), CannyStage.THRESH)
