"""The check that decides ``correct``: the plain reference against the
port's CPU path, the control that has to fail it, and a run with the timed
path broken underneath that has to come out not correct."""
import pytest
import torch

from benchmarks import harness, scenes
from benchmarks.reference import canny as reference
from benchmarks.tests.helpers import small_config, small_run, suite_with_stream
from cudacam_tpu_torch import CannyConfig, CannyStage
from cudacam_tpu_torch.engine.engine import CannyEngine
from cudacam_tpu_torch.engine.sharded_engine import ShardedCannyEngine
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda import canny as dispatch
from cudacam_tpu_torch.ops.cuda import megakernel
from cudacam_tpu_torch.parallel import packed_halo, sharded
from cudacam_tpu_torch.parallel.mesh import make_mesh

SUITE = suite_with_stream()
CANNY = dict(SUITE.cell("cam1080p.x8_calm").config["canny"])


def _canny(**kw):
    c = dict(CANNY)
    c.update(kw)
    return c


@pytest.mark.parametrize("seed, t, norm, ks", [(0, 0.0, "l2", 5), (3, 4.0, "l2", 5),
                                               (5, 1.0, "l1", 3), (9, 7.0, "l2", 7)])
def test_reference_equals_the_port_on_scenes(seed, t, norm, ks):
    c = _canny(height=96, width=128, norm=norm, kernel_size=ks)
    frame = scenes.make_scene(96, 128, seed, t, "cpu", generator=torch.Generator().manual_seed(1))
    want = CannyEngine(CannyConfig(**c), device="cpu").process(frame, CannyStage.HYSTER)
    got, _, cut = reference.canny(frame, c)
    assert not cut and torch.equal(got, want)


@pytest.mark.parametrize("cap, scan_after", [(6, 3), (12, 4), (40, 64)])
def test_reference_equals_the_port_on_a_spiral_cut_off_by_the_cap(cap, scan_after):
    c = _canny(height=96, width=128, max_hysteresis_iters=cap, hysteresis_scan_after=scan_after)
    frame = scenes.make_spiral_frame(96, 128, "cpu")
    want = CannyEngine(CannyConfig(**c), device="cpu").process(frame, CannyStage.HYSTER)
    got, rounds, cut = reference.canny(frame, c)
    assert cut and rounds == cap
    assert torch.equal(got, want)


def test_reference_equals_the_tile_path_on_a_converged_frame():
    c = dict(SUITE.cell("mega8k.tiles_calm").config["canny"], height=128, width=256)
    eng = ShardedCannyEngine(CannyConfig(**c), make_mesh(1, 4, 2), device="cpu")
    frames = torch.stack([scenes.make_scene(128, 256, s, 1.0, "cpu",
                                            generator=torch.Generator().manual_seed(s))
                          for s in (0, 1)])
    out = eng.process(frames)
    for k in range(2):
        got, _, cut = reference.canny(frames[k], c)
        assert not cut and torch.equal(out[k], got)


def test_control_fails_on_a_calm_scene():
    """The reference in float16 (mono, Gaussian, Sobel) moves edge pixels."""
    c = _canny(height=96, width=128)
    for seed in (0, 1, 2):
        frame = scenes.make_scene(96, 128, seed, 0.0, "cpu",
                                  generator=torch.Generator().manual_seed(seed))
        exact, _, _ = reference.canny(frame, c)
        low, _, _ = reference.canny(frame, c, torch.float16)
        assert int((exact != low).sum()) > 0


def test_control_in_the_programs_place_fails_the_check():
    cell = SUITE.cell("cam1080p.x8_calm")
    c = small_config(cell)
    inputs = scenes.make_inputs(cell.traffic, 96, 128, 4, "cpu")
    call = harness.make_program(c, "cpu")
    kept = {k: (k, call(inputs.calls[k])) for k in range(2)}
    assert harness.verdict(harness.check(c, inputs, kept))
    numbers = harness.check(c, inputs, kept, chain_dtype=torch.float16)
    assert numbers["mismatched_px"] > 0 and not harness.verdict(numbers)


# --- a run with the timed path broken underneath -------------------------------

def _unchanged_rounds(monkeypatch):
    """Every hysteresis round returns its state unchanged."""
    real = bitpack._make_ops

    def ops(*a, **kw):
        real(*a, **kw)
        return (lambda f, p: f), (lambda f, p: f)

    monkeypatch.setattr(bitpack, "_make_ops", ops)


def _half_batch(monkeypatch):
    """Half of each batch left out: its maps are the first half's."""
    real = dispatch.canny_mega_pipeline_batched

    def half(frames, *a, **kw):
        n = frames.shape[0] // 2
        edges, flags = real(frames[:n], *a, **kw)
        return torch.cat([edges, edges]), torch.cat([flags, flags])

    monkeypatch.setattr(dispatch, "canny_mega_pipeline_batched", half)


def _no_exchange(monkeypatch):
    """The tiles' hysteresis state is never exchanged."""
    monkeypatch.setattr(packed_halo, "halo_exchange_plain", lambda x, *a, **kw: None)


def _altered_answer(monkeypatch):
    """One pixel of every edge map flipped where it is produced."""
    for module, name in ((megakernel, "unpack"), (sharded, "unpack_core")):
        real = getattr(module, name)

        def flip(*a, _real=real, **kw):
            out = _real(*a, **kw)
            out[..., 5, 7] ^= 255
            return out

        monkeypatch.setattr(module, name, flip)


FAULTS = {
    "unchanged_rounds": (_unchanged_rounds, ["cam1080p.stream_calm", "cam1080p.x8_escalating",
                                             "cam1080p.x8_calm", "mega8k.tiles_calm"]),
    "half_batch": (_half_batch, ["cam1080p.x8_escalating", "cam1080p.x8_calm"]),
    "no_exchange": (_no_exchange, ["mega8k.tiles_calm"]),
    "altered_answer": (_altered_answer, ["cam1080p.stream_calm", "cam1080p.x8_escalating",
                                         "cam1080p.x8_calm", "mega8k.tiles_calm"]),
}
CASES = [(f, cell) for f, (_, cells) in FAULTS.items() for cell in cells]


@pytest.mark.parametrize("cell", sorted({c for _, c in CASES}))
def test_a_sound_run_is_correct(cell):
    r = small_run(SUITE, cell)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["mismatched_px"] == {"value": 0, "limit": 0, "rule": "at most"}


@pytest.mark.parametrize("fault, cell", CASES)
def test_a_broken_run_is_not_correct(monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch)
    r = small_run(SUITE, cell)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["mismatched_px"]["value"] > 0
