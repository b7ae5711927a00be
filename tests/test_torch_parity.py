"""The port's parity tool (``cudacam_tpu_torch/parity.py``) on ``device='cpu'``:
the gates of ``tests/test_parity_gate.py`` and the parity cases of
``tests/test_parity_mode.py`` through the port, every score equal (tolerance
0) to the JAX ``compare_frame`` on the same frame, and cv2's input equal byte
for byte to ``numpy_oracle``'s."""
from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from cudacam_tpu import parity as jax_parity  # noqa: E402
from cudacam_tpu.ops import numpy_oracle as oracle  # noqa: E402
from cudacam_tpu_torch import CannyConfig, CannyStage, parity  # noqa: E402
from cudacam_tpu_torch.cli import main as port_cli  # noqa: E402
from cudacam_tpu_torch.engine import CannyEngine  # noqa: E402
from cudacam_tpu_torch.io import make_scene  # noqa: E402
from cudacam_tpu_torch.ops import torch_ops  # noqa: E402

_DATA = os.path.join(os.path.dirname(__file__), "data")
_CROPS = sorted(glob.glob(os.path.join(_DATA, "ytcrop_*.png")))

# The gates of tests/test_parity_gate.py.
MIN_OURS_NEAR_CV = 0.95
MIN_CV_NEAR_OURS = 0.98
MIN_EXACT_IOU = 0.90
EDGE_RATIO_RANGE = (0.90, 1.15)


def _scores(frame, *args, **kw):
    """The port's scores on the CPU, held equal to the JAX module's."""
    got = parity.compare_frame(frame, *args, device="cpu", **kw)
    assert got == jax_parity.compare_frame(frame, *args, **kw)
    return got


@pytest.mark.parametrize("path", _CROPS, ids=[os.path.basename(p) for p in _CROPS])
def test_crop_parity_gate(path):
    frame = cv2.imread(path)
    assert frame is not None and frame.shape == (288, 512, 3)
    s = _scores(frame, low=10, high=40)
    assert s["ours_within_1px_of_cv2"] >= MIN_OURS_NEAR_CV, s
    assert s["cv2_within_1px_of_ours"] >= MIN_CV_NEAR_OURS, s
    assert s["exact_iou"] >= MIN_EXACT_IOU, s
    lo, hi = EDGE_RATIO_RANGE
    assert lo <= s["edge_count_ratio"] <= hi, s


def test_gate_has_crops():
    assert len(_CROPS) == 4, _CROPS


def test_alternate_thresholds_hold():
    frame = cv2.imread(_CROPS[0])
    s = _scores(frame, low=30, high=90)
    assert s["ours_within_1px_of_cv2"] >= 0.93, s
    assert s["cv2_within_1px_of_ours"] >= 0.97, s


_BASE = os.path.join(_DATA, "ytbase.png")
_PAIR_GRID = [(10, 40), (20, 60), (30, 90)]
# tests/test_parity_gate.py's floors per (parity domain, pair).
_SEQ_MIN = {
    ("opencv", (10, 40)): (0.95, 0.98, 0.92),
    ("opencv", (20, 60)): (0.95, 0.97, 0.91),
    ("opencv", (30, 90)): (0.84, 0.97, 0.80),
    ("reference", (10, 40)): (0.95, 0.98, 0.92),
    ("reference", (20, 60)): (0.95, 0.97, 0.91),
    ("reference", (30, 90)): (0.84, 0.97, 0.80),
}


@pytest.mark.parametrize("parity_domain", ["opencv", "reference"])
@pytest.mark.parametrize("pair", _PAIR_GRID, ids=lambda p: f"lo{p[0]}hi{p[1]}")
def test_sequence_parity_gate(pair, parity_domain):
    base = cv2.imread(_BASE)
    assert base is not None and base.shape == (576, 1024, 3)
    frames = parity.pan_zoom_frames(base, n_frames=12)
    want = jax_parity.pan_zoom_frames(base, n_frames=12)
    assert [f.tobytes() for f in frames] == [f.tobytes() for f in want]
    lo, hi = pair
    worst = None
    for i, f in enumerate(frames):
        s = _scores(f, low=lo, high=hi, parity=parity_domain)
        key = (s["ours_within_1px_of_cv2"], s["cv2_within_1px_of_ours"], s["exact_iou"])
        if worst is None or key < worst[0]:
            worst = (key, i, s)
    (ours_near, cv_near, iou), idx, s = worst
    min_ours, min_cv, min_iou = _SEQ_MIN[(parity_domain, pair)]
    assert ours_near >= min_ours, (idx, s)
    assert cv_near >= min_cv, (idx, s)
    assert iou >= min_iou, (idx, s)


def _frames():
    yield "crop0", cv2.imread(_CROPS[0])
    yield "scene", make_scene(37, 53, seed=4)
    yield "gray", make_scene(40, 64, seed=5)[..., 1].copy()


@pytest.mark.parametrize("name", [n for n, _ in _frames()])
def test_cv2_input_is_the_oracles(name):
    frame = dict(_frames())[name]
    got = parity.cv2_input(frame)
    want = oracle.gaussian_blur(oracle.rgb2mono(frame), 5)
    assert got.dtype == want.dtype == np.uint8 and got.tobytes() == want.tobytes()


# --- tests/test_parity_mode.py's parity cases, through the port -------------


def test_sqrt_threshold_equivalence():
    """The port's opencv-domain comparator keeps m > t^2, which equals
    sqrt(m) > t on the full magnitude range."""
    sx = torch.arange(0, 1021, 7, dtype=torch.int32)[:, None].expand(-1, 146).contiguous()
    sy = torch.arange(0, 1021, 7, dtype=torch.int32)[None, :].expand(146, -1).contiguous()
    keep = torch.ones_like(sx, dtype=torch.bool)
    m = (sx.to(torch.int64) ** 2 + sy.to(torch.int64) ** 2).numpy()
    for t in (0, 1, 10, 40, 100, 255, 1000, 1443):
        out = torch_ops.double_threshold_opencv(sx, sy, keep, torch.tensor(t), torch.tensor(t))
        np.testing.assert_array_equal(out.numpy() == 255, np.sqrt(m) > t)


@pytest.mark.parametrize("norm", ["l2", "l1"])
def test_oracle_vs_port_bit_exact(norm):
    frame = make_scene(48, 64, seed=11)
    cfg = CannyConfig(height=48, width=64, parity="opencv", norm=norm)
    ref = oracle.canny_pipeline(frame, 30, 120, parity="opencv", norm=norm)
    for stage, key in [(CannyStage.NMS, "nms"), (CannyStage.THRESH, "thresh"),
                       (CannyStage.HYSTER, "hyster")]:
        out = torch_ops.canny_to_stage(torch.from_numpy(frame), torch.tensor(30),
                                       torch.tensor(120), cfg, stage)
        np.testing.assert_array_equal(out.numpy(), ref[key], err_msg=f"{norm}/{key}")


def test_domains_differ_but_map_to_each_other():
    """Reference thresholds (t) and opencv thresholds (t * 8/grad_coeff)
    select nearly the same edges: they differ only where the reference's
    uint8 truncation loses sub-integer precision."""
    frame = make_scene(64, 96, seed=12)
    ref_mode = parity._our_canny(frame, 10, 40, "reference", "cpu")
    cv_mode = parity._our_canny(frame, 20, 80, "opencv", "cpu")
    np.testing.assert_array_equal(
        ref_mode, oracle.canny_pipeline(frame, 10, 40, parity="reference")["hyster"])
    np.testing.assert_array_equal(
        cv_mode, oracle.canny_pipeline(frame, 20, 80, parity="opencv")["hyster"])
    disagree = (ref_mode != cv_mode).mean()
    assert disagree < 0.02, disagree


def test_threshold_cap_per_parity():
    assert CannyConfig(height=8, width=8).threshold_cap == 255
    assert CannyConfig(height=8, width=8, parity="opencv").threshold_cap == 2048
    cfg = CannyConfig(height=8, width=8, parity="opencv")
    c2 = cfg.with_thresholds(500, 1500)
    assert (c2.low_threshold, c2.high_threshold) == (500, 1500)


def test_engine_clamp_uses_parity_cap():
    eng = CannyEngine(CannyConfig(height=16, width=16, parity="opencv",
                                  low_threshold=100, high_threshold=400), device="cpu")
    eng.set_high_threshold(5000)
    assert eng.get_high_threshold() == 2048


def test_profiled_matches_unprofiled_opencv_domain():
    """Profiling applies the configured parity domain."""
    frame = make_scene(48, 64, seed=21)
    cfg = CannyConfig(height=48, width=64, parity="opencv",
                      low_threshold=100, high_threshold=400)
    plain = CannyEngine(cfg, device="cpu").process(frame).numpy()
    profiled = CannyEngine(cfg, device="cpu", profiling=True).process(frame).numpy()
    np.testing.assert_array_equal(profiled, plain)
    # Thresholds beyond the uint8 cap must still produce edges here.
    assert (plain == 255).any()


def test_compare_frame_healthy_on_photo_like_scene():
    frame = make_scene(96, 128, seed=13)
    scores = _scores(frame, 10, 40)
    assert scores["ours_within_1px_of_cv2"] > 0.9
    assert scores["cv2_within_1px_of_ours"] > 0.9


def test_parity_report_shape():
    rep = parity.parity_report(n_frames=2, height=64, width=96, device="cpu")
    assert rep["n_frames"] >= 2
    assert set(rep["summary"]) == {
        "ours_within_1px_of_cv2",
        "cv2_within_1px_of_ours",
        "edge_count_ratio",
        "exact_iou",
    }
    assert rep == jax_parity.parity_report(n_frames=2, height=64, width=96)


# --- the port's own surface ---------------------------------------------------


@pytest.mark.parametrize("parity_domain,lo,hi", [("reference", 10, 40), ("reference", 30, 90),
                                                 ("opencv", 20, 80), ("opencv", 60, 180)])
def test_engine_route_equals_plain_route_inside_the_caps(parity_domain, lo, hi):
    """The card's route (``CannyEngine.process``, here on the CPU) and the
    plain route give the same map for a pair inside the engine's caps, the
    engine reused across pairs."""
    frame = make_scene(48, 80, seed=7)
    np.testing.assert_array_equal(parity._engine_canny(frame, lo, hi, parity_domain, "cpu"),
                                  parity._our_canny(frame, lo, hi, parity_domain, "cpu"))


@pytest.mark.parametrize("parity_domain,pair,clamped", [
    ("reference", (-40, 40), (0, 40)), ("reference", (50, 40), (50, 50)),
    ("opencv", (90, 80), (90, 90)),
])
def test_out_of_cap_pair_differs_between_routes(parity_domain, pair, clamped):
    """The engine clamps a pair outside its range (low < 0, low > high) as
    its setters do, and the plain ops take it as given: the two routes then
    give different maps, so a parity run on the card and one on the CPU agree
    on pairs inside the caps only."""
    frame = make_scene(96, 128, seed=13)
    plain = parity._our_canny(frame, *pair, parity_domain, "cpu")
    engine = parity._engine_canny(frame, *pair, parity_domain, "cpu")
    np.testing.assert_array_equal(engine, parity._our_canny(frame, *clamped, parity_domain, "cpu"))
    assert (plain != engine).any()


def test_without_cv2_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    frame = make_scene(32, 48, seed=1)
    for call in (lambda: parity.compare_frame(frame, device="cpu"),
                 lambda: parity.parity_report(n_frames=1, height=32, width=48, device="cpu"),
                 lambda: parity.pan_zoom_frames(frame, n_frames=2)):
        with pytest.raises(ImportError, match="cv2"):
            call()


def test_parity_cli_matches_the_jax_report(capsys):
    argv = ["--frames", "2", "--height", "64", "--width", "96", "--low", "20", "--high", "60"]
    assert port_cli(["parity", "--device", "cpu"] + argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == jax_parity.parity_report(n_frames=2, height=64, width=96, low=20, high=60)


def test_parity_report_from_a_source_matches_the_jax_report():
    rep = parity.parity_report(n_frames=2, source_spec="synthetic:48x64", device="cpu")
    assert rep == jax_parity.parity_report(n_frames=2, source_spec="synthetic:48x64")
    with pytest.raises(ValueError, match="no frames"):
        parity.parity_report(n_frames=0, height=32, width=48, device="cpu")


def test_parity_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["parity", "--frames", "1", "--height", "32", "--width", "48"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.parity_report(n_frames=1, height=32, width=48)
