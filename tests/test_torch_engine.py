"""The port's CannyEngine (cudacam_tpu_torch/engine) on the CPU against the
JAX package's CannyEngine (backend='xla'): every stage, ``process_all`` and
batches, plus its spec lock, threshold controls and import hygiene.

Tolerance: 0 for every integer buffer (the contract is byte equality);
``process_all``'s float planes grad and slope within 1e-6 relative (sqrt and
atan2 round on their own in torch and XLA).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.engine import CannyEngine as JaxEngine
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops.cuda import _build
from cudacam_tpu_torch.state import config_from_jax

torch.set_num_threads(2)

H, W = 80, 256
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cfg():
    return CannyConfig(height=H, width=W, backend="xla")


def port(cfg) -> CannyEngine:
    """The port's engine on the CPU for a JAX package config."""
    return CannyEngine(config_from_jax(cfg), device="cpu")


@pytest.fixture(scope="module")
def frame():
    return make_scene(H, W, seed=3)


def test_hyster_matches_jax_engine(cfg, frame):
    got = port(cfg).process(frame)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = np.asarray(JaxEngine(cfg).process(frame))
    np.testing.assert_array_equal(got.numpy(), want)


def test_tensor_input_and_batch(cfg, frame):
    eng = port(cfg)
    single = eng.process(torch.from_numpy(frame))
    other = make_scene(H, W, seed=4)
    batch = eng.process(np.stack([frame, other]))
    assert tuple(batch.shape) == (2, H, W)
    assert torch.equal(batch[0], single)
    assert torch.equal(batch[1], eng.process(other))


@pytest.mark.parametrize("stage", list(CannyStage))
def test_stages_on_cpu_match_jax_engine(cfg, frame, stage):
    got = port(cfg).process(frame, stage)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(JaxEngine(cfg).process(frame, stage)))


def _assert_all_stages(got, want):
    assert got.keys() == want.keys()
    for k, e in want.items():
        g, e = got[k].numpy(), np.asarray(e)
        assert g.dtype == e.dtype and g.shape == e.shape, k
        if k in ("grad", "slope"):
            np.testing.assert_allclose(g, e, rtol=1e-6, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, e, err_msg=k)


@pytest.mark.parametrize("channels", [3, 1])
def test_process_all_matches_jax_engine(channels):
    cfg = CannyConfig(height=48, width=64, channels=channels, backend="xla",
                      hysteresis_scan_after=2)
    fr = make_scene(48, 64, seed=5)
    if channels == 1:
        fr = fr[..., 1].copy()
    _assert_all_stages(port(cfg).process_all(fr), JaxEngine(cfg).process_all(fr))


def test_batched_stages_match_per_frame(cfg, frame):
    """A batch runs HYSTER through the batched kernels and the display
    stages frame by frame; either way each frame equals its own call, and
    process_all stacks every key."""
    eng = port(cfg)
    batch = np.stack([frame, make_scene(H, W, seed=6), make_scene(H, W, seed=7)])
    for stage in (CannyStage.HYSTER, CannyStage.GRADIENT):
        out = eng.process(batch, stage)
        assert tuple(out.shape) == (3, H, W)
        for i in range(3):
            assert torch.equal(out[i], eng.process(batch[i], stage))
    got = eng.process_all(batch[:2])
    one = eng.process_all(batch[1])
    assert all(torch.equal(got[k][1], one[k]) for k in one)


def test_spec_lock_and_type_checks(cfg):
    eng = port(cfg)
    with pytest.raises(ValueError, match="empty"):
        eng.process(np.zeros((0,), np.uint8))
    with pytest.raises(ValueError, match="empty"):
        eng.process(torch.empty(0, dtype=torch.uint8))
    with pytest.raises(ValueError, match="empty"):
        eng.process(None)
    with pytest.raises(ValueError, match="uint8"):
        eng.process(np.zeros((H, W, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        eng.process(torch.zeros((H, W, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="specs differ"):
        eng.process(np.zeros((H + 1, W, 3), np.uint8))
    with pytest.raises(ValueError, match="specs differ"):
        eng.process(np.zeros((H, W), np.uint8))


def test_mono_engine_accepts_2d():
    cfg = CannyConfig(height=37, width=53, channels=1)
    gray = make_scene(37, 53, seed=1)[..., 0].copy()
    got = port(cfg).process(gray)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JaxEngine(cfg).process(gray)))


def test_clamping_matches_jax_engine(cfg):
    eng, jeng = port(cfg), JaxEngine(cfg)
    for setter, value in [("high", 300), ("low", 400), ("low", -5), ("high", 3),
                          ("low", 10), ("high", 40), ("low", 41), ("high", 0)]:
        getattr(eng, f"set_{setter}_threshold")(value)
        getattr(jeng, f"set_{setter}_threshold")(value)
        assert (eng.get_low_threshold(), eng.get_high_threshold()) == (
            jeng.get_low_threshold(), jeng.get_high_threshold())


def test_threshold_change_rebuilds_nothing(cfg, frame):
    eng, jeng = port(cfg), JaxEngine(cfg)
    before = eng.process(frame)
    builds = _build.load.cache_info()
    for e in (eng, jeng):
        e.set_high_threshold(80)
        e.set_low_threshold(20)
    after = eng.process(frame)
    assert not torch.equal(before, after)
    np.testing.assert_array_equal(after.numpy(), np.asarray(jeng.process(frame)))
    assert _build.load.cache_info() == builds
    thr = eng._thresholds()
    assert thr.tolist() == [20, 80] and eng._thresholds() is thr  # cached by value


def test_warmup_and_device(cfg):
    pcfg = config_from_jax(cfg)
    eng = CannyEngine(pcfg, device="cpu")
    eng.warmup()
    eng.warmup(batch=2)
    eng.warmup(CannyStage.NMS, batch=3)
    assert eng.device == torch.device("cpu") and eng.config is pcfg


def test_device_checks(cfg):
    pcfg = config_from_jax(cfg)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        CannyEngine(pcfg, device="meta")
    if not torch.cuda.is_available():
        # The default device is the card: without one, construction raises.
        for dev in ({}, dict(device="cuda:0")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                CannyEngine(pcfg, **dev)
    elif shutil.which("nvcc") is None:
        # A CUDA engine without a working build raises at construction.
        with pytest.raises(RuntimeError, match="nvcc"):
            CannyEngine(pcfg, device="cuda:0")


def test_import_needs_no_jax_nvcc_or_triton():
    code = (
        "import sys\n"
        "import cudacam_tpu_torch, cudacam_tpu_torch.engine, cudacam_tpu_torch.state\n"
        "import cudacam_tpu_torch.ops.cuda.canny\n"
        "import cudacam_tpu_torch.io.sources\n"
        "from cudacam_tpu_torch import CannyConfig\n"
        "from cudacam_tpu_torch.engine import CannyEngine\n"
        "import numpy as np\n"
        "eng = CannyEngine(CannyConfig(height=37, width=53), device='cpu')\n"
        "out = eng.process(np.zeros((37, 53, 3), np.uint8))\n"
        "assert int(out.sum()) == 0\n"
        "for mod in ('jax', 'triton', 'cv2'):\n"
        "    assert mod not in sys.modules, mod\n"
        "print(cudacam_tpu_torch.probe()['cuda_available'])\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() in ("True", "False")  # probe()["cuda_available"]


# -- per-stage profiling ------------------------------------------------------

from cudacam_tpu.stages import CANNY_STAGE_NAMES  # noqa: E402
from cudacam_tpu_torch.utils.timer import TimerManager  # noqa: E402


def _profiled(cfg, mode: str) -> CannyEngine:
    eng = CannyEngine(config_from_jax(cfg), device="cpu", profiling=True, timers=TimerManager())
    eng.profiling_mode = mode
    return eng


@pytest.mark.parametrize("mode", ["auto", "stages", "cumulative", "device"])
def test_profiled_outputs_equal_unprofiled(cfg, frame, mode):
    """Every profiling mode returns the unprofiled bytes, for every final
    stage, single and batched, and fills the timers of the stages it ran."""
    eng, plain = _profiled(cfg, mode), port(cfg)
    batch = np.stack([frame, make_scene(H, W, seed=4)])
    for stage in CannyStage:
        for x in (frame, batch):
            assert torch.equal(eng.process(x, stage), plain.process(x, stage)), (mode, stage)
    names = [CANNY_STAGE_NAMES[s] for s in CannyStage]
    counts = [eng.timers.get_count(n) for n in names]
    # Stage k is timed by every run to a stage >= k: 6 final stages x 2 inputs.
    assert counts == [12, 10, 8, 6, 4, 2]
    table = eng.profiling_table()
    assert all(n in table for n in names) and "TOTAL" in table
    assert all(eng.timers.get_average_time(n) >= 0.0 for n in names)


def test_profiling_modes_and_toggles(cfg, frame):
    eng = port(cfg)
    assert not eng.is_profiling_enabled() and eng.profiling_mode == "auto"
    assert eng.backend == "cpu" and eng._profiling_mode_resolved() == "stages"
    hyster = CANNY_STAGE_NAMES[CannyStage.HYSTER]
    before = eng.timers.get_count(hyster)
    eng.process(frame)
    assert eng.timers.get_count(hyster) == before  # off: nothing is timed
    eng.set_profiling(True)
    eng.process(frame)
    assert eng.timers.get_count(hyster) == before + 1
    eng.set_profiling(False)
    eng.profiling_mode = "nope"
    eng.process(frame)  # off: the mode is not read
    eng.set_profiling(True)
    with pytest.raises(ValueError):
        eng.process(frame)


def test_cumulative_increments_are_clamped_and_sum_to_the_last_run(cfg, frame):
    eng = _profiled(cfg, "cumulative")
    eng.process(frame)
    times = [eng.timers.get_average_time(CANNY_STAGE_NAMES[s]) for s in CannyStage]
    assert all(t >= 0.0 for t in times) and sum(times) > 0.0
    assert ("cumwarm", False, CannyStage.HYSTER) in eng._profile_warmed


def test_device_mode_samples_once_and_warmup_drops_samples(cfg, frame):
    eng = _profiled(cfg, "device")
    hyster = CANNY_STAGE_NAMES[CannyStage.HYSTER]
    eng.warmup()
    assert eng.timers.get_count(hyster) == 0  # the warm-up samples are dropped
    assert not [k for k in eng._profile_warmed if k[0] == "devsample"]
    for _ in range(3):
        eng.process(frame)
    assert eng.timers.get_count(hyster) == 1  # sampled on the first frame only
    eng2 = _profiled(cfg, "stages")
    eng2.warmup(CannyStage.NMS, batch=2)
    assert eng2.profiling_table() == "(no timers)"


def test_trace_writes_a_chrome_trace(cfg, frame, tmp_path):
    import json

    eng = port(cfg)
    with eng.trace(str(tmp_path / "prof")):
        eng.process(frame)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_devtime_on_the_cpu_is_none():
    from cudacam_tpu_torch.utils.devtime import device_time_ms_per_call, event_time_ms_per_call

    calls = []
    assert device_time_ms_per_call(lambda: calls.append(1), device="cpu") is None
    assert event_time_ms_per_call(lambda: calls.append(1), device="cpu") is None
    assert not calls  # no device lane: nothing is run


def _events(*spec):
    """Fake ``prof.events()`` entries: (name, "cpu" or "cuda", start µs, µs)."""
    from types import SimpleNamespace

    kinds = {"cpu": torch.autograd.DeviceType.CPU, "cuda": torch.autograd.DeviceType.CUDA}
    return [SimpleNamespace(name=name, device_type=kinds[kind], time_range=SimpleNamespace(
        start=start, elapsed_us=lambda us=us: us)) for name, kind, start, us in spec]


def test_device_lane_leaves_host_entries_out():
    """The busy time sums the device-side entries only: a host op's entry
    repeats its kernels' device time and must not count twice."""
    from cudacam_tpu_torch.utils.devtime import whole_session_us

    events = _events(("aten::add_", "cpu", 0, 5.0), ("add_kernel", "cuda", 1, 5.0),
                     ("hyst_kernel", "cuda", 2, 7.5), ("Memcpy HtoD", "cuda", 3, 2.0),
                     ("cudaLaunchKernel", "cpu", 1, 0.0))
    assert whole_session_us(events, calls=1) == 14.5


@pytest.mark.parametrize("extra,want", [
    ((), 20.0),
    ((("hyst_kernel", "cuda", 9, 3.0),), None),  # a third hyst_kernel in two calls: not whole
    ((("old_kernel", "cuda", -4, 3.0),), 20.0),  # before the session's first host event: left out
    ((("hyst_kernel", "cuda", -4, 3.0),), 20.0),
    ((("at::cuda::spin_kernel(long)", "cuda", 1, 3.0),), 20.0),  # a sentinel: left out
])
def test_whole_session_counts_only_a_whole_trace(extra, want):
    """A session of two identical calls counts when every device entry is a
    multiple of two; device events from before the session and the
    sentinels are left out."""
    from cudacam_tpu_torch.utils.devtime import whole_session_us

    events = _events(("aten::op", "cpu", 0, 1.0), ("hyst_kernel", "cuda", 1, 4.0),
                     ("unpack_kernel", "cuda", 2, 6.0), ("aten::op", "cpu", 5, 1.0),
                     ("hyst_kernel", "cuda", 6, 4.0), ("unpack_kernel", "cuda", 7, 6.0), *extra)
    assert whole_session_us(events, calls=2) == want
    assert whole_session_us(_events(("aten::op", "cpu", 0, 1.0)), calls=2) is None


@pytest.mark.parametrize("extra,n_lane,whole", [
    ((), 4, True),
    ((("at::cuda::spin_kernel(long)", "cuda", -9, 1.0),) * 3, 4, True),  # sentinels: left out
    ((("at::cuda::spin_kernel(long)", "cuda", 1, 1.0),), 4, True),
    ((("old_kernel", "cuda", -4, 3.0),), 4, True),  # before the first host event
    ((("unpack_kernel", "cuda", 9, 6.0),), 5, False),  # three unpacks in two calls
])
def test_session_lane_leaves_sentinels_out_and_checks_whole_multiples(extra, n_lane, whole):
    """The accounting the trace tools share (``port_profile.trace``,
    ``device_events``, the device profiling mode): the lane of a session of
    two calls holds the device events after the session's first host event,
    sentinels left out, and is whole when every entry is a multiple of two."""
    from cudacam_tpu_torch.utils.devtime import session_lane, whole_session_us

    events = _events(("aten::op", "cpu", 0, 1.0), ("hyst_kernel", "cuda", 1, 4.0),
                     ("unpack_kernel", "cuda", 2, 6.0), ("aten::op", "cpu", 5, 1.0),
                     ("hyst_kernel", "cuda", 6, 4.0), ("unpack_kernel", "cuda", 7, 6.0), *extra)
    lane, got = session_lane(events, calls=2)
    assert (len(lane), got) == (n_lane, whole)
    assert all("spin_kernel" not in e.name and e.time_range.start >= 0 for e in lane)
    assert (whole_session_us(events, calls=2) is not None) == whole
    assert session_lane(_events(("aten::op", "cpu", 0, 1.0)), calls=2) == ([], False)


def test_open_session_launches_the_sentinels_on_the_card_only(cfg, frame, tmp_path, monkeypatch):
    """``open_session`` launches its sentinels on the device it is given;
    the engine's CPU trace opens no session on a card."""
    from cudacam_tpu_torch.utils import devtime

    seen = []
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: seen.append(n))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: seen.append(("sync", dev)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: __import__("contextlib").nullcontext())
    devtime.open_session("cuda:0", 3)
    assert seen == [1, 1, 1, ("sync", torch.device("cuda:0"))]
    seen.clear()
    eng = port(cfg)
    with eng.trace(str(tmp_path / "prof")):
        eng.process(frame)
    assert seen == []
