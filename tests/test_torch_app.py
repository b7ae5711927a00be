"""The port's live app (``cudacam_tpu_torch.app.CannyApp``), its IO layer,
its debug utilities and the CLI's ``run``, on ``device='cpu'``: the cases of
``tests/test_io_app.py``, ``test_multi_camera.py`` and ``test_debug_utils.py``
through the port, and the app's outputs, recorded ``.npy`` files and
composed display frames held to the JAX package's ``CannyApp`` on the same
seeded frames. Tolerance 0: every buffer is uint8 and the contract is byte
equality."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from cudacam_tpu.app import CannyApp as JaxApp
from cudacam_tpu.io import SyntheticSource as JaxSynthetic
from cudacam_tpu.io import ascii_preview as jax_ascii_preview
from cudacam_tpu.io.compose import compose as jax_compose
from cudacam_tpu.io.multi import BatchSource as JaxBatchSource
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu_torch import CannyConfig, CannyStage
from cudacam_tpu_torch.app import CannyApp
from cudacam_tpu_torch.cli import build_parser, main as cli_main
from cudacam_tpu_torch.io import (
    DeviceRingBuffer, FpsMeter, SequenceSource, SyntheticSource, ascii_preview, make_scene,
    open_source, save_png, to_host,
)
from cudacam_tpu_torch.io.compose import MODES, compose, montage
from cudacam_tpu_torch.io.keys import KeyController, dispatch_key
from cudacam_tpu_torch.io.multi import BatchSource
from cudacam_tpu_torch.ops.cuda import _build
from cudacam_tpu_torch.utils import debug
from cudacam_tpu_torch.utils.timer import TimerManager

H, W = 40, 64


def _app(**kw):
    kw.setdefault("device", "cpu")
    return CannyApp(SyntheticSource(height=H, width=W, n_frames=100), **kw)


def _children(n=4, h=32, w=48, frames=20, cls=SyntheticSource):
    return [cls(height=h, width=w, seed=s, n_frames=frames) for s in range(n)]


class TestSources:
    def test_synthetic_spec_lock_and_iteration(self):
        with SyntheticSource(height=48, width=64, n_frames=5) as src:
            assert src.spec == (48, 64, 3)
            frames = list(src)
        assert len(frames) == 5
        assert all(f.shape == (48, 64, 3) and f.dtype == np.uint8 for f in frames)

    def test_read_eof_and_read_before_start(self):
        src = SyntheticSource(height=16, width=16, n_frames=1)
        with pytest.raises(RuntimeError):
            src.read()
        src.start()
        src.read()
        with pytest.raises(EOFError):
            src.read()
        src.stop()
        assert not src.is_running()

    def test_sequence_npy_roundtrip_and_loop(self, tmp_path):
        frames = np.stack([make_scene(24, 32, seed=s) for s in range(3)])
        p = str(tmp_path / "seq.npy")
        np.save(p, frames)
        with SequenceSource(p) as src:
            assert src.spec == (24, 32, 3)
            out = list(src)
        assert len(out) == 3
        np.testing.assert_array_equal(out[1], frames[1])
        with SequenceSource(p, loop=True) as src:
            got = [src.read() for _ in range(7)]
        np.testing.assert_array_equal(got[6], frames[0])

    def test_open_source_spec_parsing(self, tmp_path):
        assert isinstance(open_source("synthetic"), SyntheticSource)
        with open_source("synthetic:32x48") as s:
            assert s.spec == (32, 48, 3)
        p = str(tmp_path / "x.npy")
        np.save(p, np.zeros((1, 8, 8), np.uint8))
        assert isinstance(open_source(f"seq:{p}"), SequenceSource)
        assert isinstance(open_source(p), SequenceSource)


class TestRing:
    def test_push_and_history_order(self):
        r = DeviceRingBuffer(3)
        assert r.latest() is None
        for i in range(5):
            r.push(torch.full((2, 2), i, dtype=torch.uint8))
        assert len(r) == 3 and r.total_pushed == 5
        assert r.latest()[0, 0] == 4
        assert [int(h[0, 0]) for h in r.history()] == [4, 3, 2]
        assert int(r.get(2)[0, 0]) == 2
        with pytest.raises(IndexError):
            r.get(3)

    def test_latest_np_readback(self):
        r = DeviceRingBuffer(2)
        assert r.latest_np() is None
        r.push(torch.ones((4, 4), dtype=torch.uint8))
        out = r.latest_np()
        assert isinstance(out, np.ndarray) and out.dtype == np.uint8 and out.sum() == 16
        r.push(np.full((2, 2), 3, np.uint8))  # a host array passes through
        assert r.latest_np().sum() == 12

    def test_wait_is_a_noop_on_the_cpu(self):
        r = DeviceRingBuffer(2)
        r.push(torch.zeros(1))
        r.wait(0)
        with pytest.raises(IndexError):
            r.wait(1)

    def test_clear_and_bad_capacity(self):
        r = DeviceRingBuffer(2)
        r.push(torch.zeros(1))
        r.clear()
        assert len(r) == 0 and r.latest() is None
        with pytest.raises(ValueError):
            DeviceRingBuffer(0)

    def test_to_host(self):
        a = to_host(torch.arange(6, dtype=torch.uint8).reshape(2, 3))
        assert isinstance(a, np.ndarray) and a.tolist() == [[0, 1, 2], [3, 4, 5]]
        b = np.zeros(3, np.uint8)
        assert to_host(b) is b


class TestFpsMeter:
    def test_fps_from_synthetic_clock(self):
        m = FpsMeter(window_s=10.0)
        for i in range(11):
            m.tick(now=i * 0.1)  # 10 fps
        assert abs(m.fps - 10.0) < 0.5
        assert abs(m.ms_per_frame - 100.0) < 5.0
        assert m.total_frames == 11 and abs(m.elapsed_s - 1.0) < 1e-9

    def test_rolling_reset(self):
        m = FpsMeter(window_s=1.0)
        for now in (0.0, 0.5, 2.0, 2.1):  # 2.0 is past the window: resets
            m.tick(now=now)
        assert abs(m.fps - 10.0) < 1.0


class TestPreview:
    @pytest.mark.parametrize("color", [False, True])
    def test_ascii_preview_is_a_copy(self, color):
        for f in (make_scene(32, 48, seed=3), make_scene(33, 50, seed=4)[..., 0]):
            got = ascii_preview(f, width=24, color=color)
            assert got == jax_ascii_preview(f, width=24, color=color) and len(got) > 0

    def test_save_png(self, tmp_path):
        p = str(tmp_path / "sub" / "x.png")
        save_png(p, np.zeros((8, 8), np.uint8))
        assert os.path.exists(p)


class TestApp:
    def test_run_loop_and_ring(self):
        with _app(ring_capacity=4) as app:
            assert app.run(6) == 6
            assert len(app.ring) == 4 and app.ring.total_pushed == 6
            assert all(isinstance(t, torch.Tensor) for t in app.ring.history())
            out = app.ring.latest_np()
            assert out.shape == (H, W) and out.dtype == np.uint8
            assert app.fps > 0

    def test_stage_controls(self):
        with _app() as app:
            assert app.stage == CannyStage.HYSTER
            app.set_stage(CannyStage.MONO)
            app.step()
            assert app.ring.latest_np().shape == (H, W)
            assert app.cycle_stage() == CannyStage.GAUSSIAN
            for _ in range(5):  # wraps around the 6 stages
                app.cycle_stage()
            assert app.stage == CannyStage.MONO

    def test_threshold_clamping_via_app(self):
        with _app() as app:
            app.set_thresholds(low=200)  # clamped to high (40)
            assert app.engine.get_low_threshold() == 40
            app.set_thresholds(high=300)
            assert app.engine.get_high_threshold() == 255

    def test_pause_reuses_last_frame(self):
        with _app() as app:
            app.step()
            app.pause()
            assert app.paused
            f1 = app._last_input
            app.step()
            assert app._last_input is f1  # no new read while paused
            app.resume()
            app.step()
            assert app._last_input is not f1

    def test_toggle_pipeline_passthrough(self):
        with _app() as app:
            assert not app.toggle_pipeline()  # now disabled
            out = app.step()
            assert isinstance(out, torch.Tensor) and out.device == app.engine.device
            assert tuple(out.shape) == (H, W, 3)  # raw BGR passthrough
            np.testing.assert_array_equal(app.ring.latest_np(), app._last_input)
            assert app.toggle_pipeline()

    def test_spec_mismatch_rejected(self):
        src = SyntheticSource(height=H, width=W, n_frames=2)
        with pytest.raises(ValueError):
            CannyApp(src, config=CannyConfig(height=32, width=32), device="cpu")

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError):
            CannyApp(SyntheticSource(height=H, width=W, n_frames=2))  # device='cuda'

    def test_record(self, tmp_path):
        with _app() as app:
            p = app.record(3, str(tmp_path / "out"))
            assert p.endswith("out.npy")
            arr = np.load(p)
            assert arr.shape == (3, H, W) and arr.dtype == np.uint8

    def test_preview_and_save(self, tmp_path):
        with _app() as app:
            assert app.preview() == ""  # nothing yet
            app.step()
            assert len(app.preview(width=32, color=False)) > 0
            assert len(app.preview(width=32, color=False, zoom=2.0, center=(0.2, 0.8))) > 0
            p = app.save_frame(str(tmp_path / "f.png"))
            assert p and os.path.exists(p)

    @pytest.mark.parametrize("mode", ["auto", "stages", "cumulative", "device"])
    def test_profiling_table(self, mode):
        src = SyntheticSource(height=H, width=W, n_frames=100)
        with CannyApp(src, profiling=True, profiling_mode=mode, device="cpu") as app:
            app.engine._timers = TimerManager()  # not the shared default
            app.warmup()
            assert app.engine.timers.get_count("6/6 Hysteresis") == 0  # warm-up dropped
            app.run(2)
            table = app.profiling_table()
            for name in ("1/6 Mono Conversion", "5/6 Double Threshold", "6/6 Hysteresis"):
                assert name in table
            assert app.engine.timers.get_count("6/6 Hysteresis") == (1 if mode == "device" else 2)
            assert app.status()["profiling"] == table
            app.set_profiling(False)
            assert app.status()["profiling"] is None

    def test_publishing_pairs_raw_and_output(self):
        with _app() as app:
            assert app.published_np() is None  # nothing in the ring yet
            app.enable_publishing(every=2)
            app.warmup()
            assert app.published_np() is None  # nothing published yet
            app.run(4)
            raw, out = app._published_pair
            assert isinstance(raw, np.ndarray) and isinstance(out, np.ndarray)
            assert raw is app._last_input  # frame 4: published on every 2nd
            ref = oracle.canny_pipeline(raw, 10, 40)["hyster"]
            np.testing.assert_array_equal(out, ref)
            assert app.published_np("split").shape == (H, 2 * W, 3)


class TestApplyControls:
    def test_all_controls_and_status_is_json(self):
        with _app() as app:
            app.step()
            st = app.apply_controls(low=5, high=50, stage="nms", paused=True, pipeline=False,
                                    mode="overlay", profiling=True, max_fps=30)
            assert (st["low"], st["high"], st["stage"]) == (5, 50, "NMS")
            assert st["paused"] and not st["pipeline_enabled"] and st["display_mode"] == "overlay"
            assert st["max_fps"] == 30.0 and st["profiling"] is not None
            assert st["backend"] == "cpu" and st["spec"] == (H, W, 3)
            json.dumps(st)  # no tensors in the status
            st = app.apply_controls(stage="5", paused=False, pipeline=True, profiling=False,
                                    max_fps=0)
            assert st["stage"] == "HYSTER" and st["max_fps"] is None and st["profiling"] is None

    @pytest.mark.parametrize("bad", [dict(stage="nope"), dict(mode="nope"), dict(stage="9")])
    def test_invalid_values_raise(self, bad):
        with _app() as app:
            with pytest.raises(ValueError):
                app.apply_controls(**bad)

    def test_live_controls_build_nothing_and_match_a_fresh_engine(self):
        """Threshold moves, a stage cycle through all six, pipeline off/on
        and profiling on/off on a running stream: the kernel library's
        loader is not called, and each output is what an engine built with
        those settings gives for the same frame."""
        from cudacam_tpu_torch.engine import CannyEngine

        with _app() as app:
            app.run(2)
            loads = _build.load.cache_info().misses
            for lo, hi in ((20, 80), (0, 255), (10, 40)):
                app.apply_controls(low=lo, high=hi)
                for _ in CannyStage:
                    stage = app.cycle_stage()
                    out = to_host(app.step())
                    eng = CannyEngine(CannyConfig(height=H, width=W, low_threshold=lo,
                                                  high_threshold=hi), device="cpu")
                    np.testing.assert_array_equal(out, to_host(eng.process(app._last_input, stage)))
            app.apply_controls(pipeline=False)
            app.step()
            app.apply_controls(pipeline=True, profiling=True)
            app.step()
            app.apply_controls(profiling=False)
            app.step()
            assert _build.load.cache_info().misses == loads


class TestCli:
    def test_parser_covers_surface(self):
        args = build_parser().parse_args(
            ["run", "--source", "synthetic:32x32", "--frames", "2", "--stage", "nms",
             "--low", "5", "--high", "50", "--kernel-size", "3", "--norm", "l1",
             "--device", "cpu", "--continuation", "split", "--profile-mode", "device",
             "--device-loop", "3", "--max-fps", "60", "--display", "overlay",
             "--preview", "ascii", "--serve", "0", "--trace", "t", "--record", "r.npy",
             "--record-input", "in.rawv", "--interactive", "--profile", "--parity", "opencv"])
        assert args.stage == "nms" and args.kernel_size == 3 and args.continuation == "split"
        with pytest.raises(SystemExit):
            build_parser().parse_args(["run", "--backend", "xla"])  # no counterpart

    def test_cli_run_end_to_end(self, capsys, tmp_path):
        rc = cli_main(["run", "--device", "cpu", "--source", "synthetic:32x48", "--frames", "3",
                       "--save", str(tmp_path / "o.png"), "--profile",
                       "--record-input", str(tmp_path / "in.rawv")])
        assert rc == 0
        out = capsys.readouterr().out
        assert "3 frames in" in out and "device=cpu" in out and "6/6 Hysteresis" in out
        assert os.path.exists(tmp_path / "o.png")
        with open_source(str(tmp_path / "in.rawv")) as src:
            assert len(list(src)) == 3

    def test_cli_small_cpu_run(self, capsys):
        assert cli_main(["run", "--device", "cpu", "--source", "synthetic:64x128",
                         "--frames", "8"]) == 0
        assert "8 frames in" in capsys.readouterr().out

    def test_cli_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(RuntimeError):
            cli_main(["run", "--source", "synthetic:32x48", "--frames", "2"])

    def test_cli_record_trace_and_device_loop(self, capsys, tmp_path):
        rc = cli_main(["run", "--device", "cpu", "--source", "synthetic:24x32", "--frames", "6",
                       "--device-loop", "3", "--record", str(tmp_path / "rec.npy"),
                       "--trace", str(tmp_path / "trace"), "--continuation", "split"])
        assert rc == 0
        assert np.load(tmp_path / "rec.npy").shape == (6, 24, 32)
        assert os.path.exists(tmp_path / "trace" / "trace.json")
        assert "6 frames in" in capsys.readouterr().out

    def test_cli_multi_run(self, tmp_path):
        import cv2

        rc = cli_main(["run", "--device", "cpu", "--source", "multi:2*synthetic:24x32",
                       "--frames", "3", "--save", str(tmp_path / "wall.png")])
        assert rc == 0
        img = cv2.imread(str(tmp_path / "wall.png"))
        assert img is not None and img.shape[0] >= 24


class TestPacing:
    def test_max_fps_caps_loop_rate(self):
        with CannyApp(SyntheticSource(height=16, width=16, n_frames=100), device="cpu") as app:
            app.warmup()
            app.max_fps = 50.0
            t0 = time.perf_counter()
            app.run(10)
            # 10 frames at <= 50 fps take >= ~0.18 s (the first frame unpaced).
            assert time.perf_counter() - t0 >= 0.15
            assert app.status()["max_fps"] == 50.0

    def test_unpaced_by_default(self):
        with CannyApp(SyntheticSource(height=16, width=16, n_frames=10), device="cpu") as app:
            assert app.max_fps is None
            assert app.status()["profiling"] is None


class TestDeviceLoop:
    def test_source_read_count_is_bounded(self):
        src = SyntheticSource(height=24, width=32, n_frames=1000)
        reads = [0]
        orig = src.read

        def counted():
            reads[0] += 1
            return orig()

        src.read = counted
        with CannyApp(src, device="cpu") as app:
            assert app.preload_device_loop(4) == 4
            assert all(isinstance(t, torch.Tensor) for t in app._device_frames)
            before = reads[0]
            for _ in range(50):
                app.step()
            assert reads[0] == before  # zero further source reads/uploads
            assert app.status()["frames"] >= 50

    def test_outputs_cycle_and_match_single(self):
        with CannyApp(SyntheticSource(height=24, width=32, n_frames=100), device="cpu") as app:
            app.preload_device_loop(3)
            outs = [to_host(app.step()) for _ in range(6)]
        np.testing.assert_array_equal(outs[0], outs[3])
        np.testing.assert_array_equal(outs[1], outs[4])

    def test_publishing_uses_host_raw(self):
        with CannyApp(SyntheticSource(height=24, width=32, n_frames=100), device="cpu") as app:
            app.enable_publishing(every=1)
            app.warmup()
            app.preload_device_loop(2)
            app.step()
            assert isinstance(app._published_pair[0], np.ndarray)  # host raw, not device

    def test_empty_source_raises(self):
        src = SyntheticSource(height=24, width=32, n_frames=1)
        with CannyApp(src, device="cpu") as app:
            app.step()
            with pytest.raises(RuntimeError):
                app.preload_device_loop(2)


class TestKeyControls:
    def test_bindings(self):
        with CannyApp(SyntheticSource(height=24, width=32, n_frames=100), device="cpu") as app:
            assert dispatch_key(app, " ")["paused"] is True
            assert dispatch_key(app, " ")["paused"] is False
            s0 = app.stage
            assert dispatch_key(app, "s")["stage"] == CannyStage((s0 + 1) % len(CannyStage)).name
            assert dispatch_key(app, "p")["pipeline_enabled"] is False
            assert dispatch_key(app, "p")["pipeline_enabled"] is True
            lo0, hi0 = app.engine.get_low_threshold(), app.engine.get_high_threshold()
            assert dispatch_key(app, "]")["low"] == lo0 + 5
            assert dispatch_key(app, "[")["low"] == lo0
            assert dispatch_key(app, "}")["high"] == hi0 + 5
            assert dispatch_key(app, "{")["high"] == hi0
            assert dispatch_key(app, "m")["display_mode"] == MODES[1]
            assert dispatch_key(app, "t")["profiling"] is not None
            assert dispatch_key(app, "x") is None  # unbound

    def test_controller_noop_without_tty(self):
        with CannyApp(SyntheticSource(height=24, width=32, n_frames=100), device="cpu") as app:
            kc = KeyController(app)
            assert kc.start() is False  # pytest's stdin is not a tty
            kc.stop()


class TestDebugUtils:
    def test_health_check_passes_on_the_cpu(self):
        assert debug.device_health_check("cpu") == "cpu"

    def test_health_check_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        with pytest.raises(debug.DeviceError):
            debug.device_health_check()  # the card is the default

    def test_health_check_wraps_other_failures(self):
        with pytest.raises(debug.DeviceError):
            debug.device_health_check("not-a-device")

    def test_enable_disable_checks_roundtrip(self):
        assert not _build._sync_after_launch
        debug.enable_checks()
        try:
            assert _build._sync_after_launch
        finally:
            debug.disable_checks()
        assert not _build._sync_after_launch
        debug.enable_checks(launch_checks=False)
        assert not _build._sync_after_launch
        debug.disable_checks()


class TestBatchSource:
    def test_stacked_frames_and_per_frame_spec(self):
        with BatchSource(_children(3)) as src:
            assert src.spec == (32, 48, 3) and src.batch == 3
            f = src.read()
            assert f.shape == (3, 32, 48, 3) and f.dtype == np.uint8
            assert (f[0] != f[1]).any()  # distinct seeds, distinct cameras

    def test_spec_mismatch_and_empty_rejected(self):
        bad = BatchSource([SyntheticSource(height=32, width=48, n_frames=2),
                           SyntheticSource(height=16, width=48, n_frames=2)])
        with pytest.raises(ValueError):
            bad.start()
        with pytest.raises(ValueError):
            BatchSource([])

    def test_any_child_eof_ends_stream(self):
        kids = [SyntheticSource(height=16, width=16, n_frames=n) for n in (5, 2)]
        with BatchSource(kids) as src:
            assert len(list(src)) == 2

    def test_open_source_multi_forms(self):
        s = open_source("multi:4*synthetic:24x32")
        assert isinstance(s, BatchSource) and s.batch == 4
        assert open_source("multi:synthetic:24x32,synthetic:24x32").batch == 2
        with s:
            f = s.read()
        assert (f[0] != f[1]).any()  # children get distinct seeds


class TestMontage:
    def test_grid_shape(self):
        tiles = [np.full((10, 12, 3), i, np.uint8) for i in range(4)]
        g = montage(tiles)
        assert g.shape == (22, 26, 3)  # 2x2 grid + 2px separators
        assert (g[0, 0] == 0).all() and (g[12, 14] == 3).all()

    def test_compose_batched_overlay(self):
        raw = np.zeros((4, 10, 12, 3), np.uint8)
        proc = np.zeros((4, 10, 12), np.uint8)
        proc[:, 5, 6] = 255
        out = compose(raw, proc, "overlay")
        assert out.shape == (22, 26, 3)
        assert tuple(out[5, 6]) == (0, 0, 255)  # tile 0's red edge

    @pytest.mark.parametrize("mode", MODES)
    def test_compose_is_a_copy(self, mode):
        rng = np.random.default_rng(11)
        raw = rng.integers(0, 256, (3, 10, 12, 3), dtype=np.uint8)
        proc = rng.choice(np.array([0, 128, 255], np.uint8), (3, 10, 12))
        for r, p in ((raw, proc), (raw[0], proc[0]), (raw[0, ..., 0], proc[0]), (None, proc[0]),
                     (raw[0], None)):
            got, want = compose(r, p, mode), jax_compose(r, p, mode)
            assert (got is None and want is None) or got.tobytes() == want.tobytes()
        with pytest.raises(ValueError):
            compose(raw, proc, "nope")


class TestMultiCameraApp:
    def test_app_processes_batch_and_matches_oracle(self):
        with CannyApp(BatchSource(_children(2, frames=10)), device="cpu") as app:
            app.step()
            out = app.ring.latest_np()
            assert out.shape == (2, 32, 48)
            raw = app._last_input
            for i in range(2):  # each camera's map equals the single-frame oracle
                np.testing.assert_array_equal(
                    out[i], oracle.canny_pipeline(raw[i], 10, 40)["hyster"])

    def test_montage_preview(self):
        with CannyApp(BatchSource(_children(4, frames=10)), device="cpu") as app:
            app.step()
            assert len(app.preview(width=40, color=False, mode="split")) > 0


class TestAgainstTheJaxApp:
    """The same seeded frames through the JAX package's app and the
    port's: outputs, recordings and composed display frames, byte for byte."""

    @pytest.mark.parametrize("stage", list(CannyStage))
    def test_outputs_per_stage(self, stage):
        with _app(final_stage=stage) as app, \
                JaxApp(JaxSynthetic(height=H, width=W, n_frames=100), final_stage=stage) as japp:
            for _ in range(3):
                got, want = to_host(app.step()), np.asarray(japp.step())
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
                assert app._last_input.tobytes() == japp._last_input.tobytes()

    def test_recorded_npy_files_are_equal(self, tmp_path):
        with _app() as app, JaxApp(JaxSynthetic(height=H, width=W, n_frames=100)) as japp:
            app.apply_controls(low=20, high=60)
            japp.apply_controls(low=20, high=60)
            p = app.record(4, str(tmp_path / "port.npy"))
            jp = japp.record(4, str(tmp_path / "jax.npy"))
        assert open(p, "rb").read() == open(jp, "rb").read()

    @pytest.mark.parametrize("mode", MODES)
    def test_composed_frames(self, mode):
        with _app() as app, JaxApp(JaxSynthetic(height=H, width=W, n_frames=100)) as japp:
            for a in (app, japp):
                a.enable_publishing(every=1)
                a.run(2)
            got, want = app.published_np(mode), japp.published_np(mode)
            assert got.shape == want.shape and got.tobytes() == want.tobytes()
            assert app.preview(width=32, color=False, mode=mode) == japp.preview(
                width=32, color=False, mode=mode)

    def test_passthrough_and_status_keys(self):
        with _app() as app, JaxApp(JaxSynthetic(height=H, width=W, n_frames=100)) as japp:
            for a in (app, japp):
                a.toggle_pipeline()
            assert to_host(app.step()).tobytes() == np.asarray(japp.step()).tobytes()
            st, jst = app.status(), japp.status()
            assert st.keys() == jst.keys()
            skip = ("backend", "fps")
            assert {k: v for k, v in st.items() if k not in skip} == {
                k: v for k, v in jst.items() if k not in skip}

    def test_multi_camera_montage(self):
        with CannyApp(BatchSource(_children(3, frames=10)), device="cpu") as app, \
                JaxApp(JaxBatchSource(_children(3, frames=10, cls=JaxSynthetic))) as japp:
            for _ in range(2):
                got, want = to_host(app.step()), np.asarray(japp.step())
                assert got.shape == (3, 32, 48) and got.tobytes() == want.tobytes()
            for a in (app, japp):
                a.display_mode = "overlay"
            wall, jwall = (compose(a._last_input, a.ring.latest_np(), "overlay")
                           for a in (app, japp))
            assert wall.tobytes() == jwall.tobytes()
