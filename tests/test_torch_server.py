"""The port's MJPEG preview server (``cudacam_tpu_torch/io/server.py``) on a
``device='cpu'`` app: the cases of ``tests/test_server.py`` through the
port. Served JPEGs are decoded and held to the app's published frame."""
from __future__ import annotations

import http.client
import json

import numpy as np
import pytest

from cudacam_tpu_torch.app import CannyApp
from cudacam_tpu_torch.io import SyntheticSource, open_source
from cudacam_tpu_torch.io.server import PreviewServer, _encode_jpeg
from cudacam_tpu_torch.ops.cuda import _build


@pytest.fixture()
def served_app():
    with CannyApp(SyntheticSource(height=40, width=64, n_frames=50), device="cpu") as app:
        server = PreviewServer(app, host="127.0.0.1", port=0, fps=30).start()
        app.enable_publishing(every=1)
        app.step()  # one published frame
        try:
            yield app, server
        finally:
            server.stop()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    return conn, conn.getresponse()


class TestPreviewServer:
    def test_status_endpoint(self, served_app):
        app, server = served_app
        conn, resp = _get(server.port, "/status")
        assert resp.status == 200
        status = json.loads(resp.read())
        assert status["stage"] == "HYSTER" and status["backend"] == "cpu"
        assert status["frames"] >= 1 and status["spec"] == [40, 64, 3]
        conn.close()

    def test_index_page(self, served_app):
        _, server = served_app
        conn, resp = _get(server.port, "/")
        assert resp.status == 200
        assert b"stream.mjpg" in resp.read()
        conn.close()

    def test_frame_snapshot_is_jpeg(self, served_app):
        _, server = served_app
        conn, resp = _get(server.port, "/frame.jpg")
        assert resp.status == 200
        body = resp.read()
        assert body[:2] == b"\xff\xd8"  # JPEG SOI marker
        conn.close()

    def test_snapshot_decodes_to_the_published_frame(self, served_app):
        import cv2

        app, server = served_app
        for mode, width in (("edges", 64), ("split", 128)):
            conn, resp = _get(server.port, f"/frame.jpg?mode={mode}")
            img = cv2.imdecode(np.frombuffer(resp.read(), np.uint8), cv2.IMREAD_COLOR)
            conn.close()
            want = app.published_np(mode)
            assert img.shape == want.shape == (40, width, 3)
            # JPEG at quality 85 is lossy: hard 0/255 edges move by ringing.
            assert np.abs(img.astype(int) - want.astype(int)).mean() < 40

    def test_no_frame_yet_is_503(self):
        with CannyApp(SyntheticSource(height=40, width=64, n_frames=5), device="cpu") as app:
            server = PreviewServer(app, host="127.0.0.1", port=0).start()
            try:
                conn, resp = _get(server.port, "/frame.jpg")
                assert resp.status == 503
                conn.close()
            finally:
                server.stop()

    def test_mjpeg_stream_yields_parts(self, served_app):
        _, server = served_app
        conn, resp = _get(server.port, "/stream.mjpg")
        assert resp.status == 200
        assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
        chunk = resp.read(4096)  # at least one boundary+jpeg header
        assert b"--frame" in chunk and b"image/jpeg" in chunk
        conn.close()

    def test_404(self, served_app):
        _, server = served_app
        conn, resp = _get(server.port, "/nope")
        assert resp.status == 404
        conn.close()

    def test_encode_jpeg_mono_and_bgr(self):
        assert _encode_jpeg(np.zeros((8, 8), np.uint8))[:2] == b"\xff\xd8"
        assert _encode_jpeg(np.zeros((8, 8, 3), np.uint8))[:2] == b"\xff\xd8"


class TestRecordInput:
    def test_cli_record_input_roundtrip(self, tmp_path):
        from cudacam_tpu_torch.cli import main as cli_main

        raw = str(tmp_path / "in.rawv")
        rc = cli_main(["run", "--device", "cpu", "--source", "synthetic:32x48", "--frames", "3",
                       "--record-input", raw])
        assert rc == 0
        with open_source(raw) as src, SyntheticSource(height=32, width=48, n_frames=3) as ref:
            assert src.spec == (32, 48, 3)
            got, want = list(src), list(ref)
        assert len(got) == 3 and all(g.tobytes() == w.tobytes() for g, w in zip(got, want))

    def test_record_outputs_and_inputs_together(self, tmp_path):
        from cudacam_tpu_torch.cli import main as cli_main

        raw = str(tmp_path / "in.rawv")
        out = str(tmp_path / "out.npy")
        rc = cli_main(["run", "--device", "cpu", "--source", "synthetic:32x48", "--frames", "2",
                       "--record", out, "--record-input", raw])
        assert rc == 0
        assert np.load(out).shape == (2, 32, 48)
        with open_source(raw) as src:
            assert len(list(src)) == 2


class TestLiveControls:
    """The reference's defining UX: moving sliders / switching stage /
    pausing while the stream renders (imguiApp.cpp:303-349). /set routes
    controls into the RUNNING app; threshold moves must build nothing."""

    def test_set_thresholds_live(self, served_app):
        app, server = served_app
        conn, resp = _get(server.port, "/set?low=20&high=90")
        assert resp.status == 200
        status = json.loads(resp.read())
        conn.close()
        assert status["low"] == 20 and status["high"] == 90
        assert app.engine.get_low_threshold() == 20

    def test_set_stage_pause_mode_pipeline(self, served_app):
        app, server = served_app
        conn, resp = _get(
            server.port, "/set?stage=thresh&paused=1&mode=overlay&pipeline=0"
        )
        status = json.loads(resp.read())
        conn.close()
        assert status["stage"] == "THRESH"
        assert status["paused"] is True
        assert status["display_mode"] == "overlay"
        assert status["pipeline_enabled"] is False
        # and back on, via POST body
        conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
        conn.request("POST", "/set", body="paused=0&pipeline=1&stage=5",
                     headers={"Content-Type":
                              "application/x-www-form-urlencoded"})
        status = json.loads(conn.getresponse().read())
        conn.close()
        assert status["paused"] is False
        assert status["pipeline_enabled"] is True
        assert status["stage"] == "HYSTER"

    def test_bad_values_are_400(self, served_app):
        _, server = served_app
        for q in ("/set?stage=nope", "/set?mode=nope", "/set?low=abc"):
            conn, resp = _get(server.port, q)
            assert resp.status == 400, q
            conn.close()

    def test_live_threshold_moves_build_nothing(self, served_app):
        app, server = served_app
        app.step()
        n0 = _build.load.cache_info().misses
        import threading

        stop = threading.Event()

        def loop():
            while not stop.is_set():
                app.step()

        t = threading.Thread(target=loop, daemon=True)
        t.start()
        try:
            for lo, hi in ((5, 50), (15, 80), (0, 255), (30, 30)):
                conn, resp = _get(server.port, f"/set?low={lo}&high={hi}")
                assert resp.status == 200
                conn.close()
        finally:
            stop.set()
            t.join(timeout=10)
        out = app.step()
        assert _build.load.cache_info().misses == n0
        assert (app.engine.get_low_threshold(), app.engine.get_high_threshold()) == (30, 30)
        assert app.engine._thresholds().tolist() == [30, 30] and out.shape == (40, 64)

    def test_profiling_and_max_fps_over_http(self, served_app):
        app, server = served_app
        conn, resp = _get(server.port, "/set?profiling=1&max_fps=120")
        status = json.loads(resp.read())
        conn.close()
        assert status["profiling"] is not None and status["max_fps"] == 120.0
        assert app.engine.is_profiling_enabled()
        conn, resp = _get(server.port, "/set?profiling=0&max_fps=0")
        status = json.loads(resp.read())
        conn.close()
        assert status["profiling"] is None and status["max_fps"] is None

    def test_published_pair_is_atomic_reference(self, served_app):
        app, _ = served_app
        app.step()
        pair = app._published_pair
        assert pair is not None and len(pair) == 2
        raw, out = pair
        assert raw.shape[:2] == out.shape[:2]
