"""MJPEG preview server — the live-display analog for headless hosts: the
port's copy of ``cudacam_tpu/io/server.py``.

The reference renders its live stream in a desktop GL window
(imguiApp.cpp:393-450). A headless host has no display; the operational
equivalent is an HTTP endpoint: the processing loop keeps pushing outputs
into the device ring, and this server — on its own thread — reads the
newest frame back on demand, JPEG-encodes it, and streams it as
multipart/x-mixed-replace (playable by any browser). Endpoints:

* ``/``            HTML viewer: stream, live status, and CONTROLS (threshold
                   sliders, stage combo, pause, pipeline toggle — the
                   reference's runtime UI, imguiApp.cpp:303-349)
* ``/stream.mjpg`` the MJPEG stream
* ``/frame.jpg``   single snapshot
* ``/status``      the app's live status JSON (stage, thresholds, fps, ...)
* ``/set``         apply controls to the RUNNING stream (GET or POST):
                   ``/set?low=10&high=40&stage=hyster&paused=0&mode=overlay
                   &pipeline=1&profiling=0`` — routed thread-safely into
                   CannyApp.apply_controls; returns the updated status.
                   Threshold moves build nothing (the kernels read them
                   from a device tensor).

Host readback happens only here, at the preview rate — the compute loop
itself never crosses the device->host boundary.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("server")

_PAGE = b"""<!doctype html>
<html><head><title>cudacam_tpu_torch</title>
<style>body{background:#111;color:#ddd;font-family:monospace;text-align:center}
img{max-width:96vw;border:1px solid #444}pre{color:#8c8}
a{color:#6af;margin:0 6px}label{margin:0 8px}
input[type=range]{vertical-align:middle}select,button{background:#222;
color:#ddd;border:1px solid #555;margin:0 4px}</style></head>
<body><h3>cudacam_tpu_torch live</h3>
<div>
<a href="#" onclick="m('edges')">edges</a><a href="#" onclick="m('raw')">raw</a>
<a href="#" onclick="m('split')">split</a><a href="#" onclick="m('overlay')">overlay</a>
</div>
<div>
<label>low <input id="lo" type="range" min="0" max="255" step="1"
 oninput="send({low:this.value})"><span id="lov"></span></label>
<label>high <input id="hi" type="range" min="0" max="255" step="1"
 oninput="send({high:this.value})"><span id="hiv"></span></label>
<select id="st" onchange="send({stage:this.value})">
<option>MONO</option><option>GAUSSIAN</option><option>GRADIENT</option>
<option>NMS</option><option>THRESH</option><option selected>HYSTER</option>
</select>
<button id="pb" onclick="send({paused:st_paused?0:1})">pause</button>
<button onclick="send({pipeline:st_pipe?0:1})">toggle pipeline</button>
</div>
<img id="v" src="/stream.mjpg">
<pre id="s"></pre>
<script>
let st_paused=false, st_pipe=true;
function m(x){send({mode:x});document.getElementById('v').src='/stream.mjpg?mode='+x}
async function send(kv){
  const q=new URLSearchParams(kv).toString();
  const r=await fetch('/set?'+q); show(await r.json());
}
function show(j){
  st_paused=j.paused; st_pipe=j.pipeline_enabled;
  document.getElementById('s').textContent=JSON.stringify(j,null,1);
  document.getElementById('lov').textContent=j.low;
  document.getElementById('hiv').textContent=j.high;
  document.getElementById('pb').textContent=j.paused?'resume':'pause';
  if(document.activeElement.id!='lo')document.getElementById('lo').value=j.low;
  if(document.activeElement.id!='hi')document.getElementById('hi').value=j.high;
}
setInterval(async()=>{const r=await fetch('/status');show(await r.json())},1000)
</script></body></html>
"""


def _encode_jpeg(frame: np.ndarray, quality: int = 85) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return buf.tobytes()


class PreviewServer:
    """Serves the newest ring-buffer frame; runs on a daemon thread."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8080,
                 fps: float = 15.0, quality: int = 85) -> None:
        # Default bind is localhost-only: the stream has no authentication,
        # and a webcam feed must not silently become network-visible.
        self._app = app
        self._fps = fps
        self._quality = quality
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route into our logger
                log.debug("http: " + fmt, *args)

            def do_GET(self):
                try:
                    route, _, query = self.path.partition("?")
                    mode = None
                    for kv in query.split("&"):
                        if kv.startswith("mode="):
                            mode = kv[5:]
                    if route in ("/", "/index.html"):
                        self._send(200, "text/html", _PAGE)
                    elif route == "/set":
                        self._apply(query)
                    elif route == "/status":
                        body = json.dumps(outer._app.status()).encode()
                        self._send(200, "application/json", body)
                    elif route == "/frame.jpg":
                        jpg = outer._snapshot(mode)
                        if jpg is None:
                            self._send(503, "text/plain", b"no frame yet")
                        else:
                            self._send(200, "image/jpeg", jpg)
                    elif route == "/stream.mjpg":
                        self._stream(mode)
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:  # surface as HTTP 500, keep serving
                    log.warning("request %s failed: %s", self.path, e)
                    try:
                        self._send(500, "text/plain",
                                   f"error: {e}".encode())
                    except Exception:
                        pass

            def do_POST(self):
                try:
                    route, _, query = self.path.partition("?")
                    if route == "/set":
                        n = int(self.headers.get("Content-Length", 0) or 0)
                        body = self.rfile.read(n).decode() if n else ""
                        self._apply(body or query)
                    else:
                        self._send(404, "text/plain", b"not found")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception as e:
                    log.warning("request %s failed: %s", self.path, e)
                    try:
                        self._send(500, "text/plain", f"error: {e}".encode())
                    except Exception:
                        pass

            def _apply(self, query: str):
                """Parse controls from a urlencoded query/body and route
                them into the app (thread-safe: CannyApp.apply_controls)."""
                from urllib.parse import parse_qs

                q = {k: v[-1] for k, v in parse_qs(query).items()}
                kw = {}
                try:
                    for key in ("low", "high"):
                        if key in q:
                            kw[key] = int(q[key])
                    if "stage" in q:
                        kw["stage"] = q["stage"]
                    for key in ("paused", "pipeline", "profiling"):
                        if key in q:
                            kw[key] = q[key].lower() in ("1", "true", "on", "yes")
                    if "mode" in q:
                        kw["mode"] = q["mode"]
                    if "max_fps" in q:
                        kw["max_fps"] = float(q["max_fps"])
                    status = outer._app.apply_controls(**kw)
                except (ValueError, KeyError) as e:
                    self._send(400, "text/plain", f"bad request: {e}".encode())
                    return
                self._send(200, "application/json", json.dumps(status).encode())

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, mode=None):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                period = 1.0 / max(0.1, outer._fps)
                while not outer._stopped.is_set():
                    jpg = outer._snapshot(mode)
                    if jpg is not None:
                        self.wfile.write(b"--frame\r\n")
                        self.wfile.write(b"Content-Type: image/jpeg\r\n")
                        self.wfile.write(
                            f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                        )
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                    time.sleep(period)

        self._stopped = threading.Event()
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="preview-http"
        )

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def _snapshot(self, mode: Optional[str] = None) -> Optional[bytes]:
        # Never touch the device from this thread: read the run loop's
        # host-published copy (see CannyApp.enable_publishing).
        frame = self._app.published_np(mode)
        if frame is None:
            return None
        return _encode_jpeg(frame, self._quality)

    def start(self) -> "PreviewServer":
        self._app.enable_publishing()
        self._thread.start()
        log.info("preview server on http://%s:%d/",
                 self._server.server_address[0], self.port)
        return self

    def stop(self) -> None:
        self._stopped.set()
        self._server.shutdown()
        self._server.server_close()
