"""Live runtime controls on the port's streaming pipeline: the reference's
ImGui panel (sliders/stage combo/pause, imguiApp.cpp:303-349) as code.

Starts a synthetic stream with the MJPEG preview server, then drives the
SAME control surface the browser page and `run --interactive` keys use:
CannyApp.apply_controls, thread-safe against the running loop, with
threshold moves building nothing.

    python examples/torch_live_controls.py [--device cpu]
    # then open the printed URL for the browser panel
"""
import argparse
import os
import sys
import threading
import time

# Make the example runnable from a source checkout (no-op when the
# package is installed).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from cudacam_tpu_torch.app import CannyApp
from cudacam_tpu_torch.io import SyntheticSource
from cudacam_tpu_torch.io.server import PreviewServer
from cudacam_tpu_torch.stages import CannyStage

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels (raises without a card); "
                         "cpu: the plain PyTorch ops")
args = parser.parse_args()

with CannyApp(SyntheticSource(height=360, width=640, n_frames=100000),
              device=args.device) as app:
    server = PreviewServer(app, host="127.0.0.1", port=0, fps=15).start()
    app.enable_publishing(every=2)
    app.warmup()
    print(f"live panel: http://127.0.0.1:{server.port}/")

    stop = threading.Event()
    t = threading.Thread(
        target=lambda: [app.step() for _ in iter(stop.is_set, True)],
        daemon=True,
    )
    t.start()

    # Scripted "slider moves" while the stream runs.
    for low, high in ((5, 30), (20, 80), (40, 160)):
        status = app.apply_controls(low=low, high=high)
        print(f"thresholds -> {status['low']}/{status['high']} "
              f"fps={status['fps']}")
        time.sleep(1.0)
    app.apply_controls(stage="nms", mode="overlay")
    time.sleep(1.0)
    app.apply_controls(stage=CannyStage.HYSTER, paused=True)
    print("paused:", app.status()["paused"])
    app.apply_controls(paused=False)
    time.sleep(1.0)

    stop.set()
    t.join(timeout=5)
    server.stop()
    print(f"processed {app.status()['frames']} frames")
