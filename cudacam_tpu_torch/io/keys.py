"""Interactive terminal key controls for a running stream: the port's copy
of ``cudacam_tpu/io/keys.py``.

Analog of the reference's keyboard handling in the SDL event
loop (imguiApp.cpp:180-194): DELETE toggles the CUDA pipeline, any other
key cycles the final stage; plus slider-style bindings the reference keeps
on screen widgets. A daemon thread reads raw single keypresses from the
controlling tty and routes them into ``CannyApp.apply_controls`` — the same
thread-safe path the HTTP /set endpoint uses.

Bindings (printed at start):
    space  pause/resume               s  cycle stage
    p      toggle pipeline (DELETE)   m  cycle display mode
    [ / ]  low threshold -/+ 5        { / }  high threshold -/+ 5
    t      toggle profiling           q  quit (raises KeyboardInterrupt
                                          in the main thread)
"""
from __future__ import annotations

import threading
from typing import Optional

from cudacam_tpu_torch.io.compose import MODES
from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("keys")

HELP = ("keys: space=pause  s=stage  p=pipeline  m=display mode  "
        "[ ]=low -/+  { }=high -/+  t=profiling  q=quit")


def dispatch_key(app, key: str) -> Optional[dict]:
    """Apply one keypress to the app; returns the new status dict, or None
    for an unbound key. Pure control logic — unit-testable without a tty."""
    if key == " ":
        return app.apply_controls(paused=not app.paused)
    if key == "s":
        app.cycle_stage()
        return app.status()
    if key == "p":  # the reference's DELETE toggle (imguiApp.cpp:183-186)
        app.toggle_pipeline()
        return app.status()
    if key == "m":
        i = MODES.index(app.display_mode)
        return app.apply_controls(mode=MODES[(i + 1) % len(MODES)])
    if key == "[":
        return app.apply_controls(low=app.engine.get_low_threshold() - 5)
    if key == "]":
        return app.apply_controls(low=app.engine.get_low_threshold() + 5)
    if key == "{":
        return app.apply_controls(high=app.engine.get_high_threshold() - 5)
    if key == "}":
        return app.apply_controls(high=app.engine.get_high_threshold() + 5)
    if key == "t":
        app.set_profiling(not app.engine.is_profiling_enabled())
        return app.status()
    return None


class KeyController:
    """Daemon thread turning raw tty keypresses into app controls."""

    def __init__(self, app) -> None:
        self._app = app
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        """Begin listening; returns False (no-op) when stdin is not a tty."""
        import sys

        if not sys.stdin.isatty():  # piped/CI runs: nothing to listen to
            log.debug("stdin is not a tty; key controls disabled")
            return False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="key-controls"
        )
        self._thread.start()
        print(HELP)
        return True

    def _loop(self) -> None:
        import os
        import select
        import sys
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while not self._stop.is_set():
                r, _, _ = select.select([fd], [], [], 0.2)
                if not r:
                    continue
                key = os.read(fd, 1).decode(errors="ignore")
                if key == "q":
                    import _thread

                    _thread.interrupt_main()  # same exit path as Ctrl-C
                    return
                status = dispatch_key(self._app, key)
                if status is not None:
                    print(f"\r{status['stage']:8s} low={status['low']:3d} "
                          f"high={status['high']:3d} "
                          f"mode={status['display_mode']:8s} "
                          f"{'PAUSED' if status['paused'] else 'running':8s}",
                          end="", flush=True)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
