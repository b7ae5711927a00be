"""Headless preview and export: the port's copy of ``cudacam_tpu/io/preview.py``.

PNG export of any stage buffer and a terminal (ANSI half-block) renderer.
Both take host arrays: pull frames from the ``DeviceRingBuffer`` through its
explicit readback."""
from __future__ import annotations

import os

import numpy as np


def save_png(path: str, frame: np.ndarray) -> str:
    """Write a (H, W[, C]) uint8 host buffer as PNG (BGR channel order)."""
    import cv2

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if not cv2.imwrite(path, np.asarray(frame)):
        raise IOError(f"failed to write {path}")
    return path


#: 8-step grayscale ramp for ASCII fallback.
_RAMP = " .:-=+*#%@"


def ascii_preview(
    frame: np.ndarray,
    width: int = 96,
    color: bool = True,
) -> str:
    """Render a frame as terminal text.

    Uses ANSI half-block characters (two pixels per character cell) when
    ``color`` is on, else a pure-ASCII luminance ramp. Gray input renders
    directly; BGR is converted with the pipeline's fixed-point weights.
    """
    a = np.asarray(frame)
    if a.ndim == 3:
        gray = np.minimum(
            255,
            (a[..., 0].astype(np.int32) * 7
             + a[..., 1].astype(np.int32) * 38
             + a[..., 2].astype(np.int32) * 19) >> 6,
        ).astype(np.uint8)
    else:
        gray = a
    h, w = gray.shape
    width = min(width, w) or 1
    # Target cell grid: each char is ~2x wider than tall; half-blocks pack
    # two rows per char row.
    step = max(1, w // width)
    cols = w // step
    row_step = step
    g = gray[: (h // row_step) * row_step : row_step, : cols * step : step]
    if not color:
        idx = (g.astype(np.int32) * (len(_RAMP) - 1)) // 255
        return "\n".join("".join(_RAMP[v] for v in row) for row in idx)
    # Pair rows: upper pixel = foreground, lower = background, char = upper
    # half block.
    if g.shape[0] % 2:
        g = g[:-1]
    top, bot = g[0::2], g[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        for tv, bv in zip(tr, br):
            parts.append(f"\x1b[38;2;{tv};{tv};{tv}m\x1b[48;2;{bv};{bv};{bv}m▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)
