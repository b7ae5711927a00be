"""Display composition — raw/processed view modes: the port's copy of
``cudacam_tpu/io/compose.py``. It works on host arrays only.

The reference's window shows the raw camera texture and the processed CUDA
texture (imguiApp.cpp:393-450, two GL textures). The headless analogs are
composition modes applied at preview/export time:

* ``edges``   the processed buffer as grayscale (default)
* ``raw``     the unprocessed camera frame
* ``split``   raw | processed side by side
* ``overlay`` processed pixels >= 128 painted red over the raw frame
"""
from __future__ import annotations

from typing import Optional

import numpy as np

MODES = ("edges", "raw", "split", "overlay")


def _to_bgr(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return img


def _is_batched(raw: Optional[np.ndarray], processed: Optional[np.ndarray]) -> bool:
    if raw is not None:
        return raw.ndim == 4 or (raw.ndim == 3 and raw.shape[-1] not in (1, 3))
    if processed is not None:
        return processed.ndim == 3 and processed.shape[-1] not in (1, 3)
    return False


def montage(tiles) -> np.ndarray:
    """Tile a list of equal-shaped BGR frames into a near-square grid with
    thin separators (the multi-camera wall view)."""
    import math

    n = len(tiles)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    h, w = tiles[0].shape[:2]
    pad = 2
    grid = np.zeros((rows * h + (rows - 1) * pad,
                     cols * w + (cols - 1) * pad, 3), np.uint8)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        y0, x0 = r * (h + pad), c * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = t
    return grid


def compose(
    raw: Optional[np.ndarray],
    processed: Optional[np.ndarray],
    mode: str = "edges",
) -> Optional[np.ndarray]:
    """Compose a BGR uint8 display frame from the raw input and the
    processed buffer. Modes needing the raw frame fall back to the
    processed view when it is unavailable (pipeline-off passthrough keeps
    working: raw may BE the processed buffer). Batched inputs
    ((B, H, W[, C])) become a montage grid of per-camera compositions."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if _is_batched(raw, processed):
        b = raw.shape[0] if raw is not None else processed.shape[0]
        tiles = [
            compose(
                None if raw is None else raw[i],
                None if processed is None else processed[i],
                mode,
            )
            for i in range(b)
        ]
        return montage(tiles)
    if mode == "raw":
        return None if raw is None else _to_bgr(raw)
    if processed is None:
        return None if raw is None else _to_bgr(raw)
    proc = _to_bgr(processed)
    if mode == "edges" or raw is None:
        return proc
    rawb = _to_bgr(raw)
    if mode == "split":
        return np.concatenate([rawb, proc], axis=1)
    # overlay: strong pixels painted red (BGR) over the raw frame.
    out = rawb.copy()
    mask = (processed if processed.ndim == 2 else processed[..., 0]) >= 128
    out[mask] = (0, 0, 255)
    return out
