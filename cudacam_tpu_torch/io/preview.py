"""PNG export of a stage buffer (``cudacam_tpu/io/preview.py::save_png``)."""
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
