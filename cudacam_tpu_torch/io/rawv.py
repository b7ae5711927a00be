"""The ``.rawv`` stream format, in plain Python.

A little-endian header (magic ``"RAWV"``, u32 version 1, u32 height, u32
width, u32 channels, u64 n_frames; 28 bytes, packed) followed by n_frames
contiguous uint8 frames of height * width * channels bytes each: the format
the native frame pump (``native/framepump.cpp``) reads and writes, byte for
byte, as the JAX package's does.
"""
from __future__ import annotations

import struct

import numpy as np

_HEADER = struct.Struct("<IIIIIQ")
_MAGIC = 0x56574152  # "RAWV" little-endian


def write_rawv(path: str, frames: np.ndarray) -> str:
    """Write an (N, H, W[, C]) uint8 array as a .rawv stream file."""
    if frames.dtype != np.uint8 or frames.ndim not in (3, 4):
        raise ValueError(f"frames must be uint8 (N,H,W[,C]), got {frames.dtype} {frames.shape}")
    frames = np.ascontiguousarray(frames)
    n, h, w = frames.shape[:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, h, w, c, n))
        f.write(frames.tobytes())
    return path
