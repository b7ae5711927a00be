"""The card's peaks and the least time a piece of work could take on it.

A frozen copy of the system's bound arithmetic: the larger of the bytes a
piece of work must move (each input byte read once, each output byte
written once) over HBM bandwidth, and its 32-bit integer operations over
the 32-bit peak. Peaks are NVIDIA's data sheet for the H100 SXM at its
700 W limit: 3.35 TB/s of HBM and 67 T operations a second of 32-bit
arithmetic outside the tensor cores (no table lists int32 apart); a card
set below 700 W reaches less, so its limit is recorded beside each run.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def chain_ops(kernel_size: int) -> int:
    """Operations a pixel of the stencil chain: 6 for mono, 2 a Gaussian
    tap and the division, 24 for the two Sobel sums, 3 for the squared
    magnitude, 10 for the NMS sector and compares, 2 for the threshold."""
    return 6 + 2 * kernel_size * kernel_size + 1 + 24 + 3 + 10 + 2


def packed_words(h: int, w: int) -> int:
    """32-bit words of one bit plane packed 32 rows a word."""
    return -(-h // 32) * w


def ff_pack_work(h: int, w: int, channels: int, kernel_size: int) -> Tuple[float, float]:
    """(bytes, operations) of a frame's ingest, chain and pack: the frame
    read once, the FINAL and CANDIDATE planes written once."""
    return h * w * channels + 2 * 4 * packed_words(h, w), chain_ops(kernel_size) * h * w


def unpack_work(h: int, w: int) -> Tuple[float, float]:
    """(bytes, operations) of a frame's unpack: the FINAL plane read once,
    the uint8 edge map written once; a byte written costs no operation
    counted."""
    return 4 * packed_words(h, w) + h * w, 0.0


def pipeline_work(h: int, w: int, channels: int, kernel_size: int) -> Tuple[float, float]:
    """(bytes, operations) a whole frame cannot do without: the frame read
    once, the edge map written once, and the stencil chain; hysteresis
    rounds are left out, since their number is not observed."""
    return h * w * channels + h * w, chain_ops(kernel_size) * h * w
