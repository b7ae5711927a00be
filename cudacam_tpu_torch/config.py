"""Configuration of the port: its own copy of ``cudacam_tpu/config.py``.

The fields, their defaults, the derived defaults, the validation and the
``halo`` / ``threshold_cap`` properties are the JAX package's, so a config
moves across (``state.config_from_jax``) and the round schedule
(inner steps, scan_after, the cap) is the same on both sides. The JAX
package's fields that select one of its executors (``backend``,
``interpret``) have no counterpart: the port's route follows the tensors'
device. ``continuation`` has the port's own values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Integer Gaussian taps: the reference's 5x5 Canny kernel (sum 159) and the
# binomial 3x3 (16) and 7x7 (4096).
GAUSSIAN_TAPS: dict[int, Tuple[Tuple[int, ...], ...]] = {
    3: (
        (1, 2, 1),
        (2, 4, 2),
        (1, 2, 1),
    ),
    5: (
        (2, 4, 5, 4, 2),
        (4, 9, 12, 9, 4),
        (5, 12, 15, 12, 5),
        (4, 9, 12, 9, 4),
        (2, 4, 5, 4, 2),
    ),
    7: (
        (1, 6, 15, 20, 15, 6, 1),
        (6, 36, 90, 120, 90, 36, 6),
        (15, 90, 225, 300, 225, 90, 15),
        (20, 120, 300, 400, 300, 120, 20),
        (15, 90, 225, 300, 225, 90, 15),
        (6, 36, 90, 120, 90, 36, 6),
        (1, 6, 15, 20, 15, 6, 1),
    ),
}


def gaussian_kernel_sum(kernel_size: int) -> int:
    return sum(sum(row) for row in GAUSSIAN_TAPS[kernel_size])


@dataclasses.dataclass(frozen=True)
class CannyConfig:
    """Full pipeline configuration; image specs are locked at engine
    construction."""

    height: int
    width: int
    channels: int = 3  # 3 = BGR, 1 = mono

    kernel_size: int = 5  # Gaussian kernel: 3, 5 or 7
    norm: str = "l2"  # 'l2' or 'l1'
    grad_coeff: int = 4
    low_threshold: int = 10  # runtime-adjustable
    high_threshold: int = 40  # runtime-adjustable

    # Hysteresis round cap: outputs cut off by it are the same bytes on
    # every route, so it is part of the result.
    max_hysteresis_iters: int = 100
    # Bit-parallel dilations per round. None: 32 for a longest side in
    # (2048, 4096], else 16.
    hysteresis_inner_steps: Optional[int] = None
    # Rounds of dilation before the 8-direction scans. None: 64 for a
    # longest side <= 2048, else 32.
    hysteresis_scan_after: Optional[int] = None

    parity: str = "reference"  # 'reference' | 'opencv'
    # Phase-2 continuation on the HYSTER path. 'kernel': the whole-frame
    # phase-2 kernel at every frame size; 'auto' is 'kernel'. 'split': the
    # column-split form (ops/cuda/megakernel.py::_cont_split), opt-in: equal
    # to 'kernel' on every converged frame, its own bytes when the round cap
    # cuts the frame off (the JAX package's 'split', which its 'auto' takes
    # at 8K).
    continuation: str = "auto"  # 'auto' | 'kernel' | 'split'

    def __post_init__(self) -> None:
        if self.kernel_size not in GAUSSIAN_TAPS:
            raise ValueError(f"kernel_size must be one of {sorted(GAUSSIAN_TAPS)}")
        if self.norm not in ("l1", "l2"):
            raise ValueError("norm must be 'l1' or 'l2'")
        if self.channels not in (1, 3):
            raise ValueError("channels must be 1 (mono) or 3 (BGR)")
        if self.parity not in ("reference", "opencv"):
            raise ValueError("parity must be 'reference' or 'opencv'")
        if self.continuation not in ("auto", "kernel", "split"):
            raise ValueError("continuation must be 'auto', 'kernel' or 'split'")
        if self.grad_coeff not in (1, 2, 4, 8):
            # (isqrt(m) * coeff) // 8 equals trunc(coeff * sqrt(m) / 8) only
            # when coeff divides 8.
            raise ValueError("grad_coeff must be 1, 2, 4 or 8")
        if self.height <= 0 or self.width <= 0:
            raise ValueError("height/width must be positive")
        side = max(self.height, self.width)
        if self.hysteresis_inner_steps is None:
            object.__setattr__(
                self,
                "hysteresis_inner_steps",
                32 if 2048 < side <= 4096 else 16,
            )
        elif self.hysteresis_inner_steps < 1:
            raise ValueError("hysteresis_inner_steps must be >= 1")
        if self.hysteresis_scan_after is None:
            object.__setattr__(
                self, "hysteresis_scan_after", 64 if side <= 2048 else 32
            )
        elif self.hysteresis_scan_after < 1:
            raise ValueError("hysteresis_scan_after must be >= 1")
        cap = self.threshold_cap
        if not (0 <= self.low_threshold <= cap) or not (
            0 <= self.high_threshold <= cap
        ):
            raise ValueError(
                f"thresholds must be in [0, {cap}] for parity='{self.parity}'"
            )
        if self.low_threshold > self.high_threshold:
            raise ValueError(
                f"low_threshold ({self.low_threshold}) must be <= "
                f"high_threshold ({self.high_threshold})"
            )

    @property
    def threshold_cap(self) -> int:
        """Largest meaningful threshold: 255 for the uint8 magnitudes of
        'reference' parity, 2048 for the raw Sobel magnitudes of 'opencv'."""
        return 255 if self.parity == "reference" else 2048

    def with_thresholds(self, low: int, high: int) -> "CannyConfig":
        cap = self.threshold_cap
        low = max(0, min(cap, int(low)))
        high = max(0, min(cap, int(high)))
        if low > high:
            low = high
        return dataclasses.replace(self, low_threshold=low, high_threshold=high)

    @property
    def halo(self) -> int:
        """Total stencil halo from mono to threshold (rows/cols each side)."""
        return self.kernel_size // 2 + 1 + 1  # gaussian + sobel + nms
