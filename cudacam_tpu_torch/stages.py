"""Canny pipeline stage identifiers: the port's own copy of
``cudacam_tpu/stages.py`` (the same values, names and pixel classes).
Running the pipeline with ``final_stage = k`` executes stages 0..k."""
from __future__ import annotations

import enum


class CannyStage(enum.IntEnum):
    """Pipeline stages, in execution order."""

    MONO = 0
    GAUSSIAN = 1
    GRADIENT = 2
    NMS = 3
    THRESH = 4
    HYSTER = 5


#: Display names.
CANNY_STAGE_NAMES: dict[CannyStage, str] = {
    CannyStage.MONO: "1/6 Mono Conversion",
    CannyStage.GAUSSIAN: "2/6 Gaussian Filter",
    CannyStage.GRADIENT: "3/6 Gradient Computation",
    CannyStage.NMS: "4/6 Non-Maximum Suppression",
    CannyStage.THRESH: "5/6 Double Threshold",
    CannyStage.HYSTER: "6/6 Hysteresis",
}

#: Pixel classes of the threshold map and the edge map.
FINAL_EDGE = 255
CANDIDATE_EDGE = 128
NO_EDGE = 0
