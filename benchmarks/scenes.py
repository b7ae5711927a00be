"""Scene recipes on the device, and the one generator that turns a traffic
file into the inputs of a run.

The recipes are the system's synthetic camera scenes (``make_scene``, an
animated BGR scene of discs and boxes on a smooth background with sensor
noise, and ``make_spiral_frame``, a square spiral ridge whose hysteresis
runs into the round cap), drawn here in torch on the device so that a pool
of 1080p or 8K frames costs milliseconds, not seconds on the host. A
scene's discs and boxes come from NumPy's generator on its scene seed, in
the original's order, so a scene is the original scene; its noise comes
from a ``torch.Generator`` on the device, seeded from the scene seed and
the time step.

A traffic file (``traffic/<name>.json``) holds:

* ``scenes``, ``times``: the calm pool, scene seeds 0 .. ``scenes`` - 1,
  each at t = 0 .. ``times`` - 1;
* ``batch``: frames a call; ``batched``: false for a single-frame call
  ((H, W, 3)), true for a batch ((B, H, W, 3));
* ``spirals_per_call``: spiral frames in every call, in slots drawn from the
  run's seed; the calm frames fill the other slots in pool order;
* ``in_flight``: calls issued and not yet waited for, at most;
* ``check_calls``: calls whose outputs are compared with the reference.

The frames are the same for every seed, because the work of a frame
depends on its content (its hysteresis rounds): at 8K a change of the
noise alone moved the rate by a quarter. The run's seed fixes the order in
which the calls cycle, the spiral's slot in each call and which calls the
check samples, so every seed runs the same calls in another order.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """The shapes of one scene, drawn in ``make_scene``'s order."""

    discs: Tuple[Tuple[int, int, int, Tuple[int, int, int]], ...]  # cy, cx, r, bgr
    boxes: Tuple[Tuple[int, int, int, int, Tuple[int, int, int]], ...]  # y0, x0, hh, ww, bgr
    rng: np.random.Generator  # where the original draws its noise next


def scene_layout(h: int, w: int, scene_seed: int) -> SceneLayout:
    rng = np.random.default_rng(scene_seed)
    discs = []
    for _ in range(24):
        cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
        r = int(rng.integers(16, max(17, min(h, w) // 9)))
        discs.append((cy, cx, r, tuple(int(v) for v in rng.integers(0, 256, size=3))))
    boxes = []
    for _ in range(16):
        if h > 64 and w > 64:
            y0, x0 = int(rng.integers(0, h - 64)), int(rng.integers(0, w - 64))
            hh, ww = int(rng.integers(24, min(160, h - y0))), int(rng.integers(24, min(160, w - x0)))
            boxes.append((y0, x0, hh, ww, tuple(int(v) for v in rng.integers(0, 256, size=3))))
    return SceneLayout(tuple(discs), tuple(boxes), rng)


def make_scene(h: int, w: int, scene_seed: int, t: float, device,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(h, w, 3) uint8 BGR scene on ``device``: the original's background,
    discs (moving with ``t``) and boxes; ``noise`` (h, w, 3) float64 is
    added as given, else drawn N(0, 2) from ``generator``."""
    lay = scene_layout(h, w, scene_seed)
    yy = torch.arange(h, dtype=torch.float64, device=device).view(h, 1)
    xx = torch.arange(w, dtype=torch.float64, device=device).view(1, w)
    base = (96 + 64 * torch.sin(2 * np.pi * (xx + 40.0 * t) / 397.0)
            + 48 * torch.cos(2 * np.pi * (yy + 25.0 * t) / 251.0))
    img = torch.stack([base, base * 0.9, base * 1.1], dim=-1)
    for cy, cx, r, bgr in lay.discs:
        dy = int(20.0 * t * (1 if (cy + cx) % 2 else -1))
        mask = (yy - (cy + dy) % h) ** 2 + (xx - cx) ** 2 < r * r
        img[mask] = torch.tensor(bgr, dtype=torch.float64, device=device)
    for y0, x0, hh, ww, bgr in lay.boxes:
        img[y0:y0 + hh, x0:x0 + ww] = torch.tensor(bgr, dtype=torch.float64, device=device)
    if noise is None:
        noise = torch.randn((h, w, 3), dtype=torch.float64, device=device,
                            generator=generator) * 2.0
    return (img + noise).clamp(0, 255).to(torch.uint8)


def make_spiral_frame(h: int, w: int, device, v: int = 65, gap: int = 12) -> torch.Tensor:
    """(h, w, 3) uint8: a square spiral ridge of value ``v``, arms ``gap``
    px apart, seeded by a bright blob at its outer tip (the original's
    points drawn as runs)."""
    if h < 2 * gap + 4 or w < 2 * gap + 4:
        raise ValueError(f"spiral frame needs h, w >= {2 * gap + 4}; got {h}x{w}")
    img = torch.zeros((h, w), dtype=torch.uint8, device=device)
    top, left, bot, right = 1, 1, h - 2, w - 2
    while right - left > gap and bot - top > gap:
        img[top, left:right + 1] = v
        img[top:bot + 1, right] = v
        img[bot, left + gap:right + 1] = v
        img[top + gap:bot + 1, left + gap] = v
        top, left, bot, right = top + gap, left + gap, bot - gap, right - gap
    img[0:3, 1:4] = 255  # the seed blob on the tip, (1, 1)
    return torch.stack([img] * 3, dim=-1)


@dataclasses.dataclass
class Traffic:
    """A traffic file's parameters (module docstring)."""

    scenes: int
    times: int
    batch: int
    batched: bool
    in_flight: int
    check_calls: int
    spirals_per_call: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        t = cls(**d)
        calm = t.batch - t.spirals_per_call
        if t.batch < 1 or calm < 0 or (not t.batched and t.batch != 1):
            raise ValueError(f"bad traffic: {d}")
        if calm and t.scenes * t.times < 1:
            raise ValueError("a call with calm frames needs a calm pool")
        if t.in_flight < 1 or t.check_calls < 1:
            raise ValueError("in_flight and check_calls must be >= 1")
        return t


@dataclasses.dataclass
class Inputs:
    """A run's inputs: the distinct calls (each an input tensor on the
    device), which source frame fills each slot of each call, and the
    source frames (the calm pool, then the spiral)."""

    calls: List[torch.Tensor]
    slots: List[List[int]]  # call -> the source frame of each slot
    sources: torch.Tensor  # (n, H, W, 3): the calm pool, then the spiral if any
    order: List[int]  # the call cycle: call i of the window is calls[order[i % len]]
    frames_per_call: int


def make_inputs(traffic: Traffic, h: int, w: int, seed: int, device) -> Inputs:
    """The run's inputs (module docstring). Frames are made on ``device``,
    each scene's noise from a generator on its scene seed and time step; a
    call is a view of the pool where its frames lie in a row, else a tensor
    of its own."""
    rng = random.Random(seed)
    n_calm = traffic.scenes * traffic.times
    frames = []
    for s in range(traffic.scenes):
        for t in range(traffic.times):
            gen = torch.Generator(device=device)
            gen.manual_seed(s * 1_000_003 + t)
            frames.append(make_scene(h, w, s, float(t), device, generator=gen))
    if traffic.spirals_per_call:
        frames.append(make_spiral_frame(h, w, device))
    sources = torch.stack(frames) if frames else torch.empty((0, h, w, 3), dtype=torch.uint8)
    del frames
    calm_per_call = traffic.batch - traffic.spirals_per_call
    n_calls = max(1, math.ceil(n_calm / calm_per_call)) if calm_per_call else 1
    calls, slots = [], []
    for c in range(n_calls):
        calm = [(c * calm_per_call + k) % n_calm for k in range(calm_per_call)]
        spiral_at = set(rng.sample(range(traffic.batch), traffic.spirals_per_call))
        slot = [n_calm if k in spiral_at else calm.pop(0) for k in range(traffic.batch)]
        slots.append(slot)
        if not traffic.batched:
            calls.append(sources[slot[0]])
        elif slot == list(range(slot[0], slot[0] + traffic.batch)):
            calls.append(sources[slot[0]:slot[0] + traffic.batch])
        else:
            calls.append(sources[slot].contiguous())
    order = list(range(n_calls))
    rng.shuffle(order)
    return Inputs(calls, slots, sources, order, traffic.batch)


def reservoir(rng: random.Random, k: int):
    """A running sample of ``k`` calls drawn uniformly from all calls so far
    (algorithm R): ``keep(i)`` says which kept slot call ``i`` takes, or
    None."""
    def keep(i: int) -> Optional[int]:
        if i < k:
            return i
        j = rng.randrange(i + 1)
        return j if j < k else None
    return keep


