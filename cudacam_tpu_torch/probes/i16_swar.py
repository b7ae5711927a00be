"""The 16-bit stencil probe (K14) on Hopper.

Port of ``tools/i16_swar_probe.py`` (``_run`` :35, ``pallas_call`` :37,
bodies ``p1``-``p4`` :56-83), which asks whether the feed-forward chain's
stencils can run on 16-bit lanes. :func:`swar_stencil` computes the four
bodies on an (H, W) plane with two 16-bit lanes per 32-bit register
(``csrc/probe_swar.cu``: ``__vadd2``, byte permutes for the column rolls),
or in its int32 mode, beside the plain version in int16 torch ops:

* P1 (int16): ``x * 3 + (x + x) * 2``;
* P2 (int16): ``x + roll(x, 1, rows) + roll(x, H-1, rows)``;
* P3 (int16): ``2x + 3 roll(x, 1, cols) + roll(x, W-1, cols)``;
* P4 (uint8): ``v`` = the 3-row sum in int16, then ``2v + roll(v, 1, cols)
  + roll(v, W-1, cols)``.

Every result is int16 arithmetic (wrapping, as jnp's) widened to int32.
:func:`run_probes` runs the four on the TPU probe's inputs.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)

#: The TPU probe's plane.
SHAPE = (256, 512)
BODIES = {1: "P1 i16 mul/add", 2: "P2 i16 row roll", 3: "P3 i16 column roll+mul",
          4: "P4 u8->i16 stencil->i32"}


def probe_inputs(h: int = SHAPE[0], w: int = SHAPE[1]) -> Tuple[np.ndarray, np.ndarray]:
    """The TPU probe's inputs: int16 and uint8 planes of values in [0, 255)
    from one generator (seed 0), in its order."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (h, w), np.int16), rng.integers(0, 255, (h, w), np.uint8)


def _check(x: torch.Tensor, body: int) -> None:
    if body not in BODIES:
        raise ValueError(f"body must be one of {sorted(BODIES)}, got {body}")
    dtype = torch.uint8 if body == 4 else torch.int16
    if x.dtype != dtype or x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"body {body} takes an (H, W) {dtype} plane, got {tuple(x.shape)} {x.dtype}")


def swar_stencil_plain(x: torch.Tensor, body: int, swar: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`swar_stencil`, on any device: the
    body in int16 torch ops (which wrap as jnp's do), widened to int32."""
    _check(x, body)
    h, w = x.shape
    x = x.to(torch.int16)
    if body == 1:
        y = x * 3 + (x + x) * 2
    elif body == 2:
        y = x + torch.roll(x, 1, 0) + torch.roll(x, h - 1, 0)
    elif body == 3:
        y = x * 2 + torch.roll(x, 1, 1) * 3 + torch.roll(x, w - 1, 1)
    else:
        v = x + torch.roll(x, 1, 0) + torch.roll(x, h - 1, 0)
        y = v * 2 + torch.roll(v, 1, 1) + torch.roll(v, w - 1, 1)
    return y.to(torch.int32)


def swar_stencil(x: torch.Tensor, body: int, swar: bool = True) -> torch.Tensor:
    """Body ``body`` (1-4) of the 16-bit probe on an (H, W) plane (int16 for
    P1-P3, uint8 for P4) -> (H, W) int32. On CUDA tensors one launch: two
    16-bit lanes per register with ``swar``, else the int32 mode of the same
    kernel; equal either way."""
    _check(x, body)
    if use_plain(x):
        return swar_stencil_plain(x, body, swar)
    require_contiguous(x)
    h, w = x.shape
    out = torch.empty((h, w), dtype=torch.int32, device=x.device)
    lib = load()
    lib.check(lib.lib.cc_swar_stencil(x.data_ptr(), out.data_ptr(), h, w, body, int(swar),
                                      x.device.index, stream_of(x)), "swar_stencil")
    count_launch("swar_stencil")
    return out


def wide_reference(x: torch.Tensor, body: int) -> torch.Tensor:
    """The body in int64 with no wrapping: equal to the int16 result exactly
    when every lane fits int16, which is what makes SWAR exact here."""
    h, w = x.shape
    x = x.to(torch.int64)
    if body == 1:
        return (7 * x).to(torch.int32)
    if body == 2:
        return (x + torch.roll(x, 1, 0) + torch.roll(x, h - 1, 0)).to(torch.int32)
    if body == 3:
        return (2 * x + 3 * torch.roll(x, 1, 1) + torch.roll(x, w - 1, 1)).to(torch.int32)
    v = x + torch.roll(x, 1, 0) + torch.roll(x, h - 1, 0)
    return (2 * v + torch.roll(v, 1, 1) + torch.roll(v, w - 1, 1)).to(torch.int32)


def run_probes(device, shape: Tuple[int, int] = SHAPE) -> List[Tuple[str, bool, str]]:
    """The four bodies on the TPU probe's inputs (or at ``shape``) on
    ``device``: both modes held to the plain version and to the unwrapped
    int64 body. ``(name, ok, detail)`` each; the detail gives the output's
    range."""
    dev = torch.device(device)
    xi16, xu8 = (torch.from_numpy(a).to(dev) for a in probe_inputs(*shape))
    rows = []
    for body, name in BODIES.items():
        x = xu8 if body == 4 else xi16
        want = swar_stencil_plain(x.cpu(), body)
        got = [swar_stencil(x, body, swar).cpu() for swar in (True, False)]
        ok = all(torch.equal(g, want) for g in got) and torch.equal(want, wide_reference(x.cpu(), body))
        rows.append((name, ok, f"range {int(want.min())}..{int(want.max())}"))
    return rows
