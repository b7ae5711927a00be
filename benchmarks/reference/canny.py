"""Plain reference of the benchmarked Canny chain: a BGR frame to its edge map.

Written for the benchmark from the published semantics of the system under
test: plain PyTorch on any device, no kernel, no batching, and nothing of
the program imported or reused. Every decision is exact integer arithmetic:

* mono: fixed-point BGR weights 7 / 38 / 19, ``>> 6``;
* Gaussian: the integer taps (sum 159 at 5x5), zero padded, floor division;
* Sobel: raw integer sums, zero padded;
* NMS: both neighbours along the Q15-binned gradient sector <= the centre
  (ties kept), on sx^2 + sy^2 (L2) or |sx| + |sy| (L1);
* double threshold ('reference' parity): the comparable magnitude against
  the smallest magnitude whose uint8 display value exceeds the threshold;
* hysteresis: bit-packed rounds (32 rows a word, vertically) on the round
  schedule that defines an output cut off by the round cap:
  ``dilate_steps`` 8-neighbour dilations a round (every 8th and the last
  exact across word boundaries), from round ``scan_after`` on followed by
  8-direction doubling scans, at most ``max_iters`` rounds.

``chain_dtype=torch.float16`` is the control: mono, Gaussian and Sobel in
float16 arithmetic, each operation rounding its result, with the rest
exact. It stands for a 16-bit float stencil chain, the lower precision a
faster chain would reach for; the configuration states exact arithmetic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

GAUSSIAN_TAPS = {
    3: ((1, 2, 1), (2, 4, 2), (1, 2, 1)),
    5: ((2, 4, 5, 4, 2), (4, 9, 12, 9, 4), (5, 12, 15, 12, 5), (4, 9, 12, 9, 4),
        (2, 4, 5, 4, 2)),
    7: ((1, 6, 15, 20, 15, 6, 1), (6, 36, 90, 120, 90, 36, 6), (15, 90, 225, 300, 225, 90, 15),
        (20, 120, 300, 400, 300, 120, 20), (15, 90, 225, 300, 225, 90, 15),
        (6, 36, 90, 120, 90, 36, 6), (1, 6, 15, 20, 15, 6, 1)),
}
SOBEL_X = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
SOBEL_Y = ((1, 2, 1), (0, 0, 0), (-1, -2, -1))
TG22 = 13573  # round(tan(22.5 deg) * 2^15)
TG67 = 79109  # round(tan(67.5 deg) * 2^15)
FINAL, CANDIDATE = 255, 128
_MASK = 0xFFFFFFFF
_CARRY_EVERY = 8


def _correlate(img: torch.Tensor, taps) -> torch.Tensor:
    """2-D correlation with zero padding, as a sum of shifted planes, in
    ``img``'s dtype (each add rounds in a float dtype)."""
    r = len(taps) // 2
    h, w = img.shape
    padded = F.pad(img, (r, r, r, r))
    acc = torch.zeros_like(img)
    for dy, row in enumerate(taps):
        for dx, t in enumerate(row):
            if t:
                acc = acc + t * padded[dy:dy + h, dx:dx + w]
    return acc


def stencil_chain(frame: torch.Tensor, kernel_size: int,
                  chain_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) or (H, W) uint8 -> the int32 Sobel sums (sx, sy)."""
    dt = chain_dtype or torch.int32
    taps = GAUSSIAN_TAPS[kernel_size]
    total = sum(map(sum, taps))
    if frame.ndim == 3:
        px = frame.to(dt)
        acc = px[..., 0] * 7 + px[..., 1] * 38 + px[..., 2] * 19
        mono = torch.floor(acc / 64) if dt.is_floating_point else acc >> 6
        mono = mono.clamp(max=255)
    else:
        mono = frame.to(dt)
    acc = _correlate(mono, taps)
    blur = torch.floor(acc / total) if dt.is_floating_point else torch.div(
        acc, total, rounding_mode="floor")
    sx, sy = _correlate(blur, SOBEL_X), _correlate(blur, SOBEL_Y)
    return sx.to(torch.int32), sy.to(torch.int32)


def threshold_map(sx: torch.Tensor, sy: torch.Tensor, low: int, high: int, grad_coeff: int,
                  norm: str) -> torch.Tensor:
    """NMS and the double threshold: uint8 map of 255 (FINAL), 128
    (CANDIDATE), 0."""
    g = sx * sx + sy * sy if norm == "l2" else sx.abs() + sy.abs()
    h, w = g.shape
    gp = F.pad(g, (1, 1, 1, 1))

    def at(dy: int, dx: int) -> torch.Tensor:
        return gp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    v, wmag = sx.abs().to(torch.int64) << 15, sy.abs().to(torch.int64)
    bin0, bin2 = v < wmag * TG22, v >= wmag * TG67
    pos = torch.where(sx >= 0, sy, -sy) > 0
    q = torch.where(bin0, at(1, 0), torch.where(bin2, at(0, 1),
                                                torch.where(pos, at(1, -1), at(-1, -1))))
    r = torch.where(bin0, at(-1, 0), torch.where(bin2, at(0, -1),
                                                 torch.where(pos, at(-1, 1), at(1, 1))))
    keep = (q <= g) & (r <= g)

    def bound(t: int) -> int:
        if t >= 255:
            return 1 << 30
        s_min = (((t + 1) << 3) + grad_coeff - 1) // grad_coeff
        return s_min * s_min if norm == "l2" else s_min

    out = torch.zeros((h, w), dtype=torch.uint8, device=g.device)
    out[keep & (g >= bound(low))] = CANDIDATE
    out[keep & (g >= bound(high))] = FINAL
    return out


# --- hysteresis on bit-packed planes (int64 words holding 32 bits) -----------

def _pack(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    hw = -(-h // 32)
    m = F.pad(mask.to(torch.int64), (0, 0, 0, hw * 32 - h))
    bits = torch.arange(32, dtype=torch.int64, device=mask.device).view(1, 32, 1)
    return (m.view(hw, 32, w) << bits).sum(dim=1)


def _unpack(words: torch.Tensor, h: int) -> torch.Tensor:
    hw, w = words.shape
    bits = torch.arange(32, dtype=torch.int64, device=words.device).view(1, 32, 1)
    return ((words.view(hw, 1, w) >> bits) & 1).view(hw * 32, w)[:h].bool()


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[i] = x[i - k] over word rows, zero fill."""
    n = x.shape[0]
    if k == 0:
        return x
    if abs(k) >= n:
        return torch.zeros_like(x)
    return F.pad(x[:n - k], (0, 0, k, 0)) if k > 0 else F.pad(x[-k:], (0, 0, 0, -k))


def _cols(x: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, c] = x[:, c - k], zero fill."""
    n = x.shape[1]
    if k == 0:
        return x
    if abs(k) >= n:
        return torch.zeros_like(x)
    return F.pad(x[:, :n - k], (k, 0)) if k > 0 else F.pad(x[:, -k:], (0, -k))


def _down(x: torch.Tensor, s: int) -> torch.Tensor:
    """Shift the packed column bit streams by ``s`` image rows (out[row r] =
    x[row r - s]), carrying across words."""
    if s == 0:
        return x
    q, r = divmod(abs(s), 32)
    if s > 0:
        base = _rows(x, q)
        return base if r == 0 else ((base << r) & _MASK) | (_rows(base, 1) >> (32 - r))
    base = _rows(x, -q)
    return base if r == 0 else (base >> r) | ((_rows(base, -1) << (32 - r)) & _MASK)


def _powers_below(n: int):
    steps, s = [], 1
    while s < n:
        steps.append(s)
        s *= 2
    return steps


def _round_ops(h: int, w: int, dilate_steps: int):
    """(dilate, scan): a round's dilations and its 8 direction scans, in the
    order that defines a cut-off output."""
    hs, vs, ds = _powers_below(w), _powers_below(h), _powers_below(min(h, w))
    directions = (
        (lambda x, s: _cols(x, s), hs), (lambda x, s: _cols(x, -s), hs),
        (lambda x, s: _down(x, s), vs), (lambda x, s: _down(x, -s), vs),
        (lambda x, s: _cols(_down(x, s), s), ds), (lambda x, s: _cols(_down(x, -s), -s), ds),
        (lambda x, s: _cols(_down(x, s), -s), ds), (lambda x, s: _cols(_down(x, -s), s), ds),
    )

    def dilate(f, p):
        for i in range(1, dilate_steps + 1):
            v = f | _cols(f, 1) | _cols(f, -1)
            if i % _CARRY_EVERY == 0 or i == dilate_steps:
                nb = v | _down(v, 1) | _down(v, -1)
            else:  # no carry across words: monotone and below the fixed point
                nb = v | ((v << 1) & _MASK) | (v >> 1)
            f = f | (p & nb)
        return f

    def scan(f, p):
        for shift, steps in directions:
            g, pp = f, p
            for s in steps:
                g = g | (pp & shift(g, s))
                pp = pp & shift(pp, s)
            f = g
        return f

    return dilate, scan


def hysteresis(tmap: torch.Tensor, dilate_steps: int, scan_after: int,
               max_iters: int) -> Tuple[torch.Tensor, int, bool]:
    """Threshold map -> (uint8 edge map, rounds, still growing at the cap)."""
    h, w = tmap.shape
    f, p = _pack(tmap == FINAL), _pack(tmap == CANDIDATE)
    dilate, scan = _round_ops(h, w, dilate_steps)
    it, changed = 0, True
    while changed and it < max_iters:
        nf = dilate(f, p)
        if it >= min(scan_after, max_iters):
            nf = scan(nf, p)
        changed = bool((nf != f).any())
        f, it = nf, it + 1
    edges = torch.where(_unpack(f, h), FINAL, 0).to(torch.uint8)
    return edges, it, changed


def canny(frame: torch.Tensor, cfg: dict,
          chain_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, int, bool]:
    """One (H, W, 3) or (H, W) uint8 frame -> (edge map, rounds, cut off by
    the cap). ``cfg`` holds the configuration file's ``canny`` fields."""
    if cfg.get("parity", "reference") != "reference":
        raise ValueError("the reference implements 'reference' parity only")
    sx, sy = stencil_chain(frame, cfg["kernel_size"], chain_dtype)
    tmap = threshold_map(sx, sy, cfg["low_threshold"], cfg["high_threshold"],
                         cfg["grad_coeff"], cfg["norm"])
    return hysteresis(tmap, cfg["hysteresis_inner_steps"], cfg["hysteresis_scan_after"],
                      cfg["max_hysteresis_iters"])
