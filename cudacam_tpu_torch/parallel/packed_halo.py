"""The collective round loop of the sharded hysteresis.

Port of ``cudacam_tpu/parallel/packed_halo.py``. Each tile holds its
(FINAL, CANDIDATE) planes packed over an extended tile
(``ops/packed_strips.py``: the geometry, the strip extraction and placement,
one halo refresh, the strip half of the JAX module). A
collective round runs the local saturate on every tile, then one halo
refresh; the loop ends when no tile grows and no new halo bit appears
anywhere, or at the round budget (the JAX ``lax.while_loop`` :256-306).

One loop per transport, as in the reference:

* :func:`sharded_loop`: a one-card mesh on the card. The whole loop is one
  cooperative launch (``sharded_loop_kernel`` in ``csrc/hyst_rounds.cu``),
  the two refreshes before it included: its prologue refreshes both planes
  in global memory (``csrc/halo.cuh``) and sets the first pending flag;
  then every tile's bands stay in shared memory, and each collective round
  runs K9 on every tile, the refresh on those bands and the pending flag,
  ended on the device. Nothing is read back. ``megakernel.loop_layout``
  reports its layout.
* :func:`packed_hysteresis_loop`: the host loop, for a distributed mesh
  (the host reads the all-reduced pending flag once per round, where the
  JAX loop has its ``psum``) and for an injected local operator. With the
  plain saturate and refresh it is :func:`sharded_loop`'s plain version,
  which CPU tensors take.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.autograd import profiler as autograd_profiler

from cudacam_tpu_torch.ops.cuda._build import (
    close_span, count_launch, count_rounds, load, open_span, require_contiguous, round_slot,
    stream_of, use_plain,
)
from cudacam_tpu_torch.ops.cuda.halo import geo_args, halo_exchange_plain
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed_plain
from cudacam_tpu_torch.ops.cuda.megakernel import _check_planes, _check_steps
from cudacam_tpu_torch.ops.packed_strips import PackedGeo

# --- the collective round loop ------------------------------------------------

#: ``exchange(x, grow=None, pending=None)``: one halo refresh of the planes
#: ``x`` in place (``parallel/mesh.py``'s transports). ``pending`` (one
#: int32) is set to "any tile in ``grow`` still growing, or any new halo
#: bit, anywhere on the mesh".
Exchange = Callable[..., None]

#: ``saturate(f, p) -> growing``: the local operator, in place on the
#: (T, hw, w) planes, returning a (T,) tensor of "cap hit while changing".
Saturate = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def packed_hysteresis_loop(
    f: torch.Tensor,
    p: torch.Tensor,
    still_growing: torch.Tensor,
    saturate: Saturate,
    exchange: Exchange,
    max_rounds: int,
) -> torch.Tensor:
    """Converge the sharded fixed point on the (T, hw, w) packed planes, in
    place; returns a one-int32 tensor on their device: the collective rounds
    taken.

    The candidate plane is static: it is exchanged once up front to deepen
    the halo candidates; only FINAL strips move per round. ``still_growing``
    (T,) is the entry state's flag (the export's phase-1 exit). A round is
    ``saturate`` then ``exchange``; the host reads the pending flag before
    each round and runs one while it is up, at most ``max_rounds`` rounds
    (packed_halo.py:256-306). On CPU tensors the read costs nothing; across
    processes the one read of the all-reduced flag per round stands in for
    the ``psum``."""
    pending = torch.zeros(1, dtype=torch.int32, device=f.device)
    exchange(p)
    exchange(f, grow=still_growing, pending=pending)
    rounds = 0
    while rounds < max_rounds and int(pending):
        exchange(f, grow=saturate(f, p), pending=pending)
        rounds += 1
    return torch.full((1,), rounds, dtype=torch.int32, device=f.device)


def _check_loop(f, p, flags, grid, geo: PackedGeo, max_rounds: int) -> Tuple[int, int, int]:
    nb, ny, nx = grid
    if f.ndim != 3 or f.shape[0] != nb * ny * nx or f.shape[2] != geo.ext_w:
        raise ValueError(f"planes {tuple(f.shape)} are not the ({nb * ny * nx}, hw, "
                         f"{geo.ext_w}) extended tiles of a {grid} mesh")
    _check_planes(f, p, geo.ext_h, flags)
    if max_rounds < 0:
        raise ValueError("max_rounds must be >= 0")
    return nb, ny, nx


def sharded_loop_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    grid: Tuple[int, int, int],
    geo: PackedGeo,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    max_rounds: int = 100,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sharded_loop`, on any device: the
    host loop with the plain saturate (``bitpack``'s two phases tile by
    tile) and the plain refresh, reading the pending flag once per round.
    Adds (1, collective rounds) to the plain round counters, as the kernel
    adds to its device's."""
    _check_loop(f, p, flags, grid, geo, max_rounds)
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters)
    rounds = packed_hysteresis_loop(
        f, p, flags[:, 0, 1], lambda ff, pp: saturate_packed_plain(ff, pp, flags, geo.ext_h, **kw)[1],
        lambda x, **k: halo_exchange_plain(x, grid, geo, **k), max_rounds)
    count_rounds("sharded_loop", 1, int(rounds))
    return rounds


def sharded_loop(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    grid: Tuple[int, int, int],
    geo: PackedGeo,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    max_rounds: int = 100,
) -> torch.Tensor:
    """The collective round loop of a one-card (nb, ny, nx) mesh on the
    (nb ny nx, ceil(ext_h/32), ext_w) planes at the export's phase-1 exit,
    in place; returns the rounds taken as a one-int32 tensor on their
    device. ``flags`` is the export's (T, 2, 2): row 0's "still growing" is
    the entry state; each round overwrites both rows, as K9 does.

    On CUDA tensors: one launch of the loop kernel, the two refreshes before
    the loop (CANDIDATE, then FINAL with the entry state's flags, which sets
    the pending flag) included, whatever the budget (0 too) and however soon
    the tiles converge; no host sync; it adds (1, the rounds) to the
    device's round counters (``round_counts()["sharded_loop"]``). Byte for
    byte the host loop, which CPU tensors run (:func:`sharded_loop_plain`)."""
    span = open_span("cc.prep.sharded_loop") if autograd_profiler._is_profiler_enabled else None
    _check_loop(f, p, flags, grid, geo, max_rounds)
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters)
    if use_plain(f, p, flags):
        if span is not None:
            close_span(span)
        return sharded_loop_plain(f, p, flags, grid, geo, max_rounds=max_rounds, **kw)
    _check_steps(dilate_steps)
    require_contiguous(f, p, flags)
    nb, ny, nx = grid
    rounds = torch.empty(1, dtype=torch.int32, device=f.device)
    lib = load()
    # Stream-ordered: the scratch is reusable once the kernel ran.
    scratch = torch.empty(lib.lib.cc_sharded_loop_scratch_words(f.shape[0], geo.ext_h, geo.ext_w),
                          dtype=torch.int32, device=f.device)
    if span is not None:
        close_span(span)
    lib.check(
        lib.lib.cc_sharded_loop(
            f.data_ptr(), p.data_ptr(), scratch.data_ptr(), flags.data_ptr(), rounds.data_ptr(),
            round_slot("sharded_loop", f.device), nb, ny, nx, geo.ext_h, geo.ext_w,
            geo_args(geo), dilate_steps, scan_after, max_iters, max_rounds, f.device.index,
            stream_of(f)),
        "sharded_loop",
    )
    count_launch("sharded_loop")
    return rounds
