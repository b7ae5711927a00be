"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Every kernel keeps a plain-integer launch count (``_build.LAUNCHES``),
raised by one by its wrapper where it launches the kernel and nowhere else,
so a run can show that a path went through the kernels. The round kernels
of the main path also count their rounds on the device (``_build.ROUNDS``:
:func:`round_counts`), so a run can tell rounds a frame from time a round.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from cudacam_tpu_torch.ops.cuda._build import (
    LAUNCHES, PHASE1_ROUTES, PLAIN_ROUNDS, ROUND_KERNELS, ROUNDS, ROUTES,
)
from cudacam_tpu_torch.ops.cuda.hysteresis import hysteresis_sweeps, hysteresis_sweeps_plain
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
    hysteresis_fused_batched, hysteresis_fused_batched_plain,
)

#: Every kernel (and kernel mode): the HYSTER main path's four in launch
#: order, then the display stages' feed-forward kernel, the two-kernel path's
#: pack and the threshold sweep's pack of every pair and its per-pair seed;
#: then the tile-sharded path's: ``ff_pack`` in its export mode (with
#: ``hyst_phase1``, K8), the round kernels as the host loop's local saturate
#: (K9), the core unpack (K10), the halo exchange (the host loop's) and the
#: one-card round loop (the two refreshes before it, then K9 + the refresh a
#: round, in one launch); then the column-split continuation
#: (K11) and the legacy row-sweep hysteresis (K12); then the probes' kernels
#: (K13, K14).
KERNELS = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack", "ff_stages", "pack_thresh",
           "sweep_pack_all", "sweep_seed", "ff_pack_export", "saturate_phase1",
           "saturate_phase2", "unpack_core", "halo_exchange", "sharded_loop", "split_converge",
           "hyst_sweeps", "probe_pack", "probe_pack_ballot", "probe_loop", "probe_unpack",
           "swar_stencil")

__all__ = ["KERNELS", "hysteresis_fused_batched", "hysteresis_fused_batched_plain",
           "hysteresis_sweeps", "hysteresis_sweeps_plain", "launch_counts", "phase1_route_counts",
           "reset_launch_counts", "reset_phase1_route_counts", "reset_round_counts",
           "round_counts"]


def launch_counts() -> Dict[str, int]:
    return {name: LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def phase1_route_counts() -> Dict[str, int]:
    """The ``hyst_phase1`` launches since the start (or the last
    :func:`reset_phase1_route_counts`) by the route each took on the card:
    ``registers`` (the bands' words in registers) or ``shared`` (in shared
    memory), as ``megakernel.round_layout`` reports it. The plain version
    (CPU tensors) launches nothing and counts nothing here."""
    return {route: ROUTES[route] for route in PHASE1_ROUTES}


def reset_phase1_route_counts() -> None:
    ROUTES.clear()


def round_counts(device: Optional[Union[str, torch.device]] = None) -> Dict[str, Tuple[int, int]]:
    """The round counters since the first counted launch (or the last
    :func:`reset_round_counts`): ``hyst_phase1`` (planes, rounds),
    ``hyst_phase2`` (planes continued, rounds added), ``sharded_loop``
    (calls, collective rounds). A plane is a frame on the whole-frame path
    and an extended tile on the tile path. ``device``: that device's block
    (``"cpu"``: the plain versions'); None sums every block. Every launch
    named ``hyst_phase1`` / ``hyst_phase2`` counts (the K6 and sweep paths'
    too); the local saturate (K9), ``split_converge`` (K11) and the
    distributed host loop count nothing. One device-to-host copy a block,
    which waits for the device: never on the hot path."""
    blocks = [PLAIN_ROUNDS]
    if device is None:
        blocks += [t.tolist() for t, _ in ROUNDS.values()]
    else:
        device = torch.device(device)
        if device.type != "cpu":
            index = torch.cuda.current_device() if device.index is None else device.index
            blocks = [ROUNDS[index][0].tolist()] if index in ROUNDS else []
    total = [[0, 0] for _ in ROUND_KERNELS]
    for block in blocks:
        for row, got in zip(total, block):
            row[0] += got[0]
            row[1] += got[1]
    return {name: tuple(row) for name, row in zip(ROUND_KERNELS, total)}


def reset_round_counts() -> None:
    """Zeroes every device's counters (on its current stream) and the plain
    versions'."""
    for t, _ in ROUNDS.values():
        t.zero_()
    for row in PLAIN_ROUNDS:
        row[:] = [0, 0]
