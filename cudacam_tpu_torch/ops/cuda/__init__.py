"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Every kernel keeps a plain-integer launch count (``_build.LAUNCHES``),
raised by one by its wrapper where it launches the kernel and nowhere else,
so a run can show that a path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from cudacam_tpu_torch.ops.cuda._build import LAUNCHES
from cudacam_tpu_torch.ops.cuda.hysteresis import hysteresis_sweeps, hysteresis_sweeps_plain

#: Every kernel (and kernel mode): the HYSTER main path's four in launch
#: order, then the display stages' feed-forward kernel, the two-kernel path's
#: pack and the threshold sweep's per-pair pack; then the tile-sharded
#: path's: ``ff_pack`` in its export mode (with ``hyst_phase1``, K8), the
#: round kernels as the host loop's local saturate (K9), the core unpack
#: (K10), the halo exchange and the one-card round loop (K9 + the exchange
#: in one launch); then the column-split continuation (K11) and the legacy
#: row-sweep hysteresis (K12); then the probes' kernels (K13, K14).
KERNELS = ("ff_pack", "hyst_phase1", "hyst_phase2", "unpack", "ff_stages", "pack_thresh",
           "sweep_pack", "ff_pack_export", "saturate_phase1", "saturate_phase2", "unpack_core",
           "halo_exchange", "sharded_loop", "split_converge", "hyst_sweeps", "probe_pack",
           "probe_pack_ballot", "probe_loop", "probe_unpack", "swar_stencil")

__all__ = ["KERNELS", "hysteresis_sweeps", "hysteresis_sweeps_plain", "launch_counts",
           "reset_launch_counts"]


def launch_counts() -> Dict[str, int]:
    return {name: LAUNCHES[name] for name in KERNELS}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
