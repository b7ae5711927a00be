"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Every wrapper keeps a plain-integer ``launches`` count, raised by one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack
from cudacam_tpu_torch.ops.cuda.megakernel import hyst_phase1, hyst_phase2, unpack

#: The main path's kernels, in launch order.
KERNELS = (ff_pack, hyst_phase1, hyst_phase2, unpack)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
