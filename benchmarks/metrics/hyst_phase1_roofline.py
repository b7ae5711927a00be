"""Share (%) of its bound that the phase-1 round kernel reaches: the 32-bit
operations of a frame's phase 1 over the card's peak, against the kernel's
device time a frame in the traced stretch. A round on ``ceil(H/32) W``
packed words costs 16 operations a word for each inner dilation step and
one for the change test (``chip_smoke.py::round_ops`` without the scans,
which phase 1 does not run); a frame takes the rounds a plane that the
program's round counters give (``cudacam_tpu_torch.ops.cuda.round_counts``,
whole-process totals). The words of the frame stand for its tiles' on the
tile path. None without a device lane or where the program has no
counters."""

from benchmarks import roofline

KERNEL = "hyst_kernel<false"
#: Word operations of one dilation step (``chip_smoke.py::DILATE_OPS``).
DILATE_OPS = 16


def round_ops(words: int, dilate_steps: int) -> int:
    """Word operations of one dilation round on ``words`` packed words."""
    return words * (DILATE_OPS * dilate_steps + 1)


def read(r):
    if r.lane is None:
        return None
    us = r.lane.us_of(KERNEL)
    try:
        from cudacam_tpu_torch.ops.cuda import round_counts
    except ImportError:
        return None
    planes, rounds = round_counts()["hyst_phase1"]
    if us is None or not planes:
        return None
    c = r.canny
    ops = round_ops(roofline.packed_words(c["height"], c["width"]),
                    c["hysteresis_inner_steps"]) * rounds / planes
    bound, _ = roofline.bound_s(0.0, ops)
    return 100.0 * bound * 1e6 / (us / r.lane.frames)
