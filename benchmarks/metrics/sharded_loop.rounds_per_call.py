"""Collective rounds a call of the one-card round loop, from the program's
round counters (``cudacam_tpu_torch.ops.cuda.round_counts``, added on the
card by ``sharded_loop_kernel``): collective rounds over loop calls. The
counters hold the whole process (the warm-up, the window and the traced
stretch; the warm-up is under 1% of a window's calls). None where the
program has no counters."""


def read(r):
    try:
        from cudacam_tpu_torch.ops.cuda import round_counts
    except ImportError:
        return None
    calls, rounds = round_counts()["sharded_loop"]
    return rounds / calls if calls else None
