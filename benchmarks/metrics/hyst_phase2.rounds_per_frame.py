"""Phase-2 rounds a frame, from the program's round counters
(``cudacam_tpu_torch.ops.cuda.round_counts``): the rounds phase 2 added,
over the planes phase 1 ran (a frame that phase 2 does not continue adds
0). The counters hold the whole process (the warm-up, the window and the
traced stretch; the warm-up is under 1% of a window's calls). None where
the program has no counters."""


def read(r):
    try:
        from cudacam_tpu_torch.ops.cuda import round_counts
    except ImportError:
        return None
    counts = round_counts()
    planes, rounds = counts["hyst_phase1"][0], counts["hyst_phase2"][1]
    return rounds / planes if planes else None
