"""Phase-1 rounds a plane, from the program's round counters
(``cudacam_tpu_torch.ops.cuda.round_counts``, added on the card by the
phase-1 kernel): rounds over planes. A plane is a frame on the whole-frame
path and an extended tile on the tile path. The counters hold the whole
process (the warm-up, the window and the traced stretch, all of the cell's
traffic; the warm-up is under 1% of a window's calls). None where the
program has no counters."""


def read(r):
    try:
        from cudacam_tpu_torch.ops.cuda import round_counts
    except ImportError:
        return None
    planes, rounds = round_counts()["hyst_phase1"]
    return rounds / planes if planes else None
