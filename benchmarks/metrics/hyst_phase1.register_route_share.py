"""Share (%) of the phase-1 launches that took the register route, from
the program's route counter (``cudacam_tpu_torch.ops.cuda.phase1_route_counts``:
``hyst_phase1`` launches by route, ``registers`` or ``shared``). The counter
holds the whole process (the warm-up, the window and the traced stretch,
all of the cell's traffic). None where the program has no such counter or
counted no launch."""


def read(r):
    try:
        from cudacam_tpu_torch.ops.cuda import phase1_route_counts
    except ImportError:
        return None
    counts = phase1_route_counts()
    n = sum(counts.values())
    return 100.0 * counts.get("registers", 0) / n if n else None
