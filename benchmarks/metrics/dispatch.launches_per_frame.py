"""Kernel launches a frame over the window, from the program's launch
counter (``cudacam_tpu_torch.ops.cuda.launch_counts``)."""


def read(r):
    n = sum(r.launches.values())
    return n / r.frames if n and r.frames else None
