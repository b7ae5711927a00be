"""Host I/O of the port: frame sources, the .rawv format and PNG export."""
from cudacam_tpu_torch.io.rawv import write_rawv
from cudacam_tpu_torch.io.sources import (
    FrameSource, make_scene, make_spiral_frame, make_spiral_thresh, open_source,
)

__all__ = ["FrameSource", "make_scene", "make_spiral_frame", "make_spiral_thresh",
           "open_source", "write_rawv"]
