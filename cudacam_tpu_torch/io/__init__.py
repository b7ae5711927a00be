"""Host I/O of the port: frame sources, the device ring, FPS metering, the
.rawv format, preview and PNG export."""
from cudacam_tpu_torch.io.metrics import FpsMeter
from cudacam_tpu_torch.io.preview import ascii_preview, save_png
from cudacam_tpu_torch.io.rawv import write_rawv
from cudacam_tpu_torch.io.ring import DeviceRingBuffer, to_host
from cudacam_tpu_torch.io.sources import (
    FrameSource, SequenceSource, SyntheticSource, VideoFileSource, WebcamSource, make_scene,
    make_spiral_frame, make_spiral_thresh, open_source,
)

__all__ = ["DeviceRingBuffer", "FpsMeter", "FrameSource", "SequenceSource", "SyntheticSource",
           "VideoFileSource", "WebcamSource", "ascii_preview", "make_scene", "make_spiral_frame",
           "make_spiral_thresh", "open_source", "save_png", "to_host", "write_rawv"]
