"""cudacam_tpu_torch — the PyTorch + CUDA port of cudacam_tpu for Hopper.

The JAX package (``cudacam_tpu``) is the reference; the port imports nothing
of it and keeps its own copies of what it needs (config, stages, the frame
sources, the oracle's constants, the native frame pump). Each TPU kernel
becomes one written by hand for sm_90a (``csrc/``), built with nvcc at
first use; the frame pump (``native/``) is built with g++. Entry points run
on the card unless the caller asks for the CPU. Importing the package needs
no GPU, no nvcc, no triton and no jax.
"""
from cudacam_tpu_torch.config import CannyConfig
from cudacam_tpu_torch.stages import CANDIDATE_EDGE, CANNY_STAGE_NAMES, FINAL_EDGE, NO_EDGE, CannyStage
from cudacam_tpu_torch.utils.env import probe

__version__ = "0.1.0"

__all__ = [
    "CannyConfig",
    "CannyStage",
    "CANNY_STAGE_NAMES",
    "FINAL_EDGE",
    "CANDIDATE_EDGE",
    "NO_EDGE",
    "probe",
    "__version__",
]
