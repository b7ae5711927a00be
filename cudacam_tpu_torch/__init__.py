"""cudacam_tpu_torch — the PyTorch + CUDA port of cudacam_tpu for Hopper.

The JAX package (``cudacam_tpu``) is the reference. The port reuses its
jax-free modules as they are (config, stages, the NumPy oracle, the frame
sources) and replaces each TPU kernel with one written by hand for sm_90a
(``csrc/``), built with nvcc at first use. Importing the package needs no
GPU, no nvcc and no triton.
"""
from cudacam_tpu.config import CannyConfig
from cudacam_tpu.stages import CANDIDATE_EDGE, CANNY_STAGE_NAMES, FINAL_EDGE, NO_EDGE, CannyStage
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
