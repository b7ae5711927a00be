"""Environment probe: what this host offers the port."""
from __future__ import annotations

import importlib.util
import shutil
from typing import Dict, Union


def probe() -> Dict[str, Union[str, bool, int, None]]:
    """Torch version, CUDA build and device, and whether nvcc and triton
    are present. Builds nothing and initialises no CUDA context beyond
    PyTorch's own availability check."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "nvcc": shutil.which("nvcc"),
        "triton": importlib.util.find_spec("triton") is not None,
    }
