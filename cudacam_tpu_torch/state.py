"""Configs and packed hysteresis state carried between the JAX package and
the port.

The system has no weights: what crosses is the ``CannyConfig`` (the port
keeps its own class with the same fields: :func:`config_from_jax`) and the
packed FINAL / CANDIDATE planes. The JAX
megakernel exports them in a guard-ringed (hwp, wp) uint32 layout
(cudacam_tpu/ops/pallas/megakernel.py ``_mega_geometry``): word rows past
ceil(h/32) and lanes past w are zero guards. The batched kernel exports
(B, hwp, wp) planes, its word rows padded up to 8 (megakernel.py:1070). The
port keeps (ceil(h/32), w) or (B, ceil(h/32), w) int32 planes with the same
bits; ``ops/bitpack.py`` of the JAX package keeps (ceil(h/32), w) uint32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cudacam_tpu_torch.config import CannyConfig


def config_from_jax(cfg) -> CannyConfig:
    """A JAX package ``CannyConfig`` -> the port's, field for field (the
    derived defaults are already resolved in ``cfg``). Its ``continuation``
    'split' stays 'split'; 'auto', 'pallas' and 'xla' become 'auto' (the
    whole-frame kernel, which gives their bytes)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(CannyConfig)}
    kw["continuation"] = "split" if cfg.continuation == "split" else "auto"
    return CannyConfig(**kw)


def planes_from_jax(
    fpack: np.ndarray, ppack: np.ndarray, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX megakernel export planes (uint32, guard-ringed; (hwp, wp), or
    (B, hwp, wp) from the batched kernel) -> the port's (ceil(h/32), w) or
    (B, ceil(h/32), w) int32 planes."""
    hw = -(-h // 32)

    def core(x: np.ndarray) -> torch.Tensor:
        x = np.asarray(x)
        if x.dtype != np.uint32 or x.ndim not in (2, 3) or x.shape[-2] < hw or x.shape[-1] < w:
            raise ValueError(f"expected uint32 planes of at least ({hw}, {w}), got {x.shape} {x.dtype}")
        # A copy: the port updates planes in place, the JAX export is read-only.
        return torch.from_numpy(np.array(x[..., :hw, :w], order="C").view(np.int32))

    return core(fpack), core(ppack)


def planes_to_jax(*planes: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The port's (ceil(h/32), w) int32 planes -> uint32 planes in the guard
    ringed layout the JAX package's packed kernels take (``saturate_packed``,
    ``converge_packed_split``): one zero word row below and 128 zero lanes
    to the right (the inverse of :func:`planes_from_jax`)."""
    return tuple(np.pad(x, ((0, 1), (0, 128))) for x in planes_to_numpy(*planes))


def planes_to_numpy(*planes: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The port's int32 planes -> uint32 numpy arrays in the JAX package's
    ``bitpack`` layout (the inverse of :func:`planes_from_jax` on the core)."""
    return tuple(p.detach().cpu().contiguous().numpy().view(np.uint32) for p in planes)
