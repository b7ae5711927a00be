"""Debug / validation modes: the port of ``cudacam_tpu/utils/debug.py``.

The reference ships opt-in sanitizers and a fail-fast CUDA error contract
(``checkCudaErrors`` logs and exits, helper.hpp:4-17). The port's analogs:

* ``enable_checks()`` — while debugging, turn on what PyTorch and
  the port's launcher offer: a warning on every implicit host
  synchronization, and a device synchronize after every kernel launch so a
  fault surfaces at the launch that caused it;
* ``device_health_check()`` — fail-fast canary: run a tiny computation on
  the device and verify the result, raising ``DeviceError`` if the device
  is absent or wedged.

The JAX package's ``interpreted_pallas`` has no counterpart: a CUDA kernel
has no interpreter, and the plain versions (``device='cpu'``) play that
part. Set ``CUDACAM_DEBUG=1`` to switch the checks on at import.
"""
from __future__ import annotations

import os
from typing import Union

import torch

from cudacam_tpu_torch.ops.cuda import _build
from cudacam_tpu_torch.utils.logging import get_logger

log = get_logger("debug")


class DeviceError(RuntimeError):
    """Raised when the device fails its health canary."""


def enable_checks(sync_warnings: bool = True, launch_checks: bool = True) -> None:
    """Enable runtime validation (for debugging only: both cost speed).

    ``sync_warnings``: ``torch.cuda.set_sync_debug_mode("warn")`` — PyTorch
    warns wherever an operation makes the host wait for the device
    (``.item()``, ``.cpu()``, a boolean test of a device tensor): it catches
    a readback that crept onto a hot path. Skipped without a CUDA device.

    ``launch_checks``: every kernel wrapper of the port synchronizes the
    device right after its launch and raises on a failed kernel status — it
    catches a fault during a kernel's run (an illegal address, a failed
    cooperative launch) at the launch that caused it, instead of at some
    later call that happens to synchronize."""
    if sync_warnings and torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode("warn")
    if launch_checks:
        _build.set_sync_after_launch(True)
    log.info("debug checks enabled (sync_warnings=%s, launch_checks=%s)",
             sync_warnings, launch_checks)


def disable_checks() -> None:
    if torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode("default")
    _build.set_sync_after_launch(False)


def device_health_check(device: Union[str, torch.device] = "cuda") -> str:
    """Fail-fast canary computation on ``device``; returns the platform name
    ('cuda' or 'cpu') on success."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise DeviceError("no CUDA device visible")
        x = torch.arange(256, dtype=torch.int32, device=dev).reshape(16, 16)
        got = int((x * 2 + 1).sum())
        expect = sum(range(256)) * 2 + 256
        if got != expect:
            raise DeviceError(f"canary mismatch on {dev}: got {got}, want {expect}")
        return dev.type
    except DeviceError:
        raise
    except Exception as e:  # surface with context, fail fast
        raise DeviceError(f"device health check failed: {e}") from e


if os.environ.get("CUDACAM_DEBUG"):
    enable_checks()
