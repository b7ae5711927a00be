"""Build the CUDA kernels at first use and load them with ctypes.

The sources in ``cudacam_tpu_torch/csrc`` have a plain C interface: nvcc
compiles each ``.cu`` to an object, all of them at once in parallel, and
links the objects into one shared library (seconds; no PyTorch headers),
which is loaded with ctypes. The library lands in ``cudacam_tpu_torch/_build``
(git-ignored), named by a digest of the sources and flags, so an edited
source rebuilds and an unchanged one loads the library already built.
Nothing here runs at import time: this module imports on a host with no
nvcc and no GPU.

Beside the build: the wrappers' launch counter (``LAUNCHES``), phase 1's
launches by route (``ROUTES``), the round kernels' counter blocks
(``ROUNDS``) and the host spans of the launch wrappers (:func:`open_span`).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> (restype, argtypes). Every pointer and the stream
#: go as c_void_p; a plain int would cut them to 32 bits.
SIGNATURES = {
    "cc_ff_pack": (_I, [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P]),
    "cc_ff_pack_route": (_I, [_P, _I, _I]),
    "cc_ff_stages": (_I, [_P] * 8 + [_I] * 13 + [_P]),
    "cc_pack_thresh": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "cc_hyst_phase1": (_I, [_P] * 5 + [_I] * 7 + [_P]),
    "cc_hyst_phase2": (_I, [_P] * 5 + [_I] * 6 + [_P]),
    "cc_hyst_scratch_words": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "cc_hyst_layout": (_I, [_I, _I, _I, _I, _I, _I, _P, _P]),
    "cc_split_converge": (_I, [_P, _P, _P, _P] + [_I] * 9 + [_P]),
    "cc_split_scratch_words": (ctypes.c_longlong, [_I] * 6),
    "cc_split_layout": (_I, [_I] * 6 + [_P]),
    "cc_hyst_sweeps": (_I, [_P] * 4 + [_I] * 7 + [_P]),
    "cc_hyst_sweeps_layout": (_I, [_I, _I, _I, _P]),
    "cc_unpack": (_I, [_P, _P, _P, _I, _I, _I, _I, _P]),
    "cc_unpack_core": (_I, [_P, _P] + [_I] * 12 + [_P]),
    "cc_halo_exchange": (_I, [_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P, _I, _P]),
    "cc_exchange_scratch_words": (ctypes.c_longlong, [_I, _I, _I]),
    "cc_sharded_loop": (_I, [_P] * 6 + [_I] * 5 + [_P] + [_I] * 5 + [_P]),
    "cc_sharded_loop_scratch_words": (ctypes.c_longlong, [_I, _I, _I]),
    "cc_sharded_loop_layout": (_I, [_I] * 7 + [_P]),
    "cc_sweep_pack_all": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "cc_sweep_seed": (_I, [_P, _P, _I, _I, _I, _I, _P]),
    "cc_probe_pack": (_I, [_P, _P, _I, _I, _I, _I, _P]),
    "cc_probe_pack_layout": (_I, [_I, _I, _I, _P]),
    "cc_probe_loop": (_I, [_P, _P, _P] + [_I] * 6 + [_P]),
    "cc_probe_loop_max_blocks": (_I, [_I]),
    "cc_probe_loop_layout": (_I, [_I, _I, _I, _P]),
    "cc_probe_ballot_grid": (_I, [_I, _I, _I, _P]),
    "cc_probe_unpack": (_I, [_P, _P, _I, _I, _I, _I, _P]),
    "cc_probe_unpack_layout": (_I, [_I, _I, _I, _P]),
    "cc_swar_stencil": (_I, [_P, _P, _I, _I, _I, _I, _I, _P]),
    "cc_swar_layout": (_I, [_I, _I, _I, _I, _P]),
    "cc_error_string": (ctypes.c_char_p, [_I]),
}

#: Launches per kernel, raised by one by its wrapper right after each launch
#: and nowhere else (``ops/cuda/__init__.py`` reads and resets them).
LAUNCHES: collections.Counter = collections.Counter()

#: The routes of a ``hyst_phase1`` launch (``csrc/hyst_rounds.cu``): the
#: band's words in registers, or in shared memory.
PHASE1_ROUTES = ("registers", "shared")
#: ``hyst_phase1`` launches by route, raised by one by its wrapper right
#: after each launch (``ops/cuda/__init__.py`` reads and resets them); not
#: part of ``LAUNCHES``' counts by kernel.
ROUTES: collections.Counter = collections.Counter()

#: The round kernels whose rounds are counted, in a counter block's row
#: order: ``hyst_phase1`` (planes, rounds), ``hyst_phase2`` (planes
#: continued, rounds added), ``sharded_loop`` (calls, collective rounds).
ROUND_KERNELS = ("hyst_phase1", "hyst_phase2", "sharded_loop")
#: A counter block per CUDA device, by device index: an int64 (3, 2)
#: tensor, one row per ``ROUND_KERNELS`` entry, and its address. A device's
#: block is made and zeroed at its first counted launch; the kernels add to
#: their row with atomics, on the device (``ops/cuda/__init__.py`` reads and
#: resets the blocks and ``PLAIN_ROUNDS``).
ROUNDS: Dict[int, Tuple[torch.Tensor, int]] = {}
_ROUNDS_MADE = threading.Lock()
_ROW_BYTES = {name: 16 * i for i, name in enumerate(ROUND_KERNELS)}
#: The plain versions' counters, in ``ROUND_KERNELS`` order: they add the
#: same values as the kernels, whatever device their tensors lie on.
PLAIN_ROUNDS: List[List[int]] = [[0, 0] for _ in ROUND_KERNELS]


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an up-to-date library was already on disk
    build_seconds: float
    compiler_log: str  # nvcc's -Xptxas -v report (registers, shared memory)

    def check(self, code: int, what: str) -> None:
        """Raise when a C entry point returned a CUDA error. Every launch
        passes through here, so with the debugging switch on
        (:func:`set_sync_after_launch`) this also synchronizes the device:
        a fault during the kernel's run raises at its launch."""
        if code != 0:
            msg = self.lib.cc_error_string(code).decode()
            raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
        if _sync_after_launch:
            torch.cuda.synchronize()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc") or (
        str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else None
    )
    if not found or not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


@functools.lru_cache(maxsize=None)
def load() -> KernelLibrary:
    """Build (when needed) and load the kernel library. Raises when nvcc is
    missing or the build fails; there is no fallback."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    path = BUILD_DIR / f"libcudacam_kernels_{digest.hexdigest()[:16]}.so"
    built, seconds, log = False, 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]
        log = "".join(outs)
        for src, proc, out in zip(sources, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
        tmp = BUILD_DIR / f"{tag}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        for obj in objs:
            obj.unlink()
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, path)
        built = True
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return KernelLibrary(lib, path, built, seconds, log)


_sync_after_launch = False


def set_sync_after_launch(enabled: bool) -> None:
    """Debugging switch (``utils/debug.py::enable_checks``): when on,
    ``KernelLibrary.check`` synchronizes the device right after each launch,
    so a fault during a kernel's run raises at that launch."""
    global _sync_after_launch
    _sync_after_launch = bool(enabled)


def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched kernel ``name``."""
    LAUNCHES[name] += 1


def _make_block(device: torch.device) -> Tuple[torch.Tensor, int]:
    with _ROUNDS_MADE:  # two threads' first launches make one block
        block = ROUNDS.get(device.index)
        if block is None:
            t = torch.zeros((len(ROUND_KERNELS), 2), dtype=torch.int64, device=device)
            block = ROUNDS[device.index] = (t, t.data_ptr())
    return block


def round_slot(name: str, device: torch.device) -> Optional[int]:
    """Address of round kernel ``name``'s two counters in ``device``'s
    block, which a launch of it on the device's current stream adds to;
    None for a launch name with no counters (the local saturate's). The
    first call on a device makes the block (a fill on that stream), so a
    wrapper asks for the slot after its prep span."""
    row = _ROW_BYTES.get(name)
    if row is None:
        return None
    block = ROUNDS.get(device.index)
    if block is None:
        block = _make_block(device)
    return block[1] + row


def count_rounds(name: str, planes: int, rounds: int) -> None:
    """A plain version's count: adds (planes, rounds) to ``name``'s row of
    ``PLAIN_ROUNDS``, as the kernel adds to its device's block."""
    row = PLAIN_ROUNDS[ROUND_KERNELS.index(name)]
    row[0] += planes
    row[1] += rounds


def open_span(name: str):
    """Opens a ``torch.profiler`` range named ``name``; :func:`close_span`
    ends it. A wrapper opens one only while a profiler session records,
    which it reads in place from ``torch.autograd.profiler``'s flag (the
    one torch's own compiled-kernel launchers read for the same purpose;
    a function call there would cost the untraced path a few tenths of a
    µs a span)::

        span = open_span(name) if autograd_profiler._is_profiler_enabled else None
        ...
        if span is not None:
            close_span(span)

    The wrappers' spans (``cc.validate``, ``cc.prep.<launch name>``) hold
    host work only: no launch, copy or fill, so they leave no entry on the
    device lane."""
    return torch.profiler.record_function(name).__enter__()


def close_span(span) -> None:
    """Ends a span from :func:`open_span`."""
    span.__exit__(None, None, None)


def use_plain(*tensors) -> bool:
    """Route of a wrapper: True (the plain PyTorch version) when every
    tensor lies on the CPU, False (the kernel) when every tensor lies on a
    CUDA device. Anything else raises: no other device has a route."""
    tensors = [t for t in tensors if t is not None]
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"tensors must all lie on the CPU or all on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_contiguous(*tensors) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
