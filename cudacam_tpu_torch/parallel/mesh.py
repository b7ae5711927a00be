"""The (b, y, x) tile mesh and its transports.

Port of ``cudacam_tpu/parallel/mesh.py``: batch 'b' (camera streams), rows
'y' and columns 'x' of a frame. A frame batch is cut into tiles over the
mesh; a tile's neighbours on 'y' and 'x' hand it their boundary state. The
mesh carries the transport that moves that state:

* no transport (the main path on one card): every tile of the batch lives
  on one device as the leading axis of one tensor, (b, y, x) order. A
  neighbour hop is an index shift over that axis; on CUDA tensors the
  packed exchange is one kernel (``ops/cuda/halo.py``) and the convergence
  flag stays on the device.
* :class:`DistTransport`: one process per mesh place, ``torch.distributed``
  underneath (NCCL on CUDA, gloo on the CPU). Strips move with
  ``batch_isend_irecv`` and the flag with ``all_reduce``
  (``parallel/distributed.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cudacam_tpu_torch.ops.cuda.halo import halo_exchange
from cudacam_tpu_torch.ops.packed_strips import PackedGeo, Shift, exchange_packed, local_shift

BATCH_AXIS = "b"
ROW_AXIS = "y"
COL_AXIS = "x"
AXES = (BATCH_AXIS, ROW_AXIS, COL_AXIS)


@dataclasses.dataclass(frozen=True)
class DistTransport:
    """One mesh place per process of the default ``torch.distributed`` group:
    rank r holds place r in (b, y, x) order. ``device`` is where this
    process's tensors live (a CUDA device for NCCL, the CPU for gloo)."""

    rank: int
    world: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """A (batch, rows, cols) mesh of tiles; ``transport`` None is the
    one-card mesh (every tile on one device), else the processes'."""

    batch: int
    rows: int
    cols: int
    transport: Optional[DistTransport] = None

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.batch, ROW_AXIS: self.rows, COL_AXIS: self.cols}

    @property
    def distributed(self) -> bool:
        return self.transport is not None

    def coords(self) -> Tuple[int, int, int]:
        """This process's (b, y, x) place (distributed meshes)."""
        r = self.transport.rank
        return r // (self.rows * self.cols), (r // self.cols) % self.rows, r % self.cols

    # -- the neighbour hop ---------------------------------------------------

    def _neighbours(self, axis: str) -> Tuple[Optional[int], Optional[int]]:
        """Ranks of this process's predecessor and successor on ``axis``."""
        _, i, j = self.coords()
        n, pos, step = (self.rows, i, self.cols) if axis == ROW_AXIS else (self.cols, j, 1)
        r = self.transport.rank
        return (r - step if pos > 0 else None), (r + step if pos < n - 1 else None)

    def shift(self) -> Shift:
        """The neighbour hop: an index shift over the tile axis on one card;
        across processes, each strip goes to the neighbour in one batch of
        point-to-point sends and receives."""
        if not self.distributed:
            return local_shift(self.rows, self.cols)
        import torch.distributed as dist

        def shift(down: torch.Tensor, up: torch.Tensor, axis: str):
            prev, nxt = self._neighbours(axis)
            top, bot = torch.zeros_like(down), torch.zeros_like(up)
            ops = []
            if nxt is not None:
                ops += [dist.P2POp(dist.isend, down.contiguous(), nxt),
                        dist.P2POp(dist.irecv, bot, nxt)]
            if prev is not None:
                ops += [dist.P2POp(dist.isend, up.contiguous(), prev),
                        dist.P2POp(dist.irecv, top, prev)]
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return top, bot

        return shift

    # -- the packed exchange -------------------------------------------------

    def exchange(self, x: torch.Tensor, geo: PackedGeo, *, grow=None, gate=None, pending=None,
                 rounds=None) -> None:
        """One halo refresh of the local tiles' planes ``x``, in place, with
        the global pending flag (``packed_halo.Exchange``): one kernel on a
        one-card mesh; across processes the plain exchange, the flag
        all-reduced and read by the host."""
        if not self.distributed:
            halo_exchange(x, (x.shape[0] // (self.rows * self.cols), self.rows, self.cols), geo,
                          grow=grow, gate=gate, pending=pending, rounds=rounds)
            return
        import torch.distributed as dist

        if gate is not None and int(gate) == 0:
            return
        out, new = exchange_packed(x, geo, self.rows, self.cols, self.shift())
        x.copy_(out)
        if pending is not None:
            flag = new.any()
            if grow is not None:
                flag = flag | grow.ne(0).any()
            flag = flag.to(torch.int32).reshape(1)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            pending.copy_(flag)
        if rounds is not None:
            rounds += 1


def make_mesh(
    batch: int = 1,
    rows: Optional[int] = None,
    cols: int = 1,
    transport: Optional[DistTransport] = None,
) -> TileMesh:
    """Build a (b, y, x) mesh: over the processes of ``transport`` (their
    number must fill it; without ``rows`` the places left go to the row
    axis, which keeps the halo exchange to two neighbours), or, without
    one, ``batch`` x ``rows`` x ``cols`` tiles on one card."""
    n = transport.world if transport is not None else batch * (rows or 1) * cols
    if rows is None:
        if n % (batch * cols) != 0:
            raise ValueError(f"{n} devices not divisible by batch*cols={batch * cols}")
        rows = n // (batch * cols)
    if batch * rows * cols != n:
        raise ValueError(f"mesh {batch}x{rows}x{cols} needs {batch * rows * cols} devices, have {n}")
    return TileMesh(batch, rows, cols, transport)


def single_device_mesh() -> TileMesh:
    return make_mesh(batch=1, rows=1, cols=1)
