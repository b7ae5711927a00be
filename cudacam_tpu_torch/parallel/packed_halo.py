"""The collective round loop of the sharded hysteresis.

Port of ``cudacam_tpu/parallel/packed_halo.py``. Each tile holds its
(FINAL, CANDIDATE) planes packed over an extended tile
(``ops/packed_strips.py``: the geometry, the strip extraction and placement,
one halo refresh, the strip half of the JAX module). A
collective round runs the local saturate on every tile, then one halo
refresh; the loop ends when no tile grows and no new halo bit appears
anywhere.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# --- the collective round loop ------------------------------------------------

#: ``exchange(x, grow=None, gate=None, pending=None, rounds=None)``: one halo
#: refresh of the planes ``x`` in place (``parallel/mesh.py``'s transports).
#: ``pending`` (one int32) is set to "any tile in ``grow`` still growing, or
#: any new halo bit, anywhere on the mesh"; ``rounds`` is raised by one; a
#: ``gate`` holding 0 makes it do nothing.
Exchange = Callable[..., None]

#: ``saturate(f, p, gate) -> growing``: the local operator, in place on the
#: (T, hw, w) planes, returning a (T,) tensor of "cap hit while changing".
Saturate = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def packed_hysteresis_loop(
    f: torch.Tensor,
    p: torch.Tensor,
    still_growing: torch.Tensor,
    saturate: Saturate,
    exchange: Exchange,
    max_rounds: int,
    host_exit: bool,
) -> torch.Tensor:
    """Converge the sharded fixed point on the (T, hw, w) packed planes, in
    place; returns a one-int32 tensor on their device: the collective rounds
    taken.

    The candidate plane is static: it is exchanged once up front to deepen
    the halo candidates; only FINAL strips move per round. ``still_growing``
    (T,) is the entry state's flag (the export's phase-1 exit). A round is
    ``saturate`` then ``exchange``; the loop runs while the pending flag is
    up, at most ``max_rounds`` rounds (packed_halo.py:256-306).

    With ``host_exit`` the host reads the pending flag before each round and
    stops the loop (on CPU tensors that costs nothing; across processes the
    one read of the all-reduced flag per round stands in for the ``psum``).
    Without it nothing is read back: all ``max_rounds`` rounds are launched,
    and each one's kernels read the device flag as their gate and return at
    once when it is 0."""
    pending = torch.zeros(1, dtype=torch.int32, device=f.device)
    rounds = torch.zeros(1, dtype=torch.int32, device=f.device)
    exchange(p)
    exchange(f, grow=still_growing, pending=pending)
    for _ in range(max_rounds):
        if host_exit and not int(pending):
            break
        growing = saturate(f, p, pending)
        exchange(f, grow=growing, gate=pending, pending=pending, rounds=rounds)
    return rounds
