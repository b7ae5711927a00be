"""NumPy models of the schedules of K13's ballot pack and resident loop
(``cudacam_tpu_torch/csrc/probe_hyster.cu``) against the contracts.

The kernels run only on a card (``tests/test_torch_cuda.py``). Here each
kernel's work split is written out in NumPy with the kernel's own indices,
and what it computes is held to independent references, tolerance 0 (bit
masks and integers):

* the resident loop (``loop_block_kernel``): one block, its threads
  holding up to R rows of one column; a round from a thread's own rows, the
  next lane's column (a shuffle) or a warp's published column, and the row
  above from the thread above's published last row or, at a thread's first
  row in the top group, the last group's (the plane's last row, cyclic);
  published rows and columns alternating between two buffers that start as
  garbage; lanes past w and rows past the plane left unmasked in full
  groups, shown to stay 0. Held to ``_loop_numpy``, to ``probe_loop_plain``
  and to the JAX probe kernel in interpret mode;
* the ballot pack (``pack_ballot_kernel``): warp tasks of one word row x 32
  columns, a lane's row read as two 16-byte vectors where the row's
  address is 16-byte aligned and the 32 columns lie inside w, else byte by
  byte; rows past h as 0; the ballot as bit assembly over lanes. Held to
  the JAX ``bitpack.pack_mask`` and to the recorded outputs of JAX probe A'.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cudacam_tpu.ops.bitpack import pack_mask
from cudacam_tpu_torch.probes import hyster_kernel as hk
from test_torch_probes import _loop_numpy, hyster_calls  # noqa: F401 (a fixture)

#: The kernel's constants: a block's threads and a thread's rows at most.
LOOP_NT, LOOP_R = 1024, 10


def _resident_plan(hw: int, w: int):
    """``probe_loop_plan``'s resident route: (rows a thread R, row groups
    G, columns tw), or None where one block does not hold the plane."""
    tw = -(-w // 32) * 32
    if w > LOOP_NT:
        return None
    rows = -(-hw // (LOOP_NT // tw))
    if rows > LOOP_R:
        return None
    return rows, -(-hw // rows), tw


def _resident_loop(plane: np.ndarray, max_rounds: int, seed: int = 0):
    """The resident loop's schedule: returns (plane, [[rounds, changed]]).
    Every published buffer starts as garbage."""
    hw, w = plane.shape
    R, G, tw = _resident_plan(hw, w)
    n = G * tw
    t = np.arange(n)
    g, c, lane = t // tw, t % tw, t % 32
    mine = np.where(c < w, np.clip(hw - g * R, 0, R), 0)
    partial = (g + 1) * R > hw  # the last group
    r = np.arange(R)
    valid = r[None, :] < mine[:, None]  # (n, R)
    src_rows = np.minimum(g[:, None] * R + r, hw - 1)
    f32 = plane.view(np.uint32)
    regs = np.where(valid, f32[src_rows, np.minimum(c, w - 1)[:, None]], 0).astype(np.uint32)

    # Sources: the row above row 0 (the group above's published last row, at
    # g = 0 the last group's), and the column right of c.
    up = np.where(g > 0, g - 1, G - 1) * tw + c
    wrap = c == w - 1
    from_edge = (mine > 0) & ((lane == 31) | wrap)
    src_warp = np.minimum(g * (tw // 32) + np.where(wrap, 0, (c + 1) // 32), n // 32 - 1)
    nxt = np.where(lane < 31, t + 1, t)  # __shfl_down_sync: lane 31 reads its own word

    rng = np.random.default_rng(seed)
    last = rng.integers(0, 2**32, (2, n), dtype=np.uint64).astype(np.uint32)
    edge = rng.integers(0, 2**32, (2, n // 32, R), dtype=np.uint64).astype(np.uint32)

    def publish(buf):
        row = np.where(partial, np.maximum(mine - 1, 0), R - 1)
        last[buf] = regs[t, row]
        edge[buf] = regs[::32, :]  # lane 0 of each warp

    publish(0)
    it = 0
    while True:
        buf = it & 1
        right = np.where(from_edge[:, None], edge[buf][src_warp], regs[nxt, :])
        above = np.concatenate([last[buf][up][:, None], regs[:, :-1]], axis=1)
        nv = regs | above | right | (regs << np.uint32(1))
        nv = np.where(partial[:, None] & ~valid, 0, nv)  # a full group's rows are all kept
        changed = bool((nv ^ regs).any())
        regs = nv
        publish(buf ^ 1)
        it += 1
        if not changed or it >= max_rounds:
            break
    assert not regs[~valid].any()  # lanes past w and rows past the plane stay 0
    out = np.zeros((hw, w), np.uint32)
    ti, ri = np.nonzero(valid)
    out[g[ti] * R + ri, c[ti]] = regs[ti, ri]
    return out.view(np.int32), [[it, int(changed)]]


def _sparse(hw: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (3, hw, w), dtype=np.uint64).astype(np.uint32)
    return (words[0] & words[1] & words[2]).view(np.int32)


#: Small and odd planes, and the tallest plane the resident route takes at
#: 256, 100, 32 and 1024 columns (every thread at 10 rows).
LOOP_PLANES = [(40, 256), (1, 1), (7, 9), (33, 5), (3, 40), (1, 77), (45, 1), (80, 100),
               (320, 32), (10, 1024)]


@pytest.mark.parametrize("shape", LOOP_PLANES)
@pytest.mark.parametrize("cap", [1, 2, 5, 37, 400])
def test_resident_loop_schedule_equals_the_contract(shape, cap):
    for seed, plane in enumerate((hk.loop_input(*shape), _sparse(*shape, seed=sum(shape)))):
        got, flags = _resident_loop(plane, cap, seed)
        want, want_flags = _loop_numpy(plane, cap)
        np.testing.assert_array_equal(got, want)
        assert flags == want_flags
        plain, plain_flags = hk.probe_loop_plain(torch.from_numpy(plane), cap)
        assert torch.equal(plain, torch.from_numpy(got)) and plain_flags.tolist() == flags


def test_resident_loop_plan_holds_the_plane_in_one_block():
    assert _resident_plan(40, 256) == (10, 4, 256)
    assert _resident_plan(41, 256) is None  # one word row past: the grid route
    assert _resident_plan(45, 1) == (2, 23, 32)
    assert _resident_plan(320, 32) == (10, 32, 32)
    assert _resident_plan(321, 32) is None
    assert _resident_plan(10, 1024) == (10, 1, 1024)
    assert _resident_plan(1, 1025) is None


def test_resident_loop_schedule_equals_the_jax_probe(hyster_calls):
    """The JAX kernel in interpret mode, on the probe's own input and on
    the edge planes of its shape."""
    kernel, kw, (plane,), (out, flags) = hyster_calls[2]
    got, got_flags = _resident_loop(plane.view(np.int32), hk.LOOP_ROUNDS)
    np.testing.assert_array_equal(got, out.view(np.int32))
    assert got_flags == np.asarray(flags).tolist() == [[326, 0]]
    corner = np.zeros((40, 256), np.int32)
    corner[39, 255] = 1
    for edge_plane in (corner, _sparse(40, 256, seed=3)):
        jout, jflags = pl.pallas_call(kernel, interpret=True, **kw)(
            jnp.asarray(edge_plane.view(np.uint32)))
        got, got_flags = _resident_loop(edge_plane, hk.LOOP_ROUNDS)
        np.testing.assert_array_equal(got, np.asarray(jout).view(np.int32))
        assert got_flags == np.asarray(jflags).tolist()


def test_resident_loop_garbage_is_never_read():
    """Runs whose published buffers start as different garbage agree:
    every value read was written first."""
    plane = _sparse(40, 256, seed=7)
    runs = [_resident_loop(plane, 400, seed) for seed in range(4)]
    assert all(np.array_equal(runs[0][0], o) and runs[0][1] == fl for o, fl in runs[1:])


# -- the ballot pack --------------------------------------------------------


def _ballot_pack(buf: np.ndarray, offset: int, h: int, w: int):
    """``pack_ballot_kernel`` on the (h, w) mask at ``buf[offset:]``, with
    ``buf`` starting on a 16-byte boundary: (words, how many rows took each
    path)."""
    hw, groups = -(-h // 32), -(-w // 32)
    out = np.zeros((hw, w), np.uint32)
    paths = {"vector": 0, "byte": 0, "past h": 0}
    lanes = np.arange(32, dtype=np.uint32)
    for task in range(hw * groups):  # k-major, as the grid walks them
        k, c0 = divmod(task, groups)
        c0 *= 32
        v = np.zeros((32, 8), np.uint32)
        for lane in range(32):
            y = 32 * k + lane
            addr = offset + y * w + c0
            if y >= h:
                paths["past h"] += 1
            elif c0 + 32 <= w and addr % 16 == 0:
                paths["vector"] += 1
                v[lane] = np.concatenate([buf[addr:addr + 16], buf[addr + 16:addr + 32]]).view("<u4")
            else:
                paths["byte"] += 1
                row = np.zeros(32, np.uint8)
                n = min(32, w - c0)
                row[:n] = buf[addr:addr + n]
                v[lane] = row.view("<u4")
        mine = np.zeros(32, np.uint32)
        for b in range(32):
            pred = ((v[:, b >> 2] >> np.uint32(8 * (b & 3))) & np.uint32(0xFF)) != 0
            word = np.bitwise_or.reduce(pred.astype(np.uint32) << lanes)  # the ballot
            mine[b] = word  # lane b keeps it
        keep = c0 + np.arange(32) < w
        out[k, c0:c0 + 32][:keep.sum()] = mine[keep]
    return out.view(np.int32), paths


def _buffer(h: int, w: int, offset: int, seed: int) -> np.ndarray:
    buf = np.zeros(offset + h * w + 32, np.uint8)
    buf[offset:offset + h * w] = hk.pack_input(seed, h, w).ravel() * np.uint8(3)
    return buf


@pytest.mark.parametrize("h,w", [(128, 256), (1, 1), (37, 53), (70, 1918), (33, 7680 + 16),
                                 (64, 96), (40, 31)])
@pytest.mark.parametrize("offset", [0, 1, 16])
def test_ballot_pack_tasks_equal_pack_mask(h, w, offset):
    buf = _buffer(h, w, offset, seed=h + w)
    mask = buf[offset:offset + h * w].reshape(h, w)
    got, paths = _ballot_pack(buf, offset, h, w)
    np.testing.assert_array_equal(got, np.asarray(pack_mask(jnp.asarray(mask != 0))).view(np.int32))
    assert torch.equal(hk.probe_pack_ballot_plain(torch.from_numpy(mask.copy())),
                       torch.from_numpy(got))
    groups, full = -(-w // 32), w // 32
    rows = min(h, 32 * -(-h // 32))
    assert paths["past h"] == (32 * -(-h // 32) - h) * groups
    if offset % 16 == 0 and w % 16 == 0:
        assert paths["vector"] == rows * full  # every whole task's rows
    if offset % 16 == 1 and w % 16 == 0:
        assert paths["vector"] == 0  # every row's address is off the boundary
    if w == 1918 and offset == 0:
        assert 0 < paths["vector"] < rows * full  # rows alternate between the paths


def test_ballot_pack_tasks_equal_the_jax_probe(hyster_calls):
    _, _, (mask,), (words,) = hyster_calls[1]
    for offset in (0, 1):
        buf = np.zeros(offset + mask.size + 32, np.uint8)
        buf[offset:offset + mask.size] = mask.ravel()
        got, paths = _ballot_pack(buf, offset, *mask.shape)
        np.testing.assert_array_equal(got, words.view(np.int32))
        assert paths["vector" if offset == 0 else "byte"] == mask.shape[0] * mask.shape[1] // 32
