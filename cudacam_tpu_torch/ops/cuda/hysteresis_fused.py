"""Hysteresis of a threshold map (the two-kernel path's second half) and of
many threshold pairs at once (the threshold sweep).

Port of the TPU fused hysteresis kernel (cudacam_tpu/ops/pallas/
hysteresis_fused.py:365/:373 ``pallas_call``: ``_fused_call`` :310 ->
``_kernel`` :168; entries ``hysteresis_fused`` :386 and
``hysteresis_fused_nmsq`` :435). The one TPU launch (pack, both phases,
unpack) becomes ``pack_thresh`` (``csrc/pack.cu``: a column walk, the one
``sweep_pack_all`` runs, ``csrc/pack_walk.cuh``) followed by the round
kernels and the unpack of ``ops/cuda/megakernel.py``, all on the device with
no readback. It serves ``process_all``'s edge map; the nmsq mode takes the
int32 ``keep * g`` plane and two bounds instead of a u8 map.
``hysteresis_fused_batched`` (the JAX entry :983, which stacks g maps as
sections of one tall map for one launch) is the same kernels over a batch:
``pack_thresh`` takes a (g, H, W) stack in one launch, and the round
kernels and the unpack take batches already: 4 launches for any g.

Port of the TPU sweep kernel (hysteresis_fused.py:729 ``pallas_call`` in
``sweep_fused`` :644 -> ``_sweep_kernel`` :478): its one launch over a
resident ``keep * g`` plane becomes ``sweep_pack_all`` (``csrc/sweep.cu``:
every sorted pair's planes from one read of the plane), then per pair in
sorted order ``sweep_seed`` (the monotone warm start) and the two round
kernels, then one unpack that writes each map at its original index. Pairs,
round counts and seeds stay on the device.

Port of the TPU saturate kernel (hysteresis_fused.py:844 ``pallas_call`` in
``saturate_packed`` :812 -> ``_sat_kernel`` :742), the local operator of the
sharded round loop: both phases on the carried packed planes of a batch of
extended tiles, the round count starting at 0 on each call, as the two round
kernels (on a one-card mesh the same round code runs inside the round loop
kernel, ``parallel/packed_halo.py::sharded_loop``).

Port of the column-split convergence (hysteresis_fused.py:876
``converge_packed_split``, no ``pallas_call`` of its own: one
``saturate_packed`` launch per column slice per seam round, XLA pad / slice /
concatenate between, in a traced loop): :func:`converge_packed_split` runs
the same seam schedule as one cooperative launch (``split_kernel`` in
``csrc/hyst_rounds.cu``), the loop on the device, and
:func:`converge_packed_split_batched` runs the seam loops of a batch of
frames in that one launch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from cudacam_tpu_torch.stages import FINAL_EDGE
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda._build import (
    count_launch, load, require_contiguous, stream_of, use_plain,
)
from cudacam_tpu_torch.ops.cuda.megakernel import (
    _check_planes, _check_steps, _launch_rounds, converge, converge_unpack, hyst_phase1_plain,
    hyst_phase2_plain, unpack, unpack_plain,
)

#: Seam halo of a column slice, in columns: the neighbour state a seam round
#: carries across each seam.
SPLIT_HALO = 64


def _check(src: torch.Tensor, bounds: Optional[torch.Tensor]) -> None:
    dtype = torch.uint8 if bounds is None else torch.int32
    if src.dtype != dtype or src.ndim != 2 or src.numel() == 0:
        what = "a (H, W) uint8 threshold map" if bounds is None else "a (H, W) int32 keep*g plane"
        raise ValueError(f"expected {what}, got {tuple(src.shape)} {src.dtype}")
    if bounds is not None and (bounds.dtype != torch.int32 or tuple(bounds.shape) != (2,)):
        raise ValueError("bounds must be an int32 tensor [lo, hi]")


def _check_batch(threshs: torch.Tensor) -> None:
    if threshs.dtype != torch.uint8 or threshs.ndim != 3 or threshs.numel() == 0:
        raise ValueError(f"expected a (g, H, W) uint8 stack of threshold maps, got "
                         f"{tuple(threshs.shape)} {threshs.dtype}")


def pack_thresh_plain(
    src: torch.Tensor, bounds: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pack_thresh`, on any device."""
    if src.ndim == 3:
        planes = [pack_thresh_plain(t, bounds) for t in src]
        return torch.stack([f for f, _ in planes]), torch.stack([p for _, p in planes])
    if bounds is None:
        return bitpack.pack_pair(src)
    lo, hi = bounds.clamp_min(0)
    final = src > hi
    cand = (src > lo) & ~final
    return (bitpack.from_words(bitpack.pack_mask(final)),
            bitpack.from_words(bitpack.pack_mask(cand)))


def pack_thresh(
    src: torch.Tensor, bounds: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed FINAL and CANDIDATE planes, (ceil(H/32), W) int32, of an
    (H, W) uint8 threshold map (FINAL == 255, CANDIDATE == 128); or, with
    int32 ``bounds`` [lo, hi] clamped at 0, of an (H, W) int32 ``keep * g``
    plane (FINAL: kg > hi; CANDIDATE: lo < kg <= hi). A (g, H, W) uint8
    stack of maps gives (g, ceil(H/32), W) planes from one launch."""
    if bounds is None and src.ndim == 3:
        _check_batch(src)
    else:
        _check(src, bounds)
    if use_plain(src, bounds):
        return pack_thresh_plain(src, bounds)
    require_contiguous(src, *([bounds] if bounds is not None else []))
    n = src.shape[0] if src.ndim == 3 else 1
    h, w = src.shape[-2:]
    f = torch.empty(tuple(src.shape[:-2]) + ((h + 31) // 32, w), dtype=torch.int32,
                    device=src.device)
    p = torch.empty_like(f)
    lib = load()
    lib.check(
        lib.lib.cc_pack_thresh(
            src.data_ptr(), bounds.data_ptr() if bounds is not None else None,
            f.data_ptr(), p.data_ptr(), n, h, w, int(bounds is not None), src.device.index,
            stream_of(src),
        ),
        "pack_thresh",
    )
    count_launch("pack_thresh")
    return f, p


def _hysteresis(src, bounds, max_iters, dilate_steps, scan_after):
    f, p = pack_thresh(src, bounds)
    flags = torch.empty((2, 2), dtype=torch.int32, device=src.device)
    out = converge_unpack(f, p, flags, src.shape[0], dilate_steps=dilate_steps,
                          scan_after=scan_after, max_iters=max_iters)
    return out, flags


def hysteresis_fused(
    thresh: torch.Tensor,
    max_iters: int = 100,
    remove_candidates: bool = True,
    return_iters: bool = False,
    dilate_steps: int = 16,
    scan_after: int = 10,
):
    """Hysteresis of an (H, W) uint8 threshold map, with the JAX entry's
    arguments: the edge map (255 / 0), bit-identical to
    ``bitpack.hysteresis_packed`` including under the cap. With
    ``remove_candidates=False`` the candidates that were not promoted keep
    their 128; with ``return_iters`` the round count comes too, as a 0-d
    int32 tensor on the map's device (never read back here)."""
    _check(thresh, None)
    out, flags = _hysteresis(thresh, None, max_iters, dilate_steps, scan_after)
    if not remove_candidates:
        out = torch.where(out == FINAL_EDGE, out, thresh)
    if return_iters:
        return out, flags[1, 0]
    return out


def hysteresis_fused_nmsq(
    kg: torch.Tensor,
    lo_cmp,
    hi_cmp,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
) -> torch.Tensor:
    """Threshold + hysteresis straight from the int32 ``keep * g`` plane
    (``ff_stages``' NMSQ output): FINAL is ``kg > hi_cmp``, CANDIDATE is
    ``lo_cmp < kg <= hi_cmp``, the bounds in the comparable domain and
    clamped at 0. Equals :func:`hysteresis_fused` of the equivalent u8 map."""
    bounds = torch.stack([torch.as_tensor(lo_cmp), torch.as_tensor(hi_cmp)]).to(
        device=kg.device, dtype=torch.int32)
    out, _ = _hysteresis(kg, bounds, max_iters, dilate_steps, scan_after)
    return out


def hysteresis_fused_batched_plain(
    threshs: torch.Tensor,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`hysteresis_fused_batched`, on any
    device: ``bitpack``'s pack, round loop and unpack, map by map."""
    _check_batch(threshs)
    h, w = threshs.shape[1:]
    out = torch.empty_like(threshs)
    for i, t in enumerate(threshs):
        f, p = bitpack.pack_pair(t)
        fc, _, _ = bitpack.converge_packed(f, p, h, w, dilate_steps, scan_after, max_iters)
        out[i] = unpack_plain(fc, h)
    return out


def hysteresis_fused_batched(
    threshs: torch.Tensor,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
) -> torch.Tensor:
    """Hysteresis of g independent (H, W) uint8 threshold maps, a (g, H, W)
    stack -> (g, H, W) edge maps (255 / 0), each equal byte for byte to its
    solo :func:`hysteresis_fused` call, under the cap too: the JAX
    package's ``hysteresis_fused_batched`` (hysteresis_fused.py:983).

    The JAX entry stacks the maps as sections of one tall map with zero
    spacer rows, so that one launch serves them all. Here each map is a
    frame of the batched kernels, which keep a round count and a stop test
    per frame: ``pack_thresh`` over the stack, the two round kernels, one
    ``unpack``: 4 launches for any g (3 where the cap is phase 1), no host
    sync. A map that converges early stops there while another runs on to
    the cap. u8 maps only, as the JAX entry takes."""
    _check_batch(threshs)
    f, p = pack_thresh(threshs)
    flags = torch.empty((threshs.shape[0], 2, 2), dtype=torch.int32, device=threshs.device)
    return converge_unpack(f, p, flags, threshs.shape[1], dilate_steps=dilate_steps,
                           scan_after=scan_after, max_iters=max_iters)


def _check_bounds(bounds: torch.Tensor) -> int:
    """Validates a sweep's (2K,) bounds; returns K."""
    if bounds.dtype != torch.int32 or bounds.ndim != 1 or bounds.numel() % 2:
        raise ValueError("bounds must be a (2K,) int32 tensor [lo_0, hi_0, lo_1, hi_1, ...]")
    return bounds.numel() // 2


def _check_sweep(kg: torch.Tensor, bounds: torch.Tensor) -> int:
    """Validates a sweep's kg plane and (2K,) bounds; returns K."""
    if kg.dtype != torch.int32 or kg.ndim != 2 or kg.numel() == 0:
        raise ValueError(f"expected a (H, W) int32 keep*g plane, got {tuple(kg.shape)} {kg.dtype}")
    return _check_bounds(bounds)


def sweep_order(bounds: torch.Tensor) -> torch.Tensor:
    """(K,) int32 permutation that orders the pairs of (2K,) ``bounds``,
    clamped at 0, by low descending, then high descending; exact duplicates
    keep ascending original index (``jnp.lexsort((-hi, -lo))`` as the JAX
    package orders them). A stable sort on the device, no readback."""
    pairs = bounds.clamp_min(0).view(-1, 2).to(torch.int64)
    key = (pairs[:, 0] << 31) | pairs[:, 1]  # both < 2^31 after the clamp
    return torch.sort(-key, stable=True).indices.to(torch.int32)


def _sweep_check_planes(kg: torch.Tensor, f: torch.Tensor, p: torch.Tensor, k: int) -> None:
    h, w = kg.shape
    want = (k, -(-h // 32), w)
    if f.dtype != torch.int32 or p.dtype != torch.int32 or f.shape != want or p.shape != want:
        raise ValueError(f"planes must be {want} int32 tensors, got {tuple(f.shape)}/{tuple(p.shape)}")


def sweep_pack_all_plain(kg: torch.Tensor, bounds: torch.Tensor, f: torch.Tensor,
                         p: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`sweep_pack_all`, on any device."""
    for s in range(bounds.numel() // 2):
        f[s], p[s] = pack_thresh_plain(kg, bounds[2 * s: 2 * s + 2])


def sweep_pack_all(kg: torch.Tensor, bounds: torch.Tensor, f: torch.Tensor,
                   p: torch.Tensor) -> None:
    """Packs every slot of a sweep in place, from one read of ``kg``: slot
    s's FINAL (kg > hi) and CANDIDATE (lo < kg <= hi) words into ``f[s]``
    and ``p[s]`` of the (K, ceil(H/32), W) int32 planes, for the pair
    ``bounds[2 s : 2 s + 2]`` clamped at 0. No seed: see :func:`sweep_seed`."""
    k = _check_sweep(kg, bounds)
    _sweep_check_planes(kg, f, p, k)
    if use_plain(kg, bounds, f, p):
        return sweep_pack_all_plain(kg, bounds, f, p)
    require_contiguous(kg, bounds, f, p)
    h, w = kg.shape
    lib = load()
    lib.check(
        lib.lib.cc_sweep_pack_all(kg.data_ptr(), bounds.data_ptr(), f.data_ptr(), p.data_ptr(), k,
                                  h, w, kg.device.index, stream_of(kg)),
        "sweep_pack_all",
    )
    count_launch("sweep_pack_all")


def _check_seed(bounds: torch.Tensor, slot: int, f: torch.Tensor) -> None:
    k = _check_bounds(bounds)
    if f.dtype != torch.int32 or f.ndim != 3 or f.shape[0] != k:
        raise ValueError(f"planes must be a ({k}, hw, w) int32 tensor, got {tuple(f.shape)}")
    if not 1 <= slot < k:
        raise ValueError(f"slot {slot} is not in [1, {k})")


def sweep_seed_plain(bounds: torch.Tensor, slot: int, f: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`sweep_seed`, on any device."""
    lo, hi = bounds[2 * slot: 2 * slot + 2].clamp_min(0)
    plo, phi = bounds[2 * slot - 2: 2 * slot].clamp_min(0)
    f[slot] = torch.where((plo >= lo) & (phi >= hi), f[slot] | f[slot - 1], f[slot])


def sweep_seed(bounds: torch.Tensor, slot: int, f: torch.Tensor) -> None:
    """The monotone warm start of slot ``slot`` >= 1, in place: when slot -
    1's pair dominates slot ``slot``'s (both bounds, clamped at 0, >=;
    decided on the device), ``f[slot]`` is ORed with ``f[slot - 1]`` as it
    stands; else nothing changes."""
    _check_seed(bounds, slot, f)
    if use_plain(bounds, f):
        return sweep_seed_plain(bounds, slot, f)
    require_contiguous(bounds, f)
    lib = load()
    lib.check(
        lib.lib.cc_sweep_seed(bounds.data_ptr(), f.data_ptr(), slot, f.shape[1], f.shape[2],
                              f.device.index, stream_of(f)),
        "sweep_seed",
    )
    count_launch("sweep_seed")


def sweep_fused_plain(
    kg: torch.Tensor,
    bounds: torch.Tensor,
    *,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
    monotone_seed: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sweep_fused`, on any device: pack,
    both phases and unpack of ``ops/bitpack.py`` per pair, in the sorted
    order with the same seeds. Reads the pairs back to the host."""
    k = _check_sweep(kg, bounds)
    h, w = kg.shape
    pairs = bounds.clamp_min(0).view(k, 2).tolist()
    order = sweep_order(bounds).tolist() if monotone_seed else range(k)
    out = torch.empty((k, h, w), dtype=torch.uint8, device=kg.device)
    prev = None  # (lo, hi, converged words) of the previous slot
    for i in order:
        lo, hi = pairs[i]
        fw, pw = pack_thresh_plain(kg, bounds[2 * i: 2 * i + 2])
        if monotone_seed and prev is not None and prev[0] >= lo and prev[1] >= hi:
            fw = fw | prev[2]
        fc, _, _ = bitpack.converge_packed(fw, pw, h, w, dilate_steps, scan_after, max_iters)
        out[i] = unpack_plain(fc, h)
        prev = (lo, hi, fc)
    return out


def _sweep_launches(kg, bounds, k, max_iters, dilate_steps, scan_after, monotone_seed):
    """The kernels' sequence: ``sweep_pack_all`` (every sorted slot's
    planes from one read of ``kg``), then per sorted slot ``sweep_seed``
    (from the second slot on, with ``monotone_seed``) and both phases on the
    slot's planes, in stream order (a slot's seed is the previous slot's
    plane after its last round); then one unpack to the original indices.
    On CPU tensors every step takes its plain version."""
    h, w = kg.shape
    order = sweep_order(bounds) if monotone_seed else None
    sorted_b = bounds.view(k, 2)[order.long()].reshape(-1) if monotone_seed else bounds
    f = torch.empty((k, -(-h // 32), w), dtype=torch.int32, device=kg.device)
    p = torch.empty_like(f)
    flags = torch.empty((k, 2, 2), dtype=torch.int32, device=kg.device)
    sweep_pack_all(kg, sorted_b, f, p)
    for i in range(k):
        if monotone_seed and i:
            sweep_seed(sorted_b, i, f)
        converge(f[i], p[i], flags[i], h, dilate_steps=dilate_steps, scan_after=scan_after,
                 max_iters=max_iters)
    return unpack(f, h, order)


def sweep_fused(
    kg: torch.Tensor,
    bounds: torch.Tensor,
    *,
    max_iters: int = 100,
    dilate_steps: int = 16,
    scan_after: int = 10,
    monotone_seed: bool = True,
) -> torch.Tensor:
    """K threshold pairs over one (H, W) int32 ``keep * g`` plane -> (K, H, W)
    uint8 edge maps, equal byte for byte to the JAX package's ``sweep_fused``
    with the same ``monotone_seed``. ``bounds`` is (2K,) int32 [lo_0, hi_0,
    lo_1, hi_1, ...] in the comparable domain, clamped at 0 here.

    With ``monotone_seed`` the pairs run in :func:`sweep_order` and each
    starts from the previous pair's plane when that pair dominates it.
    Converged maps equal the cold starts; maps cut off by ``max_iters`` do
    not, and equal the JAX package's seeded ones. Without it every pair
    starts cold, in the given order. No host sync on the kernel route."""
    k = _check_sweep(kg, bounds)
    kw = dict(max_iters=max_iters, dilate_steps=dilate_steps, scan_after=scan_after,
              monotone_seed=monotone_seed)
    if k == 0:
        return torch.empty((0,) + tuple(kg.shape), dtype=torch.uint8, device=kg.device)
    if use_plain(kg, bounds):
        return sweep_fused_plain(kg, bounds, **kw)
    return _sweep_launches(kg, bounds, k, **kw)


def saturate_packed_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`saturate_packed`, on any device:
    ``bitpack``'s two phases tile by tile. Counts no rounds, as the kernels'
    local saturate does not."""
    hyst_phase1_plain(f, p, flags, h, dilate_steps=dilate_steps, scan_after=scan_after,
                      max_iters=max_iters, count=False)
    if scan_after < max_iters:
        hyst_phase2_plain(f, p, flags, h, dilate_steps=dilate_steps, max_iters=max_iters,
                          count=False)
    else:
        flags[:, 1] = flags[:, 0]
    return f, flags[:, 1, 1]


def saturate_packed(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local saturation of (T, ceil(h/32), w) extended-tile planes, in
    place, the round count starting at 0: phase 1, then phase 2 on the
    tiles still growing. Returns ``(f, growing)``, ``growing`` the (T,)
    int32 view ``flags[:, 1, 1]``: the cap stopped a state that was still
    changing. Two launches on CUDA tensors (the round kernels, counted as
    ``saturate_phase1`` and ``saturate_phase2``), the plain ``bitpack``
    loops on CPU tensors."""
    if f.ndim != 3:
        raise ValueError("saturate_packed takes (T, hw, w) planes")
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters)
    _check_planes(f, p, h, flags)
    if use_plain(f, p, flags):
        return saturate_packed_plain(f, p, flags, h, **kw)
    _check_steps(dilate_steps)
    _launch_rounds(1, f, p, flags, h, dilate_steps, scan_after, max_iters, name="saturate_phase1")
    if scan_after < max_iters:
        _launch_rounds(2, f, p, flags, h, dilate_steps, max_iters, name="saturate_phase2")
    else:
        flags[:, 1] = flags[:, 0]
    return f, flags[:, 1, 1]


def _split_geometry(w: int, n_split: int) -> Tuple[int, int]:
    """(owned columns, halo columns) of a slice."""
    if n_split < 1 or w % n_split:
        raise ValueError(f"width {w} is not divisible by n_split {n_split}")
    ws = w // n_split
    return ws, min(SPLIT_HALO, ws)


def _split_check(f, p, flags, h, max_iters, chunk, ndim: int = 2) -> None:
    _check_planes(f, p, h, flags)
    if f.ndim != ndim:
        raise ValueError("converge_packed_split takes the (hw, w) planes of one frame"
                         if ndim == 2 else
                         "converge_packed_split_batched takes (B, hw, w) planes")
    if max_iters < 1 or (chunk is not None and chunk < 1):
        raise ValueError("max_iters and chunk must be >= 1")


def converge_packed_split_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    n_split: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`converge_packed_split`, on any
    device: the same seam schedule with ``bitpack.converge_packed`` on each
    slice. Reads the flags and every stop test back to the host."""
    _split_check(f, p, flags, h, max_iters, chunk)
    w = f.shape[1]
    ws, k = _split_geometry(w, n_split)
    it, growing = (int(v) for v in flags[0])
    if not growing:
        flags[1] = flags[0]
        return f, flags[1, 1]
    pad = torch.nn.functional.pad

    def extract(x: torch.Tensor, i: int) -> torch.Tensor:
        lo, hi = i * ws - k, (i + 1) * ws + k
        return pad(x[:, max(0, lo):min(hi, w)], (max(0, -lo), hi - min(hi, w)))

    p_slices = [extract(p, i) for i in range(n_split)]
    inner_cap = chunk if chunk is not None else max_iters
    changed = True
    while changed and it < max_iters:
        owned, spent = [], 0
        for i in range(n_split):
            sf, si, _ = bitpack.converge_packed(extract(f, i), p_slices[i], h, k + ws + k,
                                                dilate_steps, scan_after, inner_cap)
            spent = max(spent, si)
            owned.append(sf[:, k:k + ws])
        nf = torch.cat(owned, dim=1)
        changed = bool((nf != f).any())
        f.copy_(nf)
        it += spent if chunk is not None else 1
    flags[1, 0], flags[1, 1] = it, int(changed)
    return f, flags[1, 1]


def converge_packed_split(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    n_split: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Converge the (ceil(h/32), w) packed planes of one frame by
    ``n_split`` column slices with seam-halo rounds, in place: the JAX
    package's ``converge_packed_split`` on the same planes, byte for byte,
    outputs cut off by the budget included.

    ``flags`` is the frame's (2, 2) int32 tensor: row 0 = (round count to
    resume the budget at, still growing) is read on the device, and nothing
    runs when it says converged; row 1 = the final (round count, still
    changing) is written. Each seam round extracts slice i = columns
    [i ws - k, (i + 1) ws + k) of F and P (ws = w / n_split, k = min(64,
    ws), zero outside the frame), runs the saturate schedule on each from
    the same round-start state (one unconditional dilation round, dilation
    rounds below ``scan_after``, then dilations + scans, while the slice
    changes and below ``chunk`` rounds; schedule extents (h, k + ws + k)),
    writes back the owned ws columns, and adds the most rounds any slice took
    to the round count; it loops while the plane changed and the count is
    below ``max_iters``. Without ``chunk`` a slice runs up to ``max_iters``
    rounds and a seam round counts 1.

    Returns ``(f, growing)``, ``growing`` the 0-d int32 view ``flags[1, 1]``.
    One cooperative launch on CUDA tensors whatever the budget, no host
    sync: :func:`converge_packed_split_batched`'s with B = 1. Converged
    outputs equal every other route's; outputs cut off by the budget are
    this multi-slice executor's own."""
    _split_check(f, p, flags, h, max_iters, chunk)
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters, chunk=chunk)
    if use_plain(f, p, flags):
        return converge_packed_split_plain(f, p, flags, h, n_split, **kw)
    _split_launch(f[None], p[None], flags[None], h, n_split, **kw)
    return f, flags[1, 1]


def converge_packed_split_batched_plain(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    n_split: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`converge_packed_split_batched`, on any
    device: :func:`converge_packed_split_plain` frame by frame."""
    _split_check(f, p, flags, h, max_iters, chunk, ndim=3)
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters, chunk=chunk)
    for fb, pb, flb in zip(f, p, flags):
        converge_packed_split_plain(fb, pb, flb, h, n_split, **kw)
    return f, flags[:, 1, 1]


def converge_packed_split_batched(
    f: torch.Tensor,
    p: torch.Tensor,
    flags: torch.Tensor,
    h: int,
    n_split: int,
    *,
    dilate_steps: int = 16,
    scan_after: int = 10,
    max_iters: int = 100,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`converge_packed_split` on each frame of (B, ceil(h/32), w)
    planes with (B, 2, 2) flags, in place: frame by frame the bytes of a
    call on that frame alone, outputs cut off by the budget included. A
    frame whose flags say converged, or whose budget is spent, takes no
    round and gets row 1 = (its round count, its growing flag).

    Returns ``(f, growing)``, ``growing`` the (B,) int32 view
    ``flags[:, 1, 1]``. One cooperative launch on CUDA tensors (counted as
    ``split_converge``) whatever B and the budget, no host sync: the seam
    loops of the frames still growing advance together, their slices'
    bands resident in shared memory for the whole launch where one frame's
    layout holds them (``megakernel.split_layout``)."""
    kw = dict(dilate_steps=dilate_steps, scan_after=scan_after, max_iters=max_iters, chunk=chunk)
    _split_check(f, p, flags, h, max_iters, chunk, ndim=3)
    if use_plain(f, p, flags):
        return converge_packed_split_batched_plain(f, p, flags, h, n_split, **kw)
    _split_launch(f, p, flags, h, n_split, **kw)
    return f, flags[:, 1, 1]


def _split_launch(f, p, flags, h: int, n_split: int, *, dilate_steps: int, scan_after: int,
                  max_iters: int, chunk: Optional[int]) -> None:
    """One ``split_kernel`` launch on (B, hw, w) CUDA planes."""
    _check_steps(dilate_steps)
    require_contiguous(f, p, flags)
    nf, w = f.shape[0], f.shape[-1]
    _split_geometry(w, n_split)
    lib = load()
    words = lib.lib.cc_split_scratch_words(nf, h, w, n_split, dilate_steps, f.device.index)
    if words < 0:
        lib.check(-words, "split_converge")
    # Stream-ordered: the scratch is reusable once the kernel ran.
    scratch = torch.empty(words, dtype=torch.int32, device=f.device)
    lib.check(
        lib.lib.cc_split_converge(f.data_ptr(), p.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
                                  nf, h, w, n_split, dilate_steps, scan_after, max_iters,
                                  chunk if chunk is not None else 0, f.device.index, stream_of(f)),
        "split_converge",
    )
    count_launch("split_converge")
