"""The column-split continuation (K11): the port's plain version against the
JAX package's ``converge_packed_split`` (its Pallas saturate kernel in
interpret mode) on the same packed planes, and the engine with
``continuation='split'`` against the JAX engine's. Tolerance 0: the planes
are bit masks and the contract is byte equality, outputs cut off by the round
budget included."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig as JaxConfig
from cudacam_tpu.engine import CannyEngine as JaxEngine
from cudacam_tpu.io.sources import make_scene, make_spiral_frame, make_spiral_thresh
from cudacam_tpu.ops.bitpack import pack_pair
from cudacam_tpu.ops.pallas import megakernel as jax_mega
from cudacam_tpu.ops.pallas.hysteresis_fused import converge_packed_split as jax_split
from cudacam_tpu_torch import CannyConfig
from cudacam_tpu_torch.engine import CannyEngine
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda import megakernel
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import (
    converge_packed_split, converge_packed_split_plain,
)
from cudacam_tpu_torch.state import config_from_jax, planes_from_jax, planes_to_jax, planes_to_numpy


def _both(t: np.ndarray, n_split: int, it0: int = 0, **kw):
    """The JAX split and the port's on the same planes: ((F, growing), (F,
    growing, flags))."""
    h, w = t.shape
    f, p = pack_pair(jnp.asarray(t))
    fg, pg = planes_to_jax(*planes_from_jax(np.asarray(f), np.asarray(p), h, w))
    want, growing = jax_split(jnp.asarray(fg), jnp.asarray(pg), h, w, n_split, it0=it0,
                              interpret=True, **kw)
    pf, pp = planes_from_jax(fg, pg, h, w)
    flags = torch.tensor([[it0, 1], [0, 0]], dtype=torch.int32)
    got, g = converge_packed_split(pf, pp, flags, h, n_split, **kw)
    assert got is pf
    return (np.asarray(want), bool(growing)), (planes_to_numpy(pf)[0], bool(g), flags.tolist())


def _check(t, n_split, it0=0, **kw):
    h, w = t.shape
    (want, jgrow), (got, grow, flags) = _both(t, n_split, it0, **kw)
    hw = -(-h // 32)
    np.testing.assert_array_equal(got, want[:hw, :w])
    assert not want[hw:].any() and not want[:, w:].any()  # the guard ring stays zero
    assert grow == jgrow and flags[1][1] == int(jgrow) and flags[0] == [it0, 1]
    return got, grow, flags


@pytest.mark.parametrize("n_split", [2, 4])
def test_converged_equals_jax_and_the_whole_frame_fixed_point(n_split):
    t = make_spiral_thresh(64, 256)
    got, grow, _ = _check(t, n_split, dilate_steps=4, scan_after=2, max_iters=300)
    assert not grow
    f, p = bitpack.pack_pair(torch.from_numpy(t))
    whole, _, still = bitpack.converge_packed(f, p, 64, 256, 4, 2, 3000)
    assert not still  # only converged outputs equal the whole-frame route
    np.testing.assert_array_equal(got, planes_to_numpy(whole)[0])


@pytest.mark.parametrize("n_split,chunk", [(2, 8), (4, 4)])
def test_chunked_converged_equals_jax(n_split, chunk):
    _, grow, flags = _check(make_spiral_thresh(64, 256), n_split, dilate_steps=4, scan_after=2,
                            max_iters=3000, chunk=chunk)
    assert not grow and flags[1][0] > chunk  # several seam rounds were needed


@pytest.mark.parametrize("n_split", [2, 4])
def test_truncated_spiral_is_the_jax_bytes(n_split):
    """max_iters=12, chunk=4 on the 64x512 spiral: cut off by the budget."""
    got, grow, flags = _check(make_spiral_thresh(64, 512), n_split, dilate_steps=4, scan_after=2,
                              max_iters=12, chunk=4)
    assert grow and flags[1] == [12, 1]
    f, p = bitpack.pack_pair(torch.from_numpy(make_spiral_thresh(64, 512)))
    full, _, _ = bitpack.converge_packed(f, p, 64, 512, 4, 2, 3000)
    full = planes_to_numpy(full)[0]
    assert (got & ~full).sum() == 0 and (got != full).any()  # a strict under-approximation


def test_continuation_schedule_resumes_the_budget():
    """``_cont_split``'s call: scan_after 0, chunk 8, the budget resumed at
    the phase-1 count. The last seam round may overshoot the budget, as in
    the JAX package."""
    _, grow, flags = _check(make_spiral_thresh(64, 512), 2, it0=3, dilate_steps=4, scan_after=0,
                            max_iters=20, chunk=8)
    assert grow and flags[1][0] > 20


def test_unchunked_truncated_and_random_field():
    _check(make_spiral_thresh(64, 512), 2, dilate_steps=4, scan_after=2, max_iters=5)
    rng = np.random.default_rng(7)
    t = rng.choice([0, 128, 255], size=(96, 256), p=[0.55, 0.4, 0.05]).astype(np.uint8)
    _, grow, _ = _check(t, 2, dilate_steps=4, scan_after=2, max_iters=200)
    assert not grow


def test_gate_spent_budget_and_bad_arguments():
    t = torch.from_numpy(make_spiral_thresh(64, 128))
    f, p = bitpack.pack_pair(t)
    kw = dict(dilate_steps=4, scan_after=2, max_iters=12, chunk=4)
    flags = torch.tensor([[7, 0], [9, 9]], dtype=torch.int32)  # converged in phase 1
    out, growing = converge_packed_split(f.clone(), p, flags, 64, 2, **kw)
    assert torch.equal(out, f) and flags.tolist() == [[7, 0], [7, 0]] and int(growing) == 0
    flags = torch.tensor([[12, 1], [0, 0]], dtype=torch.int32)  # the budget is spent
    out, growing = converge_packed_split(f.clone(), p, flags, 64, 2, **kw)
    assert torch.equal(out, f) and flags.tolist() == [[12, 1], [12, 1]] and int(growing) == 1
    fresh = lambda: torch.tensor([[0, 1], [0, 0]], dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError):
        converge_packed_split(f.clone(), p, fresh(), 64, 3, **kw)  # 128 % 3
    with pytest.raises(ValueError):
        converge_packed_split(f.clone(), p, fresh(), 64, 2, max_iters=0)
    with pytest.raises(ValueError):
        converge_packed_split(f.clone(), p, fresh(), 64, 2, chunk=0)
    with pytest.raises(ValueError):
        converge_packed_split(f[None], p[None], fresh(), 64, 2)
    # narrow slices: the halo is the slice's own width
    a, b = f.clone(), f.clone()
    fa, fb = fresh(), fresh()
    converge_packed_split(a, p, fa, 64, 4, **kw)
    converge_packed_split_plain(b, p, fb, 64, 4, **kw)
    assert torch.equal(a, b) and fa.tolist() == fb.tolist()


def _jax_split_count(h: int, w: int) -> int:
    """``n_split`` as the JAX package's ``_cont_split`` picks it."""
    hwp = jax_mega._mega_geometry(h, w)[2] if jax_mega.mega_ok(h, w) else -(-h // 32) + 1
    n = 2
    while w % n == 0 and hwp * (w // n + 256) * 4 > jax_mega._SPLIT_SLICE_BUDGET:
        n *= 2
    return n


def test_split_count_always_divides_the_width(monkeypatch):
    def count(h, w, limit=megakernel.SPLIT_SLICE_BYTES):
        monkeypatch.setattr(megakernel, "SPLIT_SLICE_BYTES", limit)
        return megakernel.split_count(h, w)

    # The sizes the JAX package splits: the same count.
    assert count(4320, 7680) == _jax_split_count(4320, 7680) == 2
    assert count(2160, 3840) == 2 and count(64, 256) == 2
    # Widths where the JAX loop doubles once too often: twice an odd number,
    # past its slice budget. The port's count still divides the width.
    for w in (9998, 10002, 7686 * 2 - 2):
        assert w % 4 and w % _jax_split_count(4320, w), w
        for limit in (megakernel.SPLIT_SLICE_BYTES, 1_000_000, 1):
            n = count(4320, w, limit)
            assert n == 2 and w % n == 0
    # A tight limit doubles only while the doubled count divides the width.
    assert count(4320, 7680, 1) == 512  # 7680 = 512 * 15
    assert count(4320, 7680 * 3, 30_000_000) == 4
    for w in range(2, 400, 2):
        n = count(100, w, 1)
        assert n >= 2 and w % n == 0 and w % (2 * n) != 0


@pytest.mark.parametrize("cap,truncated", [(12, True), (300, False)])
def test_engine_split_equals_the_jax_engine(cap, truncated):
    h, w = 64, 256
    jcfg = JaxConfig(height=h, width=w, backend="pallas", interpret=True, continuation="split",
                     hysteresis_scan_after=2, hysteresis_inner_steps=4, max_hysteresis_iters=cap)
    cfg = config_from_jax(jcfg)
    assert cfg.continuation == "split"
    frame = make_spiral_frame(h, w)
    want = np.asarray(JaxEngine(jcfg).process(frame))
    got = CannyEngine(cfg, device="cpu").process(frame).numpy()
    np.testing.assert_array_equal(got, want)
    import dataclasses

    base = CannyEngine(dataclasses.replace(cfg, continuation="auto"), device="cpu").process(frame)
    assert (not np.array_equal(got, base.numpy())) == truncated  # docs/parity.md carve-out


@pytest.mark.parametrize("shape", [(64, 256), (37, 54), (37, 53)])
def test_engine_split_on_scenes_batches_and_odd_widths(shape):
    """Converged frames: 'split' equals the default engine, single and
    batched; an odd width has no column split and takes the kernel."""
    h, w = shape
    kw = dict(height=h, width=w, hysteresis_scan_after=1, hysteresis_inner_steps=2)
    split = CannyEngine(CannyConfig(continuation="split", **kw), device="cpu")
    base = CannyEngine(CannyConfig(continuation="kernel", **kw), device="cpu")
    frames = np.stack([make_scene(h, w, seed=s) for s in range(3)])
    out = split.process(frames)
    assert torch.equal(out, base.process(frames))
    for b in range(3):
        assert torch.equal(out[b], split.process(frames[b]))
    assert int((out == 255).sum()) > 0


def test_config_continuation_values():
    for value in ("auto", "kernel", "split"):
        assert CannyConfig(height=8, width=8, continuation=value).continuation == value
    with pytest.raises(ValueError):
        CannyConfig(height=8, width=8, continuation="pallas")
    for jvalue, value in (("auto", "auto"), ("pallas", "auto"), ("xla", "auto"),
                          ("split", "split")):
        assert config_from_jax(JaxConfig(height=8, width=8, continuation=jvalue)
                               ).continuation == value
    from cudacam_tpu_torch.ops.cuda.megakernel import canny_mega_pipeline

    with pytest.raises(ValueError):
        canny_mega_pipeline(torch.zeros((8, 8), dtype=torch.uint8),
                            torch.tensor([10, 40], dtype=torch.int32), continuation="xla")
