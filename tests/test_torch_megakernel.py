"""The port's main path (cudacam_tpu_torch/ops/cuda/megakernel.py) on CPU
tensors, where every wrapper takes its plain version, against the JAX
package: xla_ops, and the TPU megakernel and its phase-2 continuation in
Pallas interpret mode (as tests/test_megakernel.py runs them), with the
packed state handed across through cudacam_tpu_torch/state.py.

Tolerance: 0. Edge maps, packed words and round counts are integers; the
contract is byte equality, including the planes exported at the phase
boundary.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.io.sources import make_scene
from cudacam_tpu.ops import bitpack as jbp
from cudacam_tpu.ops import xla_ops
from cudacam_tpu.ops.pallas import megakernel as jmk
from cudacam_tpu_torch import state
from cudacam_tpu_torch.ops import bitpack, cuda as kernels, torch_ops
from cudacam_tpu_torch.ops.cuda import megakernel as tmk
from cudacam_tpu_torch.ops.cuda.canny import canny_to_stage, pipeline_kwargs
from cudacam_tpu_torch.ops.cuda.feedforward import ff_pack

torch.set_num_threads(2)

THR = torch.tensor([10, 40], dtype=torch.int32)


def _frame(h, w, seed=5):
    if min(h, w) < 8:
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return make_scene(h, w, seed=seed)


@pytest.mark.parametrize(
    "h,w,scan_after,channels",
    [(80, 256, 12, 3), (80, 256, 1, 3), (37, 53, 1, 3), (1, 1, 1, 3), (37, 53, 2, 1)],
)
def test_pipeline_matches_xla(h, w, scan_after, channels):
    cfg = CannyConfig(height=h, width=w, channels=channels, hysteresis_scan_after=scan_after)
    fr = _frame(h, w)
    if channels == 1:
        fr = fr[..., 0].copy()
    edge, flags = tmk.canny_mega_pipeline(torch.from_numpy(fr), THR, **pipeline_kwargs(cfg))
    want = xla_ops.canny_to_stage(jnp.asarray(fr), jnp.int32(10), jnp.int32(40), cfg, CannyStage.HYSTER)
    np.testing.assert_array_equal(edge.numpy(), np.asarray(want))
    # flags: row 1 is the final exit of the round loop
    thresh = torch_ops.canny_to_stage(torch.from_numpy(fr), THR[0], THR[1], cfg, CannyStage.THRESH)
    f, p = bitpack.pack_pair(thresh)
    _, it, growing = bitpack.converge_packed(
        f, p, h, w, cfg.hysteresis_inner_steps, scan_after, cfg.max_hysteresis_iters)
    assert flags[1].tolist() == [it, int(growing)]


def _jax_mega(fr, scan_after):
    """The TPU megakernel's planar input and its keyword arguments."""
    kw = dict(kernel_size=5, grad_coeff=4, norm="l2", parity="reference",
              dilate_steps=16, scan_after=scan_after, max_iters=100)
    planar = jnp.transpose(jnp.asarray(fr), (2, 0, 1))
    return planar, kw


@pytest.mark.parametrize("scan_after", [12, 1])
def test_phase_boundary_matches_tpu_megakernel(scan_after):
    """canny_mega at a multi-block geometry (bh=32: three slabs, the last
    partial): same flags; when still growing at the boundary, the same
    exported planes (the JAX kernel leaves them unwritten when converged)."""
    h, w = 80, 256
    fr = make_scene(h, w, seed=5)
    planar, kw = _jax_mega(fr, scan_after)
    jedge, jflags, jf, jp = jmk.canny_mega(
        planar, np.int32(10), np.int32(40), interpret=True, block_h=32, **kw)
    f, p, flags = tmk.canny_mega(torch.from_numpy(fr), THR, **kw)
    assert flags[0].tolist() == np.asarray(jflags)[0].tolist()
    if scan_after == 12:
        assert flags[0, 1] == 0  # converged in phase 1: the kernel wrote the edge map
        np.testing.assert_array_equal(tmk.unpack(f, h).numpy(), np.asarray(jedge))
    else:
        assert flags[0, 1] == 1
        want_f, want_p = state.planes_from_jax(np.asarray(jf), np.asarray(jp), h, w)
        assert torch.equal(f, want_f) and torch.equal(p, want_p)


def test_continuation_matches_tpu_pipeline():
    """The escalating frame through the TPU pipeline with the Pallas
    continuation kernel (K2) and through the port's phase 2."""
    h, w = 80, 256
    fr = make_scene(h, w, seed=5)
    planar, kw = _jax_mega(fr, 1)
    want = jmk.canny_mega_pipeline(planar, np.int32(10), np.int32(40), interpret=True,
                                   cont="pallas", **kw)
    edge, flags = tmk.canny_mega_pipeline(torch.from_numpy(fr), THR, **kw)
    assert flags[0, 1] == 1
    np.testing.assert_array_equal(edge.numpy(), np.asarray(want))


def test_phase2_resumes_on_planes_from_jax():
    """Hand the JAX kernel's exported state to the port's phase 2: the
    result equals the JAX package's own loop run to the end."""
    h, w = 80, 256
    t = np.asarray(xla_ops.canny_to_stage(
        jnp.asarray(make_scene(h, w, seed=5)), jnp.int32(10), jnp.int32(40),
        CannyConfig(height=h, width=w), CannyStage.THRESH))
    jf, jp = (np.asarray(x) for x in jbp.pack_pair(jnp.asarray(t)))
    guard_f = np.zeros((4, 384), np.uint32)
    guard_p = np.zeros((4, 384), np.uint32)
    guard_f[:3, :256], guard_p[:3, :256] = jf, jp
    f, p = state.planes_from_jax(guard_f, guard_p, h, w)
    flags = torch.zeros((2, 2), dtype=torch.int32)
    tmk.hyst_phase1(f, p, flags, h, dilate_steps=16, scan_after=1, max_iters=100)
    tmk.hyst_phase2(f, p, flags, h, dilate_steps=16, max_iters=100)
    want = xla_ops.hysteresis(jnp.asarray(t), 100, 16, scan_after=1)
    np.testing.assert_array_equal(tmk.unpack(f, h).numpy(), np.asarray(want))
    np.testing.assert_array_equal(state.planes_to_numpy(p)[0], jp)


def test_state_layout_checks():
    with pytest.raises(ValueError):
        state.planes_from_jax(np.zeros((4, 384), np.int32), np.zeros((4, 384), np.int32), 80, 256)
    with pytest.raises(ValueError):
        state.planes_from_jax(np.zeros((2, 384), np.uint32), np.zeros((2, 384), np.uint32), 80, 256)


def test_static_phase2_skip_copies_flags():
    """scan_after >= max_iters: the cap is phase 1 and phase 2 is not run."""
    h, w = 80, 256
    kw = dict(dilate_steps=16, scan_after=3, max_iters=3)
    edge, flags = tmk.canny_mega_pipeline(torch.from_numpy(make_scene(h, w, seed=2)), THR, **kw)
    assert flags[0].tolist() == flags[1].tolist()
    cfg = CannyConfig(height=h, width=w, hysteresis_scan_after=3, max_hysteresis_iters=3)
    want = torch_ops.canny_to_stage(torch.from_numpy(make_scene(h, w, seed=2)), THR[0], THR[1],
                                    cfg, CannyStage.HYSTER)
    assert torch.equal(edge, want)


def test_cpu_route_launches_no_kernel():
    kernels.reset_launch_counts()
    tmk.canny_mega_pipeline(torch.from_numpy(_frame(37, 53)), THR, scan_after=1)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)


def test_wrappers_reject_other_devices_and_bad_inputs():
    meta = torch.empty((37, 53, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ff_pack(meta, THR)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ff_pack(torch.zeros((37, 53, 3), dtype=torch.uint8), THR.to("meta"))
    with pytest.raises(ValueError):
        ff_pack(torch.zeros((37, 53, 4), dtype=torch.uint8), THR)
    with pytest.raises(ValueError):
        ff_pack(torch.zeros((37, 53, 3), dtype=torch.int32), THR)
    with pytest.raises(ValueError):
        ff_pack(torch.zeros((37, 53, 3), dtype=torch.uint8), THR.to(torch.int64))
    f = torch.zeros((2, 53), dtype=torch.int32)
    flags = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not pack"):
        tmk.hyst_phase1(f, f.clone(), flags, 80)
    with pytest.raises(ValueError, match="flags"):
        tmk.hyst_phase1(f, f.clone(), flags[0], 37)
    with pytest.raises(ValueError):
        tmk.unpack(f, 80)


def test_non_hyster_stage_on_gpu_tensor_not_implemented():
    """Every stage now has a kernel route, so none raises NotImplementedError:
    the dispatch hands each stage to a kernel wrapper, and the wrapper takes
    a route by the tensor's device (a meta tensor has none, and raises
    before touching a kernel); a CPU tensor takes the plain version."""
    cfg = CannyConfig(height=37, width=53)
    meta = torch.empty((37, 53, 3), dtype=torch.uint8, device="meta")
    for stage in CannyStage:
        with pytest.raises(ValueError, match="CPU or all on one CUDA"):
            canny_to_stage(meta, THR.to("meta"), cfg, stage)
    cpu = torch.from_numpy(_frame(37, 53))
    out = canny_to_stage(cpu, THR, cfg, CannyStage.THRESH)
    want = xla_ops.canny_to_stage(jnp.asarray(cpu.numpy()), jnp.int32(10), jnp.int32(40), cfg,
                                  CannyStage.THRESH)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _batch(h, w):
    """Three scenes that converge in phase 1 at scan_after 12 and the spiral
    frame, which is still growing there."""
    from cudacam_tpu.io.sources import make_spiral_frame

    return np.stack([make_scene(h, w, seed=s) for s in range(3)] + [make_spiral_frame(h, w)])


@pytest.mark.parametrize("scan_after", [1, 12])
def test_batched_phase_boundary_matches_tpu_batched_megakernel(scan_after):
    """Batched canny_mega (one launch per kernel for the batch) against the
    TPU batched megakernel at B=2: per-frame flags, and the exported planes
    (word rows padded to 8) of every frame still growing."""
    h, w = 64, 256
    fr = _batch(h, w)[2:]  # a converging scene and the spiral
    planar, kw = _jax_mega(fr[0], scan_after)
    _, jflags, jf, jp = jmk.canny_mega_batched(
        jnp.transpose(jnp.asarray(fr), (0, 3, 1, 2)), np.int32(10), np.int32(40),
        interpret=True, **kw)
    assert np.asarray(jf).shape == (2, 8, 384)
    f, p, flags = tmk.canny_mega_batched(torch.from_numpy(fr), THR, **kw)
    assert flags.shape == (2, 2, 2)
    assert flags[:, 0].tolist() == np.asarray(jflags).tolist()
    want_f, want_p = state.planes_from_jax(np.asarray(jf), np.asarray(jp), h, w)
    assert want_f.shape == f.shape == (2, 2, 256)
    growing = [b for b in range(2) if flags[b, 0, 1] == 1]
    assert growing == ([0, 1] if scan_after == 1 else [1])
    for b in growing:
        assert torch.equal(f[b], want_f[b]) and torch.equal(p[b], want_p[b])


def test_batched_pipeline_mixed_escalation_matches_tpu():
    """Only the spiral frame escalates: the port's batched pipeline equals the
    TPU batched pipeline and the port's single-frame pipeline, frame by frame."""
    h, w = 64, 256
    fr = _batch(h, w)
    kw = dict(kernel_size=5, grad_coeff=4, norm="l2", parity="reference",
              dilate_steps=16, scan_after=12, max_iters=100)
    edges, flags = tmk.canny_mega_pipeline_batched(torch.from_numpy(fr), THR, **kw)
    assert flags[:, 0, 1].tolist() == [0, 0, 0, 1]
    want = jmk.canny_mega_pipeline_batched(
        jnp.transpose(jnp.asarray(fr), (0, 3, 1, 2)), np.int32(10), np.int32(40),
        interpret=True, **kw)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(want))
    for b in range(4):
        e1, f1 = tmk.canny_mega_pipeline(torch.from_numpy(fr[b]), THR, **kw)
        assert torch.equal(edges[b], e1) and torch.equal(flags[b], f1)
    gray = torch.from_numpy(np.ascontiguousarray(fr[..., 1]))
    gedges, gflags = tmk.canny_mega_pipeline_batched(gray, THR, **kw)
    for b in range(4):
        e1, f1 = tmk.canny_mega_pipeline(gray[b], THR, **kw)
        assert torch.equal(gedges[b], e1) and torch.equal(gflags[b], f1)


def test_batched_wrappers_check_shapes():
    f = torch.zeros((3, 2, 53), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"flags must be a \(3, 2, 2\)"):
        tmk.hyst_phase1(f, f.clone(), torch.zeros((2, 2), dtype=torch.int32), 37)
    with pytest.raises(ValueError):
        tmk.ff_pack_batched(torch.zeros((2, 37, 53, 4), dtype=torch.uint8), THR)
    assert tmk.unpack(f, 37).shape == (3, 37, 53)
