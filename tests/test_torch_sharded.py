"""The port's tile-sharded pipeline (``cudacam_tpu_torch/parallel/sharded.py``)
against the JAX package's ``build_sharded_pipeline`` and the NumPy oracle,
on the CPU: the port's plain route on a one-card (local) mesh, the JAX
package's on the 8 virtual CPU devices.

Mirrors every class of ``tests/test_sharded.py`` (tolerance 0: every output
is a uint8 stage buffer), and holds the plain versions of the export
megakernel (K8), the packed saturate (K9) and the core unpack (K10) against
``canny_mega_export``, ``saturate_packed`` and ``unpack_core_call`` in
interpret mode on granule-aligned extended tiles, where the port's plane
layout and the JAX package's coincide. The whole pipeline cut off by a low
round cap equals ``backend='pallas'`` there too: both run the export's
schedule (a pre-populated extension and phase 1 before the collective
rounds), which ``backend='xla'`` does not.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.io.sources import make_scene, make_spiral_frame
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.ops.pallas.hysteresis_fused import saturate_packed as jax_saturate
from cudacam_tpu.ops.pallas.megakernel import canny_mega_export, unpack_core_call
from cudacam_tpu.parallel import build_sharded_pipeline as jax_pipeline
from cudacam_tpu.parallel import make_mesh as jax_mesh
from cudacam_tpu_torch.ops import bitpack
from cudacam_tpu_torch.ops.cuda.canny import hyster_kwargs, pipeline_kwargs
from cudacam_tpu_torch.ops.cuda.hysteresis_fused import saturate_packed
from cudacam_tpu_torch.ops.cuda.megakernel import mega_export, unpack_core
from cudacam_tpu_torch.parallel import build_sharded_pipeline, make_mesh, shard_frame
from cudacam_tpu_torch.state import config_from_jax
from cudacam_tpu_torch.stages import CannyStage as PortStage

from conftest import make_bgr_frame, make_noise_frame

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _expected(frames, low=10, high=40, **kw):
    return np.stack([oracle.canny_pipeline(f, low=low, high=high, **kw)["hyster"] for f in frames])


def _port(cfg, mesh, frames, low=10, high=40, stage=CannyStage.HYSTER, **kw):
    """The port's plain route on a (batch, rows, cols) local mesh."""
    run = build_sharded_pipeline(config_from_jax(cfg), make_mesh(*mesh), PortStage(int(stage)),
                                 **kw)
    out = run(shard_frame(torch.from_numpy(np.asarray(frames)), run.mesh),
              torch.tensor([low, high], dtype=torch.int32))
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


def _jax(cfg, mesh, frames, low=10, high=40, stage=CannyStage.HYSTER, **kw):
    b, r, c = mesh
    run = jax_pipeline(cfg, jax_mesh(batch=b, rows=r, cols=c, devices=jax.devices()[:b * r * c]),
                       final_stage=stage, **kw)
    return np.asarray(run(jnp.asarray(frames), jnp.int32(low), jnp.int32(high)))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(99)
    return np.stack(
        [make_bgr_frame(rng, 64, 96), make_noise_frame(rng, 64, 96), 255 - make_bgr_frame(rng, 64, 96)]
    )[:2]


class TestRowSharded:
    def test_rows8(self, frames):
        cfg = CannyConfig(height=64, width=96)
        out = _port(cfg, (1, 8, 1), frames)
        np.testing.assert_array_equal(out, _expected(frames))
        np.testing.assert_array_equal(out, _jax(cfg, (1, 8, 1), frames))

    @pytest.mark.parametrize("stage,key", [
        (CannyStage.MONO, "mono"), (CannyStage.GAUSSIAN, "gaussian"), (CannyStage.NMS, "nms"),
        (CannyStage.THRESH, "thresh"), (CannyStage.GRADIENT, "gradient_display"),
    ])
    def test_partial_stage(self, frames, stage, key):
        cfg = CannyConfig(height=64, width=96)
        out = _port(cfg, (1, 8, 1), frames, stage=stage)
        exp = np.stack([oracle.canny_pipeline(f)[key] for f in frames])
        np.testing.assert_array_equal(out, exp, err_msg=f"stage {stage}")
        if stage != CannyStage.MONO:
            np.testing.assert_array_equal(out, _jax(cfg, (1, 8, 1), frames, stage=stage))

    def test_partial_stage_on_a_grid(self, frames):
        cfg = CannyConfig(height=64, width=96, kernel_size=7)
        for stage, key in [(CannyStage.NMS, "nms"), (CannyStage.THRESH, "thresh")]:
            out = _port(cfg, (2, 2, 2), frames, stage=stage)
            exp = np.stack([oracle.canny_pipeline(f, kernel_size=7)[key] for f in frames])
            np.testing.assert_array_equal(out, exp, err_msg=f"stage {stage}")


class TestGridSharded:
    def test_2d_tiles(self, frames):
        cfg = CannyConfig(height=64, width=96)
        out = _port(cfg, (1, 2, 4), frames)
        np.testing.assert_array_equal(out, _expected(frames))
        np.testing.assert_array_equal(out, _jax(cfg, (1, 2, 4), frames))

    def test_batch_and_grid(self, frames):
        cfg = CannyConfig(height=64, width=96)
        out = _port(cfg, (2, 2, 2), frames)
        np.testing.assert_array_equal(out, _expected(frames))
        np.testing.assert_array_equal(out, _jax(cfg, (2, 2, 2), frames))

    def test_single_tile_mesh_is_the_raw_frame(self, frames):
        cfg = CannyConfig(height=64, width=96)
        run = build_sharded_pipeline(config_from_jax(cfg), make_mesh(1, 1, 1))
        g = run.geo
        assert (g.e_top, g.e_bot, g.e_left, g.e_right, g.ext_h, g.ext_w) == (0, 0, 0, 0, 64, 96)
        np.testing.assert_array_equal(_port(cfg, (1, 1, 1), frames), _expected(frames))


def _snake(h=64, w=96, col=48):
    frame = np.zeros((h, w), np.uint8)
    frame[:, col] = np.linspace(255, 80, h).astype(np.uint8)
    return frame


class TestCrossShardHysteresis:
    def test_edge_snakes_across_shards(self):
        frame = _snake()
        cfg = CannyConfig(height=64, width=96, channels=1)
        out = _port(cfg, (1, 8, 1), frame[None], 5, 90)[0]
        exp = oracle.canny_pipeline(frame, low=5, high=90)["hyster"]
        np.testing.assert_array_equal(out, exp)
        np.testing.assert_array_equal(out, _jax(cfg, (1, 8, 1), frame[None], 5, 90)[0])
        assert (out[60] == 255).any()

    def test_no_seed_no_promotion(self):
        frame = np.zeros((64, 96), np.uint8)
        frame[:, 48] = 60  # only candidates
        cfg = CannyConfig(height=64, width=96, channels=1)
        out = _port(cfg, (1, 8, 1), frame[None], 5, 90)[0]
        np.testing.assert_array_equal(out, oracle.canny_pipeline(frame, low=5, high=90)["hyster"])
        assert not out.any()


class TestKernelVariants:
    @pytest.mark.parametrize("ks", [3, 7])
    def test_kernel_sizes(self, frames, ks):
        cfg = CannyConfig(height=64, width=96, kernel_size=ks)
        out = _port(cfg, (1, 4, 2), frames)
        np.testing.assert_array_equal(out, _expected(frames, kernel_size=ks))
        np.testing.assert_array_equal(out, _jax(cfg, (1, 4, 2), frames))

    def test_opencv_parity_domain(self, frames):
        cfg = CannyConfig(height=64, width=96, parity="opencv")
        out = _port(cfg, (1, 4, 2), frames, 30, 120)
        np.testing.assert_array_equal(out, _expected(frames, low=30, high=120, parity="opencv"))

    def test_l1_norm(self, frames):
        cfg = CannyConfig(height=64, width=96, norm="l1")
        out = _port(cfg, (1, 2, 2), frames)
        np.testing.assert_array_equal(out, _expected(frames, norm="l1"))
        np.testing.assert_array_equal(out, _jax(cfg, (1, 2, 2), frames))

    def test_halo_larger_than_a_tile_raises(self):
        cfg = config_from_jax(CannyConfig(height=64, width=96, kernel_size=7))
        with pytest.raises(ValueError, match="halo"):
            build_sharded_pipeline(cfg, make_mesh(1, 16, 1))  # 4-row tiles, halo 5
        with pytest.raises(ValueError, match="divisible"):
            build_sharded_pipeline(cfg, make_mesh(1, 5, 1))


class TestInjectableSaturate:
    """The round loop with an injected local operator ``(f, p) -> (f,
    growing)``, as the JAX package's ``local_saturate``: the loop itself
    carries convergence through repeated exchange and the pending flag."""

    def _run_with(self, make_saturate, rows=4, cols=2):
        frame = _snake()
        cfg = CannyConfig(height=64, width=96, channels=1)
        ny, nx = rows, cols
        from cudacam_tpu_torch.ops.packed_strips import make_geo

        geo = make_geo(64 // ny, 96 // nx, ny=ny, nx=nx)
        out = _port(cfg, (1, rows, cols), frame[None], 5, 90,
                    local_saturate=make_saturate(config_from_jax(cfg), geo))[0]
        np.testing.assert_array_equal(out, oracle.canny_pipeline(frame, low=5, high=90)["hyster"])
        assert (out[60] == 255).any()  # cross-shard promotion happened

    @staticmethod
    def _default(cfg, geo):
        def saturate(f, p):
            flags = torch.zeros((f.shape[0], 2, 2), dtype=torch.int32)
            return saturate_packed(f, p, flags, geo.ext_h, **hyster_kwargs(cfg))

        return saturate

    def test_default_packed_operator(self):
        self._run_with(self._default)

    def test_weak_operator_still_converges(self):
        def weak(cfg, geo):
            dilates, _ = bitpack._make_ops(geo.ext_h, geo.ext_w, 1)

            def saturate(f, p):
                nf = torch.stack([bitpack.from_words(dilates(bitpack.to_words(fb),
                                                             bitpack.to_words(pb)))
                                  for fb, pb in zip(f, p)])
                return nf, (nf != f).flatten(1).any(1)

            return saturate

        self._run_with(weak)

    def test_full_local_operator(self):
        def full_local(cfg, geo):
            def saturate(f, p):
                outs = [bitpack.converge_packed(fb, pb, geo.ext_h, geo.ext_w,
                                                max_iters=cfg.max_hysteresis_iters)
                        for fb, pb in zip(f, p)]
                return (torch.stack([o[0] for o in outs]),
                        torch.tensor([bool(o[2]) for o in outs]))

            return saturate

        self._run_with(full_local)

    def test_row_only_mesh(self):
        self._run_with(self._default, rows=8, cols=1)


# -- K8, K9, K10 against the Pallas kernels (interpret mode) on a 2-row mesh
# of 96x384 frames: 48x384 tiles, extended tiles 112x384 (ext_h % 8 == 0,
# ext_w % 128 == 0), so the JAX package's granule padding is zero.

H, W = 96, 384


def _aligned():
    cfg = CannyConfig(height=H, width=W, channels=1, interpret=True, hysteresis_scan_after=3,
                      hysteresis_inner_steps=4)
    pipe = build_sharded_pipeline(config_from_jax(cfg), make_mesh(1, 2, 1))
    g = pipe.geo
    assert g.ext_h % 8 == 0 and g.ext_w % 128 == 0
    return cfg, pipe


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _jax_planes(words: np.ndarray, hwp: int, wp: int) -> jnp.ndarray:
    out = np.zeros((hwp, wp), np.uint32)
    out[:words.shape[0], :words.shape[1]] = words
    return jnp.asarray(out)


@pytest.fixture(scope="module")
def aligned_export():
    """The JAX export of tile 1 of the spiral and the port's plain K8 on
    both tiles."""
    cfg, pipe = _aligned()
    pcfg, t, g = pipe.cfg, pipe.tiling, pipe.geo
    frame = make_spiral_frame(H, W)[..., 0].copy()
    thr = torch.tensor([10, 40], dtype=torch.int32)
    f, p, flags = mega_export(torch.from_numpy(frame)[None], thr, t, **pipeline_kwargs(pcfg))
    oy, ox = t.ext_origin(1, 0)
    ext = np.zeros((g.ext_h, g.ext_w), np.uint8)
    rows = frame[max(oy, 0):oy + g.ext_h]
    ext[:rows.shape[0]] = rows
    jf, jp, jflags = canny_mega_export(
        jnp.asarray(ext), jnp.int32(10), jnp.int32(40), (oy, ox), image_size=(H, W),
        ring=(pcfg.halo, 0), kernel_size=5, grad_coeff=4, norm="l2", parity="reference",
        dilate_steps=pcfg.hysteresis_inner_steps, scan_after=pcfg.hysteresis_scan_after,
        max_iters=pcfg.max_hysteresis_iters, interpret=True)
    return cfg, pipe, (f, p, flags), (np.asarray(jf), np.asarray(jp), np.asarray(jflags))


def test_mega_export_plain_matches_pallas(aligned_export):
    _, pipe, (f, p, flags), (jf, jp, jflags) = aligned_export
    hw, ew = pipe.geo.hw, pipe.geo.ext_w
    np.testing.assert_array_equal(_u32(f[1]), jf[:hw, :ew])
    np.testing.assert_array_equal(_u32(p[1]), jp[:hw, :ew])
    assert not jf[hw:].any() and not jf[:, ew:].any()
    assert flags[1, 0].tolist() == jflags[0].tolist()
    assert _u32(p[1]).any() and flags[1, 0, 1] == 1  # candidates, still growing


@pytest.mark.parametrize("scan_after,max_iters", [(3, 100), (2, 5), (6, 6)])
def test_saturate_packed_plain_matches_pallas(aligned_export, scan_after, max_iters):
    _, pipe, (f, p, _), (jf, jp, _) = aligned_export
    g = pipe.geo
    kw = dict(dilate_steps=4, scan_after=scan_after, max_iters=max_iters)
    fk = f[1:].clone()
    flags = torch.zeros((1, 2, 2), dtype=torch.int32)
    _, growing = saturate_packed(fk, p[1:].clone(), flags, g.ext_h, **kw)
    jout, jgrow, jit = jax_saturate(jnp.asarray(jf), jnp.asarray(jp), g.ext_h, g.ext_w,
                                    interpret=True, return_iters=True, **kw)
    np.testing.assert_array_equal(_u32(fk[0]), np.asarray(jout)[:g.hw, :g.ext_w])
    assert bool(growing[0]) == bool(jgrow) and int(flags[0, 1, 0]) == int(jit)


def test_unpack_core_plain_matches_pallas(aligned_export):
    _, pipe, _, _ = aligned_export
    t, g = pipe.tiling, pipe.geo
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=(2, g.hw, g.ext_w), dtype=np.uint64).astype(np.uint32)
    if g.ext_h % 32:  # no bits past the extended tile
        words[:, -1] &= np.uint32((1 << (g.ext_h % 32)) - 1)
    out = unpack_core(torch.from_numpy(words.view(np.int32)),
                      torch.zeros((1, H, W), dtype=torch.uint8), t)
    for i in range(2):
        want = unpack_core_call(_jax_planes(words[i], g.hw + 1, g.ext_w + 128), g.e_top, g.e_left,
                                g.h_loc, g.w_loc, interpret=True)
        np.testing.assert_array_equal(out[0, i * g.h_loc:(i + 1) * g.h_loc].numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("cap,scan_after,steps", [(6, 2, 2), (3, 2, 1)])
def test_truncated_pipeline_matches_pallas(cap, scan_after, steps):
    """The spiral cut off by the cap (the converged output has more finals)
    on the 2-row mesh: the port's plain route equals ``backend='pallas'``."""
    frame = make_spiral_frame(H, W)[..., 0].copy()
    cfg = CannyConfig(height=H, width=W, channels=1, interpret=True, max_hysteresis_iters=cap,
                      hysteresis_scan_after=scan_after, hysteresis_inner_steps=steps)
    out = _port(cfg, (1, 2, 1), frame[None])
    np.testing.assert_array_equal(out, _jax(cfg, (1, 2, 1), frame[None], backend="pallas"))
    assert (out == 255).sum() < (oracle.canny_pipeline(frame)["hyster"] == 255).sum()


def test_converged_scene_matches_both_backends():
    frames = np.stack([make_scene(H, W, seed=s) for s in (1, 2)])
    cfg = CannyConfig(height=H, width=W, interpret=True)
    out = _port(cfg, (1, 2, 1), frames)
    np.testing.assert_array_equal(out, _expected(frames))
    np.testing.assert_array_equal(out, _jax(cfg, (1, 2, 1), frames, backend="pallas"))
