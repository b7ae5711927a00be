"""The port's ShardedCannyEngine (``cudacam_tpu_torch/engine/sharded_engine.py``)
on the CPU, mirroring ``tests/test_sharded_engine.py``: every output equals
the NumPy oracle and the JAX package's ShardedCannyEngine (tolerance 0)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

from cudacam_tpu import CannyConfig, CannyStage
from cudacam_tpu.engine import ShardedCannyEngine as JaxShardedEngine
from cudacam_tpu.ops import numpy_oracle as oracle
from cudacam_tpu.parallel import make_mesh as jax_mesh
from cudacam_tpu_torch.engine import ShardedCannyEngine
from cudacam_tpu_torch.parallel import make_mesh
from cudacam_tpu_torch.state import config_from_jax
from cudacam_tpu_torch.stages import CannyStage as PortStage

from conftest import make_bgr_frame

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(42)
    return np.stack([make_bgr_frame(rng, 64, 96) for _ in range(2)])


@pytest.fixture(scope="module")
def engine():
    return ShardedCannyEngine(config_from_jax(CannyConfig(height=64, width=96)),
                              make_mesh(batch=1, rows=4, cols=2), device="cpu")


class TestShardedEngine:
    def test_full_pipeline_matches_oracle(self, engine, frames):
        out = engine.process(frames)
        assert out.dtype == torch.uint8 and out.device.type == "cpu"
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(out[i].numpy(), oracle.canny_pipeline(f)["hyster"])
        jeng = JaxShardedEngine(CannyConfig(height=64, width=96, backend="xla"),
                                jax_mesh(batch=1, rows=4, cols=2, devices=jax.devices()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(jeng.process(frames)))

    def test_stage_selection(self, engine, frames):
        out = engine.process(frames, PortStage.NMS)
        np.testing.assert_array_equal(out[0].numpy(), oracle.canny_pipeline(frames[0])["nms"])
        out = engine.process(torch.from_numpy(frames), int(CannyStage.THRESH))
        np.testing.assert_array_equal(out[1].numpy(), oracle.canny_pipeline(frames[1])["thresh"])

    def test_threshold_clamping_and_effect(self, engine, frames):
        engine.set_low_threshold(500)  # clamped to high
        assert engine.get_low_threshold() == engine.get_high_threshold()
        engine.set_high_threshold(90)
        engine.set_low_threshold(30)
        out = engine.process(frames)
        np.testing.assert_array_equal(
            out[0].numpy(), oracle.canny_pipeline(frames[0], low=30, high=90)["hyster"])
        engine.set_low_threshold(10)
        engine.set_high_threshold(40)

    def test_input_validation(self, engine):
        with pytest.raises(ValueError):
            engine.process(np.zeros((64, 96, 3), np.uint8))  # missing batch
        with pytest.raises(ValueError):
            engine.process(np.zeros((2, 32, 96, 3), np.uint8))  # wrong spec
        with pytest.raises(ValueError):
            engine.process(np.zeros((2, 64, 96, 3), np.float32))  # dtype
        with pytest.raises(ValueError):
            engine.process(torch.zeros((2, 64, 96, 3), dtype=torch.int32))

    def test_batch_axis_divisibility(self, frames):
        eng = ShardedCannyEngine(config_from_jax(CannyConfig(height=64, width=96)),
                                 make_mesh(batch=2, rows=2, cols=2), device="cpu")
        with pytest.raises(ValueError):
            eng.process(frames[:1])  # B=1 not divisible by mesh batch 2
        out = eng.process(frames)
        np.testing.assert_array_equal(out[1].numpy(), oracle.canny_pipeline(frames[1])["hyster"])

    def test_warmup(self, engine):
        engine.warmup(batch=1)
        engine.warmup(PortStage.GRADIENT)

    def test_device_and_mesh(self, engine):
        assert engine.device == torch.device("cpu") and engine.mesh.shape == {"b": 1, "y": 4, "x": 2}
        assert engine.pipeline() is engine.pipeline(PortStage.HYSTER)  # built once per stage
        with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
            ShardedCannyEngine(engine.config, engine.mesh, device="meta")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ShardedCannyEngine(engine.config, engine.mesh)  # the card is the default
