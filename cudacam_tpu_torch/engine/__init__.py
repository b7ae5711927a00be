from cudacam_tpu_torch.engine.engine import CannyEngine, ThresholdControls
from cudacam_tpu_torch.engine.sharded_engine import ShardedCannyEngine

__all__ = ["CannyEngine", "ShardedCannyEngine", "ThresholdControls"]
