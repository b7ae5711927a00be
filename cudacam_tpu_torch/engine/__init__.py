from cudacam_tpu_torch.engine.engine import CannyEngine, ThresholdControls

__all__ = ["CannyEngine", "ThresholdControls"]
