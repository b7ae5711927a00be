from cudacam_tpu_torch.utils.logging import get_logger, init_logging
from cudacam_tpu_torch.utils.timer import TimerManager

__all__ = ["get_logger", "init_logging", "TimerManager"]
