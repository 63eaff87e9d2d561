"""Training library: the plateau-driven trainer, the device image pool and
the plateau statistics (the port of annonet_tpu.train)."""

from annonet_tpu_torch.train.device_cache import DeviceImagePool
from annonet_tpu_torch.train.plateau import (
    count_steps_without_decrease,
    count_steps_without_decrease_robust,
)
from annonet_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    bn_momentum_for_step,
    make_train_step,
)

__all__ = [
    "DeviceImagePool",
    "Trainer",
    "TrainerConfig",
    "bn_momentum_for_step",
    "count_steps_without_decrease",
    "count_steps_without_decrease_robust",
    "make_train_step",
]
