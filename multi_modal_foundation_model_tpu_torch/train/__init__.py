from .checkpoint import (load_checkpoint_meta, restore_checkpoint,
                         save_checkpoint)
from .logging import MetricLogger
from .schedule import Optimizer, OptimizerConfig
from .trainer import MultiModalTrainer, TrainerConfig

__all__ = [
    "MetricLogger",
    "MultiModalTrainer",
    "Optimizer",
    "OptimizerConfig",
    "TrainerConfig",
    "load_checkpoint_meta",
    "restore_checkpoint",
    "save_checkpoint",
]
