from .checkpoint import (load_checkpoint_meta, restore_checkpoint,
                         save_checkpoint)
from .logging import MetricLogger
from .multisession import MultiSessionTrainer, build_multisession_loaders
from .schedule import Optimizer, OptimizerConfig
from .trainer import (BaselineTrainer, MultiModalTrainer, TrainerConfig,
                      make_baseline_trainer, make_multimodal_trainer)

__all__ = [
    "BaselineTrainer",
    "MetricLogger",
    "MultiModalTrainer",
    "MultiSessionTrainer",
    "Optimizer",
    "OptimizerConfig",
    "TrainerConfig",
    "build_multisession_loaders",
    "make_baseline_trainer",
    "make_multimodal_trainer",
    "load_checkpoint_meta",
    "restore_checkpoint",
    "save_checkpoint",
]
