"""Metric loggers of the port."""
from ray_lightning_tpu_torch.loggers.base import Logger
from ray_lightning_tpu_torch.loggers.csv_logger import CSVLogger
from ray_lightning_tpu_torch.loggers.tensorboard import (
    TENSORBOARD_AVAILABLE,
    TensorBoardLogger,
)

__all__ = ["Logger", "CSVLogger", "TensorBoardLogger", "TENSORBOARD_AVAILABLE"]
