"""Metric loggers of the port."""
from ray_lightning_tpu_torch.loggers.base import Logger
from ray_lightning_tpu_torch.loggers.csv_logger import CSVLogger

__all__ = ["Logger", "CSVLogger"]
