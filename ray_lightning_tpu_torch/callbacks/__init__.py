"""Trainer callbacks of the port."""
from ray_lightning_tpu_torch.callbacks.base import Callback
from ray_lightning_tpu_torch.callbacks.checkpoint import ModelCheckpoint
from ray_lightning_tpu_torch.callbacks.early_stopping import EarlyStopping
from ray_lightning_tpu_torch.callbacks.profiler import ProfilerCallback
from ray_lightning_tpu_torch.callbacks.throughput import ThroughputMonitor

__all__ = ["Callback", "ModelCheckpoint", "EarlyStopping", "ProfilerCallback",
           "ThroughputMonitor"]
