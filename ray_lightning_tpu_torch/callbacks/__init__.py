"""Trainer callbacks of the port."""
from ray_lightning_tpu_torch.callbacks.base import Callback
from ray_lightning_tpu_torch.callbacks.checkpoint import ModelCheckpoint

__all__ = ["Callback", "ModelCheckpoint"]
