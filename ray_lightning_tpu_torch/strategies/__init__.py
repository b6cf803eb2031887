"""Strategies of the port: one device for now."""
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

__all__ = ["SingleDeviceStrategy"]
