"""Strategies of the port: one device, and the Ray-actor family over
several worker processes."""
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy, Strategy
from ray_lightning_tpu_torch.strategies.ray_strategies import (
    HorovodRayStrategy,
    RayShardedStrategy,
    RayStrategy,
)

__all__ = ["Strategy", "SingleDeviceStrategy", "RayStrategy",
           "RayShardedStrategy", "HorovodRayStrategy"]
