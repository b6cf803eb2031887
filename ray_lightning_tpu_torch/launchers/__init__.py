"""Launchers of the port: the Ray-actor launcher over its own runtime."""
from ray_lightning_tpu_torch.launchers.ray_launcher import RayLauncher
from ray_lightning_tpu_torch.launchers.utils import RayExecutor, WorkerOutput

__all__ = ["RayLauncher", "RayExecutor", "WorkerOutput"]
