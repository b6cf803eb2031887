"""The Lightning-style core of the port: module, data module, data
pipeline and the single-device Trainer."""
from ray_lightning_tpu_torch.core.data import (
    DataLoader,
    Dataset,
    DictDataset,
    TensorDataset,
    default_collate,
    ensure_loader,
)
from ray_lightning_tpu_torch.core.datamodule import LightningDataModule
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.trainer import Trainer

__all__ = [
    "DataLoader", "Dataset", "DictDataset", "TensorDataset", "default_collate",
    "ensure_loader", "LightningDataModule", "LightningModule", "Trainer",
]
