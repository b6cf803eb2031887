"""LightningDataModule (``ray_lightning_tpu/core/datamodule.py``)."""
from __future__ import annotations


class LightningDataModule:
    def prepare_data(self) -> None:
        """Download / write to disk."""

    def setup(self, stage: str) -> None:
        """Build datasets for the given stage."""

    def teardown(self, stage: str) -> None: ...

    def train_dataloader(self):
        return None

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None
