"""CSV metrics logger (``ray_lightning_tpu/loggers/csv_logger.py``): the same
directory layout and the same columns (every metric name seen, plus
``step``, sorted)."""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ray_lightning_tpu_torch.loggers.base import Logger


class CSVLogger(Logger):
    def __init__(self, save_dir: str, name: str = "default", version: Optional[str] = None):
        self._save_dir = save_dir
        self._name = name
        if version is None:
            version = self._next_version()
        self._version = str(version)
        self._rows: list = []
        self._keys: set = set()

    def _next_version(self) -> str:
        base = os.path.join(self._save_dir, self._name)
        if not os.path.isdir(base):
            return "version_0"
        existing = [
            int(d.split("_")[1])
            for d in os.listdir(base)
            if d.startswith("version_") and d.split("_")[1].isdigit()
        ]
        return f"version_{max(existing) + 1 if existing else 0}"

    @property
    def name(self) -> str:
        return self._name

    @property
    def version(self) -> str:
        return self._version

    @property
    def log_dir(self) -> str:
        return os.path.join(self._save_dir, self._name, self._version)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "hparams.json"), "w") as f:
            json.dump({k: repr(v) for k, v in params.items()}, f, indent=2)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        row = {k: float(np.asarray(v)) for k, v in metrics.items()}
        if step is not None:
            row["step"] = step
        self._keys.update(row)
        self._rows.append(row)

    def save(self) -> None:
        if not self._rows:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        keys = sorted(self._keys)
        with open(os.path.join(self.log_dir, "metrics.csv"), "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            for row in self._rows:
                writer.writerow(row)
