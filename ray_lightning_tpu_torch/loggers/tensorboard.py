"""TensorBoard logger (``ray_lightning_tpu/loggers/tensorboard.py``),
available where the ``tensorboard`` package is installed (it backs
``torch.utils.tensorboard``); otherwise the name is a placeholder that
raises with the reason when used. The writer is imported when a logger is
made, not with this module: it can pull in TensorFlow, which takes seconds
and must not slow every import of the port."""
from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, Optional

import numpy as np

from ray_lightning_tpu_torch.loggers.base import Logger
from ray_lightning_tpu_torch.utils.common import Unavailable

TENSORBOARD_AVAILABLE = importlib.util.find_spec("tensorboard") is not None


if TENSORBOARD_AVAILABLE:

    class TensorBoardLogger(Logger):
        def __init__(self, save_dir: str, name: str = "default",
                     version: Optional[str] = None):
            from torch.utils.tensorboard import SummaryWriter

            self._save_dir = save_dir
            self._name = name
            self._version = str(version) if version is not None else "version_0"
            self._dir = os.path.join(save_dir, name, self._version)
            self._writer = SummaryWriter(self._dir)

        @property
        def name(self) -> str:
            return self._name

        @property
        def version(self) -> str:
            return self._version

        @property
        def log_dir(self) -> str:
            return self._dir

        def log_hyperparams(self, params: Dict[str, Any]) -> None:
            self._writer.add_text("hparams", str(params))

        def log_metrics(self, metrics: Dict[str, float],
                        step: Optional[int] = None) -> None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, float(np.asarray(v)), global_step=step)

        def save(self) -> None:
            self._writer.flush()

        def finalize(self, status: str) -> None:
            self._writer.flush()
            self._writer.close()

else:

    class TensorBoardLogger(Unavailable):  # type: ignore[no-redef]
        _reason = "tensorboard is not installed; use CSVLogger"
