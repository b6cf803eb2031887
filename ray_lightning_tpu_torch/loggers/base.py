"""Logger protocol (``ray_lightning_tpu/loggers/base.py``)."""
from __future__ import annotations

from typing import Any, Dict, Optional


class Logger:
    @property
    def name(self) -> str:
        return "default"

    @property
    def version(self) -> str:
        return "0"

    @property
    def log_dir(self) -> Optional[str]:
        return None

    def log_hyperparams(self, params: Dict[str, Any]) -> None: ...

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None: ...

    def save(self) -> None: ...

    def finalize(self, status: str) -> None:
        self.save()
