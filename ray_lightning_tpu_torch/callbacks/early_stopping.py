"""EarlyStopping on a monitored metric (``ray_lightning_tpu/callbacks/
early_stopping.py``), with state that survives a checkpoint resume."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_lightning_tpu_torch.callbacks.base import Callback


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", min_delta: float = 0.0,
                 patience: int = 3, mode: str = "min",
                 check_on_train_epoch_end: bool = False, strict: bool = False):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.check_on_train_epoch_end = check_on_train_epoch_end
        self.strict = strict
        self.wait_count = 0
        self.best_score = np.inf if mode == "min" else -np.inf
        self.stopped_epoch = 0

    def _improved(self, score: float) -> bool:
        if self.mode == "min":
            return score < self.best_score - self.min_delta
        return score > self.best_score + self.min_delta

    def _check(self, trainer) -> None:
        if trainer.sanity_checking:
            return
        metrics = trainer.callback_metrics
        if self.monitor not in metrics:
            if self.strict:
                raise RuntimeError(
                    f"EarlyStopping monitor {self.monitor!r} not found in "
                    f"callback_metrics {sorted(metrics)}"
                )
            return
        score = float(np.asarray(metrics[self.monitor]))
        if self._improved(score):
            self.best_score = score
            self.wait_count = 0
        else:
            self.wait_count += 1
            if self.wait_count >= self.patience:
                self.stopped_epoch = trainer.current_epoch
                trainer.should_stop = True

    def on_validation_end(self, trainer, module) -> None:
        if not self.check_on_train_epoch_end:
            self._check(trainer)

    def on_train_epoch_end(self, trainer, module) -> None:
        if self.check_on_train_epoch_end or not trainer._val_ran_this_epoch:
            self._check(trainer)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "wait_count": self.wait_count,
            "best_score": float(self.best_score),
            "stopped_epoch": self.stopped_epoch,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.wait_count = int(state.get("wait_count", 0))
        self.best_score = float(state.get("best_score", self.best_score))
        self.stopped_epoch = int(state.get("stopped_epoch", 0))
