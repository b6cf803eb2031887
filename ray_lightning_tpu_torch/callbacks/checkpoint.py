"""ModelCheckpoint (``ray_lightning_tpu/callbacks/checkpoint.py``): monitor a
metric, keep the top-k checkpoints, write ``last.ckpt`` on request, expose
``best_model_path``. The checkpoints are the Trainer's ``torch.save`` files."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

from ray_lightning_tpu_torch.callbacks.base import Callback


class ModelCheckpoint(Callback):
    CHECKPOINT_EXT = ".ckpt"
    saves_checkpoints = True

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: Optional[str] = None,
        monitor: Optional[str] = None,
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = False,
        every_n_epochs: int = 1,
        save_weights_only: bool = False,
    ):
        if mode not in ("min", "max"):
            raise ValueError(f"mode={mode!r}: expected 'min' or 'max'")
        self.dirpath = dirpath
        self.filename = filename or "epoch={epoch}-step={step}"
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.every_n_epochs = max(1, every_n_epochs)
        self.save_weights_only = save_weights_only

        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self.best_k_models: Dict[str, float] = {}

    @staticmethod
    def default_dirpath(trainer) -> str:
        return os.path.join(trainer.default_root_dir, "checkpoints")

    def setup(self, trainer, module, stage: str) -> None:
        if self.dirpath is None:
            self.dirpath = self.default_dirpath(trainer)

    def _is_better(self, score: float, reference: float) -> bool:
        return score < reference if self.mode == "min" else score > reference

    def _format_name(self, trainer, metrics) -> str:
        name = self.filename.replace("{epoch}", str(trainer.current_epoch))
        name = name.replace("{step}", str(trainer.global_step))
        for key, value in metrics.items():
            token = "{" + key + "}"
            if token in name:
                name = name.replace(token, f"{float(value):.4f}")
        return name + self.CHECKPOINT_EXT

    def _worst_kept(self) -> Optional[str]:
        if not self.best_k_models:
            return None
        fn = max if self.mode == "min" else min
        return fn(self.best_k_models, key=self.best_k_models.get)

    def _save(self, trainer, module) -> None:
        if trainer.sanity_checking:
            return
        # under an ep mesh every rank gathers the experts here, at one
        # point, whether or not rank 0 then writes
        whole = trainer.whole_state(self.save_weights_only)
        if not trainer.is_global_zero_writer:
            return
        metrics = trainer.callback_metrics
        os.makedirs(self.dirpath, exist_ok=True)

        if self.monitor is not None:
            if self.monitor not in metrics:
                return  # nothing to monitor yet (e.g. no val ran this epoch)
            score = float(np.asarray(metrics[self.monitor]))
        else:
            score = None

        path = os.path.join(self.dirpath, self._format_name(trainer, metrics))
        if score is not None and path in self.best_k_models:
            # filename without {epoch}/{step}: de-duplicate (-v1, -v2, ...)
            # so top-k accounting never collapses onto one path
            stem = path[: -len(self.CHECKPOINT_EXT)]
            version = 1
            while f"{stem}-v{version}{self.CHECKPOINT_EXT}" in self.best_k_models:
                version += 1
            path = f"{stem}-v{version}{self.CHECKPOINT_EXT}"

        if score is None:
            # unmonitored: keep only the newest checkpoint unless
            # save_top_k == -1
            should_save = True
            if self.save_top_k != -1 and self.best_model_path and os.path.exists(
                self.best_model_path
            ) and self.best_model_path != path:
                os.remove(self.best_model_path)
        elif self.save_top_k == -1 or len(self.best_k_models) < self.save_top_k:
            should_save = True
        else:
            worst = self._worst_kept()
            should_save = worst is not None and self._is_better(
                score, self.best_k_models[worst]
            )
            if should_save and self.save_top_k != -1:
                self.best_k_models.pop(worst, None)
                if os.path.exists(worst):
                    os.remove(worst)

        if should_save:
            trainer.save_checkpoint(path, weights_only=self.save_weights_only,
                                    whole=whole)
            if score is not None:
                self.best_k_models[path] = score
                if self.best_model_score is None or self._is_better(
                    score, self.best_model_score
                ):
                    self.best_model_score = score
                    self.best_model_path = path
                # trim in case save_top_k shrank
                while self.save_top_k != -1 and len(self.best_k_models) > self.save_top_k:
                    worst = self._worst_kept()
                    self.best_k_models.pop(worst, None)
                    if os.path.exists(worst) and worst != self.best_model_path:
                        os.remove(worst)
            else:
                self.best_model_path = path

        if self.save_last:
            last = os.path.join(self.dirpath, "last" + self.CHECKPOINT_EXT)
            trainer.save_checkpoint(last, weights_only=self.save_weights_only,
                                    whole=whole)
            self.last_model_path = last

    def on_validation_end(self, trainer, module) -> None:
        if trainer.current_epoch % self.every_n_epochs == 0:
            self._save(trainer, module)

    def on_train_epoch_end(self, trainer, module) -> None:
        # when no validation ran this epoch, still honour every_n_epochs
        if (
            not trainer._val_ran_this_epoch
            and trainer.current_epoch % self.every_n_epochs == 0
        ):
            self._save(trainer, module)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "best_model_path": self.best_model_path,
            "best_model_score": self.best_model_score,
            "last_model_path": self.last_model_path,
            "best_k_models": dict(self.best_k_models),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")
        self.last_model_path = state.get("last_model_path", "")
        self.best_k_models = dict(state.get("best_k_models", {}))
