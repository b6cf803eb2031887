"""LightningModule (``ray_lightning_tpu/core/module.py``) for the port.

As in the JAX package, the steps are functions of ``(params, batch,
batch_idx)``: the Trainer owns the parameter tree (a dict of tensors that
it turns into ``nn.Parameter`` leaves) and passes it in. ``self.log`` keeps
each value as a tensor on its device, detached, with its ``LogMeta``; the
Trainer reads them back in batches at its drain points, never once per
step.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


@dataclass
class LogMeta:
    on_step: bool
    on_epoch: bool
    prog_bar: bool = False
    reduce: str = "mean"  # mean | sum | max | min


@dataclass
class _StepContext:
    """Per-step context: the phase and the captured log values."""

    phase: str  # "train" | "val" | "test" | "predict"
    logs: Dict[str, torch.Tensor] = field(default_factory=dict)


class HParams(dict):
    """Dict with attribute access, like PTL's AttributeDict hparams."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:
            raise AttributeError(item) from e

    def __setattr__(self, key, value):
        self[key] = value


class LightningModule:
    """Base class for user models: ``init_params``, the ``*_step``
    functions and ``configure_optimizers`` (which reads ``self.params``, set
    by the Trainer to its parameter tree before the call)."""

    def __init__(self):
        self._trainer = None
        self._step_ctx: Optional[_StepContext] = None
        self._log_meta: Dict[str, LogMeta] = {}
        self._params = None  # populated by fit / load_from_checkpoint
        # the Trainer's precision policy (utils/precision.py), set by the
        # Trainer before fit, validate, test and predict
        self.precision_policy = None
        self.hparams: HParams = getattr(self, "hparams", HParams())

    # ------------------------------------------------------------------ #
    # wiring
    # ------------------------------------------------------------------ #
    @property
    def trainer(self):
        return self._trainer

    @trainer.setter
    def trainer(self, trainer):
        self._trainer = trainer

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    @property
    def current_epoch(self) -> int:
        return self._trainer.current_epoch if self._trainer is not None else 0

    @property
    def global_step(self) -> int:
        return self._trainer.global_step if self._trainer is not None else 0

    @property
    def training(self) -> bool:
        return self._step_ctx is not None and self._step_ctx.phase == "train"

    # ------------------------------------------------------------------ #
    # hyperparameters
    # ------------------------------------------------------------------ #
    def save_hyperparameters(self, *args, ignore=()):
        """Record the calling ``__init__``'s arguments into ``self.hparams``;
        checkpoints embed them so ``load_from_checkpoint`` can rebuild the
        module."""
        frame = inspect.currentframe().f_back
        arg_info = inspect.getargvalues(frame)
        if args:
            captured = {}
            for a in args:
                if isinstance(a, dict):
                    captured.update(a)
                elif isinstance(a, str):
                    captured[a] = arg_info.locals.get(a)
        else:
            captured = {
                k: v
                for k, v in arg_info.locals.items()
                if k not in ("self", "__class__") and not k.startswith("_")
                and k not in ignore
            }
        for k, v in captured.items():
            self.hparams[k] = v

    # ------------------------------------------------------------------ #
    # params and steps (user overrides)
    # ------------------------------------------------------------------ #
    def init_params(self, generator: torch.Generator, device=None):
        """Return the parameter tree, drawn from ``generator`` on
        ``device``."""
        raise NotImplementedError("override init_params(generator, device)")

    def forward(self, params, *args, **kwargs):
        raise NotImplementedError("override forward()")

    def __call__(self, params, *args, **kwargs):
        return self.forward(params, *args, **kwargs)

    def training_step(self, params, batch, batch_idx):
        """Return the loss (or ``{"loss": loss, ...}``) of one batch. When
        ``configure_optimizers`` returns alternating optimizers
        (``{"optimizers": [opt0, opt1, ...], "param_labels": ...}``), the
        Trainer calls it once per optimizer with ``optimizer_idx=i``, on the
        parameters as the previous sub-step left them, and only optimizer
        i's leaves take its gradient: the override must then accept an
        ``optimizer_idx`` argument."""
        raise NotImplementedError

    def validation_step(self, params, batch, batch_idx):
        return None

    def test_step(self, params, batch, batch_idx):
        return self.validation_step(params, batch, batch_idx)

    def predict_step(self, params, batch, batch_idx):
        return self.forward(params, batch)

    def configure_optimizers(self):
        raise NotImplementedError

    def flops_per_sample(self) -> Optional[float]:
        """Training FLOPs for one sample (forward and backward), or None."""
        return None

    def tokens_per_sample(self) -> Optional[int]:
        return None

    # ------------------------------------------------------------------ #
    # logging
    # ------------------------------------------------------------------ #
    def log(self, name: str, value, on_step: Optional[bool] = None,
            on_epoch: Optional[bool] = None, prog_bar: bool = False,
            reduce: str = "mean", sync_dist: bool = True, **_: Any) -> None:
        ctx = self._step_ctx
        if ctx is None:
            return  # logging outside a step is a no-op
        phase = ctx.phase
        if on_step is None:
            on_step = phase == "train"
        if on_epoch is None:
            on_epoch = phase != "train"
        self._log_meta[name] = LogMeta(
            on_step=on_step, on_epoch=on_epoch, prog_bar=prog_bar, reduce=reduce
        )
        ctx.logs[name] = (value.detach() if torch.is_tensor(value)
                          else torch.as_tensor(value))

    def log_dict(self, metrics: Dict[str, Any], **kwargs) -> None:
        for k, v in metrics.items():
            self.log(k, v, **kwargs)

    # the trainer brackets every step with these
    def _capture_begin(self, phase: str) -> None:
        self._step_ctx = _StepContext(phase=phase)

    def _capture_end(self) -> Dict[str, torch.Tensor]:
        logs = self._step_ctx.logs if self._step_ctx else {}
        self._step_ctx = None
        return logs

    # ------------------------------------------------------------------ #
    # hooks
    # ------------------------------------------------------------------ #
    def prepare_data(self) -> None: ...

    def setup(self, stage: str) -> None: ...

    def teardown(self, stage: str) -> None: ...

    def on_fit_start(self) -> None: ...

    def on_fit_end(self) -> None: ...

    def on_train_start(self) -> None: ...

    def on_train_end(self) -> None: ...

    def on_train_epoch_start(self) -> None: ...

    def on_train_epoch_end(self) -> None: ...

    def on_validation_epoch_start(self) -> None: ...

    def on_validation_epoch_end(self) -> None: ...

    def on_save_checkpoint(self, checkpoint: Dict[str, Any]) -> None: ...

    def on_load_checkpoint(self, checkpoint: Dict[str, Any]) -> None: ...

    def train_dataloader(self):
        return None

    def val_dataloader(self):
        return None

    def test_dataloader(self):
        return None

    def predict_dataloader(self):
        return None

    # ------------------------------------------------------------------ #
    # checkpoint IO
    # ------------------------------------------------------------------ #
    @classmethod
    def load_from_checkpoint(cls, path: str, **override_hparams):
        """Rebuild the module from a checkpoint written by the Trainer and
        attach its parameters (CPU tensors)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        hparams = dict(ckpt.get("hyper_parameters", {}))
        hparams.update(override_hparams)
        try:
            module = cls(**hparams) if hparams else cls()
        except TypeError:
            # ctor takes a single config dict
            module = cls(hparams)
        module._params = ckpt["state_dict"]
        return module
