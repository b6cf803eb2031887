"""The Trainer on one device (``ray_lightning_tpu/core/trainer.py``):
fit / validate / test / predict with the JAX Trainer's arguments, logged
metric names and epoch reduction.

A training step is eager PyTorch: the module's ``training_step`` on the
parameter tree (``nn.Parameter`` leaves), ``loss.backward()``, an optional
global-norm clip, ``optimizer.step()`` and ``lr_scheduler.step()``. The host
never waits for the device inside the step loop: batches go up from pinned
memory without blocking, logged values stay on the device, and they come
back in one copy at the drain points (epoch end, validation, the end of
fit), as the JAX Trainer's ``_step_log_buffer`` does.

Not ported yet, and refused loudly (ROADMAP.md, queue 1): strategies
(several devices), precision policies, gradient accumulation, alternating
or per-group optimizers, the async input pipeline, elastic membership,
telemetry.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.callbacks.base import (
    Callback,
    collect_callback_states,
    restore_callback_states,
)
from ray_lightning_tpu_torch.callbacks.checkpoint import ModelCheckpoint
from ray_lightning_tpu_torch.core.data import ensure_loader
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.loggers.base import Logger
from ray_lightning_tpu_torch.loggers.csv_logger import CSVLogger
from ray_lightning_tpu_torch.utils.seed import seed_everything
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

__version__ = "0.1.0"

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


@dataclass
class TrainerState:
    fn: Optional[str] = None  # fit | validate | test | predict
    status: str = "initializing"  # running | finished | interrupted


def _host_floats(values) -> np.ndarray:
    """Scalar values (tensors on a device, or numbers) as one float64 array,
    through one device-to-host copy."""
    tensors = [torch.as_tensor(v).detach().reshape(()).float() for v in values]
    dev = tensors[0].device
    return torch.stack([t.to(dev) for t in tensors]).cpu().numpy().astype(np.float64)


@dataclass
class _EpochAggregator:
    """Per-batch on_epoch values kept on the device; reduced at epoch end
    (one host copy per metric)."""

    sums: Dict[str, list] = field(default_factory=dict)
    weights: Dict[str, list] = field(default_factory=dict)

    def update(self, logs: Dict[str, Any], batch_size: int) -> None:
        for name, value in logs.items():
            self.sums.setdefault(name, []).append(value)
            self.weights.setdefault(name, []).append(batch_size)

    def reduce(self, meta_lookup) -> Dict[str, np.ndarray]:
        out = {}
        for name, values in self.sums.items():
            vals = _host_floats(values)
            meta = meta_lookup(name)
            reduce_kind = meta.reduce if meta else "mean"
            if reduce_kind == "mean":
                w = np.asarray(self.weights[name], dtype=np.float64)
                out[name] = np.asarray(np.sum(vals * w) / max(np.sum(w), 1e-12))
            elif reduce_kind == "sum":
                out[name] = np.asarray(np.sum(vals))
            elif reduce_kind == "max":
                out[name] = np.asarray(np.max(vals))
            elif reduce_kind == "min":
                out[name] = np.asarray(np.min(vals))
            else:
                out[name] = np.asarray(vals[-1])
        return out


def _normalize_optimizers(configured):
    """``configure_optimizers``' result -> (optimizer, lr scheduler or
    None). One optimizer only."""
    sched = None
    if isinstance(configured, dict):
        if "optimizers" in configured:
            raise NotImplementedError(
                "alternating or per-group optimizers ({'optimizers': ...}) "
                + _NOT_PORTED
            )
        opt, sched = configured.get("optimizer"), configured.get("lr_scheduler")
    elif isinstance(configured, (list, tuple)):
        opts, scheds = (configured if len(configured) == 2
                        and isinstance(configured[0], (list, tuple))
                        else (configured, []))
        if len(opts) != 1 or len(scheds) > 1:
            raise NotImplementedError(
                "more than one optimizer or scheduler " + _NOT_PORTED
            )
        opt, sched = opts[0], (scheds[0] if scheds else None)
    else:
        opt = configured
    if isinstance(sched, dict):
        sched = sched.get("scheduler")
    if not isinstance(opt, torch.optim.Optimizer):
        raise TypeError(
            "configure_optimizers must return a torch.optim.Optimizer, "
            "optionally with an lr scheduler"
        )
    return opt, sched


@torch.no_grad()
def _clip_by_global_norm(tensors: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: when the global norm g reaches
    ``max_norm``, scale every gradient by max_norm / g. On the device, no
    host sync."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


class Trainer:
    def __init__(
        self,
        device: DeviceLike = None,
        max_epochs: Optional[int] = None,
        max_steps: int = -1,
        callbacks: Optional[List[Callback]] = None,
        logger: Any = True,
        enable_checkpointing: bool = True,
        default_root_dir: Optional[str] = None,
        log_every_n_steps: int = 50,
        check_val_every_n_epoch: int = 1,
        val_check_interval: Optional[Union[int, float]] = None,
        num_sanity_val_steps: int = 0,
        limit_train_batches: Optional[Union[int, float]] = None,
        limit_val_batches: Optional[Union[int, float]] = None,
        limit_test_batches: Optional[Union[int, float]] = None,
        limit_predict_batches: Optional[Union[int, float]] = None,
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        precision: Optional[Union[str, int]] = None,
        seed: Optional[int] = None,
        strategy: Any = None,
    ):
        if strategy is not None:
            raise NotImplementedError(
                f"strategy={strategy!r}: strategies (several devices) "
                + _NOT_PORTED + "; the port trains on one device"
            )
        if precision is not None:
            raise NotImplementedError(
                f"precision={precision!r}: precision policies " + _NOT_PORTED
                + "; the parameters' dtype is the compute dtype"
            )
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                f"accumulate_grad_batches={accumulate_grad_batches}: gradient "
                "accumulation " + _NOT_PORTED
            )
        # PTL semantics: ints are batch/step counts, floats epoch fractions
        for name, value in (
            ("val_check_interval", val_check_interval),
            ("limit_train_batches", limit_train_batches),
            ("limit_val_batches", limit_val_batches),
            ("limit_test_batches", limit_test_batches),
            ("limit_predict_batches", limit_predict_batches),
        ):
            if value is not None and not isinstance(value, int):
                if not isinstance(value, float):
                    raise TypeError(
                        f"{name} must be int, float, or None, got {value!r}"
                    )
                if not 0.0 <= value <= 1.0:
                    raise ValueError(
                        f"{name}={value}: float values are epoch fractions and "
                        "must be in [0.0, 1.0]; pass an int for a batch count"
                    )
        self.device = resolve_device(device)
        self.max_epochs = max_epochs if max_epochs is not None else 1000
        self.max_steps = max_steps
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.val_check_interval = val_check_interval
        self.num_sanity_val_steps = num_sanity_val_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.gradient_clip_val = gradient_clip_val
        self.seed = seed
        self.enable_checkpointing = enable_checkpointing
        self.default_root_dir = os.path.abspath(default_root_dir or os.getcwd())

        self.callbacks: List[Callback] = list(callbacks or [])
        if self.enable_checkpointing and not any(
            isinstance(c, ModelCheckpoint) for c in self.callbacks
        ):
            self.callbacks.append(ModelCheckpoint())
        # checkpoint-writing callbacks dispatch last
        self.callbacks.sort(key=lambda c: c.saves_checkpoints)

        if logger is True:
            self.logger: Optional[Logger] = CSVLogger(
                os.path.join(self.default_root_dir, "lightning_logs")
            )
        elif logger is False or logger is None:
            self.logger = None
        else:
            self.logger = logger

        self.state = TrainerState()
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.sanity_checking = False
        self.num_val_batches = 0
        self._val_ran_this_epoch = False
        self._epoch_ended = True
        self.callback_metrics: Dict[str, Any] = {}
        self.logged_metrics: Dict[str, Any] = {}
        self._module: Optional[LightningModule] = None
        self._params = None
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self._scheduler = None
        self._step_log_buffer: list = []

    # ------------------------------------------------------------------ #
    # properties and dispatch
    # ------------------------------------------------------------------ #
    @property
    def lightning_module(self) -> Optional[LightningModule]:
        return self._module

    @property
    def model(self) -> Optional[LightningModule]:
        return self._module

    @property
    def params(self):
        return self._params

    @property
    def optimizer(self) -> Optional[torch.optim.Optimizer]:
        return self._optimizer

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                return cb
        return None

    def _hook(self, name: str, *args) -> None:
        module_hook = getattr(self._module, name, None)
        if callable(module_hook):
            module_hook(*args)
        for cb in self.callbacks:
            getattr(cb, name)(self, self._module, *args)

    def _cb(self, name: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, name)(self, self._module, *args)

    # ------------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------------ #
    def fit(self, model: LightningModule, train_dataloaders=None,
            val_dataloaders=None, datamodule=None,
            ckpt_path: Optional[str] = None) -> None:
        self.state.fn = "fit"
        self._launch(self._fit_impl, model, train_dataloaders, val_dataloaders,
                     datamodule, ckpt_path)

    def validate(self, model=None, dataloaders=None, datamodule=None,
                 ckpt_path=None, verbose=True):
        self.state.fn = "validate"
        return self._launch(self._eval_impl, model, dataloaders, datamodule,
                            ckpt_path, "val")

    def test(self, model=None, dataloaders=None, datamodule=None,
             ckpt_path=None, verbose=True):
        self.state.fn = "test"
        return self._launch(self._eval_impl, model, dataloaders, datamodule,
                            ckpt_path, "test")

    def predict(self, model=None, dataloaders=None, datamodule=None,
                ckpt_path=None):
        self.state.fn = "predict"
        return self._launch(self._predict_impl, model, dataloaders, datamodule,
                            ckpt_path)

    def _launch(self, fn, model, *args):
        model = model or self._module
        if model is None:
            raise ValueError("no model provided")
        self._module = model
        model.trainer = self
        self.state.status = "running"
        try:
            result = fn(model, *args)
            self.state.status = "finished"
            return result
        except BaseException as e:
            self.state.status = "interrupted"
            self._cb("on_exception", e)
            raise

    def _resolve_loader(self, explicit, datamodule, hook_name: str):
        if explicit is not None:
            return ensure_loader(explicit)
        for owner in (datamodule, self._module):
            hook = getattr(owner, hook_name, None) if owner is not None else None
            if hook is not None:
                loader = hook()
                if loader is not None:
                    return ensure_loader(loader)
        return None

    # ------------------------------------------------------------------ #
    # device placement
    # ------------------------------------------------------------------ #
    def _place_params(self, tree):
        """The parameter tree as ``nn.Parameter`` leaves on the device,
        copied: training never writes into the caller's tensors."""
        return tree_map(
            lambda t: torch.nn.Parameter(
                torch.as_tensor(t).detach().to(self.device, copy=True),
                requires_grad=torch.as_tensor(t).is_floating_point(),
            ),
            tree,
        )

    def _to_device(self, batch):
        pinned = self.device.type == "cuda"

        def move(a):
            if isinstance(a, np.ndarray):
                t = torch.from_numpy(a)
                if pinned:
                    t = t.pin_memory()
                return t.to(self.device, non_blocking=pinned)
            return a

        return tree_map(move, batch)

    @staticmethod
    def _batch_size_of(batch) -> int:
        for leaf in tree_leaves(batch):
            if hasattr(leaf, "shape") and len(leaf.shape) > 0:
                return int(leaf.shape[0])
        return 1

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #
    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        module = self._module
        module._capture_begin("train")
        try:
            out = module.training_step(self._params, batch, self.global_step)
        finally:
            logs = module._capture_end()
        loss = out["loss"] if isinstance(out, dict) else out
        self._optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.gradient_clip_val:
            _clip_by_global_norm(list(tree_leaves(self._params)),
                                 self.gradient_clip_val)
        self._optimizer.step()
        if self._scheduler is not None:
            self._scheduler.step()
        logs = dict(logs)
        logs.setdefault("loss", loss.detach())
        return logs

    @torch.no_grad()
    def _eval_step(self, phase: str, batch, batch_idx: int):
        module = self._module
        step_fn = {"val": module.validation_step, "test": module.test_step}[phase]
        module._capture_begin(phase)
        try:
            out = step_fn(self._params, batch, batch_idx)
        finally:
            logs = module._capture_end()
        if isinstance(out, dict):
            for k, v in out.items():
                logs.setdefault(k, torch.as_tensor(v))
        return logs

    # ------------------------------------------------------------------ #
    # fit
    # ------------------------------------------------------------------ #
    def _fit_impl(self, model, train_dataloaders, val_dataloaders, datamodule,
                  ckpt_path):
        seed = seed_everything(self.seed)
        self._step_log_buffer = []
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup("fit")
        model.prepare_data()
        model.setup("fit")
        self._cb("setup", "fit")

        train_loader = self._resolve_loader(train_dataloaders, datamodule,
                                            "train_dataloader")
        val_loader = self._resolve_loader(val_dataloaders, datamodule,
                                          "val_dataloader")
        if train_loader is None:
            raise ValueError("fit requires a train dataloader")

        if model._params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            host = model.init_params(gen, self.device)
        else:
            host = model._params
        self._params = self._place_params(host)
        model._params = self._params  # configure_optimizers reads them
        self._optimizer, self._scheduler = _normalize_optimizers(
            model.configure_optimizers()
        )
        if ckpt_path is not None:
            self._restore_checkpoint(ckpt_path)

        if self.logger is not None:
            self.logger.log_hyperparams(dict(model.hparams))

        self._hook("on_fit_start")
        self._hook("on_train_start")

        if val_loader is not None and self.num_sanity_val_steps > 0:
            self.sanity_checking = True
            self._cb("on_sanity_check_start")
            self._run_eval_epoch(val_loader, limit=self.num_sanity_val_steps,
                                 record=False)
            self._cb("on_sanity_check_end")
            self.sanity_checking = False

        try:
            while self.current_epoch < self.max_epochs and not self.should_stop:
                self._run_train_epoch(train_loader, val_loader)
                self.current_epoch += 1
                if 0 <= self.max_steps <= self.global_step:
                    self.should_stop = True
        finally:
            self._drain_step_logs()
            self._hook("on_train_end")
            self._hook("on_fit_end")
            if self.logger is not None:
                self.logger.finalize(self.state.status)
            self._cb("teardown", "fit")
            model.teardown("fit")
            if datamodule is not None:
                datamodule.teardown("fit")
        model._params = self._params

    def _run_train_epoch(self, train_loader, val_loader):
        model = self._module
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(self.current_epoch)
        self._val_ran_this_epoch = False
        self.num_val_batches = (
            self._loader_len(val_loader, self.limit_val_batches,
                             "limit_val_batches") if val_loader else 0
        )
        self._epoch_ended = False
        self._hook("on_train_epoch_start")
        aggregator = _EpochAggregator()
        limit_train = self._resolve_limit(self.limit_train_batches, train_loader,
                                          "limit_train_batches")
        # float val_check_interval = every fraction of this epoch's batches;
        # int = every N global steps
        val_every_n_batches = None
        if (
            isinstance(self.val_check_interval, float)
            and val_loader is not None
            and (self.current_epoch + 1) % self.check_val_every_n_epoch == 0
        ):
            n_train = self._loader_len(train_loader, limit_train,
                                       "limit_train_batches")
            if not n_train:
                raise ValueError(
                    f"val_check_interval={self.val_check_interval}: a float "
                    "fraction requires a sized train dataloader"
                )
            val_every_n_batches = int(n_train * self.val_check_interval)
            if val_every_n_batches == 0:
                raise ValueError(
                    f"val_check_interval={self.val_check_interval} of a "
                    f"{n_train}-batch epoch resolves to every 0 batches; use "
                    f"a fraction >= {1.0 / n_train:.4g} or an int step interval"
                )

        for batch_idx, batch in enumerate(train_loader):
            if limit_train is not None and batch_idx >= limit_train:
                self._epoch_ended = True
                break
            device_batch = self._to_device(batch)
            self._cb("on_train_batch_start", batch, batch_idx)
            logs = self._train_step(device_batch)
            self._record_train_logs(logs, aggregator, self._batch_size_of(batch))
            self._cb("on_train_batch_end", logs, batch, batch_idx)
            self.global_step += 1
            if val_loader is not None and (
                (val_every_n_batches is not None
                 and (batch_idx + 1) % val_every_n_batches == 0)
                or (isinstance(self.val_check_interval, int)
                    and self.val_check_interval
                    and self.global_step % self.val_check_interval == 0)
            ):
                self._run_validation(val_loader)
            if 0 <= self.max_steps <= self.global_step:
                self.should_stop = True
                break
        else:
            self._epoch_ended = True

        self._drain_step_logs()
        epoch_metrics = aggregator.reduce(model._log_meta.get)
        epoch_out: Dict[str, np.ndarray] = {}
        for name, value in epoch_metrics.items():
            meta = model._log_meta.get(name)
            if meta is None or not meta.on_epoch:
                continue
            out_name = f"{name}_epoch" if (meta.on_step and meta.on_epoch) else name
            self.callback_metrics[out_name] = value
            self.logged_metrics[out_name] = value
            epoch_out[out_name] = value
        if self.logger is not None and epoch_out:
            self.logger.log_metrics(epoch_out, step=self.global_step)

        if (
            val_loader is not None
            and not self.val_check_interval
            and (self.current_epoch + 1) % self.check_val_every_n_epoch == 0
        ):
            self._run_validation(val_loader)

        self._hook("on_train_epoch_end")

    def _record_train_logs(self, logs, aggregator: _EpochAggregator,
                           batch_size: int) -> None:
        model = self._module
        epoch_logs = {}
        for name, value in logs.items():
            meta = model._log_meta.get(name)
            if meta is None:
                # the implicit "loss" of the step
                self.logged_metrics[name] = value
                epoch_logs[name] = value
                continue
            if meta.on_step:
                out = f"{name}_step" if meta.on_epoch else name
                self.logged_metrics[out] = value
            if meta.on_epoch:
                epoch_logs[name] = value
        aggregator.update(epoch_logs, batch_size)
        if (
            self.logger is not None
            and self.log_every_n_steps
            and self.global_step % self.log_every_n_steps == 0
        ):
            # deferred: the device scalars resolve in one copy at the next
            # drain point, so the step loop never waits for the device
            step_metrics = {k: v for k, v in self.logged_metrics.items()
                            if torch.is_tensor(v)}
            if step_metrics:
                self._step_log_buffer.append((self.global_step, step_metrics))

    def _drain_step_logs(self) -> None:
        """Emit the step metrics deferred by ``_record_train_logs``: one
        device-to-host copy for the whole buffer. Non-scalar values are
        dropped (the logger's rows are scalar)."""
        if not self._step_log_buffer:
            return
        buffered, self._step_log_buffer = self._step_log_buffer, []
        if self.logger is None:
            return
        keys = [(i, name) for i, (_, metrics) in enumerate(buffered)
                for name, v in metrics.items() if v.numel() == 1]
        if not keys:
            return
        host = _host_floats([buffered[i][1][name] for i, name in keys])
        rows: Dict[int, Dict[str, float]] = {}
        for (i, name), value in zip(keys, host):
            rows.setdefault(i, {})[name] = float(value)
        for i, row in rows.items():
            self.logger.log_metrics(row, step=buffered[i][0])

    def _run_validation(self, val_loader):
        # a drain point: deferred step rows land before the val rows
        self._drain_step_logs()
        self._hook("on_validation_epoch_start")
        self._cb("on_validation_start")
        metrics = self._run_eval_epoch(val_loader, limit=self.limit_val_batches,
                                       record=True)
        self._val_ran_this_epoch = True
        self._hook("on_validation_epoch_end")
        self._cb("on_validation_end")
        return metrics

    def _run_eval_epoch(self, loader, limit=None, record=True, phase="val"):
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.current_epoch)
        aggregator = _EpochAggregator()
        limit = self._resolve_limit(limit, loader, f"limit_{phase}_batches")
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break
            logs = self._eval_step(phase, self._to_device(batch), batch_idx)
            aggregator.update(logs, self._batch_size_of(batch))
            hook = "on_test_batch_end" if phase == "test" else "on_validation_batch_end"
            self._cb(hook, logs, batch, batch_idx)
        metrics = aggregator.reduce(self._module._log_meta.get)
        if record:
            for name, value in metrics.items():
                self.callback_metrics[name] = value
                self.logged_metrics[name] = value
            if self.logger is not None and metrics:
                self.logger.log_metrics(metrics, step=self.global_step)
        return metrics

    @staticmethod
    def _resolve_limit(limit, loader, name: str):
        """PTL semantics: int = batch count, float = fraction of len(loader)."""
        if limit is None or isinstance(limit, int):
            return limit
        try:
            n = len(loader)
        except TypeError:
            raise ValueError(
                f"{name}={limit}: a float fraction requires a sized dataloader"
            )
        resolved = int(n * limit)
        if resolved == 0 and limit > 0.0:
            raise ValueError(
                f"{name}={limit} of a {n}-batch dataloader resolves to 0 "
                "batches; use a larger fraction or an int batch count"
            )
        return resolved

    def _loader_len(self, loader, limit, name: str = "limit") -> int:
        try:
            n = len(loader)
        except TypeError:
            n = 0
        limit = self._resolve_limit(limit, loader, name) if n else limit
        if isinstance(limit, int):
            n = min(n, limit)
        return n

    # ------------------------------------------------------------------ #
    # validate / test / predict
    # ------------------------------------------------------------------ #
    def _setup_eval(self, model, dataloaders, datamodule, ckpt_path, stage,
                    hook_name):
        seed_everything(self.seed)
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup(stage)
        model.prepare_data()
        model.setup(stage)
        loader = self._resolve_loader(dataloaders, datamodule, hook_name)
        if loader is None:
            raise ValueError(f"{stage} requires a dataloader")
        if ckpt_path is not None:
            model._params = torch.load(ckpt_path, map_location="cpu",
                                       weights_only=True)["state_dict"]
        if model._params is None:
            raise ValueError(
                f"{stage} requires trained params (fit first or pass ckpt_path)"
            )
        self._params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(self.device), model._params
        )
        return loader

    def _eval_impl(self, model, dataloaders, datamodule, ckpt_path, phase: str):
        hook_name = {"val": "val_dataloader", "test": "test_dataloader"}[phase]
        loader = self._setup_eval(model, dataloaders, datamodule, ckpt_path,
                                  "validate" if phase == "val" else phase,
                                  hook_name)
        limit = self.limit_val_batches if phase == "val" else self.limit_test_batches
        if phase == "test":
            self._cb("on_test_start")
        metrics = self._run_eval_epoch(loader, limit=limit, phase=phase)
        for name, value in metrics.items():
            self.callback_metrics[name] = value
        if phase == "test":
            self._cb("on_test_epoch_end")
            self._cb("on_test_end")
        if self.logger is not None:
            self.logger.save()
        return [dict(metrics)]

    @torch.no_grad()
    def _predict_impl(self, model, dataloaders, datamodule, ckpt_path):
        loader = self._setup_eval(model, dataloaders, datamodule, ckpt_path,
                                  "predict", "predict_dataloader")
        self._cb("on_predict_start")
        outputs = []
        limit = self._resolve_limit(self.limit_predict_batches, loader,
                                    "limit_predict_batches")
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break
            model._capture_begin("predict")
            try:
                out = model.predict_step(self._params, self._to_device(batch),
                                         batch_idx)
            finally:
                model._capture_end()
            outputs.append(tree_map(
                lambda t: t.cpu() if torch.is_tensor(t) else t, out))
        self._cb("on_predict_end")
        return outputs

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def dump_checkpoint(self, weights_only: bool = False) -> Dict[str, Any]:
        model = self._module
        params = self._params if self._params is not None else model._params
        ckpt: Dict[str, Any] = {
            "epoch": self.current_epoch,
            "epoch_complete": bool(self._epoch_ended),
            "global_step": self.global_step,
            "version": __version__,
            "state_dict": tree_map(lambda t: t.detach().cpu(), params),
            "hyper_parameters": dict(model.hparams),
        }
        if not weights_only:
            if self._optimizer is not None:
                ckpt["optimizer_states"] = [self._optimizer.state_dict()]
            if self._scheduler is not None:
                ckpt["lr_schedulers"] = [self._scheduler.state_dict()]
            ckpt["callbacks"] = collect_callback_states(self.callbacks)
            ckpt["callback_metrics"] = {
                k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                for k, v in self.callback_metrics.items()
            }
        model.on_save_checkpoint(ckpt)
        return ckpt

    def save_checkpoint(self, filepath: str, weights_only: bool = False) -> None:
        """``torch.save`` of :meth:`dump_checkpoint`, written to a temporary
        file in the same directory and renamed into place, so a reader never
        sees a half-written checkpoint."""
        ckpt = self.dump_checkpoint(weights_only)
        filepath = os.path.abspath(filepath)
        directory = os.path.dirname(filepath)
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(ckpt, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, filepath)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _restore_checkpoint(self, ckpt_path: str) -> None:
        """Resume a fit: parameters, optimizer and scheduler state, progress,
        callback states. A mid-epoch save re-runs its epoch from the start."""
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self._params),
                                tree_leaves(ckpt["state_dict"])):
                dst.copy_(src)
        if "optimizer_states" in ckpt:
            self._optimizer.load_state_dict(ckpt["optimizer_states"][0])
        if "lr_schedulers" in ckpt and self._scheduler is not None:
            self._scheduler.load_state_dict(ckpt["lr_schedulers"][0])
        base = int(ckpt.get("epoch", 0))
        self.current_epoch = base + 1 if ckpt.get("epoch_complete", True) else base
        self.global_step = int(ckpt.get("global_step", 0))
        restore_callback_states(self.callbacks, ckpt.get("callbacks", {}))
        for k, v in ckpt.get("callback_metrics", {}).items():
            self.callback_metrics[k] = np.asarray(v)
        self._module.on_load_checkpoint(ckpt)
