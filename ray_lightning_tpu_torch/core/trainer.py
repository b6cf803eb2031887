"""The Trainer (``ray_lightning_tpu/core/trainer.py``): fit / validate /
test / predict with the JAX Trainer's arguments, logged metric names and
epoch reduction, on one device or, through the Ray strategies, over several
worker processes.

A training step is eager PyTorch: the module's ``training_step`` on the
parameter tree (``nn.Parameter`` leaves, or a cast of them under a mixed
precision policy), backward, and at every ``accumulate_grad_batches``-th
batch the update: the mean of the accumulated gradients, an optional
global-norm clip, ``optimizer.step()`` and the LR schedulers' step, which
is ``optax.MultiSteps`` around the clipped optimizer. Alternating
optimizers (``optimizer_idx``) run one sub-step per optimizer; per-group
optimizers share one backward. The host never waits for the device inside
the step loop: batches go up from pinned memory on a side stream
(``core/prefetch.py``), logged values stay on the device, and they come
back in one copy at the drain points (epoch end, validation, the end of
fit), as the JAX Trainer's ``_step_log_buffer`` does.

With a strategy that has a launcher (``RayStrategy``, ``RayShardedStrategy``,
``HorovodRayStrategy``) the entry points hand the stage to it: the stage
runs in each worker process, where the strategy's rank shards the data
(``DistributedSampler``), its engine runs the collectives of each update
(``parallel/data_parallel.py``), epoch metrics are averaged over the ranks,
and only rank 0 logs and writes checkpoints; the main process gets rank 0's
weights and metrics back. One process drives one device: ``devices > 1``
and a strategy named by a string are refused (ROADMAP.md). Not ported: the
TPU accelerator (``accelerator="tpu"``), elastic membership and telemetry.
"""
from __future__ import annotations

import inspect
import os
import tempfile
import time
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
from ray_lightning_tpu_torch.core.data import (
    DataLoader,
    DistributedSampler,
    ensure_loader,
)
from ray_lightning_tpu_torch.core.module import LightningModule
from ray_lightning_tpu_torch.core.prefetch import AsyncLoader, DevicePrefetcher
from ray_lightning_tpu_torch.device import DeviceLike, resolve_device
from ray_lightning_tpu_torch.loggers.base import Logger
from ray_lightning_tpu_torch.loggers.csv_logger import CSVLogger
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy, Strategy
from ray_lightning_tpu_torch.utils.precision import (
    cast_floats,
    matmul_precision_scope,
    parse_matmul_precision,
    parse_precision,
    round_matmul_inputs,
)
from ray_lightning_tpu_torch.utils.seed import seed_everything
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

__version__ = "0.1.0"

_SEVERAL_DEVICES = ("is not ported (ROADMAP.md): one process of the port "
                    "drives one device; to train over several devices pass "
                    "strategy=RayStrategy(num_workers=N) (or "
                    "RayShardedStrategy, HorovodRayStrategy), which starts one "
                    "worker process per device")


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


@dataclass
class _Optimizers:
    """``configure_optimizers``' result, normalised: the optimizers, each
    optimizer's LR schedulers, whether they alternate (one sub-step per
    optimizer, ``optimizer_idx``), and the ``param_labels`` (None for one
    optimizer). ``names`` are the labels that select each optimizer:
    indices when alternating, the dict's keys for per-group optimizers."""

    optimizers: List[torch.optim.Optimizer]
    schedulers: List[List[Any]]
    alternating: bool = False
    labels: Any = None
    names: List[Any] = field(default_factory=list)


def _scheduler_list(sched) -> List[Any]:
    if sched is None:
        return []
    scheds = list(sched) if isinstance(sched, (list, tuple)) else [sched]
    return [s.get("scheduler") if isinstance(s, dict) else s for s in scheds]


def _normalize_optimizers(configured) -> _Optimizers:
    """``configure_optimizers``' result (``Trainer._normalize_tx``): one
    optimizer (alone, in a one-item list, as ``{"optimizer": ...,
    "lr_scheduler": ...}`` or as PTL's ``([opt], [sched])``), or
    ``{"optimizers": [...] | {label: opt}, "param_labels": ...,
    "lr_scheduler": ...}`` for alternating or per-group optimizers. Each
    scheduler steps with the optimizer it was built on."""
    scheds: List[Any] = []
    names: List[Any] = []
    alternating, labels = False, None
    if isinstance(configured, dict) and "optimizers" in configured:
        opts = configured["optimizers"]
        labels = configured.get("param_labels")
        if labels is None:
            raise ValueError(
                "configure_optimizers returned {'optimizers': ...} without "
                "'param_labels' (a tree of labels, a prefix over the params "
                "is fine, or a callable params -> labels)"
            )
        if isinstance(opts, dict):
            names, opts = list(opts), list(opts.values())
        else:
            opts = list(opts)
            names = list(range(len(opts)))
            alternating = True
        scheds = _scheduler_list(configured.get("lr_scheduler"))
    else:
        if isinstance(configured, dict):
            opts = configured.get("optimizer")
            scheds = _scheduler_list(configured.get("lr_scheduler"))
        elif (isinstance(configured, (list, tuple)) and len(configured) == 2
              and isinstance(configured[0], (list, tuple))):
            opts, scheds = configured[0], _scheduler_list(configured[1])
        else:
            opts = configured
        if isinstance(opts, (list, tuple)):
            if len(opts) != 1:
                raise ValueError(
                    "a bare list of optimizers is ambiguous: for PTL-style "
                    "ALTERNATING optimizers (optimizer_idx) return "
                    "{'optimizers': [opt0, opt1], 'param_labels': <leaf -> "
                    "optimizer index>}; for per-parameter-group optimizers "
                    "over one loss return {'optimizers': {label: opt}, "
                    "'param_labels': ...}"
                )
            opts = opts[0]
        opts = [opts]
        names = [None]
    for opt in opts:
        if not isinstance(opt, torch.optim.Optimizer):
            raise TypeError(
                "configure_optimizers must return torch.optim.Optimizer "
                f"instances, optionally with lr schedulers; got {type(opt)!r}"
            )
    by_opt: List[List[Any]] = [[] for _ in opts]
    for sched in scheds:
        owner = [i for i, opt in enumerate(opts)
                 if getattr(sched, "optimizer", None) is opt]
        if not owner:
            raise ValueError(
                f"lr scheduler {sched!r} is not built on any of the "
                "configured optimizers"
            )
        by_opt[owner[0]].append(sched)
    return _Optimizers(opts, by_opt, alternating, labels, names)


def _flat_labels(labels, params) -> List[Any]:
    """``param_labels`` (a tree that is a prefix of the parameter tree, or a
    callable params -> such a tree) as one label per leaf, in
    ``tree_leaves`` order."""
    if callable(labels):
        labels = labels(params)

    def walk(lab, sub):
        if isinstance(lab, dict):
            if not isinstance(sub, dict) or set(lab) != set(sub):
                raise ValueError(
                    f"param_labels keys {sorted(lab)} do not match the "
                    f"parameter keys "
                    f"{sorted(sub) if isinstance(sub, dict) else type(sub)}"
                )
            return [x for k in sub for x in walk(lab[k], sub[k])]
        if isinstance(lab, (list, tuple)):
            if not isinstance(sub, (list, tuple)) or len(lab) != len(sub):
                raise ValueError(
                    "param_labels has a list where the parameters do not, or "
                    "one of another length"
                )
            return [x for l, t in zip(lab, sub) for x in walk(l, t)]
        return [lab] * len(list(tree_leaves(sub)))

    return walk(labels, params)


def _check_labels(optim: _Optimizers, params) -> None:
    """Every float leaf is in exactly one optimizer, the one its label
    names, and every optimizer holds only leaves of the tree: a torch
    optimizer names its parameters itself, so the labels are checked
    against those sets (optax derives the sets from the labels)."""
    leaves = list(tree_leaves(params))
    flat = _flat_labels(optim.labels, params)
    if optim.alternating:
        try:
            seen = {int(label) for label in flat}
        except (TypeError, ValueError):
            raise ValueError(
                "with a LIST of alternating optimizers, param_labels must map "
                "each leaf to an optimizer INDEX (int); for string-labeled "
                "parameter groups over one loss use the dict form "
                "{'optimizers': {label: opt}, ...}"
            )
        k = len(optim.optimizers)
        if not seen <= set(range(k)) or len(seen) < k:
            raise ValueError(
                f"param_labels must cover exactly the optimizer indices "
                f"0..{k - 1}; got labels {sorted(seen)}"
            )
        flat = [int(label) for label in flat]
    else:
        unknown = [label for label in dict.fromkeys(flat)
                   if label not in optim.names]
        if unknown:
            raise ValueError(
                f"param_labels {unknown} name no optimizer; the optimizers "
                f"are {optim.names}"
            )
    owner: Dict[int, int] = {}
    for i, opt in enumerate(optim.optimizers):
        for group in opt.param_groups:
            for p in group["params"]:
                if owner.setdefault(id(p), i) != i:
                    raise ValueError(
                        f"a parameter of shape {tuple(p.shape)} is in two "
                        "optimizers"
                    )
    ids = {id(leaf) for leaf in leaves}
    if not set(owner) <= ids:
        raise ValueError(
            "an optimizer holds a tensor that is not a leaf of the Trainer's "
            "parameter tree (build optimizers from self.params)"
        )
    for leaf, label in zip(leaves, flat):
        if not leaf.requires_grad:
            continue
        want = optim.names.index(label)
        got = owner.get(id(leaf))
        if got != want:
            held = ("no optimizer" if got is None
                    else f"optimizer {optim.names[got]!r}")
            raise ValueError(
                f"param_labels puts a leaf of shape {tuple(leaf.shape)} in "
                f"optimizer {label!r}, but {held} holds it"
            )


@dataclass
class _Update:
    """What one update steps: the optimizers, their schedulers, and the
    leaves whose gradients it reads, clips and clears."""

    optimizers: List[torch.optim.Optimizer]
    schedulers: List[Any]
    leaves: List[torch.Tensor]


@torch.no_grad()
def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``: when the global norm g reaches
    ``max_norm``, scale every gradient by max_norm / g. On the device, no
    host sync."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _resolve_trainer_device(device: DeviceLike, accelerator: str,
                            devices: Any) -> torch.device:
    """``accelerator`` and ``devices`` (the JAX Trainer's arguments) with
    the port's ``device``: "auto", "gpu" and "cuda" mean the card, "cpu"
    the CPU; one device only."""
    if accelerator in ("tpu", "_tpu"):
        raise NotImplementedError(
            f"accelerator={accelerator!r}: the delayed TPU accelerator "
            "(accelerators/delayed_tpu.py) is TPU-only and not ported "
            "(ROADMAP.md, queue 1 item 9); use 'auto', 'gpu', 'cuda' or 'cpu'"
        )
    if accelerator not in ("auto", "gpu", "cuda", "cpu"):
        raise ValueError(
            f"accelerator={accelerator!r}: expected 'auto', 'gpu', 'cuda' or "
            "'cpu'"
        )
    if devices not in ("auto", None, 1, "1", [0]):
        if isinstance(devices, int) and devices > 1:
            raise NotImplementedError(f"devices={devices}: " + _SEVERAL_DEVICES)
        raise ValueError(f"devices={devices!r}: expected 'auto' or 1")
    if device is None:
        return resolve_device("cpu" if accelerator == "cpu" else None)
    dev = resolve_device(device)
    if accelerator != "auto" and (dev.type == "cpu") != (accelerator == "cpu"):
        raise ValueError(
            f"device={device!r} contradicts accelerator={accelerator!r}"
        )
    return dev


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
        strategy: Optional[Strategy] = None,
        min_epochs: int = 0,
        accelerator: str = "auto",
        devices: Any = "auto",
        enable_progress_bar: bool = False,
        fast_dev_run: bool = False,
        use_distributed_sampler: bool = True,
        matmul_precision: Optional[str] = None,
    ):
        """The JAX Trainer's arguments, plus ``device`` (where the port
        runs: the card unless ``"cpu"``; ``accelerator="cpu"`` says the
        same) and ``matmul_precision`` (``utils/precision.py``; the JAX
        Trainer reads it from an environment variable)."""
        if strategy is None:
            strategy = SingleDeviceStrategy()
        elif not isinstance(strategy, Strategy):
            raise NotImplementedError(
                f"strategy={strategy!r}: a strategy named by a string "
                + _SEVERAL_DEVICES
            )
        if int(accumulate_grad_batches) != accumulate_grad_batches or (
                accumulate_grad_batches < 1):
            raise ValueError(
                f"accumulate_grad_batches={accumulate_grad_batches}: must be "
                "an int >= 1"
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
        self.device = _resolve_trainer_device(device, accelerator, devices)
        self.strategy = strategy
        self.accelerator = accelerator
        self.max_epochs = max_epochs if max_epochs is not None else 1000
        self.min_epochs = min_epochs
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
        self.accumulate_grad_batches = int(accumulate_grad_batches)
        self.precision = precision
        self.precision_policy = parse_precision(precision)
        self.matmul_precision = parse_matmul_precision(matmul_precision)
        self.seed = seed
        self.enable_progress_bar = enable_progress_bar
        self.fast_dev_run = fast_dev_run
        # one device: the rank-sharding sampler is a no-op, as in JAX
        self.use_distributed_sampler = use_distributed_sampler
        self.enable_checkpointing = enable_checkpointing and not fast_dev_run
        if fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1
            self.limit_test_batches = 1
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
        self._optim: Optional[_Optimizers] = None
        self._updates: List[_Update] = []
        # micro-batches whose gradients wait in the leaves' .grad for the
        # next update (optax.MultiSteps' mini_step)
        self._micro_step = 0
        self._step_log_buffer: list = []
        self._input_prefetcher: Optional[DevicePrefetcher] = None
        self._input_stats = {"starved_s": 0.0, "batches": 0}
        self._copy_stream = None
        # the data-parallel engine of a multi-rank strategy, inside a worker
        self._dp = None
        self._sampler_seed = 0
        # the workers' kernel launches of the last launched stage
        self.worker_launch_counts: Optional[Dict[str, int]] = None

    def __getstate__(self):
        """What ships to a worker: no optimizer, stream, engine or parameter
        copies (the module carries the parameters it starts from)."""
        state = dict(self.__dict__)
        state.update(_optim=None, _updates=[], _copy_stream=None, _dp=None,
                     _input_prefetcher=None, _step_log_buffer=[], _params=None)
        return state

    # ------------------------------------------------------------------ #
    # properties and dispatch
    # ------------------------------------------------------------------ #
    @property
    def world_size(self) -> int:
        return self.strategy.world_size

    @property
    def global_rank(self) -> int:
        return self.strategy.global_rank

    @property
    def is_global_zero(self) -> bool:
        return self.strategy.is_global_zero

    @property
    def is_global_zero_writer(self) -> bool:
        """Whether this process writes logs and checkpoints (rank 0)."""
        return self.strategy.is_global_zero

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
    def optimizers(self) -> List[torch.optim.Optimizer]:
        return list(self._optim.optimizers) if self._optim is not None else []

    @property
    def optimizer(self) -> Optional[torch.optim.Optimizer]:
        return self._optim.optimizers[0] if self._optim is not None else None

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint):
                return cb
        return None

    @property
    def early_stopping_callback(self):
        from ray_lightning_tpu_torch.callbacks.early_stopping import EarlyStopping

        for cb in self.callbacks:
            if isinstance(cb, EarlyStopping):
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
        launcher = self.strategy.launcher
        self.state.status = "running"
        try:
            if launcher is not None:
                result = launcher.launch(fn, model, *args, trainer=self)
            else:
                result = fn(model, *args)
            self.state.status = "finished"
            return result
        except BaseException as e:
            self.state.status = "interrupted"
            self._cb("on_exception", e)
            raise

    def _maybe_shard_loader(self, loader, shuffle: bool):
        """Over several ranks, a ``DataLoader`` without a sampler is
        re-wrapped with this rank's ``DistributedSampler`` (seeded with the
        run's seed, which the launcher fixes in the main process for every
        worker)."""
        kwargs = self.strategy.distributed_sampler_kwargs
        if (kwargs is None or not self.use_distributed_sampler
                or not isinstance(loader, DataLoader)
                or loader.sampler is not None):
            return loader
        sampler = DistributedSampler(len(loader.dataset), shuffle=shuffle,
                                     seed=self._sampler_seed,
                                     drop_last=loader.drop_last, **kwargs)
        return loader.with_sampler(sampler)

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
        """The parameter tree as ``nn.Parameter`` leaves on the device, in
        the precision policy's parameter dtype, copied: training never
        writes into the caller's tensors."""
        tree = cast_floats(tree, self.precision_policy.param_dtype)
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

    def _compute_view(self, params):
        """What a step computes on: under a mixed policy a cast of the
        masters (inside autograd, so the gradients land on the masters in
        their dtype), once per step; under fp8-emulated the float leaves
        rounded to fp8's value grid."""
        policy = self.precision_policy
        if policy.cast_params_in_compute:
            params = cast_floats(params, policy.compute_dtype)
        return round_matmul_inputs(self.matmul_precision, params)

    # ------------------------------------------------------------------ #
    # steps
    # ------------------------------------------------------------------ #
    def _build_updates(self) -> None:
        """One ``_Update`` for a single optimizer or per-group optimizers
        (every optimizer steps after one backward, the clip spans every
        leaf), one per optimizer when they alternate (each clips and clears
        only its own leaves)."""
        optim = self._optim
        leaves = [t for t in tree_leaves(self._params) if t.requires_grad]
        if not optim.alternating:
            self._updates = [_Update(list(optim.optimizers),
                                     [s for ss in optim.schedulers for s in ss],
                                     leaves)]
            return
        self._updates = []
        for opt, scheds in zip(optim.optimizers, optim.schedulers):
            held = {id(p) for g in opt.param_groups for p in g["params"]}
            self._updates.append(_Update([opt], list(scheds),
                                         [t for t in leaves if id(t) in held]))

    def _check_optimizer_idx(self) -> None:
        sig = inspect.signature(self._module.training_step)
        if "optimizer_idx" not in sig.parameters and not any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in sig.parameters.values()
        ):
            raise TypeError(
                f"configure_optimizers returned {len(self._optim.optimizers)} "
                "alternating optimizers, so training_step must accept an "
                "`optimizer_idx` argument (PTL multiple-optimizer contract)"
            )

    def _train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One micro-batch: forward and backward into the leaves' ``.grad``
        (summed over the micro-batches of an accumulation); at the k-th,
        the update. Alternating optimizers run their sub-steps in order,
        each on the parameters the previous one left."""
        policy = self.precision_policy
        batch = round_matmul_inputs(self.matmul_precision,
                                    cast_floats(batch, policy.compute_dtype))
        self._gather_params()
        update = self._micro_step + 1 == self.accumulate_grad_batches
        with matmul_precision_scope(self.matmul_precision):
            if not self._optim.alternating:
                loss, logs = self._forward_backward(batch)
                if update:
                    self._apply_update(self._updates[0])
                logs.setdefault("loss", loss)
            else:
                logs = {}
                for i, unit in enumerate(self._updates):
                    loss_i, logs_i = self._forward_backward(batch, i, unit)
                    if update:
                        self._apply_update(unit)
                    logs.update(logs_i)
                    logs[f"loss_opt{i}"] = loss_i
                # 'loss' is the sum over the sub-steps; loss_opt{i} are the
                # parts
                logs.setdefault("loss", sum(
                    logs[f"loss_opt{i}"] for i in range(len(self._updates))))
        self._micro_step = 0 if update else self._micro_step + 1
        return logs

    def _forward_backward(self, batch, optimizer_idx: Optional[int] = None,
                          unit: Optional[_Update] = None):
        module = self._module
        params = self._compute_view(self._params)
        extra = {} if optimizer_idx is None else {"optimizer_idx": optimizer_idx}
        module._capture_begin("train")
        try:
            out = module.training_step(params, batch, self.global_step, **extra)
        finally:
            logs = dict(module._capture_end())
        loss = out["loss"] if isinstance(out, dict) else out
        if unit is None:
            loss.backward()
        else:
            # only this optimizer's leaves: the others' gradients of this
            # sub-loss are dropped, as optax.set_to_zero drops them
            grads = torch.autograd.grad(loss, unit.leaves, allow_unused=True)
            with torch.no_grad():
                for leaf, g in zip(unit.leaves, grads):
                    if g is None:
                        continue
                    if leaf.grad is None:
                        leaf.grad = g
                    else:
                        leaf.grad.add_(g)
        return loss.detach(), logs

    @torch.no_grad()
    def _apply_update(self, unit: _Update) -> None:
        """optax.MultiSteps(chain(clip_by_global_norm, tx)): the mean of the
        accumulated gradients, clipped, then every optimizer and scheduler
        of the update steps. A leaf the loss did not reach gets a zero
        gradient, as optax gives it (its moments decay and weight decay
        applies)."""
        held = self._held_ids(unit)
        for leaf in unit.leaves:
            if leaf.grad is None and id(leaf) in held:
                leaf.grad = torch.zeros_like(leaf)
        if self._dp is not None and self._dp.zero_stage:
            self._dp.sharded_update(self._unit_index(unit), unit,
                                    self.accumulate_grad_batches,
                                    self.gradient_clip_val)
            return
        grads = [leaf.grad for leaf in unit.leaves if leaf.grad is not None]
        if self._dp is not None:
            self._dp.all_reduce_mean_(grads)
        if self.accumulate_grad_batches > 1:
            torch._foreach_div_(grads, float(self.accumulate_grad_batches))
        if self.gradient_clip_val and self._dp is not None:
            self._dp.clip_(unit.leaves, self.gradient_clip_val)
        elif self.gradient_clip_val:
            _clip_by_global_norm(grads, self.gradient_clip_val)
        for opt in unit.optimizers:
            opt.step()
        for sched in unit.schedulers:
            sched.step()
        for leaf in unit.leaves:
            leaf.grad = None

    def _held_ids(self, unit: _Update):
        """The ids of the leaves the unit's optimizers hold (under ZeRO
        they hold flat shards; the leaves are those of its flat groups)."""
        if self._dp is not None and self._dp.zero_stage:
            return {id(t) for fg in self._dp._groups[self._unit_index(unit)]
                    for t in fg.leaves}
        return {id(p) for opt in unit.optimizers
                for g in opt.param_groups for p in g["params"]}

    def _unit_index(self, unit: _Update) -> int:
        return next(i for i, u in enumerate(self._updates) if u is unit)

    def _gather_params(self) -> None:
        """Under ZeRO stage 3, all-gather the parameters that the last
        update left sharded (a collective: every rank reaches the same
        calls)."""
        if self._dp is not None and self._dp.zero_stage == 3:
            self._dp.ensure_full()

    def _apply_mesh(self, model) -> None:
        """Under a strategy's ``ProcessMesh``: hand it to the module
        (``param_shardings``, which also gives the per-leaf layout) and,
        where its 'ep' axis splits the experts, keep this member's slice of
        every expert leaf (``DataParallel.shard_experts``)."""
        mesh = self.strategy.process_mesh
        if mesh is None:
            return
        shardings = getattr(model, "param_shardings", None)
        specs = shardings(mesh) if shardings is not None else None
        if mesh.size("ep") > 1:
            if specs is None:
                raise NotImplementedError(
                    f"{type(model).__name__} gives no param_shardings, so an "
                    "'ep' mesh axis cannot tell its expert leaves")
            self._params = self._dp.shard_experts(self._params, specs)

    def whole_params(self):
        """The parameter tree with every expert leaf whole: under an ep mesh
        each leaf's slices are all-gathered over the ep group (a collective:
        every rank calls it at the same point); else the tree itself."""
        params = self._params if self._params is not None else (
            self._module._params if self._module is not None else None)
        if params is None or self._dp is None or not self._dp.expert_dims:
            return params
        return self._dp.gather_experts(params)

    def whole_state(self, weights_only: bool = False
                    ) -> Optional[Dict[str, Any]]:
        """What a checkpoint holds under an ep mesh, each expert leaf
        gathered whole over the ep group (a collective: every rank calls it
        at the same point, before rank 0 writes): ``state_dict``, and unless
        ``weights_only`` the stage-0 ``optimizer_states`` and a partial
        accumulation's ``grads``. None without an ep mesh (a checkpoint
        then reads the rank's own tensors)."""
        dp = self._dp
        if dp is None or not dp.expert_dims:
            return None
        whole: Dict[str, Any] = {"state_dict": self.whole_params()}
        if weights_only:
            return whole
        if not dp.zero_stage and self._optim is not None:
            whole["optimizer_states"] = [dp.gather_optimizer_state(opt)
                                         for opt in self._optim.optimizers]
        if self._micro_step:
            whole["grads"] = dp.gather_grads(list(tree_leaves(self._params)))
        return whole

    def _reduce_over_ranks(self, metrics: Dict[str, np.ndarray]):
        if self._dp is None:
            return metrics
        kinds = {name: (meta.reduce if meta else "mean") for name, meta in
                 ((n, self._module._log_meta.get(n)) for n in metrics)}
        return self._dp.reduce_metrics(metrics, kinds)

    @torch.no_grad()
    def _eval_step(self, phase: str, batch, batch_idx: int):
        module = self._module
        step_fn = {"val": module.validation_step, "test": module.test_step}[phase]
        params = self._params
        if self.precision_policy.cast_params_in_compute:
            params = cast_floats(params, self.precision_policy.compute_dtype)
        batch = cast_floats(batch, self.precision_policy.compute_dtype)
        module._capture_begin(phase)
        try:
            out = step_fn(params, batch, batch_idx)
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
        self._sampler_seed = seed
        self._step_log_buffer = []
        self._input_prefetcher = None
        self._input_stats = {"starved_s": 0.0, "batches": 0}
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        model.precision_policy = self.precision_policy
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
        train_loader = self._maybe_shard_loader(train_loader, shuffle=True)
        if val_loader is not None:
            val_loader = self._maybe_shard_loader(val_loader, shuffle=False)

        if model._params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            host = model.init_params(gen, self.device)
        else:
            host = model._params
        self._params = self._place_params(host)
        # the masters are a copy: a fresh init would otherwise stay
        # allocated beside them for the whole fit
        del host
        # over several ranks: the whole tree from global rank 0 over the
        # world, then (under an ep mesh) each member's slice of the experts,
        # and only then the optimizers, on the leaves each rank keeps
        self._dp = self.strategy.data_parallel(self)
        if self._dp is not None:
            self._dp.broadcast_(list(tree_leaves(self._params)))
            self._apply_mesh(model)
        model._params = self._params  # configure_optimizers reads them
        self._optim = _normalize_optimizers(model.configure_optimizers())
        if self._optim.labels is not None:
            _check_labels(self._optim, self._params)
        self._build_updates()
        self._micro_step = 0
        if self._dp is not None:
            if ckpt_path is not None and self._dp.zero_stage:
                raise NotImplementedError(
                    f"ckpt_path with ZeRO stage {self._dp.zero_stage}: "
                    "resuming sharded optimizer states is not ported yet "
                    "(ROADMAP.md); resume with RayStrategy (stage 0)")
            self._dp.setup(self._updates)
        if ckpt_path is not None:
            self._restore_checkpoint(ckpt_path)
        if self._optim.alternating:
            self._check_optimizer_idx()

        if self.logger is not None and self.is_global_zero:
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
                if self.should_stop and self.current_epoch < self.min_epochs:
                    self.should_stop = False
            self._gather_params()
        finally:
            self._drain_step_logs()
            self._fold_input_stats()
            self._hook("on_train_end")
            self._hook("on_fit_end")
            if self.logger is not None and self.is_global_zero:
                self.logger.finalize(self.state.status)
            self._cb("teardown", "fit")
            model.teardown("fit")
            if datamodule is not None:
                datamodule.teardown("fit")
        model._params = self._params

    def _prefetch_shard(self, loader, limit):
        """``(idx, host_batch, device_batch)`` through the input pipeline:
        host batches assembled on background threads (``AsyncLoader``,
        unless ``strategy.loader_num_workers`` is 0) and up to
        ``strategy.prefetch_depth`` batches' copies issued ahead of the
        step (``DevicePrefetcher``; on the card from pinned memory on a side
        stream). A bad batch raises after the good batches before it."""
        num_workers = self.strategy.loader_num_workers
        if not isinstance(loader, AsyncLoader) and num_workers != 0:
            loader = AsyncLoader(loader, num_workers=num_workers)
        self._input_prefetcher = DevicePrefetcher(
            self._to_device, depth=self.strategy.prefetch_depth,
            stream=self._copy_stream)
        return self._input_prefetcher.iterate(loader, limit)

    def _fold_input_stats(self) -> None:
        if self._input_prefetcher is not None:
            self._input_stats["starved_s"] += self._input_prefetcher.starved_s
            self._input_stats["batches"] += self._input_prefetcher.batches
            self._input_prefetcher = None

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
        t_epoch = time.perf_counter()
        n_batches = 0
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

        for batch_idx, batch, device_batch in self._prefetch_shard(
                train_loader, limit_train):
            self._cb("on_train_batch_start", batch, batch_idx)
            logs = self._train_step(device_batch)
            self._record_train_logs(logs, aggregator, self._batch_size_of(batch))
            self._cb("on_train_batch_end", logs, batch, batch_idx)
            self.global_step += 1
            n_batches += 1
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
            # only a max_steps break leaves the epoch marked partial
            self._epoch_ended = True

        self._drain_step_logs()
        self._fold_input_stats()
        epoch_metrics = self._reduce_over_ranks(
            aggregator.reduce(model._log_meta.get))
        epoch_out: Dict[str, np.ndarray] = {}
        for name, value in epoch_metrics.items():
            meta = model._log_meta.get(name)
            if meta is None or not meta.on_epoch:
                continue
            out_name = f"{name}_epoch" if (meta.on_step and meta.on_epoch) else name
            self.callback_metrics[out_name] = value
            self.logged_metrics[out_name] = value
            epoch_out[out_name] = value
        if self.logger is not None and epoch_out and self.is_global_zero:
            self.logger.log_metrics(epoch_out, step=self.global_step)

        if (
            val_loader is not None
            and not self.val_check_interval
            and (self.current_epoch + 1) % self.check_val_every_n_epoch == 0
        ):
            self._run_validation(val_loader)

        self._gather_params()
        self._hook("on_train_epoch_end")

        if self.enable_progress_bar and self.is_global_zero:
            # one batched read-back of the first scalar metrics
            head = {k: v for k, v in list(self.callback_metrics.items())[:6]
                    if np.asarray(v).size == 1}
            shown = ({k: f"{float(v):.4f}" for k, v in
                      zip(head, _host_floats(list(head.values())))}
                     if head else {})
            print(f"[epoch {self.current_epoch}] {n_batches} steps in "
                  f"{time.perf_counter() - t_epoch:.1f}s {shown}", flush=True)

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
            and self.is_global_zero
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
        self._gather_params()
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
        metrics = self._reduce_over_ranks(
            aggregator.reduce(self._module._log_meta.get))
        if record:
            for name, value in metrics.items():
                self.callback_metrics[name] = value
                self.logged_metrics[name] = value
            if self.logger is not None and metrics and self.is_global_zero:
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
        self._sampler_seed = seed_everything(self.seed)
        if datamodule is not None:
            datamodule.prepare_data()
            datamodule.setup(stage)
        model.prepare_data()
        model.setup(stage)
        loader = self._resolve_loader(dataloaders, datamodule, hook_name)
        if loader is None:
            raise ValueError(f"{stage} requires a dataloader")
        loader = self._maybe_shard_loader(loader, shuffle=False)
        self._dp = (self.strategy.data_parallel(self)
                    if self.strategy.world_size > 1 else None)
        if ckpt_path is not None:
            model._params = torch.load(ckpt_path, map_location="cpu",
                                       weights_only=True)["state_dict"]
        if model._params is None:
            raise ValueError(
                f"{stage} requires trained params (fit first or pass ckpt_path)"
            )
        model.precision_policy = self.precision_policy
        self._params = tree_map(
            lambda t: torch.as_tensor(t).detach().to(self.device),
            cast_floats(model._params, self.precision_policy.param_dtype),
        )
        if self._dp is not None:
            self._apply_mesh(model)
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
        if self.logger is not None and self.is_global_zero:
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
        policy = self.precision_policy
        params = self._params
        if policy.cast_params_in_compute:
            params = cast_floats(params, policy.compute_dtype)
        for batch_idx, batch in enumerate(loader):
            if limit is not None and batch_idx >= limit:
                break
            model._capture_begin("predict")
            try:
                out = model.predict_step(
                    params, cast_floats(self._to_device(batch),
                                        policy.compute_dtype), batch_idx)
            finally:
                model._capture_end()
            outputs.append(tree_map(
                lambda t: t.cpu() if torch.is_tensor(t) else t, out))
        self._cb("on_predict_end")
        return outputs

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def dump_checkpoint(self, weights_only: bool = False,
                        whole: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
        """The checkpoint as a dict. Under ZeRO stage >= 1 the optimizer
        states are this rank's shard and are left out (a resume from them
        is refused); under stage 3 the parameters must be whole, which they
        are at validation and at the epoch's end. Under an ep mesh the
        experts are written whole: from ``whole`` (:meth:`whole_state`,
        gathered by every rank), else gathered here, which every rank must
        then call."""
        model = self._module
        params = self._params if self._params is not None else model._params
        if self._dp is not None and self._dp.zero_stage == 3 and self._dp.released:
            raise RuntimeError(
                "dump_checkpoint under ZeRO stage 3 between steps: the "
                "parameters are sharded; checkpoints are written at "
                "validation and at the epoch's end, where every rank has "
                "gathered them")
        if whole is None:
            whole = self.whole_state(weights_only)
        if whole is not None:
            params = whole["state_dict"]
        ckpt: Dict[str, Any] = {
            "epoch": self.current_epoch,
            "epoch_complete": bool(self._epoch_ended),
            "global_step": self.global_step,
            "version": __version__,
            "state_dict": tree_map(lambda t: t.detach().cpu(), params),
            "hyper_parameters": dict(model.hparams),
        }
        if not weights_only:
            if self._dp is not None and self._dp.zero_stage:
                ckpt["zero_stage"] = self._dp.zero_stage
            elif self._optim is not None:
                ckpt["optimizer_states"] = (
                    whole["optimizer_states"] if whole is not None else
                    [opt.state_dict() for opt in self._optim.optimizers])
                scheds = [s for ss in self._optim.schedulers for s in ss]
                if scheds:
                    ckpt["lr_schedulers"] = [s.state_dict() for s in scheds]
            if self._micro_step:
                # a partial accumulation (MultiSteps' state lives in the
                # optimizer state, so the JAX checkpoint carries it too)
                grads = (whole["grads"] if whole is not None else
                         [t.grad for t in tree_leaves(params)])
                ckpt["accumulation"] = {
                    "micro_step": self._micro_step,
                    "grads": [None if g is None else g.detach().cpu()
                              for g in grads],
                }
            ckpt["callbacks"] = collect_callback_states(self.callbacks)
            ckpt["callback_metrics"] = {
                k: torch.as_tensor(np.asarray(v, dtype=np.float64))
                for k, v in self.callback_metrics.items()
            }
        model.on_save_checkpoint(ckpt)
        return ckpt

    def save_checkpoint(self, filepath: str, weights_only: bool = False,
                        whole: Optional[Dict[str, Any]] = None) -> None:
        """``torch.save`` of :meth:`dump_checkpoint`, written to a temporary
        file in the same directory and renamed into place, so a reader never
        sees a half-written checkpoint."""
        ckpt = self.dump_checkpoint(weights_only, whole)
        if not self.is_global_zero_writer:
            return
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
        """Resume a fit: parameters (in the policy's dtype), optimizer and
        scheduler states, a partial gradient accumulation, progress and
        callback states. A mid-epoch save re-runs its epoch from the
        start."""
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        if ckpt.get("zero_stage"):
            raise NotImplementedError(
                f"{ckpt_path} was written under ZeRO stage "
                f"{ckpt['zero_stage']} without optimizer states; resuming it "
                "is not ported yet (ROADMAP.md)")
        state_dict = ckpt["state_dict"]
        dp = self._dp
        experts = dp is not None and bool(dp.expert_dims)
        if experts:  # the whole tree, cut to this member's expert slices
            state_dict = dp.slice_whole(state_dict)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self._params),
                                tree_leaves(state_dict)):
                dst.copy_(src)
        optim = self._optim
        for opt, state in zip(optim.optimizers, ckpt.get("optimizer_states", [])):
            if experts:
                state = dp.slice_optimizer_state(opt, state)
            opt.load_state_dict(state)
        for sched, state in zip([s for ss in optim.schedulers for s in ss],
                                ckpt.get("lr_schedulers", [])):
            sched.load_state_dict(state)
        accumulation = ckpt.get("accumulation")
        if accumulation is not None:
            self._micro_step = int(accumulation["micro_step"])
            grads = accumulation["grads"]
            if experts:
                grads = [None if g is None else (
                    dp.slice_expert(g, dp.expert_dims[i]) if i in dp.expert_dims
                    else g) for i, g in enumerate(grads)]
            for leaf, g in zip(tree_leaves(self._params), grads):
                leaf.grad = None if g is None else g.to(self.device, leaf.dtype)
        base = int(ckpt.get("epoch", 0))
        self.current_epoch = base + 1 if ckpt.get("epoch_complete", True) else base
        self.global_step = int(ckpt.get("global_step", 0))
        restore_callback_states(self.callbacks, ckpt.get("callbacks", {}))
        for k, v in ckpt.get("callback_metrics", {}).items():
            self.callback_metrics[k] = np.asarray(v)
        self._module.on_load_checkpoint(ckpt)
