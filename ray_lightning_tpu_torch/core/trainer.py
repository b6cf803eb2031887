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
TPU accelerator (``accelerator="tpu"``).

With ``strategy.telemetry`` (``observability/``) a fit records spans
(``fit/setup``, ``compile`` for the first step and ``step`` after it,
``validate``, ``checkpoint/save``/``restore``, ``elastic/*``), the
``rlt_step_time_seconds`` histogram (the host's interval of each step,
with no sync: the device's step time once the launches back up), the
input pipeline's counters and a goodput ledger that classes every second
of the fit. In a worker the session's beats carry them to the main
process; an in-process fit writes them itself under
``<default_root_dir>/telemetry`` when it ends. With telemetry off the step
loop pays one ``None`` check.

Each training and validation batch starts with a health tick: a fault
scripted for this rank at this step fires (``runtime/faults.py``), then a
heartbeat goes to the main process's hang supervisor (``session.py``,
throttled; a no-op outside a worker). A tick reads no tensor, so it adds no
host sync to a step. A worker group that the launcher relaunched after a
failure resumes from ``_relaunch_ckpt_path``, the newest checkpoint the run
wrote, in place of the ``ckpt_path`` that fit was given.

In an elastic group (``RayStrategy(elastic=True)``, ``runtime/elastic.py``)
the tick also polls the membership ledger: a shrink aborts the epoch, and
so does a collective that failed against a dead peer once the main
process's shrink arrives. ``_apply_resize`` then moves the worker to the
new membership epoch: the state it keeps comes through the JAX tiers (the
live handoff, this rank's own salvage, the checkpoint the main process
pinned), the process group is joined again at the new world size and rank,
the data-parallel engine with its buckets and ZeRO shards and the
optimizers are rebuilt, the samplers re-sharded, and the epoch re-runs
from its start. A grow is applied at an epoch's end: a survivor writes its
live state and the spare that joins (``_elastic_join``) loads it.
"""
from __future__ import annotations

import contextlib
import inspect
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ray_lightning_tpu_torch import observability as obs
from ray_lightning_tpu_torch import session as worker_session
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
from ray_lightning_tpu_torch.runtime import faults
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


class _SyncedFile:
    """A file that ``torch.save`` writes into, synced to disk after every
    ``SYNC_BYTES`` with a heartbeat after each sync: a checkpoint's write
    proceeds in bounded steps, each a sign of life."""

    SYNC_BYTES = 256 * 2**20

    def __init__(self, f, step: int):
        self.f, self.step, self.pending = f, step, 0

    def write(self, data) -> int:
        n = self.f.write(data)
        self.pending += memoryview(data).nbytes
        if self.pending >= self.SYNC_BYTES:
            self.f.flush()
            os.fsync(self.f.fileno())
            self.pending = 0
            worker_session.emit_heartbeat(self.step)
        return n

    def flush(self) -> None:
        self.f.flush()


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
        # set by the launcher for a relaunched worker group: the checkpoint
        # its fit resumes from
        self._relaunch_ckpt_path: Optional[str] = None
        # an elastic worker's view of the membership ledger (set in the
        # worker by the launcher), and what its resizes did
        self._elastic_agent = None
        self.elastic_log: List[Dict[str, Any]] = []
        # the flight recorder and the goodput ledger of the running fit:
        # None with telemetry off, the hot loop's only check
        self._obs = None
        self._goodput = None
        self._first_step_dispatched = False

    def __getstate__(self):
        """What ships to a worker: no optimizer, stream, engine or parameter
        copies (the module carries the parameters it starts from)."""
        state = dict(self.__dict__)
        state.update(_optim=None, _updates=[], _copy_stream=None, _dp=None,
                     _input_prefetcher=None, _step_log_buffer=[], _params=None,
                     _elastic_agent=None, _obs=None, _goodput=None,
                     _profiler=None)
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

    def _train_program(self) -> str:
        """The train step's program name in the cost records, as the JAX
        Trainer's ``_train_program``."""
        zero = self._dp is not None and self._dp.zero_stage
        return "zero_train_step" if zero else "train_step"

    def _analyze_train_step(self, prof, batch) -> None:
        """The step's cost, counted once on meta tensors of its shapes (off
        with ``TORCHRT_COST_ANALYSIS=0``); a step that cannot be counted
        ships no cost record. Never raises."""
        if not obs.profiler.cost_analysis_enabled():
            return
        try:
            program = self._train_cost_program(batch)
        except Exception:
            return
        prof.analyze(self._train_program(), *program)

    def _train_cost_program(self, batch):
        """``(fn, args, collectives)`` for the profiler's count of one train
        step (``observability.profiler.FleetProfiler.analyze``): ``fn(params,
        batch)`` runs, on meta copies of the parameters and of ``batch``, what
        ``_train_step`` runs for one micro-batch (the compute view, the
        module's ``training_step``, the backward with remat's recompute)
        and one update (the mean over the micro-batches, the clip, each
        optimizer's step, on fresh optimizers of the same classes and
        settings over the meta leaves, their state made outside the count).
        It touches no leaf, gradient, optimizer, scheduler or counter of the
        trainer. ``collectives`` are the data-parallel engine's for the step
        (``DataParallel.step_collectives``)."""
        to_meta = obs.profiler.to_meta
        params = to_meta(self._params, requires_grad=True)
        meta_of = {id(t): m for t, m in zip(tree_leaves(self._params),
                                             tree_leaves(params))}
        units = []
        for unit in self._updates:
            opts = []
            for opt in unit.optimizers:
                groups = []
                for g in opt.param_groups:
                    held = [meta_of.get(id(p)) for p in g["params"]]
                    held = [m if m is not None else to_meta(p, True)
                            for m, p in zip(held, g["params"])]
                    groups.append({**g, "params": held})
                accepted = inspect.signature(type(opt)).parameters
                meta_opt = type(opt)(groups, **{
                    k: v for k, v in opt.defaults.items() if k in accepted})
                # the state a live optimizer already holds after its first
                # step, made outside the count
                for g in meta_opt.param_groups:
                    for p in g["params"]:
                        p.grad = torch.empty_like(p)
                meta_opt.step()
                meta_opt.zero_grad(set_to_none=True)
                opts.append(meta_opt)
            leaves = [meta_of[id(t)] for t in unit.leaves]
            units.append((opts, leaves))
        module = self._module
        policy = self.precision_policy
        alternating = self._optim.alternating
        step = self.global_step
        accumulate = self.accumulate_grad_batches
        clip = self.gradient_clip_val

        def update(opts, leaves):
            for m in leaves:
                if m.grad is None:
                    m.grad = torch.zeros_like(m)
            grads = [m.grad for m in leaves]
            if accumulate > 1:
                torch._foreach_div_(grads, float(accumulate))
            if clip:
                _clip_by_global_norm(grads, clip)
            for opt in opts:
                for g in opt.param_groups:
                    for p in g["params"]:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
                opt.step()

        def fn(params, batch):
            batch = round_matmul_inputs(self.matmul_precision,
                                        cast_floats(batch, policy.compute_dtype))
            with matmul_precision_scope(self.matmul_precision):
                for i, (opts, leaves) in enumerate(units):
                    extra = {"optimizer_idx": i} if alternating else {}
                    out = module.training_step(self._compute_view(params),
                                               batch, step, **extra)
                    loss = out["loss"] if isinstance(out, dict) else out
                    if not alternating:
                        loss.backward()
                    else:
                        grads = torch.autograd.grad(loss, leaves,
                                                    allow_unused=True)
                        for m, g in zip(leaves, grads):
                            m.grad = g
                    with torch.no_grad():
                        update(opts, leaves)

        collectives = (self._dp.step_collectives(self._updates, clip)
                       if self._dp is not None else {})
        return fn, (params, to_meta(batch)), collectives

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

    def _build_engine(self, model, broadcast: bool = True) -> None:
        """Over several ranks: the data-parallel engine over the joined
        group, the whole tree from global rank 0 (unless ``broadcast`` is
        False: a resize or a joining spare loads its state after), then,
        under an ep mesh, each member's slice of the experts; and the
        optimizers on the leaves each rank keeps (under ZeRO, its flat
        shards)."""
        self._dp = self.strategy.data_parallel(self)
        if self._dp is not None:
            if broadcast:
                self._dp.broadcast_(list(tree_leaves(self._params)))
            self._apply_mesh(model)
        model._params = self._params  # configure_optimizers reads them
        self._optim = _normalize_optimizers(model.configure_optimizers())
        if self._optim.labels is not None:
            _check_labels(self._optim, self._params)
        self._build_updates()
        self._micro_step = 0
        if self._dp is not None:
            self._dp.setup(self._updates)
            if self._dp.zero_stage:
                self._publish_zero_telemetry()

    def _publish_zero_telemetry(self) -> None:
        """The ZeRO parameter all-gather's bytes as gauges: as gathered
        and as fp32 would be, beside the leaves sharded (nothing with
        telemetry off)."""
        reg = obs.registry()
        if reg is None:
            return
        sizes = self._dp.zero_gather_bytes()
        reg.gauge("rlt_zero_allgather_bytes",
                  program="zero_train_step").set(float(sizes["wire"]))
        reg.gauge("rlt_zero_allgather_fp32_bytes",
                  program="zero_train_step").set(float(sizes["fp32"]))
        reg.gauge("rlt_zero_sharded_params").set(float(sizes["leaves"]))

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
        """What a checkpoint holds under an ep mesh or ZeRO, gathered whole
        (a collective: every rank calls it at the same point, before rank 0
        writes): ``state_dict`` with each expert leaf whole over the ep
        group, and unless ``weights_only`` the ``optimizer_states`` as a
        stage-0 optimizer of the whole model holds them (under ZeRO the
        shards all-gathered, ``DataParallel.gather_zero_state``) and a
        partial accumulation's ``grads``. None otherwise (a checkpoint then
        reads the rank's own tensors)."""
        dp = self._dp
        if dp is None or not (dp.expert_dims or dp.zero_stage):
            return None
        whole: Dict[str, Any] = {"state_dict": self.whole_params()}
        if weights_only:
            return whole
        if self._optim is not None:
            gather = (dp.gather_zero_state if dp.zero_stage
                      else dp.gather_optimizer_state)
            whole["optimizer_states"] = [gather(opt)
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
        if getattr(self.strategy, "telemetry", False):
            obs.enable()
        self._obs = obs.get_recorder()
        # every second of the fit classified into a goodput category,
        # published on each beat (collect_beat_payload)
        self._goodput = (obs.goodput.new_ledger("train")
                         if self._obs is not None else None)
        self._first_step_dispatched = False
        # the fleet profiler: armed by telemetry (the driver's command file)
        # or by TORCHRT_PROFILE_AT_STEP; absent otherwise, so that the hot
        # loop keeps its one attribute check
        self._profiler = None
        if self._obs is not None or os.environ.get(
                obs.profiler.PROFILE_AT_STEP_ENV):
            from ray_lightning_tpu_torch.observability.aggregator import (
                telemetry_dir,
            )

            try:
                self._profiler = obs.profiler.FleetProfiler(
                    telemetry_dir(self.default_root_dir),
                    rank=self.global_rank or 0, recorder=self._obs,
                    device=self.device)
            except Exception:
                self._profiler = None
        setup_wall, setup_t0 = time.time(), time.perf_counter()
        agent = self._elastic_agent
        if agent is not None:
            agent.beat = lambda: worker_session.emit_heartbeat(
                self.global_step)
            if agent.is_joiner:
                # a warm spare: wait to be named in a grow and join its
                # group before anything reads the world
                self._elastic_join(agent)
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
        joining = agent is not None and agent.pending_handoff_cmd is not None
        self._build_engine(model, broadcast=not joining)
        if self._relaunch_ckpt_path is not None:
            # a relaunched group: the newest state of this run beats the
            # checkpoint the fit started from
            ckpt_path = self._relaunch_ckpt_path
        if ckpt_path is not None:
            self._restore_checkpoint(ckpt_path)
        if joining:
            # an admitted spare: the survivors' live state beats all else
            self._load_elastic_handoff(agent)
        if self._optim.alternating:
            self._check_optimizer_idx()
        if self._obs is not None:
            # data, parameters, engine and optimizers, restore included
            self._obs.add_span("fit/setup", setup_wall,
                               time.perf_counter() - setup_t0,
                               step=self.global_step)

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

        from ray_lightning_tpu_torch.parallel import data_parallel

        if self._dp is not None and worker_session.heartbeat_enabled():
            data_parallel.set_collective_beat(
                lambda: worker_session.emit_heartbeat(self.global_step))
        try:
            while self.current_epoch < self.max_epochs and not self.should_stop:
                try:
                    self._run_train_epoch(train_loader, val_loader)
                except Exception as err:
                    cmd = self._elastic_resize_for(err)
                    if cmd is None:
                        raise
                    self._apply_resize(cmd, train_loader, val_loader, err)
                    # as after a mid-epoch resume: the epoch re-runs from
                    # its start (some batches train again, none are skipped)
                    continue
                self.current_epoch += 1
                if 0 <= self.max_steps <= self.global_step:
                    self.should_stop = True
                if self.should_stop and self.current_epoch < self.min_epochs:
                    self.should_stop = False
                if agent is not None:
                    # the boundary admits a pending grow (or a resize that
                    # raced the epoch's end); on the last boundary too, so
                    # that a joiner waiting to be admitted is released
                    cmd = agent.poll_epoch_end()
                    if cmd is not None:
                        self._apply_resize(cmd, train_loader, val_loader)
            self._gather_params()
        finally:
            data_parallel.set_collective_beat(None)
            if self._goodput is not None:
                self._goodput.enter("drain")
            self._drain_step_logs()
            self._fold_input_stats()
            if self._profiler is not None:
                # a window cut short by should_stop or an exception still
                # stops its trace and ships its records
                self._profiler.close()
                self._profiler = None
            self._hook("on_train_end")
            self._hook("on_fit_end")
            if self.logger is not None and self.is_global_zero:
                self.logger.finalize(self.state.status)
            self._cb("teardown", "fit")
            model.teardown("fit")
            if datamodule is not None:
                datamodule.teardown("fit")
        model._params = self._params
        in_process = (getattr(self.strategy, "launcher", None) is None
                      and not getattr(self.strategy, "_is_remote", False))
        # a worker leaves its pending profile records to its final beat; an
        # in-process fit drains them here or loses them
        profile_records = obs.profiler.drain_pending() if in_process else None
        if in_process and (self._obs is not None or profile_records):
            # no aggregator in the main process: this process's ring and
            # registry go straight to the files a launched fit leaves
            from ray_lightning_tpu_torch.observability.aggregator import (
                telemetry_dir,
                write_local_dump,
            )

            write_local_dump(
                telemetry_dir(self.default_root_dir), self._obs,
                obs.metrics.get_registry() if self._obs is not None else None,
                profile=profile_records)

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
            stream=self._copy_stream, recorder=self._obs)
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

        # hoisted: with telemetry off the loop pays one `rec is not None`
        # check a batch (and one for the profiler, which exists only with
        # telemetry or an armed TORCHRT_PROFILE_AT_STEP)
        rec = self._obs
        prof = self._profiler
        led = self._goodput
        step_hist = (obs.metrics.get_registry().histogram(
            "rlt_step_time_seconds") if rec is not None else None)
        # the time between iterations is the prefetcher pulling the next
        # batch: input wait until the body reclassifies it
        if led is not None:
            led.enter("input_wait")
        for batch_idx, batch, device_batch in self._prefetch_shard(
                train_loader, limit_train):
            if led is not None:
                led.enter("productive_compute" if self._first_step_dispatched
                          else "compile")
            if rec is not None or prof is not None:
                it_wall, it_t0 = time.time(), time.perf_counter()
                if prof is not None:
                    prof.before_step(self.global_step, device_batch)
            self._health_tick(train=True)
            self._cb("on_train_batch_start", batch, batch_idx)
            logs = self._train_step(device_batch)
            self._record_train_logs(logs, aggregator, self._batch_size_of(batch))
            self._cb("on_train_batch_end", logs, batch, batch_idx)
            self.global_step += 1
            n_batches += 1
            if rec is not None or prof is not None:
                dt = time.perf_counter() - it_t0
                first = not self._first_step_dispatched
                if rec is not None and first:
                    # the first step builds the kernels: out of the
                    # step-time histogram
                    rec.add_span("compile", it_wall, dt,
                                 step=self.global_step - 1)
                elif rec is not None:
                    # the host's interval of the step: the device's step
                    # time once the launch queue backs up
                    rec.add_span("step", it_wall, dt,
                                 step=self.global_step - 1)
                    step_hist.observe(dt)
                if prof is not None and first:
                    self._analyze_train_step(prof, device_batch)
                elif prof is not None:
                    prof.after_step(
                        self.global_step - 1, dt, sync=logs,
                        starved_s=(self._input_prefetcher.starved_s
                                   if self._input_prefetcher is not None
                                   else 0.0))
            self._first_step_dispatched = True
            if val_loader is not None and (
                (val_every_n_batches is not None
                 and (batch_idx + 1) % val_every_n_batches == 0)
                or (isinstance(self.val_check_interval, int)
                    and self.val_check_interval
                    and self.global_step % self.val_check_interval == 0)
            ):
                self._run_validation(val_loader)
            if led is not None:
                led.enter("input_wait")
            if 0 <= self.max_steps <= self.global_step:
                self.should_stop = True
                break
        else:
            # only a max_steps break leaves the epoch marked partial
            self._epoch_ended = True

        if led is not None:
            led.enter("idle")
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

    def _health_tick(self, train: bool) -> None:
        """A batch's liveness tick: fire a fault scripted for this rank at
        this global step (training batches only: a validation batch must not
        fire a step's fault again), then a heartbeat. Both are no-ops
        unless set up."""
        if train:
            faults.fire_step_faults(self.global_step)
        worker_session.emit_heartbeat(self.global_step)
        agent = self._elastic_agent
        if train and agent is not None:
            # one stat of the ledger: a resize to apply now aborts the epoch
            cmd = agent.poll_now()
            if cmd is not None:
                from ray_lightning_tpu_torch.runtime.elastic import (
                    MembershipChanged,
                )

                raise MembershipChanged(cmd)

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
        led = self._goodput
        ctx = (led.phase("productive_compute") if led is not None
               else contextlib.nullcontext())
        with ctx, obs.span("validate", step=self.global_step):
            self._gather_params()
            self._hook("on_validation_epoch_start")
            self._cb("on_validation_start")
            metrics = self._run_eval_epoch(
                val_loader, limit=self.limit_val_batches, record=True)
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
            self._health_tick(train=False)
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
        """The checkpoint as a dict. Under ZeRO or an ep mesh the optimizer
        states and experts are written whole: from ``whole``
        (:meth:`whole_state`, gathered by every rank), else gathered here,
        which every rank must then call; ``zero_stage`` records the stage
        it was written under. Under stage 3 the parameters must be whole,
        which they are at validation and at the epoch's end."""
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
            if self._optim is not None:
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
        led = self._goodput
        ctx = (led.phase("checkpoint") if led is not None
               else contextlib.nullcontext())
        with ctx, obs.span("checkpoint/save", step=self.global_step,
                           path=filepath):
            ckpt = self.dump_checkpoint(weights_only, whole)
            if not self.is_global_zero_writer:
                return
            # a checkpoint of GBs can outlast a hang_timeout: it is written
            # in synced steps with a beat after each (_SyncedFile), so that
            # only a stalled write goes silent
            worker_session.emit_heartbeat(self.global_step, force=True)
            filepath = os.path.abspath(filepath)
            directory = os.path.dirname(filepath)
            os.makedirs(directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    torch.save(ckpt, _SyncedFile(f, self.global_step))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, filepath)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            worker_session.emit_heartbeat(self.global_step, force=True)
        reg = obs.registry()
        if reg is not None:
            reg.counter("rlt_checkpoint_saves_total").inc()

    def await_checkpoint_writer(self) -> None:
        """Every rank, after a checkpoint that rank 0 writes: over several
        ranks with a heartbeat channel, wait for the writer in a barrier and
        beat meanwhile, so that a long write does not leave the waiting
        ranks silent (a no-op otherwise)."""
        if self.world_size <= 1 or not worker_session.heartbeat_enabled():
            return
        import torch.distributed as dist

        work = dist.barrier(async_op=True)
        while not work.is_completed():
            worker_session.emit_heartbeat(self.global_step)
            time.sleep(0.01)
        work.wait()

    def _restore_checkpoint(self, ckpt_path: str) -> None:
        """Resume a fit: parameters (in the policy's dtype), optimizer and
        scheduler states, a partial gradient accumulation, progress and
        callback states. The optimizer states are whole, whatever the (world
        size, ZeRO stage) they were written under: under ZeRO each rank
        cuts its shards from them. A mid-epoch save re-runs its epoch from
        the start."""
        with obs.span("checkpoint/restore", path=ckpt_path):
            self._load_state(torch.load(ckpt_path, map_location="cpu",
                                        weights_only=True))

    def _load_state(self, ckpt: Dict[str, Any], progress: bool = True) -> None:
        """A checkpoint's state (a file's, an elastic handoff's or this
        rank's own salvage) into the current parameters, optimizers and
        schedulers, cut to this rank's ZeRO shards and expert slices;
        ``progress`` also takes its epoch and step."""
        state_dict = ckpt["state_dict"]
        dp = self._dp
        experts = dp is not None and bool(dp.expert_dims)
        if experts:  # the whole tree, cut to this member's expert slices
            state_dict = dp.slice_whole(state_dict)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(self._params),
                                tree_leaves(state_dict)):
                dst.copy_(src)
        zero = dp is not None and dp.zero_stage
        if zero:  # the leaves are views of the flat buffers: the shards too
            dp.sync_shards()
        optim = self._optim
        for opt, state in zip(optim.optimizers, ckpt.get("optimizer_states", [])):
            if zero:
                state = dp.slice_zero_state(opt, state)
            elif experts:
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
        if progress:
            base = int(ckpt.get("epoch", 0))
            self.current_epoch = (base + 1 if ckpt.get("epoch_complete", True)
                                  else base)
            self.global_step = int(ckpt.get("global_step", 0))
        restore_callback_states(self.callbacks, ckpt.get("callbacks", {}))
        for k, v in ckpt.get("callback_metrics", {}).items():
            self.callback_metrics[k] = np.asarray(v)
        self._module.on_load_checkpoint(ckpt)

    # ------------------------------------------------------------------ #
    # elastic membership (shrink and grow without a relaunch)
    # ------------------------------------------------------------------ #
    def _elastic_join(self, agent) -> None:
        """A warm spare's admission: wait for the grow naming this boot id,
        join its group and take its rank."""
        from ray_lightning_tpu_torch.runtime import elastic

        t = time.perf_counter()
        with obs.span("elastic/join", boot_id=agent.boot_id):
            while True:
                cmd = agent.wait_for_join()
                try:
                    cmd = agent.connect(cmd)
                    break
                except elastic.MembershipChanged:
                    continue  # superseded before it connected: wait again
        self._set_rank(cmd.rank_of(agent.boot_id), cmd.world)
        self.elastic_log.append({"kind": "join", "epoch": cmd.epoch,
                                 "world": cmd.world, "join_s":
                                 time.perf_counter() - t, "wall": time.time()})

    def _set_rank(self, rank: int, world: int) -> None:
        """Take ``rank`` of ``world``: the strategy's context, and the rank
        that fault specs target (the logical rank, as in the JAX package)."""
        strategy = self.strategy
        strategy._set_worker_context(rank, world, local_rank=strategy.local_rank,
                                     node_rank=rank)
        os.environ[faults.RANK_ENV] = str(rank)

    def _load_elastic_handoff(self, agent) -> None:
        """A joiner's side of the handoff: the survivors' live state (or,
        when the writer could not salvage it, the pinned checkpoint), then
        the ack of the membership epoch."""
        from ray_lightning_tpu_torch.runtime import elastic

        cmd, agent.pending_handoff_cmd = agent.pending_handoff_cmd, None
        t = time.perf_counter()
        with obs.span("elastic/handoff_load", epoch=cmd.epoch):
            payload = elastic.read_handoff(cmd.handoff,
                                           timeout=agent.join_timeout,
                                           allow_failed=True)
            if payload is not None:
                self._load_state(payload["ckpt"], progress=False)
                self.current_epoch = int(payload["meta"]["epoch"])
                self.global_step = int(payload["meta"]["global_step"])
            elif cmd.restore:
                self._restore_checkpoint(cmd.restore)
            else:
                raise RuntimeError(
                    f"elastic grow (membership epoch {cmd.epoch}): the "
                    "survivors' state was not handed over and no checkpoint "
                    "is available")
        self.elastic_log[-1]["handoff_read_s"] = time.perf_counter() - t
        agent.ack(cmd)
        self.elastic_log[-1]["ack_wall"] = time.time()

    def _elastic_resize_for(self, err: BaseException):
        """The resize an exception out of the epoch stands for, or None: a
        resize raised by the tick, or a collective that failed against a
        dead peer, after which the worker waits for the main process's
        shrink."""
        agent = self._elastic_agent
        if agent is None:
            return None
        from ray_lightning_tpu_torch.runtime import elastic

        if isinstance(err, elastic.MembershipChanged):
            return err.cmd
        if elastic.is_collective_failure(err):
            return agent.wait_for_resize()
        return None

    def _salvage_live_state(self, healthy: bool) -> Optional[Dict[str, Any]]:
        """This rank's live state as a checkpoint dict, or None. A failed
        collective happens before ``optimizer.step``, so a rank that holds
        the whole model (no ZeRO, no expert slices) has intact weights and
        states. Under ZeRO or an ep mesh the state is gathered whole, a
        collective, which only a healthy group (an epoch-boundary resize,
        every member calling) can do: after a death the dead rank's shards
        are gone and the checkpoint tier restores."""
        dp = self._dp
        if dp is not None and (dp.zero_stage or dp.expert_dims) and not healthy:
            return None
        try:
            return self.dump_checkpoint()
        except Exception:
            return None

    def _apply_resize(self, cmd, train_loader, val_loader, err=None) -> None:
        """Move this worker to membership epoch ``cmd.epoch``: settle the
        host buffers, hand over or salvage the live state, join the new
        group at its world size and rank, rebuild the engine and the
        optimizers and restore the state through the best tier (the live
        handoff, this rank's salvage, the pinned checkpoint), then re-shard
        the samplers and ack."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.mesh import ProcessMesh
        from ray_lightning_tpu_torch.runtime import elastic

        agent = self._elastic_agent
        t0, wall0 = time.perf_counter(), time.time()
        if self._goodput is not None:
            # a planned resize is an elastic transition; one that a failure
            # forced is fault recovery
            self._goodput.enter("fault_recovery" if err is not None
                                else "elastic_transition")
        my_rank = cmd.rank_of(agent.boot_id)
        if my_rank is None:  # evicted while transitioning: not our group
            raise elastic.MembershipChanged(cmd)
        spec = getattr(self.strategy, "mesh_spec", None)
        if spec is not None:
            try:
                ProcessMesh(spec, cmd.world, my_rank)
            except (ValueError, NotImplementedError) as e:
                raise RuntimeError(
                    f"elastic {cmd.kind} to world {cmd.world}: the mesh "
                    f"{spec.axes} cannot be rebuilt at this size ({e})"
                ) from err
        try:
            self._drain_step_logs()
        except Exception:
            self._step_log_buffer = []
        self._fold_input_stats()
        # a failed update's partial accumulation is dropped: the epoch
        # re-runs from its start
        for leaf in tree_leaves(self._params):
            leaf.grad = None
        self._micro_step = 0
        healthy = err is None
        writer = (cmd.handoff_writer is not None
                  and agent.boot_id == cmd.handoff_writer)
        dp = self._dp
        gathered = dp is not None and bool(dp.zero_stage or dp.expert_dims)
        salvage = None
        if writer or (cmd.kind == "shrink" and cmd.world == 1) or (
                healthy and gathered):
            salvage = self._salvage_live_state(healthy)
        meta = {"epoch": int(self.current_epoch),
                "global_step": int(self.global_step)}
        record = {"kind": cmd.kind, "epoch": cmd.epoch, "world": cmd.world,
                  "wall": wall0, "failure": None if err is None
                  else f"{type(err).__name__}: {str(err)[:200]}"}
        if writer:
            t = time.perf_counter()
            if salvage is not None:
                record["handoff_bytes"] = elastic.write_handoff(
                    cmd.handoff, {"ckpt": salvage, "meta": meta})
            else:  # the readers fall back to the checkpoint tier
                elastic.write_handoff_failed(cmd.handoff)
            record["handoff_write_s"] = time.perf_counter() - t
        worker_session.emit_heartbeat(self.global_step, force=True)

        t = time.perf_counter()
        if dist.is_initialized():
            agent.backend = dist.get_backend()
        with obs.span("elastic/reconnect", epoch=cmd.epoch, world=cmd.world):
            cmd = agent.reconnect(cmd)
        record["reconnect_s"] = time.perf_counter() - t
        my_rank = cmd.rank_of(agent.boot_id)
        self._set_rank(my_rank, cmd.world)

        state, progress = None, True
        if cmd.handoff and not writer:
            t = time.perf_counter()
            payload = elastic.read_handoff(cmd.handoff,
                                           timeout=agent.failure_wait,
                                           allow_failed=True)
            record["handoff_read_s"] = time.perf_counter() - t
            if payload is not None:
                state, meta, record["tier"] = payload["ckpt"], payload[
                    "meta"], "handoff"
                progress = False
        elif salvage is not None:
            state, progress, record["tier"] = salvage, False, "salvage"
        if state is None and cmd.restore:
            state = torch.load(cmd.restore, map_location="cpu",
                               weights_only=True)
            record["tier"] = "checkpoint"
        if state is None:
            raise RuntimeError(
                f"elastic {cmd.kind} (membership epoch {cmd.epoch}): no live "
                "state survived and no checkpoint is available to restore "
                "from") from err
        self._params = self._place_params(state["state_dict"])
        self._build_engine(self._module, broadcast=False)
        self._load_state(state, progress=progress)
        if not progress:
            self.current_epoch = int(meta["epoch"])
            self.global_step = int(meta["global_step"])
        del state, salvage
        for loader in (train_loader, val_loader):
            self._resize_sampler(loader)
        self._cb("on_membership_resize")
        agent.ack(cmd)
        record.update(rank=my_rank, resize_s=time.perf_counter() - t0,
                      ack_wall=time.time())
        self.elastic_log.append(record)
        # the first step after a resize is a compile again, as in JAX
        self._first_step_dispatched = False
        if self._obs is not None:
            self._obs.add_span("elastic/resize", wall0, record["resize_s"],
                               step=self.global_step)
        worker_session.emit_heartbeat(self.global_step, force=True)

    def _resize_sampler(self, loader) -> None:
        """Re-shard a loader's ``DistributedSampler`` over the new ranks."""
        sampler = getattr(loader, "sampler", None) if loader is not None else None
        if not isinstance(sampler, DistributedSampler):
            return
        kwargs = (self.strategy.distributed_sampler_kwargs
                  or {"num_replicas": 1, "rank": 0})
        sampler.num_replicas = kwargs["num_replicas"]
        sampler.rank = kwargs["rank"]
        n = sampler.num_replicas
        sampler.num_samples = (sampler.data_len // n if sampler.drop_last
                               else -(-sampler.data_len // n))
