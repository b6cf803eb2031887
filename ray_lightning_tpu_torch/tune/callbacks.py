"""Tune <-> Trainer callbacks (``ray_lightning_tpu/tune/callbacks.py``).

Metrics and checkpoints made inside a launcher's worker processes are
reported from the trial process, where the trial session lives: each travels
as a callable through the worker's session queue, and the launcher's
result loop runs it in the trial process (``launchers/ray_launcher.py::
process_results``). When the Trainer runs in the trial process itself (a
``SingleDeviceStrategy``), the callable runs in place.

Unlike the JAX package, which ships lambdas and closures, the callables are
``functools.partial`` objects of module-level functions: the port's runtime
pickles with the standard library, by reference.

The checkpoint is ``to_state_stream(trainer.dump_checkpoint(...))``, which
``Trainer.fit(ckpt_path=...)`` reads back. Under an ep mesh every rank
gathers the experts (``trainer.whole_state()``, a collective) before rank 0
writes. Under ZeRO stage >= 1 it holds no optimizer states, and a resume
from it raises ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ray_lightning_tpu_torch.callbacks.base import Callback
from ray_lightning_tpu_torch.session import get_session
from ray_lightning_tpu_torch.tune import session as tune_session
from ray_lightning_tpu_torch.utils.serialization import to_state_stream


def _report(metrics: Dict[str, float]) -> None:
    tune_session.report(**metrics)


def _write_checkpoint(stream: bytes, filename: str) -> None:
    tune_session.get_trial_session().checkpoint(stream, filename)


def _scalar(value) -> float:
    """A metric as a float, from a tensor on any device or an array."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return float(np.asarray(value))


def _deliver(fn) -> None:
    """Run ``fn`` in the trial process: through the session queue from a
    launcher worker, in place when the Trainer runs in the trial process."""
    try:
        worker_session = get_session()
    except ValueError:
        worker_session = None
    if worker_session is not None:
        worker_session.put_queue(fn)
    else:
        fn()


class TuneCallback(Callback):
    VALID_ON = ("validation_end", "train_epoch_end", "test_end")

    def __init__(self, on: Union[str, Sequence[str]] = "validation_end"):
        if isinstance(on, str):
            on = [on]
        for point in on:
            if point not in self.VALID_ON:
                raise ValueError(f"invalid hook point {point!r}; valid: {self.VALID_ON}")
        self._on = list(on)

    def _handle(self, trainer, module) -> None:
        raise NotImplementedError

    def on_validation_end(self, trainer, module):
        if "validation_end" in self._on:
            self._handle(trainer, module)

    def on_train_epoch_end(self, trainer, module):
        if "train_epoch_end" in self._on:
            self._handle(trainer, module)

    def on_test_end(self, trainer, module):
        if "test_end" in self._on:
            self._handle(trainer, module)


class TuneReportCallback(TuneCallback):
    """Report trainer metrics to tune. ``metrics`` maps tune names to
    ``trainer.callback_metrics`` keys, or is a key or a list of keys
    reported under their own names; None reports every metric."""

    def __init__(
        self,
        metrics: Optional[Union[str, List[str], Dict[str, str]]] = None,
        on: Union[str, Sequence[str]] = "validation_end",
    ):
        super().__init__(on)
        if isinstance(metrics, str):
            metrics = [metrics]
        self._metrics = metrics

    def _get_report_dict(self, trainer) -> Optional[Dict[str, float]]:
        if trainer.sanity_checking:
            return None
        available = trainer.callback_metrics
        if not self._metrics:
            return {k: _scalar(v) for k, v in available.items()}
        report = {}
        if isinstance(self._metrics, dict):
            items = self._metrics.items()
        else:
            items = [(m, m) for m in self._metrics]
        for tune_name, trainer_name in items:
            if trainer_name in available:
                report[tune_name] = _scalar(available[trainer_name])
        return report or None

    def _handle(self, trainer, module):
        if not trainer.is_global_zero:
            return
        report = self._get_report_dict(trainer)
        if report is None:
            return
        _deliver(functools.partial(_report, report))


class _TuneCheckpointCallback(TuneCallback):
    """Ship the trainer's checkpoint stream to the trial process, which
    writes it into the trial directory (only the trial process knows it)."""

    def __init__(self, filename: str = "checkpoint", on="validation_end"):
        super().__init__(on)
        self._filename = filename

    def _handle(self, trainer, module):
        if trainer.sanity_checking:
            return
        # a collective under an ep mesh: every rank, before rank 0 writes
        whole = trainer.whole_state()
        if not trainer.is_global_zero:
            return
        stream = to_state_stream(trainer.dump_checkpoint(whole=whole))
        _deliver(functools.partial(_write_checkpoint, stream, self._filename))


class TuneReportCheckpointCallback(TuneCallback):
    """Checkpoint, then report, as one callback: the reported iteration has
    its checkpoint."""

    def __init__(
        self,
        metrics: Optional[Union[str, List[str], Dict[str, str]]] = None,
        filename: str = "checkpoint",
        on: Union[str, Sequence[str]] = "validation_end",
    ):
        super().__init__(on)
        self._checkpoint = _TuneCheckpointCallback(filename, on)
        self._report = TuneReportCallback(metrics, on)

    def _handle(self, trainer, module):
        self._checkpoint._handle(trainer, module)
        self._report._handle(trainer, module)
