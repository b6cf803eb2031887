"""The tune integration (``ray_lightning_tpu/tune/``): ``run`` with the
FIFO, ASHA and PBT schedulers, search spaces, ``with_parameters``, resource
bundles, and the Tune callbacks that report from a Trainer, through the
launcher's session queue when it trains in worker processes.

The callbacks import torch; they load on first use, so that a trial process
boots without it (its trainable imports what it needs)."""
from ray_lightning_tpu_torch.tune.schedulers import ASHAScheduler, PopulationBasedTraining
from ray_lightning_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_lightning_tpu_torch.tune.session import get_trial_session, is_session_enabled
from ray_lightning_tpu_torch.tune.tune import (
    ExperimentAnalysis,
    PlacementGroupFactory,
    get_tune_resources,
    max_concurrent_for,
    run,
    with_parameters,
)

_CALLBACKS = ("TuneReportCallback", "TuneReportCheckpointCallback")


def __getattr__(name):
    if name in _CALLBACKS:
        from ray_lightning_tpu_torch.tune import callbacks

        return getattr(callbacks, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "is_session_enabled",
    "get_trial_session",
    "TuneReportCallback",
    "TuneReportCheckpointCallback",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "uniform",
    "run",
    "with_parameters",
    "get_tune_resources",
    "PlacementGroupFactory",
    "max_concurrent_for",
    "ExperimentAnalysis",
    "ASHAScheduler",
    "PopulationBasedTraining",
]
