"""Trial schedulers (``ray_lightning_tpu/tune/schedulers.py``, a copy):
FIFO, ASHA (asynchronous successive halving at milestone rungs) and PBT
(quantile exploit), driven by the tune controller's result stream. Given the
same result stream they make the JAX package's decisions."""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


CONTINUE = "CONTINUE"
STOP = "STOP"
EXPLOIT = "EXPLOIT"  # PBT: (decision, source_trial_id)


class TrialScheduler:
    def on_result(self, trial_id: str, metrics: Dict[str, Any], iteration: int):
        return CONTINUE, None

    def on_complete(self, trial_id: str) -> None: ...


class FIFOScheduler(TrialScheduler):
    pass


@dataclass
class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving: at each rung (grace_period *
    reduction_factor^k iterations) a trial continues only if it is in the top
    1/reduction_factor of results seen at that rung."""

    metric: str = "loss"
    mode: str = "min"
    max_t: int = 100
    grace_period: int = 1
    reduction_factor: int = 4
    _rungs: Dict[int, List[float]] = field(default_factory=dict)
    _passed: Dict[str, set] = field(default_factory=dict)

    def _rung_levels(self) -> List[int]:
        levels = []
        t = self.grace_period
        while t < self.max_t:
            levels.append(t)
            t *= self.reduction_factor
        return levels

    def on_result(self, trial_id, metrics, iteration):
        if self.metric not in metrics:
            return CONTINUE, None
        value = float(metrics[self.metric])
        if self.mode == "max":
            value = -value
        if iteration >= self.max_t:
            return STOP, None
        passed = self._passed.setdefault(trial_id, set())
        # milestone semantics: a trial is judged at the first report AT OR
        # PAST each rung it hasn't been judged at yet (trials need not
        # report every iteration)
        for level in self._rung_levels():
            if iteration >= level and level not in passed:
                passed.add(level)
                recorded = self._rungs.setdefault(level, [])
                recorded.append(value)
                k = max(1, len(recorded) // self.reduction_factor)
                cutoff = sorted(recorded)[k - 1]
                if value > cutoff:
                    return STOP, None
        return CONTINUE, None

    def on_complete(self, trial_id):
        self._passed.pop(trial_id, None)


@dataclass
class PopulationBasedTraining(TrialScheduler):
    """PBT: at each perturbation interval, bottom-quantile trials clone the
    state of a top-quantile trial (checkpoint transfer handled by the
    controller) and explore a mutated config."""

    metric: str = "loss"
    mode: str = "min"
    perturbation_interval: int = 2
    hyperparam_mutations: Dict[str, Any] = field(default_factory=dict)
    quantile_fraction: float = 0.25
    seed: int = 0
    _latest: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    _rng: Optional[random.Random] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    @property
    def rng(self) -> random.Random:
        return self._rng

    def on_result(self, trial_id, metrics, iteration):
        if self.metric not in metrics:
            return CONTINUE, None
        value = float(metrics[self.metric])
        self._latest[trial_id] = (value, iteration)
        if iteration % self.perturbation_interval != 0 or len(self._latest) < 2:
            return CONTINUE, None
        scores = sorted(
            self._latest.items(),
            key=lambda kv: kv[1][0],
            reverse=(self.mode == "max"),
        )
        n = len(scores)
        k = max(1, int(math.ceil(n * self.quantile_fraction)))
        top = [t for t, _ in scores[:k]]
        bottom = {t for t, _ in scores[-k:]}
        if trial_id in bottom and trial_id not in top:
            source = self._rng.choice(top)
            return EXPLOIT, source
        return CONTINUE, None

    def on_complete(self, trial_id):
        self._latest.pop(trial_id, None)
